"""Training over the frame axis in the port, on the CPU: gloo worlds of 2
and 4 processes (tests/torch_mesh_worker.py, one thread each) run
`make_train_step(mesh=)` on a 1 x 2 and a 2 x 2 (data, frame) mesh, each
rank with its rows of the batch and its block of 2 of each clip's 4 frames,
the AdamW moments split over data x frame (ZeRO-1); against one process
running the whole batch, and, at 2 x 2, against the JAX package's
`make_train_step` on a 2 x 2 mesh of the virtual CPU devices with the batch
on P("data", "frame") and the optimizer state over ("data", "frame"), as
tools/aot_v5e8.py's frame-sharded training target lays it out.

The micro model zoo at 128x128, 4 frames, fp32, weights from the JAX
package's `fast_init_params`; the ranks build it with remat, so the
backward's recomputation runs the frame collectives again; update 0 at lr
0, update 1 at lr 1e-4; the draws are tests/test_torch_train_dp.py's (the
JAX step's own, from a key whose first two steps drop no clip: the dropout
mask depends on the key and the clip count only, not on the frames). The
runs compute the same math in another summation order, so the bounds are
that file's: loss and grad_norm rtol 1e-5, its rule for the masters and for
the moments.

On the 1 x 2 mesh the ranks also check each frame collective's backward
(`parallel/sequence.py`'s autograd Functions, group_norm's summed
statistics) against autograd of the unsharded function on one process. The
collectives move values and add them in pairs, so their gradients are
equal; group_norm's statistics are fp32 sums in another order, within 1e-6
of each element plus 1e-6 of the largest. A temporal transformer at 4x4
tokens takes the all-to-all branch of `_temporal_attention`, as every level
of the micro UNet at 128x128 does; at 1x1 tokens and one clip its rows do
not split, and it takes the gather_frames branch: its gradients (inputs,
context, and every parameter's summed over the ranks) are sums of the
frames' terms in another order, within 1e-5 of each tensor's largest
element (1.3e-6 measured).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stableanimator_tpu import parallel as jax_parallel
from stableanimator_tpu.core.config import PipelineConfig as JPipelineConfig
from stableanimator_tpu.core.config import TrainConfig as JTrainConfig
from stableanimator_tpu.core.config import micro_model_kwargs as jax_micro_kwargs
from stableanimator_tpu.pipeline import build_models as jax_build_models
from stableanimator_tpu.pipeline import fast_init_params
from stableanimator_tpu.train.train_step import create_train_state as jax_create_train_state
from stableanimator_tpu.train.train_step import make_train_step as jax_make_train_step
from stableanimator_tpu_torch.convert.from_jax import state_dicts_from_jax
from stableanimator_tpu_torch.train.train_step import VIDEO_KEYS
from tests.test_torch_train_dp import (
    B,
    DROPOUT,
    HW,
    LR,
    _jax_noises,
    _key_keeping_every_clip,
    _masters_close,
)
from tests.torch_mesh_worker import collect_ranks, micro_models, start_ranks, train_steps
from tests.torch_threads import share_cores

THREADS = share_cores()

F = 4
MESHES = {"1x2": 2, "2x2": 4}          # mesh -> world size
COLLECTIVES = ("halo_exchange", "frames_to_rows", "rows_to_frames", "gather_frames",
               "first_frame", "group_norm")
TRANSFORMERS = ("transformer_all_to_all", "transformer_gather")


def _jax_frame_steps(jm, params, batch, key, n_steps):
    """The JAX package's make_train_step on a 2 x 2 (data, frame) mesh,
    the clips' frames split over "frame", ZeRO-1 over both axes: (final
    trainable params, [(loss, grad_norm)] per step)."""
    mesh = jax_parallel.make_mesh(data=2, frame=2, devices=jax.devices()[:4])
    axes = ("data", "frame")
    cfg = dataclasses.replace(JTrainConfig(), learning_rate=LR, lr_warmup_steps=1)

    def pinned(state):
        # the same shardings before every call, so that the second call runs
        # the first one's program (test_torch_train_dp.py)
        return state._replace(
            step=jnp.asarray(int(state.step), jnp.int32),
            params=jax_parallel.shard_params(state.params, mesh),
            frozen=jax_parallel.shard_params(state.frozen, mesh),
            opt_state=jax_parallel.shard_optimizer_state(state.opt_state, mesh, axes))

    def placed(name, v):
        sharding = (jax_parallel.video_sharding if name in VIDEO_KEYS
                    else jax_parallel.batch_sharding)(mesh, v.ndim)
        return jax.device_put(jnp.asarray(v.numpy()), sharding)

    state, tx = jax_create_train_state(params, cfg)
    jbatch = {k: placed(k, v) for k, v in batch.items()}
    step = jax_make_train_step(jm, tx, cfg, JPipelineConfig(),
                               conditioning_dropout_prob=DROPOUT, donate=False, mesh=mesh)
    metrics = []
    for _ in range(n_steps):
        state, m = step(pinned(state), jbatch, key)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return state.params, metrics


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jm = jax_build_models(**jax_micro_kwargs(), dtype=None, use_flash=False)
    params = fast_init_params(jm, height=HW, width=HW)
    key = _key_keeping_every_clip(2)
    rng = np.random.default_rng(0)
    batch = {"frames": rng.uniform(-1, 1, (B, F, HW, HW, 3)),
             "ref_image": rng.uniform(0, 1, (B, HW, HW, 3)),
             "pose_pixels": rng.uniform(-1, 1, (B, F, HW, HW, 3)),
             "face_embed": rng.normal(size=(B, 32)),
             "face_mask": rng.integers(0, 2, (B, F, HW, HW, 1))}
    batch = {k: torch.from_numpy(v.astype(np.float32)) for k, v in batch.items()}
    inputs = {"state_dicts": state_dicts_from_jax(params),
              "batch": batch, "cfg": dict(mixed_precision="no", learning_rate=LR,
                                          lr_warmup_steps=1),
              "noises": [_jax_noises(jax.random.fold_in(key, s), F) for s in range(2)]}
    started = [start_ranks("frame_train", world, tmp_path_factory.mktemp(mesh), inputs)
               for mesh, world in MESHES.items()]
    try:                                    # the JAX steps while the ranks run
        jax_params, jax_metrics = _jax_frame_steps(jm, params, batch, key, 2)
    finally:
        ranks = dict(zip(MESHES, (collect_ranks(s) for s in started)))
    jax_masters = {f"{m}.{k}": v for m, sd in state_dicts_from_jax(jax_params).items()
                   for k, v in sd.items()}
    torch.set_num_threads(1)
    try:
        one, metrics = train_steps(micro_models(inputs["state_dicts"]), inputs, 2)
    finally:
        torch.set_num_threads(THREADS)
    want = copy.deepcopy(one.state_dict())
    want["exp_avg"] = {n: st["exp_avg"] for n, st in zip(
        one.names, (one.optimizer.state[p] for p in one.optimizer.param_groups[0]["params"]))}
    return inputs, ranks, metrics, want, (jax_masters, jax_metrics)


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_backward_matches_unsharded_autograd(runs, name):
    """Each rank's block of the gradient through the sharded function
    equals autograd through the unsharded one (group_norm's weight and bias
    gradients summed over the ranks)."""
    _, ranks, _, _, _ = runs
    pairs = [pair for r in ranks["1x2"] for pair in r["grads"][name]]
    assert max(want.abs().max().item() for _, want in pairs) > 0
    for got, want in pairs:      # (first_frame's is zero on the second rank)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * want.abs().max().item())


@pytest.mark.parametrize("name", TRANSFORMERS)
def test_temporal_transformer_backward_matches_unsharded_autograd(runs, name):
    _, ranks, _, _, _ = runs
    for r in ranks["1x2"]:
        assert len(r["grads"][name]) > 50               # inputs, context, parameters
        for got, want in r["grads"][name]:
            scale = want.abs().max().item()
            assert (got - want).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("mesh", MESHES)
def test_frame_steps_match_one_process(runs, mesh):
    """Loss and grad_norm of both steps, and the consolidated moments; each
    rank holds its share of the moments (odd shapes whole)."""
    _, ranks, metrics, want, _ = runs
    opt_want = want["optimizer"]["state"]
    total = sum(v.numel() for st in opt_want.values() for k, v in st.items()
                if k in ("exp_avg", "exp_avg_sq"))
    n = MESHES[mesh]
    assert all(r["held"] < 1.2 * total / n for r in ranks[mesh]), (
        [r["held"] for r in ranks[mesh]], total)
    for r in ranks[mesh]:
        np.testing.assert_allclose(r["metrics"], metrics, rtol=1e-5)
        got = r["state_dict"]
        assert (got["step"], got["updates"]) == (2, 2)
        opt_got = got["optimizer"]["state"]
        for key in ("exp_avg", "exp_avg_sq"):
            big = max(st[key].abs().max().item() for st in opt_want.values())
            for i, st in opt_want.items():
                tol = 1e-4 * st[key].abs().max().item() + 1e-6 * big
                assert (opt_got[i][key] - st[key]).abs().max().item() <= tol, (key, i)


@pytest.mark.parametrize("mesh", MESHES)
def test_frame_masters_after_two_updates(runs, mesh):
    """Update 1 (lr 1e-4) moved the masters alike on every rank and in the
    one process."""
    inputs, ranks, _, want, _ = runs
    for r in ranks[mesh]:
        _masters_close(r["state_dict"]["masters"], want["masters"], want["exp_avg"])
    first = {f"{k}.{n}": v for k, sd in inputs["state_dicts"].items() for n, v in sd.items()}
    moved = sum(int(((w - first[n]).abs() > 0.5 * LR).sum()) for n, w in want["masters"].items())
    assert moved > 1000


def test_2x2_frame_steps_match_the_jax_package(runs):
    """Loss and grad_norm of both steps, and the masters after update 1,
    against JAX's make_train_step on a 2 x 2 mesh with the frames split."""
    _, ranks, _, want, (jax_masters, jax_metrics) = runs
    for r in ranks["2x2"]:
        np.testing.assert_allclose(r["metrics"], jax_metrics, rtol=1e-5)
        got = r["state_dict"]["masters"]
        assert set(got) <= set(jax_masters) and len(got) > 900
        _masters_close(got, {n: jax_masters[n] for n in got}, want["exp_avg"])
