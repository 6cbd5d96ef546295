"""Data-parallel training with ZeRO-1 in the port, on the CPU: two gloo
processes (tests/torch_mesh_worker.py, one thread each) each run one row of
a 2-row batch through `make_train_step(mesh=)` with the AdamW moments
sharded over them, against one process running the 2-row batch, and
against the JAX package's `make_train_step` on a 2-device data mesh with
its optimizer state sharded (`shard_optimizer_state`), on the same batch
and draws; the consolidated checkpoint resumed in a world of 1; and the
training CLI under torchrun with 2 ranks.

The micro model zoo at 128x128, 2 frames, fp32, weights from the JAX
package's `fast_init_params`; update 0 at lr 0, update 1 at lr 1e-4. The
port is handed the draws the JAX step takes from its key (step s:
fold_in(key, s), split 5 ways; test_torch_train.py's scheme), from a key
whose first two steps drop no clip (the JAX package's gradients are NaN
for a dropped clip; test_torch_train.py's docstring). The runs compute the
same math in another summation order (the batch's gradient as the mean of
two 1-row gradients; XLA's against torch's), so the bounds are
test_torch_train.py's:
loss and grad_norm rtol 1e-5; masters 1e-6 where the last gradient is above
1e-4 of its largest element (AdamW moves the others by lr times a ratio of
two tiny numbers), 2 lr elsewhere; the moments (sums of gradients and of
their squares) as that file's gradients: within 1e-4 of each tensor's
largest element plus 1e-6 of the largest of all (a gradient that is zero in
exact arithmetic, such as a conv bias before a GroupNorm, is fp32 rounding
of the large terms).
"""

import copy
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stableanimator_tpu import parallel as jax_parallel
from stableanimator_tpu.core.config import PipelineConfig as JPipelineConfig
from stableanimator_tpu.core.config import TrainConfig as JTrainConfig
from stableanimator_tpu.core.config import micro_model_kwargs as jax_micro_kwargs
from stableanimator_tpu.diffusion.scheduler import sample_sigmas_lognormal as jax_sigmas
from stableanimator_tpu.pipeline import build_models as jax_build_models
from stableanimator_tpu.pipeline import fast_init_params
from stableanimator_tpu.train.train_step import create_train_state as jax_create_train_state
from stableanimator_tpu.train.train_step import make_train_step as jax_make_train_step
from stableanimator_tpu_torch.convert.from_jax import state_dicts_from_jax
from stableanimator_tpu_torch.core.checkpoint import CheckpointManager
from tests.torch_mesh_worker import REPO, collect_ranks, micro_models, start_ranks, train_steps
from tests.torch_threads import share_cores

THREADS = share_cores()

B, F, HW, LR, DROPOUT = 2, 2, 128, 1e-4, 0.1


def _jax_noises(key, f: int = F) -> dict:
    """The five draws of the JAX train_loss for the step key `key`, for B
    clips of f frames."""
    k = jax.random.split(key, 5)
    h8 = HW // 8
    draws = {"eps0": jax.random.normal(k[0], (B * f, h8, h8, 4), jnp.float32),
             "ref_aug": jax.random.normal(k[1], (B, HW, HW, 3), jnp.float32),
             "keep": jax.random.bernoulli(k[2], 1.0 - DROPOUT, (B,)).astype(jnp.float32),
             "sigmas": jax_sigmas(k[3], (B,)),
             "noise": jax.random.normal(k[4], (B, f, h8, h8, 4), jnp.float32)}
    return {n: torch.from_numpy(np.array(v, np.float32)) for n, v in draws.items()}


def _key_keeping_every_clip(n_steps: int):
    for i in range(1000):
        key = jax.random.PRNGKey(i)
        if all(_jax_noises(jax.random.fold_in(key, s))["keep"].tolist() == [1.0] * B
               for s in range(n_steps)):
            return key
    raise AssertionError("no key keeps every clip")


def _jax_data_parallel_steps(jm, params, batch, key, n_steps):
    """The JAX package's make_train_step on a 2-device data mesh, ZeRO-1 as
    its training CLI shards it: (final trainable params, [(loss,
    grad_norm)] per step)."""
    mesh = jax_parallel.make_mesh(data=2, frame=1, devices=jax.devices()[:2])
    cfg = dataclasses.replace(JTrainConfig(), learning_rate=LR, lr_warmup_steps=1)

    def pinned(state):
        # the shardings of cli/train.py (its resume path: an uncommitted step
        # scalar), before every call, so that the second call runs the first
        # one's program instead of compiling another for its outputs' layouts
        return state._replace(
            step=jnp.asarray(int(state.step), jnp.int32),
            params=jax_parallel.shard_params(state.params, mesh),
            frozen=jax_parallel.shard_params(state.frozen, mesh),
            opt_state=jax_parallel.shard_optimizer_state(state.opt_state, mesh))

    state, tx = jax_create_train_state(params, cfg)
    jbatch = {k: jax.device_put(jnp.asarray(v.numpy()), jax_parallel.batch_sharding(mesh, v.ndim))
              for k, v in batch.items()}
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
              "noises": [_jax_noises(jax.random.fold_in(key, s)) for s in range(3)]}
    started = start_ranks("dp_step", 2, tmp_path_factory.mktemp("dp"), inputs)
    try:                                    # the JAX steps while the ranks run
        jax_params, jax_metrics = _jax_data_parallel_steps(jm, params, batch, key, 2)
    finally:
        ranks = collect_ranks(started)
    jax_masters = {f"{m}.{k}": v for m, sd in state_dicts_from_jax(jax_params).items()
                   for k, v in sd.items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one, metrics = train_steps(micro_models(inputs["state_dicts"]), inputs, 2)
        want = copy.deepcopy(one.state_dict())
        want["exp_avg"] = {n: st["exp_avg"] for n, st in zip(
            one.names, (one.optimizer.state[p] for p in one.optimizer.param_groups[0]["params"]))}
        # step 3 in a world of 1, from the one-process checkpoint and from the
        # 2-rank run's consolidated one
        # (copies: the optimizer takes over a loaded dict's tensors)
        third = [train_steps(micro_models(inputs["state_dicts"]), inputs, 1,
                             state_dict=copy.deepcopy(sd))
                 for sd in (want, ranks[0]["state_dict"])]
    finally:
        torch.set_num_threads(threads)
    return inputs, ranks, metrics, want, third, (jax_masters, jax_metrics)


def _masters_close(got: dict, want: dict, grads: dict):
    g_max = max(g.abs().max().item() for g in grads.values())
    for name, w in want.items():
        atol = torch.where(grads[name].abs() > 1e-4 * g_max, 1e-6, 2 * LR)
        assert torch.all((got[name] - w).abs() <= atol), name


def test_two_rank_zero1_step_matches_one_process(runs):
    """Loss and grad_norm of both steps, and the consolidated moments."""
    _, ranks, metrics, want, _, _ = runs
    opt_want = want["optimizer"]["state"]
    total = sum(v.numel() for st in opt_want.values() for k, v in st.items()
                if k in ("exp_avg", "exp_avg_sq"))
    # ZeRO-1: each rank holds about half of the moments (odd shapes whole)
    assert all(r["held"] < 0.6 * total for r in ranks), ([r["held"] for r in ranks], total)
    for r in ranks:
        np.testing.assert_allclose(r["metrics"], metrics, rtol=1e-5)
        got = r["state_dict"]
        assert (got["step"], got["updates"]) == (2, 2)
        opt_got = got["optimizer"]["state"]
        for key in ("exp_avg", "exp_avg_sq"):
            big = max(st[key].abs().max().item() for st in opt_want.values())
            for i, st in opt_want.items():
                tol = 1e-4 * st[key].abs().max().item() + 1e-6 * big
                assert (opt_got[i][key] - st[key]).abs().max().item() <= tol, (key, i)


def test_two_rank_masters_after_two_updates(runs):
    """Update 1 (lr 1e-4) moved the masters, alike on both runs."""
    inputs, ranks, _, want, _, _ = runs
    for r in ranks:
        _masters_close(r["state_dict"]["masters"], want["masters"], want["exp_avg"])
    first = {f"{k}.{n}": v for k, sd in inputs["state_dicts"].items() for n, v in sd.items()}
    moved = sum(int(((w - first[n]).abs() > 0.5 * LR).sum()) for n, w in want["masters"].items())
    assert moved > 1000


def test_two_rank_zero1_steps_match_the_jax_package_on_a_data_mesh(runs):
    """Loss and grad_norm of both steps, and the masters after update 1,
    against JAX's make_train_step on a 2-device data mesh with ZeRO-1."""
    _, ranks, _, want, _, (jax_masters, jax_metrics) = runs
    for r in ranks:
        np.testing.assert_allclose(r["metrics"], jax_metrics, rtol=1e-5)
        got = r["state_dict"]["masters"]
        assert set(got) <= set(jax_masters) and len(got) > 900
        _masters_close(got, {n: jax_masters[n] for n in got}, want["exp_avg"])


def test_consolidated_checkpoint_resumes_in_a_world_of_one(runs):
    """Step 3 from the 2-rank checkpoint equals step 3 from the one-process
    one."""
    _, _, _, _, third, _ = runs
    (want, want_metrics), (got, got_metrics) = third
    np.testing.assert_allclose(got_metrics, want_metrics, rtol=1e-5)
    assert (got.step, got.updates) == (3, 3)
    exp_avg = {n: want.optimizer.state[p]["exp_avg"]
               for n, p in zip(want.names, want.optimizer.param_groups[0]["params"])}
    _masters_close(dict(zip(got.names, got.masters)), dict(zip(want.names, want.masters)),
                   exp_avg)


def test_train_cli_under_two_gloo_ranks(tmp_path):
    """torchrun --nproc_per_node 2: 2 steps, then a resume to step 3."""
    from tests.test_torch_train import _write_clips

    data = tmp_path / "data"
    data.mkdir()
    rec = tmp_path / "rec.txt"
    rec.write_text("\n".join(_write_clips(data, hw=64)))
    out = tmp_path / "out"
    common = [sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc_per_node", "2", "-m", "stableanimator_tpu_torch.cli.train",
              "--checkpoint_dir", str(tmp_path / "nockpt"), "--output_dir", str(out),
              "--data_root_path", str(data), "--rec_data_path", str(rec),
              "--dataset_width", "64", "--dataset_height", "64", "--sample_n_frames", "2",
              "--allow_random_init", "--model_scale", "micro", "--mixed_precision", "no",
              "--checkpointing_steps", "2", "--num_workers", "2", "--device", "cpu"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    logs = []
    for extra in (["--max_train_steps", "2"],
                  ["--max_train_steps", "3", "--resume_from_checkpoint", "latest"]):
        proc = subprocess.run(common + extra, cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        logs.append(proc.stdout)
    assert logs[0].count("mesh: 2 devices, global batch 2") == 1      # rank 0 alone prints
    assert "resumed from step 2" in logs[1]
    assert sorted(int(d) for d in os.listdir(out) if d.isdigit()) == [2, 3]
    restored = CheckpointManager(str(out)).restore()
    assert (restored["step"], restored["updates"]) == (3, 3)
    assert (out / "metrics.jsonl").read_text().count("\n") == 2
