"""The training slice: the port's `train_loss`, its gradients, two optimizer
steps (with and without gradient accumulation), the data loader, the
checkpoints and the training CLI, against the JAX package on the micro
model zoo (`micro_model_kwargs`), 128x128, 2 clips of 2 frames, fp32 on the
CPU, weights from `fast_init_params`.

Why 128x128: at 64x64 the UNet's deepest level is 1x1, its GroupNorms
normalise groups of one or two values, and the gradient becomes
ill-conditioned: two fp32 evaluations of the same port graph (1 and 8
threads) differ by ~5e-3 of the gradient's norm. At 128x128 they differ by
~2e-6 (`test_gradient_conditioning_sets_the_parity_size` prints both), so
the tolerances below can be those of summation order.

jax.random cannot be reproduced in torch, so the port is handed the five
draws the JAX loss takes from `jax.random.split(rng, 5)`. The JAX side's
model graph (value_and_grad of its `train_loss`) is jitted once; its steps
are `make_train_step`'s body, written out with that jit: the step's key is
fold_in(rng, step), then the JAX package's own optax chain
(`make_optimizer`: clip_by_global_norm + adamw, MultiSteps for
accumulation) updates the parameters.

Tolerances (fp32, the same math in another summation order):
  loss: rtol 1e-5.
  gradients: each leaf within 1e-4 of its largest element, plus 1e-6 of
    the largest gradient element of all leaves: a gradient that is zero in
    exact arithmetic (the bias of a conv that feeds a GroupNorm, which
    subtracts it again) is fp32 rounding of the large terms, ~1e-8 of the
    largest element.
  parameters after the steps: AdamW moves each element by up to lr
    (1e-4) per update, by ~lr * g / |g|; elements whose gradient is near 0
    move by an amount set by the ratio of two tiny numbers, so the bound is
    1e-6 absolute, 1 % of one update, on the elements whose gradient is
    above 1e-4 of the largest gradient element, and 2 lr elsewhere.
  grad_norm: rtol 1e-5.

A clip dropped by conditioning dropout zeroes both streams of the ID
cross-attention; the JAX package's renormalisation then takes sqrt(0) and
its gradients turn NaN (most of the micro zoo's 970 leaves). The port keeps
the forward and gives sqrt a zero gradient at 0, so the comparisons that
need finite JAX gradients use keys that drop no clip, and the dropped-clip
case compares the loss and the leaves JAX keeps finite.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.flatten_util import ravel_pytree

from stableanimator_tpu.convert import torch_to_jax as t2j
from stableanimator_tpu.core.config import PipelineConfig as JPipelineConfig
from stableanimator_tpu.core.config import TrainConfig as JTrainConfig
from stableanimator_tpu.core.config import micro_model_kwargs as jax_micro_kwargs
from stableanimator_tpu.diffusion.scheduler import edm_loss_weight as jax_edm_weight
from stableanimator_tpu.diffusion.scheduler import sample_sigmas_lognormal as jax_sigmas
from stableanimator_tpu.diffusion.scheduler import timestep_of_sigma as jax_timestep
from stableanimator_tpu.pipeline import build_models as jax_build_models
from stableanimator_tpu.pipeline import fast_init_params
from stableanimator_tpu.train import data as jax_data
from stableanimator_tpu.train import train_loss as jax_train_loss
from stableanimator_tpu.train.train_step import make_optimizer as jax_make_optimizer
from stableanimator_tpu_torch.convert.checkpoints import (
    CHECKPOINT_FILES,
    init_id_adapter_from_svd,
    load_state_dicts,
)
from stableanimator_tpu_torch.convert.from_jax import state_dicts_from_jax
from stableanimator_tpu_torch.core.checkpoint import CheckpointManager
from stableanimator_tpu_torch.core.config import PipelineConfig, TrainConfig, micro_model_kwargs
from stableanimator_tpu_torch.diffusion.scheduler import (
    edm_loss_weight,
    sample_sigmas_lognormal,
    timestep_of_sigma,
)
from stableanimator_tpu_torch.pipeline.animation import build_models
from stableanimator_tpu_torch.train import data as port_data
from stableanimator_tpu_torch.train.train_step import (
    create_train_state,
    draw_noises,
    make_train_step,
    train_loss,
)
from tests.torch_threads import share_cores

THREADS = share_cores()

TRAINABLE = ("unet", "pose_net", "face_encoder")
CONVERT = {"unet": t2j.convert_unet, "pose_net": t2j.convert_pose_net,
           "face_encoder": t2j.convert_face_encoder}
DROPOUT = 0.5
LR = 1e-4
B, F, HW = 2, 2, 128
DATA_HW = 64            # the data loader's and the CLI's clips


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"frames": rng.uniform(-1, 1, (B, F, HW, HW, 3)),
            "ref_image": rng.uniform(0, 1, (B, HW, HW, 3)),
            "pose_pixels": rng.uniform(-1, 1, (B, F, HW, HW, 3)),
            "face_embed": rng.normal(size=(B, 32)),
            "face_mask": rng.integers(0, 2, (B, F, HW, HW, 1))}


def _jax_noises(rng):
    """The five draws of the JAX train_loss for key `rng`, as numpy."""
    k = jax.random.split(rng, 5)
    h8 = HW // 8
    return {"eps0": jax.random.normal(k[0], (B * F, h8, h8, 4), jnp.float32),
            "ref_aug": jax.random.normal(k[1], (B, HW, HW, 3), jnp.float32),
            "keep": jax.random.bernoulli(k[2], 1.0 - DROPOUT, (B,)).astype(jnp.float32),
            "sigmas": jax_sigmas(k[3], (B,)),
            "noise": jax.random.normal(k[4], (B, F, h8, h8, 4), jnp.float32)}


def _key_where(keeps, n_keys=1):
    """The first PRNGKey(i) whose n_keys step keys fold_in(key, step) draw the
    given keep masks (in order; a single mask applies to every step)."""
    for i in range(1000):
        key = jax.random.PRNGKey(i)
        steps = [jax.random.fold_in(key, s) for s in range(n_keys)] if n_keys > 1 else [key]
        if all(np.asarray(_jax_noises(k)["keep"]).tolist() == keeps for k in steps):
            return key
    raise AssertionError(f"no key draws {keeps}")


def _torch(tree):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in tree.items()}


@pytest.fixture(scope="module")
def zoo():
    jm = jax_build_models(**jax_micro_kwargs(), dtype=None, use_flash=False)
    params = fast_init_params(jm, height=HW, width=HW)
    jcfg = JTrainConfig()
    jpipe = JPipelineConfig()
    frozen = {k: params[k] for k in params if k not in TRAINABLE}
    batch = {k: jnp.asarray(v, jnp.float32) for k, v in _batch().items()}

    def loss(trainable, frozen, batch, rng):
        return jax_train_loss(jm, trainable, frozen, batch, rng, jcfg, jpipe,
                              conditioning_dropout_prob=DROPOUT)

    # the frozen weights and the batch are arguments, not closed-over
    # constants, which XLA would fold through the frozen VAE at compile time
    vg = jax.jit(jax.value_and_grad(loss))
    return params, lambda trainable, rng: vg(trainable, frozen, batch, rng)


def _port(params, remat=False):
    pm = build_models(**micro_model_kwargs(), dtype=torch.float32, device="cpu", seed=None,
                      remat=remat)
    for name, sd in state_dicts_from_jax(params).items():
        getattr(pm, name).load_state_dict(sd, strict=True)
    return pm


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _as_jax(sds):
    """The port's state dicts (model -> key -> tensor) as JAX param trees."""
    return {m: CONVERT[m]({k: v.detach().numpy() for k, v in sd.items()})["params"]
            for m, sd in sds.items()}


@pytest.mark.parametrize("keep", [[1.0, 1.0], [1.0, 0.0]])
def test_train_loss_and_every_gradient_match_jax(zoo, keep):
    params, vg = zoo
    key = _key_where(keep)
    want_loss, want_grads = vg({k: params[k] for k in TRAINABLE}, key)

    pm = _port(params, remat=True)           # remat: the function is the same
    for name in TRAINABLE:
        getattr(pm, name).requires_grad_(True)
    loss = train_loss(pm, _torch(_batch()), TrainConfig(), PipelineConfig(),
                      conditioning_dropout_prob=DROPOUT, noises=_torch(_jax_noises(key)))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    loss.backward()
    # parameters the loss does not reach (single-key attention shortcuts)
    # have no .grad in torch and a zero gradient in JAX
    got = _as_jax({m: {k: p.grad if p.grad is not None else torch.zeros_like(p)
                       for k, p in getattr(pm, m).named_parameters()} for m in TRAINABLE})
    compared = nan_leaves = 0
    floor = 1e-6 * max(np.abs(w[np.isfinite(w)]).max(initial=0.0)
                       for m in TRAINABLE for _, w in _flat(want_grads[m]))
    for m in TRAINABLE:
        want = dict(_flat(want_grads[m]))
        have = dict(_flat(got[m]))
        assert set(have) == set(want), m
        for path, w in want.items():
            assert np.isfinite(have[path]).all(), (m, path)
            if not np.isfinite(w).all():     # the JAX package's sqrt(0) (docstring)
                nan_leaves += 1
                continue
            np.testing.assert_allclose(have[path], w, rtol=0,
                                       atol=1e-4 * np.abs(w).max() + floor,
                                       err_msg=f"{m} {path}")
            compared += 1
    if keep == [1.0, 1.0]:
        assert nan_leaves == 0 and compared > 900
    else:
        assert compared > 50


def _jax_steps(zoo, cfg, rng, n_steps):
    """make_train_step's body with the shared value_and_grad jit."""
    params, vg = zoo
    tx = jax_make_optimizer(cfg)
    trainable = {k: params[k] for k in TRAINABLE}
    # the chain runs on the parameters raveled into one vector: the same
    # elementwise math and the same global norm, without ~1000 leaves' worth
    # of eager dispatches or a jit that compiles for a minute
    flat, unravel = ravel_pytree(trainable)
    opt_state = tx.init(flat)
    norms, all_grads = [], []
    for step in range(n_steps):
        _, grads = vg(unravel(flat), jax.random.fold_in(rng, step))
        norms.append(float(optax.global_norm(grads)))
        all_grads.append(grads)
        updates, opt_state = tx.update(ravel_pytree(grads)[0], opt_state, flat)
        flat = optax.apply_updates(flat, updates)
    return unravel(flat), norms, all_grads


def _port_steps(params, cfg, rng, n_steps):
    pm = _port(params)
    state = create_train_state(pm, cfg)
    step_fn = make_train_step(pm, cfg, PipelineConfig(), conditioning_dropout_prob=DROPOUT)
    batch = _torch(_batch())
    norms = []
    for step in range(n_steps):
        noises = _torch(_jax_noises(jax.random.fold_in(rng, step)))
        state, metrics = step_fn(state, batch, noises=noises)
        norms.append(metrics["grad_norm"].item())
    assert state.step == n_steps
    return state, pm, norms


@pytest.mark.parametrize("accumulate,warmup,n_steps", [(1, 1, 2), (2, 0, 2)])
def test_parameters_after_two_steps_match_optax(zoo, accumulate, warmup, n_steps):
    # no accumulation: update 0 at lr 0, update 1 at lr; accumulation 2: one
    # update at lr (no warm-up) from the mean of the two calls' gradients
    params, vg = zoo
    kw = dict(learning_rate=LR, lr_warmup_steps=warmup, gradient_accumulation_steps=accumulate)
    rng = _key_where([1.0, 1.0], n_keys=n_steps)
    want, want_norms, grads = _jax_steps(zoo, dataclasses.replace(JTrainConfig(), **kw), rng,
                                         n_steps)
    state, pm, norms = _port_steps(params, TrainConfig(mixed_precision="no", **kw), rng, n_steps)
    np.testing.assert_allclose(norms, want_norms, rtol=1e-5)
    assert state.updates == n_steps // accumulate
    # the gradient of the last update (the mean over its accumulation window;
    # update 0 of the warm-up has lr 0) decides which elements moved by a
    # well-defined amount
    used = jax.tree_util.tree_map(lambda *g: sum(g) / accumulate, *grads[-accumulate:])
    g_max = max(np.abs(g).max() for m in TRAINABLE for _, g in _flat(used[m]))
    got = _as_jax(state.master_state_dicts())
    moved = 0
    for m in TRAINABLE:
        have, g_used, before = dict(_flat(got[m])), dict(_flat(used[m])), dict(_flat(params[m]))
        for path, w in _flat(want[m]):
            atol = np.where(np.abs(g_used[path]) > 1e-4 * g_max, 1e-6, 2 * LR)
            assert np.all(np.abs(have[path] - w) <= atol), (m, path)
            moved += int(np.sum(np.abs(w - before[path]) > 0.5 * LR))
    assert moved > 1000                     # the step really moved the parameters
    # the models hold the masters (fp32 run: the same values)
    for m in TRAINABLE:
        for k, p in getattr(pm, m).named_parameters():
            torch.testing.assert_close(p.detach(), state.master_state_dicts()[m][k],
                                       rtol=0, atol=0)


def _write_clips(root, n_clips=2, n_frames=6, hw=DATA_HW):
    from PIL import Image

    rng = np.random.default_rng(0)
    paths = []
    for c in range(n_clips):
        d = root / f"clip{c}"
        for sub in ("images", "poses", "faces"):
            (d / sub).mkdir(parents=True)
        for i in range(n_frames):
            Image.fromarray(rng.integers(0, 255, (hw, hw, 3), dtype=np.uint8)).save(
                d / "images" / f"{i:05d}.png")
            pose = np.zeros((hw, hw, 3), np.uint8)
            pose[10 + i:30 + i, 20:40] = 255
            Image.fromarray(pose).save(d / "poses" / f"{i:05d}.png")
            mask = np.zeros((hw, hw), np.uint8)
            mask[8:24, 24:40] = 255
            Image.fromarray(mask).save(d / "faces" / f"{i:05d}.png")
        np.save(d / "face_embed.npy", rng.normal(size=512).astype(np.float32))
        paths.append(str(d))
    return paths


def _thread_spread(params, hw):
    """‖g1 − g8‖ / ‖g8‖: the port's fp32 gradient with 1 and with 8 CPU
    threads (two summation orders of the same math), batch B at hw x hw."""
    rng = np.random.default_rng(3)
    batch = {"frames": rng.uniform(-1, 1, (B, F, hw, hw, 3)),
             "ref_image": rng.uniform(0, 1, (B, hw, hw, 3)),
             "pose_pixels": rng.uniform(-1, 1, (B, F, hw, hw, 3)),
             "face_embed": rng.normal(size=(B, 32)),
             "face_mask": rng.integers(0, 2, (B, F, hw, hw, 1))}
    batch = _torch(batch)
    noises = draw_noises(batch, 4, 0.0, None, torch.Generator().manual_seed(0))
    grads, threads = [], torch.get_num_threads()
    try:
        for n in (1, 8):
            torch.set_num_threads(n)
            pm = _port(params)
            for m in TRAINABLE:
                getattr(pm, m).requires_grad_(True)
            train_loss(pm, batch, TrainConfig(), PipelineConfig(), conditioning_dropout_prob=0.0,
                       noises=noises).backward()
            grads.append(torch.cat([p.grad.flatten() for m in TRAINABLE
                                    for p in getattr(pm, m).parameters() if p.grad is not None]))
    finally:
        torch.set_num_threads(threads)
    return ((grads[0] - grads[1]).norm() / grads[1].norm()).item()


def test_gradient_conditioning_sets_the_parity_size(zoo):
    # why the parity tests run at 128x128: there two summation orders agree
    # to summation-order precision; at 64x64 (the micro UNet's deepest level
    # 1x1) they do not, so no tight gradient tolerance would hold
    params, _ = zoo
    spread = {hw: _thread_spread(params, hw) for hw in (64, 128)}
    print(f"gradient spread between 1 and 8 threads: {spread}")
    assert spread[128] < 1e-5
    assert spread[64] > 10 * spread[128]


def test_data_loader_gives_the_jax_packages_arrays(tmp_path):
    paths = _write_clips(tmp_path)
    # the images are resized on load: 64 -> 48 exercises PIL's resampling too
    want = jax_data.MixedResolutionSampler(
        jax_data.AnimationDataset(paths, 3, 48, 40, seed=5), None, seed=5)
    got = port_data.MixedResolutionSampler(
        port_data.AnimationDataset(paths, 3, 48, 40, seed=5), None, seed=5)
    for _ in range(3):
        a, b = want.batch(2), got.batch(2)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    listing = tmp_path / "list.txt"
    listing.write_text("\n".join(paths) + "\n\n")
    assert port_data.read_path_list(str(listing)) == jax_data.read_path_list(str(listing))


def test_checkpoint_save_latest_restore_and_retention(tmp_path, zoo):
    params, _ = zoo
    cfg = TrainConfig(mixed_precision="no", learning_rate=LR, lr_warmup_steps=0)
    pm = _port(params)
    state = create_train_state(pm, cfg, trainable_keys=("pose_net", "face_encoder"))
    step_fn = make_train_step(pm, cfg, PipelineConfig(), conditioning_dropout_prob=0.0)
    state, _ = step_fn(state, _torch(_batch()), generator=torch.Generator().manual_seed(0))
    mgr = CheckpointManager(str(tmp_path / "ckpt"), total_limit=2)
    for step in (1, 2000, 4000):
        mgr.save(step, state.state_dict())
    assert mgr.all_steps() == [2000, 4000] and mgr.latest_step() == 4000
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2000", "4000"]

    fresh = create_train_state(_port(params), cfg, trainable_keys=("pose_net", "face_encoder"))
    fresh.load_state_dict(mgr.restore())
    assert (fresh.step, fresh.updates) == (state.step, state.updates) == (1, 1)
    for a, b in zip(fresh.masters, state.masters):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(fresh.params, state.params):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=0, atol=0)
    moments = [fresh.optimizer.state[m]["exp_avg_sq"] for m in fresh.masters]
    for a, m in zip(moments, state.masters):
        torch.testing.assert_close(a, state.optimizer.state[m]["exp_avg_sq"], rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


def test_sigmas_and_id_adapter_init():
    z = torch.tensor([-1.0, 0.0, 2.0])
    want = np.exp(0.7 + 1.6 * z.numpy())
    np.testing.assert_allclose(sample_sigmas_lognormal((3,), z=z).numpy(), want, rtol=1e-6)
    sd = {"down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight": torch.ones(2, 2),
          "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_v.weight": torch.zeros(2, 2),
          "down_blocks.0.attentions.0.temporal_transformer_blocks.0.attn2.to_k.weight":
              torch.ones(2, 2)}
    out = init_id_adapter_from_svd(sd)
    prefix = "down_blocks.0.attentions.0.transformer_blocks.0.attn2.processor."
    assert set(out) - set(sd) == {prefix + "id_to_k.weight", prefix + "id_to_v.weight"}
    torch.testing.assert_close(out[prefix + "id_to_k.weight"], torch.ones(2, 2))
    sigmas = np.array([0.01, 0.7, 5.0, 80.0], np.float32)
    np.testing.assert_allclose(edm_loss_weight(torch.from_numpy(sigmas)).numpy(),
                               np.asarray(jax_edm_weight(jnp.asarray(sigmas))), rtol=1e-6)
    np.testing.assert_allclose(timestep_of_sigma(torch.from_numpy(sigmas)).numpy(),
                               np.asarray(jax_timestep(jnp.asarray(sigmas))), rtol=1e-6)


def test_load_state_dicts_reads_reference_npz(tmp_path, zoo):
    # the checkpoint directory's .npz files (reference key space) load into
    # fresh modules key for key; a vanilla SVD UNet gets its ID adapter from
    # the cross-attention projections
    params, _ = zoo
    src = _port(params)
    for name, fname in CHECKPOINT_FILES.items():
        sd = {k: v.numpy() for k, v in getattr(src, name).state_dict().items()}
        if name == "unet":
            sd = {k: v for k, v in sd.items() if ".processor.id_to_" not in k}
        np.savez(tmp_path / fname, **sd)
    dst = build_models(**micro_model_kwargs(), dtype=torch.float32, device="cpu", seed=None)
    assert load_state_dicts(str(tmp_path), dst, allow_random_init=False,
                            init_id_adapter=True) == list(CHECKPOINT_FILES)
    for name in CHECKPOINT_FILES:
        want = getattr(src, name).state_dict()
        for k, v in getattr(dst, name).state_dict().items():
            if ".processor.id_to_" in k:
                v_src = want[k.replace("processor.id_to_", "to_")]
            else:
                v_src = want[k]
            torch.testing.assert_close(v, v_src, rtol=0, atol=0, msg=f"{name} {k}")
    os.remove(tmp_path / "pose_net.npz")
    with pytest.raises(FileNotFoundError):
        load_state_dicts(str(tmp_path), dst, allow_random_init=False, init_id_adapter=True)


def test_train_cli_two_steps_then_resume(tmp_path):
    from PIL import Image

    from stableanimator_tpu_torch.cli import train as cli

    data = tmp_path / "data"
    data.mkdir()
    rec = tmp_path / "rec.txt"
    rec.write_text("\n".join(_write_clips(data)))
    poses = tmp_path / "val_poses"
    poses.mkdir()
    for i in range(6):
        Image.fromarray(np.full((DATA_HW, DATA_HW, 3), 40 * i, np.uint8)).save(poses / f"{i:03d}.png")
    Image.fromarray(np.full((DATA_HW, DATA_HW, 3), 128, np.uint8)).save(tmp_path / "ref.png")
    out = tmp_path / "out"
    common = ["--checkpoint_dir", str(tmp_path / "nockpt"), "--output_dir", str(out),
              "--data_root_path", str(data), "--rec_data_path", str(rec),
              "--dataset_width", str(DATA_HW), "--dataset_height", str(DATA_HW),
              "--sample_n_frames", "2", "--allow_random_init", "--model_scale", "micro",
              "--mixed_precision", "no", "--learning_rate", "1e-4", "--lr_warmup_steps", "1",
              "--checkpointing_steps", "2", "--validation_steps", "2",
              "--validation_image", str(tmp_path / "ref.png"),
              "--validation_control_folder", str(poses), "--gradient_checkpointing",
              "--num_workers", "2", "--device", "cpu"]
    cli.main(common + ["--max_train_steps", "2"])
    assert sorted(int(d) for d in os.listdir(out) if d.isdigit()) == [2]
    assert (out / "metrics.jsonl").read_text().count("\n") == 1
    assert (out / "validation_step_2.gif").exists()
    cli.main(common + ["--max_train_steps", "3", "--resume_from_checkpoint", "latest"])
    assert sorted(int(d) for d in os.listdir(out) if d.isdigit()) == [2, 3]
    restored = CheckpointManager(str(out)).restore()
    assert (restored["step"], restored["updates"]) == (3, 3)
