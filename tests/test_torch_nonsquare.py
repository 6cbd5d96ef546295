"""The port at non-square frame sizes against the JAX package: the
reference's 576x1024 request is landscape (latent 72x128) and its vertical
training bucket portrait (height 1024, width 576: latent 128x72), so a swap
of height and width anywhere on those paths (token reshapes, PoseNet, the
tile blend, the decode, the face mask) must show here. Micro model zoo
(`micro_model_kwargs`), fp32 on the CPU, weights from `fast_init_params`;
the same inputs, made with numpy from a seed, go through both packages.

Tolerances are those of the square tests of the same functions:
  UNet: 1e-3 (tests/test_torch_unet.py: the same fp32 math in another
    summation order through ~50 layers).
  VAE decode: 2e-4 (tests/test_torch_models.py).
  generate: 2e-3 per pixel and 3e-4 on the mean (tests/test_torch_pipeline.py:
    Euler steps amplify summation-order differences by the init sigma).
  training: loss and grad_norm rtol 1e-5; each gradient leaf within 1e-4 of
    its largest element plus 1e-6 of the largest gradient element
    (tests/test_torch_train.py, which also says why the short side is 128:
    at 64 the micro UNet's deepest level is 1x1 and the fp32 gradient
    ill-conditioned).

The last test holds chip_smoke.py's reckonings of the 576x1024 and
450-frame paths (launches, tiles, decode groups) against the port's own
planning functions, so that the card's assertions test the kernels and not
a miscount.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from stableanimator_tpu.convert import torch_to_jax as t2j
from stableanimator_tpu.core.config import PipelineConfig as JPipelineConfig
from stableanimator_tpu.core.config import TrainConfig as JTrainConfig
from stableanimator_tpu.core.config import micro_model_kwargs as jax_micro_kwargs
from stableanimator_tpu.pipeline import build_models as jax_build_models
from stableanimator_tpu.pipeline import fast_init_params
from stableanimator_tpu.pipeline import generate as jax_generate
from stableanimator_tpu.train import train_loss as jax_train_loss
from stableanimator_tpu_torch.convert.from_jax import state_dicts_from_jax
from stableanimator_tpu_torch.core.config import (
    PipelineConfig,
    TrainConfig,
    UNetConfig,
    micro_model_kwargs,
)
from stableanimator_tpu_torch.pipeline.animation import build_models, generate
from stableanimator_tpu_torch.train.train_step import (
    create_train_state,
    make_train_step,
    train_loss,
)
from tests.torch_threads import share_cores

THREADS = share_cores()

TRAINABLE = ("unet", "pose_net", "face_encoder")
CONVERT = {"unet": t2j.convert_unet, "pose_net": t2j.convert_pose_net,
           "face_encoder": t2j.convert_face_encoder}
LR = 1e-4
# the portrait training clip: height twice the width, as the vertical bucket
B, F, H, W = 1, 2, 256, 128


@pytest.fixture(scope="module")
def micro():
    jm = jax_build_models(**jax_micro_kwargs(), dtype=None, use_flash=False)
    params = fast_init_params(jm, height=64, width=64)
    return jm, params


def _port(params, remat=False):
    pm = build_models(**micro_model_kwargs(), dtype=torch.float32, device="cpu", seed=None,
                      remat=remat)
    for name, sd in state_dicts_from_jax(params).items():
        getattr(pm, name).load_state_dict(sd, strict=True)
    return pm


def test_unet_matches_jax_at_a_portrait_latent(micro):
    # the vertical bucket's orientation (the landscape request's UNet runs in
    # the generate test below)
    jm, params = micro
    h, w = 16, 8
    pm = _port(params)
    cfg = micro_model_kwargs()["unet_cfg"]
    assert isinstance(cfg, UNetConfig)
    rng = np.random.default_rng(h)
    b, frames = 2, 2
    sample = rng.normal(size=(b, frames, h, w, cfg.in_channels)).astype(np.float32)
    context = rng.normal(size=(b, 1 + cfg.num_id_tokens, cfg.cross_attention_dim)
                         ).astype(np.float32)
    context[0] = 0.0                                   # the CFG uncond stream
    ids = np.asarray([[6.0, 127.0, 0.02]] * b, np.float32)
    pose = rng.normal(size=(b * frames, h, w, cfg.block_out_channels[0])).astype(np.float32)
    t = np.float32(0.25 * np.log(37.0))
    want = np.asarray(jax.jit(jm.unet.apply)(
        {"params": params["unet"]}, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(context),
        jnp.asarray(ids), jnp.asarray(pose)))
    with torch.no_grad():
        got = pm.unet(torch.from_numpy(sample), torch.tensor(t), torch.from_numpy(context),
                      torch.from_numpy(ids), torch.from_numpy(pose)).numpy()
    assert got.shape == (b, frames, h, w, cfg.out_channels)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_vae_decode_matches_jax_at_a_non_square_latent(micro):
    jm, params = micro
    pm = _port(params)
    z = np.random.default_rng(1).normal(size=(4, 8, 16, 4)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, z: jm.vae.apply({"params": p}, z, num_frames=2,
                                                        method=jm.vae.decode))(
        params["vae"], jnp.asarray(z)))
    with torch.no_grad():
        got = pm.vae.decode(torch.from_numpy(z), num_frames=2).numpy()
    assert got.shape == (4, 64, 128, 3)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_landscape_generate_matches_jax_through_the_sequential_decode(micro, monkeypatch):
    # 64 x 128 (latent 8 x 16); the latent volume 4 x 8 x 16 exceeds the
    # batched decode's limit, so both packages decode one 2-frame chunk at
    # a time, as the 576x1024 request does at 4 frames
    jm, params = micro
    pm = _port(params)
    h, w, frames = 64, 128, 4
    rng = np.random.default_rng(11)
    ref = rng.uniform(size=(1, h, w, 3)).astype(np.float32)
    pose = rng.uniform(-1, 1, size=(frames, h, w, 3)).astype(np.float32)
    face = rng.normal(size=(1, 32)).astype(np.float32)
    kw = dict(num_frames=frames, tile_size=4, tile_overlap=1, num_inference_steps=2,
              decode_chunk_size=2, batched_decode_max_latent_volume=frames * 8 * 16 - 1)

    mapped = []                      # the JAX decode's sequential branch is a lax.map
    lax_map = jax.lax.map
    monkeypatch.setattr(jax.lax, "map", lambda f, xs, **k: mapped.append(xs.shape)
                        or lax_map(f, xs, **k))
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax_generate(jm, params, jnp.asarray(ref), jnp.asarray(pose),
                                   jnp.asarray(face), JPipelineConfig(**kw), rng=key))
    monkeypatch.undo()
    assert mapped == [(2, 2, 8, 16, 4)]

    decoded = []                     # the port's: one VAE call per chunk
    vae_decode = pm.vae.decode
    monkeypatch.setattr(pm.vae, "decode", lambda z, num_frames: decoded.append(
        (tuple(z.shape), num_frames)) or vae_decode(z, num_frames=num_frames))
    keys = jax.random.split(key, 3)
    aug = np.array(jax.random.normal(keys[0], ref.shape, jnp.float32))
    init = np.array(jax.random.normal(keys[1], (1, 4, 8, 16, 4), jnp.float32))
    got = generate(pm, torch.from_numpy(ref), torch.from_numpy(pose), torch.from_numpy(face),
                   PipelineConfig(**kw), aug_noise=torch.from_numpy(aug),
                   init_noise=torch.from_numpy(init), device="cpu").numpy()
    assert decoded == [((2, 8, 16, 4), 2)] * 2
    assert got.shape == (frames, h, w, 3)
    assert want.std() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    assert np.abs(got - want).mean() < 3e-4


def _batch():
    rng = np.random.default_rng(0)
    mask = np.zeros((B, F, H, W, 1))
    mask[:, :, 40:136, 16:72] = 1.0                  # a box unlike its transpose
    return {"frames": rng.uniform(-1, 1, (B, F, H, W, 3)),
            "ref_image": rng.uniform(0, 1, (B, H, W, 3)),
            "pose_pixels": rng.uniform(-1, 1, (B, F, H, W, 3)),
            "face_embed": rng.normal(size=(B, 32)), "face_mask": mask}


def _jax_noises(key):
    """The five draws of the JAX train_loss for `key` (no dropout), as numpy."""
    k = jax.random.split(key, 5)
    from stableanimator_tpu.diffusion.scheduler import sample_sigmas_lognormal

    return {"eps0": jax.random.normal(k[0], (B * F, H // 8, W // 8, 4), jnp.float32),
            "ref_aug": jax.random.normal(k[1], (B, H, W, 3), jnp.float32),
            "keep": jnp.ones((B,), jnp.float32),
            "sigmas": sample_sigmas_lognormal(k[3], (B,)),
            "noise": jax.random.normal(k[4], (B, F, H // 8, W // 8, 4), jnp.float32)}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in tree.items()}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _as_jax(sds):
    return {m: CONVERT[m]({k: v.detach().numpy() for k, v in sd.items()})["params"]
            for m, sd in sds.items()}


def test_portrait_train_step_matches_jax(micro):
    jm, params = micro
    jcfg = JTrainConfig()
    frozen = {k: params[k] for k in params if k not in TRAINABLE}
    trainable = {k: params[k] for k in TRAINABLE}
    batch = _batch()
    key = jax.random.PRNGKey(3)

    def loss(trainable, frozen, batch, rng):
        return jax_train_loss(jm, trainable, frozen, batch, rng, jcfg, JPipelineConfig(),
                              conditioning_dropout_prob=0.0)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss))(
        trainable, frozen, {k: jnp.asarray(v, jnp.float32) for k, v in batch.items()}, key)
    want_norm = float(optax.global_norm(want_grads))

    # the loss and every gradient leaf
    noises = _torch(_jax_noises(key))
    pm = _port(params)
    for name in TRAINABLE:
        getattr(pm, name).requires_grad_(True)
    got_loss = train_loss(pm, _torch(batch), TrainConfig(), PipelineConfig(),
                          conditioning_dropout_prob=0.0, noises=noises)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    got_loss.backward()
    got = _as_jax({m: {k: p.grad if p.grad is not None else torch.zeros_like(p)
                       for k, p in getattr(pm, m).named_parameters()} for m in TRAINABLE})
    g_max = max(np.abs(g).max() for m in TRAINABLE for _, g in _flat(want_grads[m]))
    compared = 0
    for m in TRAINABLE:
        have = dict(_flat(got[m]))
        for path, w in _flat(want_grads[m]):
            np.testing.assert_allclose(have[path], w, rtol=0,
                                       atol=1e-4 * np.abs(w).max() + 1e-6 * g_max,
                                       err_msg=f"{m} {path}")
            compared += 1
    assert compared > 900

    # one training step's metrics (its AdamW update is held against optax at
    # 128x128 in tests/test_torch_train.py; it sees no frame shape)
    cfg = TrainConfig(mixed_precision="no", learning_rate=LR, lr_warmup_steps=0)
    pm = _port(params)
    state = create_train_state(pm, cfg)
    before = [m.clone() for m in state.masters]
    step_fn = make_train_step(pm, cfg, PipelineConfig(), conditioning_dropout_prob=0.0)
    state, metrics = step_fn(state, _torch(batch), noises=noises)
    np.testing.assert_allclose(metrics["loss"].item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(), want_norm, rtol=1e-5)
    assert state.updates == 1 and any((a != b).any() for a, b in zip(state.masters, before))


def test_chip_smoke_reckons_the_large_paths_as_the_port_plans_them():
    import chip_smoke as cs

    from stableanimator_tpu_torch.diffusion.tiling import auto_tile_batch, tile_indices
    from stableanimator_tpu_torch.models.transformer import BasicTransformerBlock
    from stableanimator_tpu_torch.models.unet import UNetSpatioTemporal
    from stableanimator_tpu_torch.ops.attention import FLASH_MIN_SEQ
    from stableanimator_tpu_torch.pipeline.animation import (
        _decode_group_size,
        resolve_steps_per_dispatch,
    )

    # the long-video plans: tiles, UNet calls a step, steps a segment, decode groups
    for n, (tiles, calls, per_segment, groups) in cs.LONG_PLANS.items():
        cfg = dataclasses.replace(PipelineConfig(), num_frames=n)
        assert tile_indices(n, 16, 4).shape[0] == tiles
        assert -(-tiles // auto_tile_batch(n, 16, 4)) == calls
        assert resolve_steps_per_dispatch(cfg) == per_segment
        assert -(-n // _decode_group_size(cfg, n, 64, 64)) == groups

    # the 576x1024 request: the heads of the UNet's spatial self-attentions
    # by token count (full width, on the meta device), those at >= 512 tokens
    # take the kernel; the decode is past the batched limit
    h8, w8 = cs.PRO_HW[0] // 8, cs.PRO_HW[1] // 8
    with torch.device("meta"):
        unet = UNetSpatioTemporal(UNetConfig())
    heads = {}
    for name, mod in unet.named_modules():
        if isinstance(mod, BasicTransformerBlock):
            level = int(name.split(".")[1]) if name.startswith("down_blocks") else (
                3 - int(name.split(".")[1]) if name.startswith("up_blocks") else 3)
            tokens = (h8 >> level) * (w8 >> level)
            heads.setdefault((tokens, mod.attn1.heads, mod.attn1.dim_head), []).append(name)
    on_kernel = {k: len(v) for k, v in heads.items() if k[0] >= FLASH_MIN_SEQ}
    assert on_kernel == {(9216, 5, 64): 5, (2304, 10, 64): 5, (576, 20, 64): 5}
    assert sum(on_kernel.values()) == cs.PRO_UNET_ATTENTIONS
    want = {tuple(s[1:]) for lbl, s, lse in cs.PATH_SHAPES if lbl.startswith("pro_level")}
    assert want == {(t, hd, d) for t, hd, d in on_kernel}
    pipe = PipelineConfig()
    assert 16 * h8 * w8 > pipe.batched_decode_max_latent_volume
    assert 16 // pipe.decode_chunk_size == cs.PRO_DECODE_CALLS

    # the vertical training batch: height x width, the face box scaled by both
    batch = cs._train_batch(1, 2, *cs.VERTICAL_HW, 8, "cpu")
    assert batch["frames"].shape == (1, 2, 1024, 576, 3)
    rows = batch["face_mask"][0, 0, :, :, 0].sum(dim=1).nonzero().flatten()
    cols = batch["face_mask"][0, 0, :, :, 0].sum(dim=0).nonzero().flatten()
    assert (rows.min(), rows.max() + 1, cols.min(), cols.max() + 1) == (128, 512, 216, 360)


def test_chip_smoke_plain_versions_run_in_batch_chunks(monkeypatch):
    # the plain versions over chunks of the batch give the whole batch's
    # outputs (each row of the batch is its own attention)
    import chip_smoke as cs

    from stableanimator_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((5, 48, 2, 64), generator=g).to(torch.bfloat16)
                   for _ in range(4))
    whole_o, whole_lse = fa.flash_attention_reference(q, k, v, with_lse=True)
    whole_grads = fa.flash_attention_bwd_reference(q, k, v, whole_o, whole_lse, do)
    monkeypatch.setattr(cs, "PLAIN_SCORE_BYTES", 2 * 2 * 48 * 48 * 4)   # 2 rows a chunk
    assert cs._plain_rows(q, k) == 2 and "chunks of 2" in cs._chunks_note(q, k)
    o, lse = cs._plain(fa.flash_attention_reference, q, k, v, with_lse=True)
    torch.testing.assert_close(o, whole_o, rtol=0, atol=0)
    torch.testing.assert_close(lse, whole_lse, rtol=1e-6, atol=1e-6)
    grads = cs._plain(fa.flash_attention_bwd_reference, q, k, v, whole_o, whole_lse, do)
    for got, want in zip(grads, whole_grads):
        torch.testing.assert_close(got, want, rtol=0, atol=torch.finfo(want.dtype).eps)


def test_chip_smoke_kernel_line_names_what_bounds_most_of_its_bound():
    # the 576x1024 paths add a bytes-bound shape (level 2) to the forward's
    # operations-bound ones; bound_by follows the larger part of bound_ms
    import chip_smoke as cs

    def row(shape, bound_ms, by):
        return dict(shape=list(shape), ms=2 * bound_ms, plain_ms=1.0, library_ms=1.0,
                    bound_ms=bound_ms, bound_by=by)

    rows = {name: [] for name in cs.KERNELS}
    rows[cs.FWD_KERNEL] = [("pro_level0", row((32, 9216, 5, 64), 3.518, "operations")),
                           ("pro_level2", row((32, 576, 20, 64), 0.056, "bytes"))]
    pro = {"timed": {"by_shape": {(32, 9216, 9216, 5, 64): 125, (32, 576, 576, 20, 64): 125},
                     "norms": {("group_norm", (32, 9216, 320, True)): 100}}}
    paths = cs._paths(None, None, None, pro=pro)
    max_err = {name: 0.0 for name in cs.KERNELS}
    fwd = cs._kernel_entries(max_err, rows, paths)[0]
    assert (fwd["name"], fwd["launches"], fwd["bound_by"]) == (cs.FWD_KERNEL, 250, "operations")
    assert fwd["bound_ms"] == pytest.approx(125 * (3.518 + 0.056))
    rows[cs.FWD_KERNEL] = rows[cs.FWD_KERNEL][1:]
    with pytest.raises(SystemExit, match="not timed"):
        cs._kernel_entries(max_err, rows, paths)
