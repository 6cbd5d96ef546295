"""The port's long-video path against the JAX package's, on the micro model
zoo (`micro_model_kwargs`), 64x64, fp32 on the CPU, weights from
`fast_init_params`: the grouped denoise, the segmented dispatch with its
progress calls, the dispatched decode, the steps-per-dispatch policy and
warm_generate's plan.

As in tests/test_torch_pipeline.py, the port is handed the exact noise the
JAX pipeline draws (jax.random.split(rng, 3)[0] for the augmentation, [1]
for the initial tile noise), and the tolerance starts from the same: 2e-3
per pixel, 3e-4 on the mean (fp32 summation order, amplified by the init
sigma). How far that order moves a pixel depends on the host and on torch's
and XLA's own rounding, so each case also measures it in the same run
(`_rounding_bounds`): the port's generate under other roundings (the
initial noise scaled by each of NOISE_NUDGES, another thread count), and
the bounds are ROUNDING_FACTOR times the largest change any of them makes,
per value and on the mean, never below ATOL / MEAN_ATOL. Past ATOL_CEILING
/ MEAN_CEILING the case fails: a fault could hide under such bounds (the
pose latents gathered one frame off in the grouped denoise: 8.2e-2, mean
2.2e-3, at 34 frames; the tile blend weights one frame off: 0.23, mean
6.4e-3, at 14).

The cases run 3 Euler steps. How far rounding goes on this micro zoo at 14
frames: scaling the port's initial noise by (1 + 1e-7) alone moves single
pixels by up to 7e-4 at 3 steps, but by 3e-3 at 4 steps and 8e-3 to 3.3e-2
at 5 and 6 (the last steps at small sigma amplify it); the port against JAX
moved by the same amounts. Past 3 steps no per-pixel bound of 2e-3 can
hold, so the segments are made short instead of the request long.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stableanimator_tpu.core.config import PipelineConfig as JPipelineConfig
from stableanimator_tpu.core.config import micro_model_kwargs as jax_micro_kwargs
from stableanimator_tpu.pipeline import animation as jax_animation
from stableanimator_tpu.pipeline import build_models as jax_build_models
from stableanimator_tpu.pipeline import fast_init_params
from stableanimator_tpu_torch.convert.from_jax import state_dicts_from_jax
from stableanimator_tpu_torch.core.config import PipelineConfig, micro_model_kwargs
from stableanimator_tpu_torch.diffusion.tiling import auto_tile_batch
from stableanimator_tpu_torch.pipeline import animation
from tests.torch_threads import share_cores

THREADS = share_cores()

ATOL, MEAN_ATOL = 2e-3, 3e-4
# the bounds from rounding measured in the same run (module docstring)
ROUNDING_FACTOR, ATOL_CEILING, MEAN_CEILING = 2.0, 2e-2, 1e-3
NOISE_NUDGES = (1 + 1e-7, 1 - 1e-7, 1 + 3e-7, 1 - 3e-7)
# 14 frames at tile 4 / overlap 1 are 5 tiles: past the 4-tile flat path
LONG = dict(num_frames=14, tile_size=4, tile_overlap=1)


@pytest.fixture(scope="module")
def micro():
    jm = jax_build_models(**jax_micro_kwargs(), dtype=None, use_flash=False)
    params = fast_init_params(jm, height=64, width=64)
    pm = animation.build_models(**micro_model_kwargs(), dtype=torch.float32, device="cpu",
                                seed=None)
    for name, sd in state_dicts_from_jax(params).items():
        getattr(pm, name).load_state_dict(sd, strict=True)
    return jm, params, pm


def _rounding_bounds(got, probes) -> tuple[float, float]:
    """Per-value and mean bounds: ROUNDING_FACTOR times the largest change
    the probes (the same computation under other roundings) make to `got`,
    at least ATOL and MEAN_ATOL."""
    diffs = [np.abs(p - got) for p in probes]
    print("rounding: " + "; ".join(f"max {d.max():.3e} mean {d.mean():.3e}" for d in diffs))
    return (max(ATOL, ROUNDING_FACTOR * max(d.max() for d in diffs)),
            max(MEAN_ATOL, ROUNDING_FACTOR * max(d.mean() for d in diffs)))


def _inputs(frames, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(1, 64, 64, 3)).astype(np.float32),
            rng.uniform(-1, 1, size=(frames, 64, 64, 3)).astype(np.float32),
            rng.normal(size=(1, 32)).astype(np.float32))


@pytest.mark.parametrize("kw,plan,seen", [
    # auto: 5 tiles go in groups of 1 (auto_tile_batch) and 5-step segments,
    # here one segment of the 3 steps
    (dict(LONG), (1, 5), [(3, 3)]),
    # auto at 34 frames: 11 tiles in groups of 1, 30 // 11 = 2-step segments
    (dict(LONG, num_frames=34), (1, 2), [(2, 3), (3, 3)]),
    # groups of 2 pad the 5 tiles with a zero-weight duplicate; 2-step
    # segments; the decode splits into groups of 4 + 4 + 4 + 2
    (dict(LONG, max_tile_batch=2, steps_per_dispatch=2, decode_chunk_size=2,
          batched_decode_max_latent_volume=2 * 2 * 64), (2, 2), [(2, 3), (3, 3)]),
], ids=["auto", "auto_34f", "padded_groups"])
def test_long_video_generate_matches_jax(micro, kw, plan, seen):
    jm, params, pm = micro
    kw = dict(kw, num_inference_steps=3)
    f = kw["num_frames"]
    ref, pose, face = _inputs(f, seed=1)
    cfg = PipelineConfig(**kw)
    mtb = auto_tile_batch(f, 4, 1) if cfg.max_tile_batch == "auto" else cfg.max_tile_batch
    assert (mtb, animation.resolve_steps_per_dispatch(cfg)) == plan
    key = jax.random.PRNGKey(7)
    seen_jax, seen_port = [], []
    want = np.asarray(jax_animation.generate(
        jm, params, jnp.asarray(ref), jnp.asarray(pose), jnp.asarray(face),
        JPipelineConfig(**kw), rng=key,
        progress=lambda done, total: seen_jax.append((done, total))))
    keys = jax.random.split(key, 3)
    aug = np.array(jax.random.normal(keys[0], ref.shape, jnp.float32))
    init = np.array(jax.random.normal(keys[1], (1, 4, 8, 8, 4), jnp.float32))
    # At least 2 threads: at one thread and a batch under 16, PyTorch's CPU
    # convolution with a 1x1 spatial kernel (the temporal (3, 1, 1) ones)
    # runs its own slow_conv3d in place of oneDNN's, another rounding, which
    # the 34-frame case's three Euler steps amplified to 2.63e-3 on one host.
    # On another host (AMD EPYC, torch 2.13, JAX under the suite's XLA flags)
    # the 34-frame case lies 2.18e-3 from JAX at 2 threads, and the port at 4
    # threads lies 2.23e-3 from itself at 2, on the same value: rounding, which
    # the probes below measure.
    threads = max(THREADS, 2)

    def port(scale=1.0, n_threads=threads, progress=None):
        torch.set_num_threads(n_threads)
        try:
            return animation.generate(
                pm, torch.from_numpy(ref), torch.from_numpy(pose), torch.from_numpy(face), cfg,
                aug_noise=torch.from_numpy(aug), init_noise=torch.from_numpy(init) * scale,
                device="cpu", progress=progress).numpy()
        finally:
            torch.set_num_threads(THREADS)

    got = port(progress=lambda done, total: seen_port.append((done, total)))
    probes = [port(scale) for scale in NOISE_NUDGES] + [port(n_threads=4 if threads != 4 else 2)]
    atol, mean_atol = _rounding_bounds(got, probes)
    assert seen_jax == seen_port == seen
    assert got.shape == want.shape == (f, 64, 64, 3)
    assert want.std() > 0.05
    assert atol < ATOL_CEILING and mean_atol < MEAN_CEILING, (atol, mean_atol)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert np.abs(got - want).mean() < mean_atol


def test_decode_dispatched_matches_jax(micro, monkeypatch):
    jm, params, pm = micro
    lat = np.random.default_rng(5).normal(size=(1, 14, 8, 8, 4)).astype(np.float32)
    # 2-frame chunks, 2 chunks of 8x8 latents per group: groups of 4, a remainder of 2
    kw = dict(decode_chunk_size=2, batched_decode_max_latent_volume=2 * 2 * 64)
    want = np.asarray(jax_animation._decode_dispatched(jm, params, jnp.asarray(lat),
                                                       JPipelineConfig(**kw), None))
    groups = []
    decode_group = animation._decode_group

    def spy(models, latents, start, cfg, group):
        groups.append((start, group))
        return decode_group(models, latents, start, cfg, group)

    monkeypatch.setattr(animation, "_decode_group", spy)
    with torch.inference_mode():
        got = animation._decode_dispatched(pm, torch.from_numpy(lat), PipelineConfig(**kw))
    assert groups == [(0, 4), (4, 4), (8, 4), (12, 2)]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_resolve_steps_per_dispatch_matches_jax():
    n = 0
    for frames in (4, 14, 16, 40, 52, 64, 100, 450):
        for tile, overlap in ((4, 1), (16, 4), (8, 2)):
            for mtb in ("auto", None, 1, 2, 3):
                for spd in ("auto", None, 3):
                    kw = dict(num_frames=frames, tile_size=tile, tile_overlap=overlap,
                              max_tile_batch=mtb, steps_per_dispatch=spd)
                    for face_opt in (False, True):
                        got = animation.resolve_steps_per_dispatch(PipelineConfig(**kw), face_opt)
                        want = jax_animation.resolve_steps_per_dispatch(JPipelineConfig(**kw),
                                                                        face_opt)
                        assert got == want, (kw, face_opt)
                        n += 1
    assert n == 8 * 3 * 5 * 3 * 2
    # the long-video configuration: 64 frames at 16/4 are 5 tiles -> 5-step segments
    assert animation.resolve_steps_per_dispatch(PipelineConfig(num_frames=64)) == 5


@pytest.mark.parametrize("kw", [
    dict(**LONG, num_inference_steps=3),
    dict(**LONG, num_inference_steps=3, max_tile_batch=2, steps_per_dispatch=2,
         decode_chunk_size=2, batched_decode_max_latent_volume=2 * 2 * 64),
], ids=["auto", "padded_groups"])
def test_warm_generate_plan_matches_jax(micro, kw):
    # after the generate parity above in this module, so JAX's compile-only
    # warm finds its programs compiled
    jm, params, pm = micro
    cfg = dict(kw, height=64, width=64)
    want = jax_animation.warm_generate(jm, params, JPipelineConfig(**cfg), execute=False)
    got = animation.warm_generate(pm, PipelineConfig(**cfg), device="cpu", execute=False)
    assert got == want
    assert got["path"] == "segmented"
    # executing runs the plan once on zero inputs
    ran = animation.warm_generate(pm, PipelineConfig(**cfg), device="cpu", uint8_inputs=False)
    assert ran == dict(want, executed=True)


def test_warm_generate_flat_path(micro):
    # the JAX package's flat warm compiles the whole request and returns this
    # dict (tests/test_pipeline.py::test_warm_generate_covers_both_paths)
    _, _, pm = micro
    cfg = PipelineConfig(num_frames=4, height=64, width=64, tile_size=4, tile_overlap=1,
                         num_inference_steps=2, decode_chunk_size=2)
    assert animation.warm_generate(pm, cfg, device="cpu") == {
        "path": "flat", "programs": 1, "executed": False, "face_opt": False}
