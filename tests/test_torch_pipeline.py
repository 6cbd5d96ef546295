"""The slice as a whole: the port's flat `generate` against the JAX
package's on the micro model zoo (`micro_model_kwargs`), 64x64, fp32 on
the CPU, weights from `fast_init_params`.

jax.random cannot be reproduced in torch, so the port is handed the exact
noise the JAX pipeline draws: jax.random.split(rng, 3)[0] for the VAE
noise augmentation and [1] for the initial tile noise.

Tolerance: frames are in [0, 1]; the two sides run the same fp32 math in a
different summation order, amplified by the init sigma (700) through the
Euler steps. How far that goes: on the 6-frame case, scaling the initial
noise by (1 + 1e-7) alone moves single pixels by 6e-4 and the mean by
3e-5. Against JAX, single pixels reach ~1.3e-3 and the mean ~1e-4. The
bounds: 2e-3 per pixel, what the JAX package's pipeline tests allow
between two fp32 paths (tests/test_pipeline.py), and 3e-4 on the mean.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stableanimator_tpu.core.config import PipelineConfig as JPipelineConfig
from stableanimator_tpu.core.config import micro_model_kwargs as jax_micro_kwargs
from stableanimator_tpu.pipeline import build_models as jax_build_models
from stableanimator_tpu.pipeline import decode_frames as jax_decode_frames
from stableanimator_tpu.pipeline import fast_init_params
from stableanimator_tpu.pipeline import generate as jax_generate
from stableanimator_tpu_torch.convert.from_jax import state_dicts_from_jax
from stableanimator_tpu_torch.core.config import PipelineConfig, micro_model_kwargs
from stableanimator_tpu_torch.pipeline.animation import build_models, decode_frames, generate
from tests.torch_threads import share_cores

THREADS = share_cores()

ATOL = 2e-3


@pytest.fixture(scope="module")
def micro():
    jm = jax_build_models(**jax_micro_kwargs(), dtype=None, use_flash=False)
    params = fast_init_params(jm, height=64, width=64)
    pm = build_models(**micro_model_kwargs(), dtype=torch.float32, device="cpu", seed=None)
    for name, sd in state_dicts_from_jax(params).items():
        getattr(pm, name).load_state_dict(sd, strict=True)
    return jm, params, pm


def _inputs(frames, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(1, 64, 64, 3)).astype(np.float32),
            rng.uniform(-1, 1, size=(frames, 64, 64, 3)).astype(np.float32),
            rng.normal(size=(1, 32)).astype(np.float32))


@pytest.mark.parametrize("frames,tile,overlap,steps,chunk", [(4, 4, 1, 2, 2), (6, 4, 2, 3, 4)])
def test_generate_matches_jax(micro, frames, tile, overlap, steps, chunk):
    jm, params, pm = micro
    ref, pose, face = _inputs(frames, seed=frames)
    kw = dict(num_frames=frames, tile_size=tile, tile_overlap=overlap,
              num_inference_steps=steps, decode_chunk_size=chunk)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_generate(jm, params, jnp.asarray(ref), jnp.asarray(pose),
                                   jnp.asarray(face), JPipelineConfig(**kw), rng=key))
    keys = jax.random.split(key, 3)
    aug = np.array(jax.random.normal(keys[0], ref.shape, jnp.float32))
    init = np.array(jax.random.normal(keys[1], (1, tile, 8, 8, 4), jnp.float32))
    got = generate(pm, torch.from_numpy(ref), torch.from_numpy(pose), torch.from_numpy(face),
                   PipelineConfig(**kw), aug_noise=torch.from_numpy(aug),
                   init_noise=torch.from_numpy(init), device="cpu").numpy()
    assert got.shape == (frames, 64, 64, 3) and got.dtype == np.float32
    assert want.std() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.abs(got - want).mean() < 3e-4


def test_generate_uint8_inputs_and_output(micro):
    _, _, pm = micro
    rng = np.random.default_rng(3)
    ref_u8 = rng.integers(0, 256, size=(1, 64, 64, 3), dtype=np.uint8)
    pose_u8 = rng.integers(0, 256, size=(4, 64, 64, 3), dtype=np.uint8)
    face = torch.from_numpy(rng.normal(size=(1, 32)).astype(np.float32))
    cfg = PipelineConfig(num_frames=4, tile_size=4, tile_overlap=1, num_inference_steps=2,
                         decode_chunk_size=2)
    f32 = generate(pm, torch.from_numpy(ref_u8.astype(np.float32) / 255.0),
                   torch.from_numpy(pose_u8.astype(np.float32) / 127.5 - 1.0), face, cfg,
                   device="cpu")
    u8 = generate(pm, torch.from_numpy(ref_u8), torch.from_numpy(pose_u8), face,
                  dataclasses.replace(cfg, output_uint8=True), device="cpu")
    assert u8.dtype == torch.uint8 and u8.shape == (4, 64, 64, 3)
    # same default seed, same pixels: uint8 output is the rounded fp32 output
    want = np.clip(f32.numpy() * 255.0 + 0.5, 0, 255).astype(np.uint8)
    assert np.abs(u8.numpy().astype(int) - want.astype(int)).max() <= 1


def test_sequential_decode_matches_jax(micro):
    # the non-batched decode branch (one chunk at a time, uneven tail chunk)
    jm, params, pm = micro
    lat = np.random.default_rng(5).normal(size=(1, 5, 8, 8, 4)).astype(np.float32)
    kw = dict(decode_chunk_size=2, batched_decode_max_latent_volume=0)
    want = np.asarray(jax_decode_frames(jm, params, jnp.asarray(lat), JPipelineConfig(**kw)))
    got = decode_frames(pm, torch.from_numpy(lat), PipelineConfig(**kw)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _face_opt():
    from stableanimator_tpu_torch.pipeline.face_opt import FaceOptConfig, FaceOptimizer

    def arcface(pixels):                               # [N, 3, 112, 112] -> [N, 8]
        n = pixels.shape[0]
        return pixels.reshape(n, 3, 4, 28, 4, 28).mean(dim=(3, 5)).reshape(n, -1)[:, :8]

    def decode(latents, num_frames):
        x = torch.tanh(latents[..., :3])
        return x.repeat_interleave(8, dim=1).repeat_interleave(8, dim=2)

    return FaceOptimizer(FaceOptConfig(steps=1, lr=0.5, start_step=0, latent_crop=4),
                         arcface, decode, np.ones((8,), np.float32), np.zeros((4, 2), np.int32))


# face_opt (ROADMAP item 9) and the mesh (item 11d) are ported: the cases
# that raised now run (the mesh's in a world of one process; more ranks in
# tests/test_torch_mesh.py)
@pytest.mark.parametrize("kw,match", [
    pytest.param("face_opt", None, id="kw0-item 9"),
    pytest.param("mesh", None, id="kw1-item 11"),
])
def test_outside_the_slice_raises(micro, kw, match):
    _, _, pm = micro
    ref, pose, face = (torch.from_numpy(x) for x in _inputs(4, seed=0))
    cfg = PipelineConfig(tile_size=4, tile_overlap=1, num_inference_steps=2,
                         decode_chunk_size=2)
    if kw == "mesh":
        import torch.distributed as dist

        from stableanimator_tpu_torch.parallel import make_mesh

        mesh = make_mesh(device="cpu")          # a gloo world of one, in memory
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            assert mesh.shape == {"data": 1, "frame": 1}
            sharded = generate(pm, ref, pose, face, cfg, device="cpu", mesh=mesh)
            plain = generate(pm, ref, pose, face, cfg, device="cpu")
        finally:
            torch.set_num_threads(threads)
            dist.destroy_process_group()
        # one rank: every sharding is the identity, no collective runs
        torch.testing.assert_close(sharded, plain, rtol=0, atol=0)
        return
    if match is None:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)   # small shapes: other test workers hold the cores
        try:
            frames = generate(pm, ref, pose, face, cfg, device="cpu", face_opt=_face_opt())
            plain = generate(pm, ref, pose, face, cfg, device="cpu")
        finally:
            torch.set_num_threads(threads)
        assert frames.shape == (4, 64, 64, 3) and torch.isfinite(frames).all()
        assert (frames - plain).abs().max() > 1e-6
        return
    with pytest.raises(NotImplementedError, match=match):
        generate(pm, ref, pose, face, cfg, device="cpu", **kw)
