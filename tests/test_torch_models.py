"""The port's VAE, PoseNet, FusionFaceId and CLIP against the JAX
package's Flax modules: tiny configs, fp32 on the CPU, weights from the
JAX package's `fast_init_params` carried across by `state_dicts_from_jax`.

Tolerance: both sides compute the same fp32 math; they differ in
summation order (oneDNN vs XLA:CPU convolutions and matmuls), which the
deeper VAE grows to a few 1e-5 at unit-scale outputs. 2e-4 is the
tolerance of the JAX package's own torch-oracle parity tests
(tests/test_models_parity.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stableanimator_tpu.core.config import (
    CLIPVisionConfig as JCLIP,
    FaceEncoderConfig as JFace,
    PoseNetConfig as JPose,
    UNetConfig as JUNet,
    VAEConfig as JVAE,
)
from stableanimator_tpu.pipeline import build_models as jax_build_models
from stableanimator_tpu.pipeline import fast_init_params
from stableanimator_tpu_torch.core.config import (
    CLIPVisionConfig,
    FaceEncoderConfig,
    PoseNetConfig,
    UNetConfig,
    VAEConfig,
)
from stableanimator_tpu_torch.convert.from_jax import state_dicts_from_jax
from stableanimator_tpu_torch.pipeline.animation import build_models
from tests.torch_threads import share_cores

THREADS = share_cores()

ATOL = RTOL = 2e-4


@pytest.fixture(scope="module")
def tiny():
    jm = jax_build_models(JUNet.tiny(), JVAE.tiny(), JCLIP.tiny(), JPose.tiny(),
                          JFace.tiny(), dtype=None, use_flash=False)
    params = fast_init_params(jm, height=64, width=64)
    pm = build_models(UNetConfig.tiny(), VAEConfig.tiny(), CLIPVisionConfig.tiny(),
                      PoseNetConfig.tiny(), FaceEncoderConfig.tiny(),
                      dtype=torch.float32, device="cpu", seed=None)
    for name, sd in state_dicts_from_jax(params).items():
        getattr(pm, name).load_state_dict(sd, strict=True)
    return jm, params, pm


def _rng(seed):
    return np.random.default_rng(seed)


def test_vae_encode_matches_jax(tiny):
    jm, params, pm = tiny
    x = _rng(0).uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    want = jm.vae.apply({"params": params["vae"]}, jnp.asarray(x), method=jm.vae.encode)
    mean, logvar = pm.vae.encode(torch.from_numpy(x))
    np.testing.assert_allclose(mean.numpy(), np.asarray(want.mean), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(want.logvar), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("frames,chunk", [(4, 2), (3, 3)])
def test_vae_decode_matches_jax(tiny, frames, chunk):
    jm, params, pm = tiny
    z = _rng(1).normal(size=(frames, 4, 4, 4)).astype(np.float32)
    want = jm.vae.apply({"params": params["vae"]}, jnp.asarray(z), num_frames=chunk,
                        method=jm.vae.decode)
    got = pm.vae.decode(torch.from_numpy(z), num_frames=chunk)
    assert got.shape == (frames, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_pose_net_matches_jax(tiny):
    jm, params, pm = tiny
    x = _rng(2).uniform(-1, 1, size=(3, 32, 32, 3)).astype(np.float32)
    want = jm.pose_net.apply({"params": params["pose_net"]}, jnp.asarray(x))
    got = pm.pose_net(torch.from_numpy(x))
    assert got.shape == (3, 4, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_face_encoder_matches_jax(tiny):
    jm, params, pm = tiny
    cfg = FaceEncoderConfig.tiny()
    ide = _rng(3).normal(size=(2, cfg.id_embeddings_dim)).astype(np.float32)
    clip = _rng(4).normal(size=(2, 1, cfg.clip_embeddings_dim)).astype(np.float32)
    want = jm.face_encoder.apply({"params": params["face_encoder"]}, jnp.asarray(ide),
                                 jnp.asarray(clip))
    got = pm.face_encoder(torch.from_numpy(ide), torch.from_numpy(clip))
    assert got.shape == (2, cfg.num_tokens, cfg.cross_attention_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_clip_matches_jax(tiny):
    jm, params, pm = tiny
    x = _rng(5).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = jm.clip.apply({"params": params["clip"]}, jnp.asarray(x))
    got = pm.clip(torch.from_numpy(x))
    assert got.shape == (2, CLIPVisionConfig.tiny().projection_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
