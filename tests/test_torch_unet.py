"""The port's UNet (with its transformer stack and ID adapter) against the
JAX package's `UNetSpatioTemporal`: `UNetConfig.tiny()` (full topology,
two layers per block), fp32 on the CPU, weights from `fast_init_params`.

Tolerance: the same fp32 math in a different summation order through ~50
layers grows to a few 1e-4 at unit-scale outputs (2.6e-4 seen); 1e-3 keeps
within the 2e-3 of the JAX package's own torch-oracle UNet parity test
(tests/test_models_parity.py).
"""

import numpy as np
import pytest
import torch

import jax
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
from stableanimator_tpu_torch.convert.from_jax import state_dict_from_jax
from stableanimator_tpu_torch.core.config import UNetConfig
from stableanimator_tpu_torch.models.unet import UNetSpatioTemporal
from tests.torch_threads import share_cores

THREADS = share_cores()


@pytest.fixture(scope="module")
def unets():
    jm = jax_build_models(JUNet.tiny(), JVAE.tiny(), JCLIP.tiny(), JPose.tiny(), JFace.tiny(),
                          dtype=None, use_flash=False)
    params = fast_init_params(jm, height=64, width=64)["unet"]
    port = UNetSpatioTemporal(UNetConfig.tiny()).eval()
    port.load_state_dict(state_dict_from_jax("unet", params), strict=True)
    return jax.jit(jm.unet.apply), params, port


@pytest.mark.parametrize("frames,hw", [(3, 8), (2, 16)])
def test_unet_matches_jax(unets, frames, hw):
    jax_unet, params, port = unets
    cfg = UNetConfig.tiny()
    rng = np.random.default_rng(frames)
    b = 2
    sample = rng.normal(size=(b, frames, hw, hw, cfg.in_channels)).astype(np.float32)
    context = rng.normal(size=(b, 1 + cfg.num_id_tokens, cfg.cross_attention_dim)).astype(np.float32)
    context[0] = 0.0                                   # the CFG uncond stream
    ids = np.asarray([[6.0, 127.0, 0.02]] * b, np.float32)
    pose = rng.normal(size=(b * frames, hw, hw, cfg.block_out_channels[0])).astype(np.float32)
    t = np.float32(0.25 * np.log(37.0))

    want = np.asarray(jax_unet({"params": params}, jnp.asarray(sample), jnp.asarray(t),
                               jnp.asarray(context), jnp.asarray(ids), jnp.asarray(pose)))
    with torch.no_grad():
        got = port(torch.from_numpy(sample), torch.tensor(t), torch.from_numpy(context),
                   torch.from_numpy(ids), torch.from_numpy(pose)).numpy()
    assert got.shape == (b, frames, hw, hw, cfg.out_channels)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_unet_without_pose_latents_matches_jax(unets):
    jax_unet, params, port = unets
    cfg = UNetConfig.tiny()
    rng = np.random.default_rng(9)
    sample = rng.normal(size=(1, 2, 8, 8, cfg.in_channels)).astype(np.float32)
    context = rng.normal(size=(1, 5, cfg.cross_attention_dim)).astype(np.float32)
    ids = np.asarray([[6.0, 127.0, 0.02]], np.float32)
    want = np.asarray(jax_unet({"params": params}, jnp.asarray(sample), jnp.float32(-1.3),
                               jnp.asarray(context), jnp.asarray(ids), None))
    with torch.no_grad():
        got = port(torch.from_numpy(sample), torch.tensor(-1.3), torch.from_numpy(context),
                   torch.from_numpy(ids), None).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
