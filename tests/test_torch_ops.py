"""The port's ops, scheduler and tiling against the JAX package's, on the
same numpy inputs (CPU, fp32 unless stated)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stableanimator_tpu.core.config import SchedulerConfig as JSchedulerConfig
from stableanimator_tpu.diffusion import scheduler as jsched
from stableanimator_tpu.diffusion import tiling as jtiling
from stableanimator_tpu.ops.attention import dot_product_attention as jax_dpa
from stableanimator_tpu.ops.attention import xla_attention
from stableanimator_tpu.ops.norms import group_norm as jax_group_norm
from stableanimator_tpu.ops.norms import layer_norm as jax_layer_norm
from stableanimator_tpu.ops.resize import resize_antialias as jax_resize_antialias
from stableanimator_tpu_torch.core.config import SchedulerConfig
from stableanimator_tpu_torch.diffusion import scheduler, tiling
from stableanimator_tpu_torch.ops.attention import dot_product_attention, plain_attention
from stableanimator_tpu_torch.ops.norms import group_norm, layer_norm
from stableanimator_tpu_torch.ops.resize import resize_antialias
from tests.torch_threads import share_cores

THREADS = share_cores()


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# fp32 norms: same formula, summation order only (tests/test_ops.py: 2e-5)
@pytest.mark.parametrize("shape,groups", [((2, 6, 5, 32), 8), ((2, 3, 4, 4, 64), 32)])
def test_group_norm_matches_jax(shape, groups):
    x, w, b = _rand(*shape), _rand(shape[-1], seed=1), _rand(shape[-1], seed=2)
    want = np.asarray(jax_group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                     num_groups=groups, eps=1e-6))
    got = group_norm(_t(x), _t(w), _t(b), groups, 1e-6).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_group_norm_bf16_applies_affine_in_input_dtype():
    # bf16: the fold (a, b in fp32, cast once) and the bf16 multiply-add are
    # the same in both; the outputs agree to one bf16 ulp
    x, w, b = _rand(2, 8, 8, 64, seed=3), _rand(64, seed=4), _rand(64, seed=5)
    want = np.asarray(jax_group_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                                     jnp.asarray(b), num_groups=32).astype(jnp.float32))
    got = group_norm(_t(x).bfloat16(), _t(w), _t(b), 32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=2 ** -7)


def test_layer_norm_matches_jax():
    x, w, b = _rand(3, 7, 64), _rand(64, seed=3), _rand(64, seed=4)
    want = np.asarray(jax_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    np.testing.assert_allclose(layer_norm(_t(x), _t(w), _t(b)).numpy(), want,
                               rtol=2e-5, atol=2e-5)


# resize: host-computed float64 matrices in both, fp32 products
@pytest.mark.parametrize("hw,out", [((64, 48), 32), ((512, 512), 224), ((70, 90), 224)])
def test_resize_antialias_matches_jax(hw, out):
    x = np.random.default_rng(6).uniform(-1, 1, size=(1, *hw, 3)).astype(np.float32)
    want = np.asarray(jax_resize_antialias(jnp.asarray(x), out, out))
    got = resize_antialias(_t(x), out, out).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("sq,sk", [(64, 5), (16, 16), (256, 256)])
def test_dispatcher_small_kv_matches_xla_attention(sq, sk):
    # CPU tensors and kv < 512 take the plain path on both sides
    q, k, v = _rand(2, sq, 4, 16, seed=11), _rand(2, sk, 4, 16, seed=12), _rand(2, sk, 4, 16, seed=13)
    want = np.asarray(xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(np.asarray(jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))),
                               want, rtol=0, atol=0)
    got = dot_product_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(plain_attention(_t(q), _t(k), _t(v)).numpy(), got)


@pytest.mark.parametrize("steps", [1, 2, 3, 25, 50])
def test_schedule_tables_equal_jax(steps):
    want = jsched.make_schedule(steps, JSchedulerConfig())
    got = scheduler.make_schedule(steps, SchedulerConfig())
    np.testing.assert_array_equal(got.sigmas.numpy(), np.asarray(want.sigmas))
    np.testing.assert_array_equal(got.timesteps.numpy(), np.asarray(want.timesteps))
    assert got.init_noise_sigma == want.init_noise_sigma


def test_euler_step_matches_jax():
    sched = scheduler.make_schedule(25)
    mo, s = _rand(1, 4, 8, 8, 4, seed=20), _rand(1, 4, 8, 8, 4, seed=21) * 700.0
    for i in (0, 12, 24):
        sig, nxt = sched.sigmas[i], sched.sigmas[i + 1]
        want_in = np.asarray(jsched.scale_model_input(jnp.asarray(s), float(sig)))
        np.testing.assert_allclose(scheduler.scale_model_input(_t(s), sig).numpy(), want_in,
                                   rtol=1e-6, atol=0)
        want = np.asarray(jsched.step_euler(jnp.asarray(mo), jnp.asarray(s), float(sig), float(nxt)))
        got = scheduler.step_euler(_t(mo), _t(s), sig, nxt).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("f,tile,overlap", [(16, 16, 4), (4, 4, 1), (6, 4, 2), (14, 4, 1),
                                            (64, 16, 4), (450, 16, 4)])
def test_tiling_tables_equal_jax(f, tile, overlap):
    np.testing.assert_array_equal(tiling.tile_indices(f, tile, overlap),
                                  jtiling.tile_indices(f, tile, overlap))
    assert tiling.auto_tile_batch(f, tile, overlap) == jtiling.auto_tile_batch(f, tile, overlap)
    np.testing.assert_array_equal(tiling.tile_blend_weight(tile), jtiling.tile_blend_weight(tile))
