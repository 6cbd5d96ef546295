"""The port's resident-K/V flash attention against the JAX package's.

  (a) the routing: the port's budget test against the JAX package's
      `_use_resident` at budgets 0 and 4 MiB, on the three shapes of the
      64-frame request and the ragged ones of tests/test_ops.py; the
      kernel's own test on the same shapes (d = 64 at any number of keys;
      the VAE's 512-wide head is refused);
  (b) the resident wrapper's CPU output and lse against the JAX package's
      `_flash_fwd_resident` (the Pallas kernel in interpret mode) at the
      shapes of tests/test_ops.py::TestFlashKernelVariants.

On the CPU the wrapper computes its plain version, the function the CUDA
kernel computes; tests/test_torch_flash_attention_resident_cuda.py holds the
kernel itself against it on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stableanimator_tpu.ops import flash_attention as jfa
from stableanimator_tpu_torch.ops import flash_attention as fa
from tests.torch_threads import share_cores

THREADS = share_cores()

MIB4 = 4 * 1024 * 1024
# (label, q shape, kv length): the 64-frame request's UNet levels 0 and 1
# (CFG x 16 frames per tile group) and VAE mid attention, and tests/test_ops.py's
SHAPES = [("unet_level0", (32, 4096, 5, 64), 4096),
          ("unet_level1", (32, 1024, 10, 64), 1024),
          ("vae_mid", (16, 4096, 1, 512), 4096),
          ("ragged", (2, 300, 5, 64), 513),
          ("small", (2, 256, 2, 64), 256)]
# test (b) on those shapes: whether the resident kernel takes the call
TAKES = {"unet_level0": True, "unet_level1": True, "vae_mid": False, "ragged": True,
         "small": True}
# with the 4 MiB budget, the route of each call
ROUTE_4MIB = {"unet_level0": "resident", "unet_level1": "resident", "vae_mid": "refused",
              "ragged": "resident", "small": "resident"}


def _k_shape(q_shape, sk):
    return (q_shape[0], sk) + tuple(q_shape[2:])


@pytest.mark.parametrize("budget", [0, MIB4])
@pytest.mark.parametrize("label,q_shape,sk", SHAPES)
def test_budget_test_matches_jax(monkeypatch, label, q_shape, sk, budget):
    k_shape = _k_shape(q_shape, sk)
    passes = {}
    for dtype in (jnp.bfloat16, jnp.float32):
        q = jax.ShapeDtypeStruct(q_shape, dtype)
        k = jax.ShapeDtypeStruct(k_shape, dtype)
        monkeypatch.setattr(jfa, "_RESIDENT_KV_MAX_BYTES", budget)
        want = jfa._use_resident(q, k)
        itemsize = np.dtype(dtype).itemsize
        assert fa.passes_resident_budget(q_shape, k_shape, itemsize, budget) == want, dtype
        # the budget is read from the environment at call time
        monkeypatch.setenv(fa.RESIDENT_BUDGET_ENV, str(budget))
        assert fa.resident_kv_budget() == budget
        assert fa.passes_resident_budget(q_shape, k_shape, itemsize) == want
        passes[dtype] = want
    # at 4 MiB every bf16 call of the 64-frame request passes the JAX test; at 0 none
    assert passes[jnp.bfloat16] == (budget == MIB4)


@pytest.mark.parametrize("label,q_shape,sk", SHAPES)
def test_capacity_test(label, q_shape, sk):
    k_shape = _k_shape(q_shape, sk)
    assert fa.resident_kernel_takes(q_shape) == TAKES[label]
    assert fa.resident_route(q_shape, k_shape, 2, MIB4) == ROUTE_4MIB[label]
    assert fa.resident_route(q_shape, k_shape, 2, 0) == "streamed"


def test_capacity_limits():
    # the kernel streams K and V through its ring: no key count is too many,
    # no head dim but 64 is taken
    for sk in (1, 512, 513, 1024, 2048, 2049, 4096, 4097, 9216):
        assert fa.resident_route((2, 256, 5, 64), (2, sk, 5, 64), 2, 8 * MIB4) == "resident", sk
    for d in (32, 128, 512):
        assert not fa.resident_kernel_takes((1, 4096, 1, d))
    # the 576x1024 level-0 attention (9216 keys) passes an 8 x 4 MiB budget in
    # JAX's test and takes the resident kernel
    assert fa.resident_route((32, 9216, 5, 64), (32, 9216, 5, 64), 2, 8 * MIB4) == "resident"


# fp32: summation order only (tests/test_ops.py allows 2e-4 between the
# Pallas kernels and XLA); bf16: one bf16 ulp of outputs below 2
TOL = {"float32": 2e-4, "bfloat16": 1.6e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk", [(256, 256), (300, 513)])
@pytest.mark.parametrize("h", [1, 2, 5])
def test_resident_matches_jax_interpret(h, sq, sk, dtype):
    rng = np.random.default_rng(h * 1000 + sq + sk)
    q = rng.normal(size=(2, sq, h, 64)).astype(np.float32)
    k, v = (rng.normal(size=(2, sk, h, 64)).astype(np.float32) for _ in range(2))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    want, want_lse = jfa._flash_fwd_resident(jq, jk, jv, 64 ** -0.5, True, True)
    want = np.asarray(want.astype(jnp.float32))
    want_lse = np.asarray(want_lse)[..., 0]                       # [B, Sq, H]

    before = fa.flash_attention_resident.launches
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    got, got_lse = fa.flash_attention_resident(tq, tk, tv, with_lse=True)
    got2 = fa.flash_attention_resident(tq, tk, tv)
    assert fa.flash_attention_resident.launches == before   # the CPU path launches nothing
    assert got.dtype == tdt and got.shape == (2, sq, h, 64)
    assert got_lse.dtype == torch.float32 and got_lse.shape == (2, sq, h)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=TOL[dtype])
    np.testing.assert_array_equal(got2.float().numpy(), got.float().numpy())
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=0, atol=2e-4)


def test_resident_wrapper_rejects_other_devices():
    q = torch.empty((1, 128, 2, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_resident(q, q, q)


def test_reset_zeroes_the_resident_counters():
    fa.flash_attention_resident.launches = 3
    fa.flash_attention_resident.launches_by_shape[(1, 2, 3, 4, 64)] = 3
    fa.flash_attention_resident.refused = 2
    fa.reset_launch_counts()
    assert (fa.flash_attention_resident.launches, fa.flash_attention_resident.refused) == (0, 0)
    assert not fa.flash_attention_resident.launches_by_shape
