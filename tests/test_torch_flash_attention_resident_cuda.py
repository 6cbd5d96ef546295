"""The port's resident-K/V flash-attention kernel on the card: against its
plain version and against the streamed kernel, at
the 64-frame request's UNet shapes, the training shape with lse, ragged
ones and the kernel's edges; the routing under the budget; and the calls it
does not take.

Imports neither JAX nor the test configuration, so it runs on a machine
with the GPU and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_attention_resident_cuda.py -q
"""

import pytest
import torch

from stableanimator_tpu_torch.ops import flash_attention as fa
from tests.torch_threads import share_cores

THREADS = share_cores()

# lse is fp32 in both; they differ by summation order only
LSE_ATOL = 1e-3


def _qkv(shape, sk, dtype, fused=False):
    """q [B, Sq, H, D] and k, v [B, sk, H, D]; `fused` makes them strided
    views of one [B, S, 3, H, D] tensor (a fused QKV projection's layout)."""
    gen = torch.Generator(device="cuda").manual_seed(sum(shape) + sk)
    b, sq, h, d = shape
    if fused:
        qkv = torch.randn((b, sq, 3, h, d), generator=gen, device="cuda").to(dtype)
        return [qkv[:, :, i] for i in range(3)]
    return [torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
            for s in (sq, sk, sk)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


# (q shape, kv length, dtype, fused): the 64-frame request's UNet levels, the
# training shape, ragged ones, and the kernel's edges: a q length off the
# 192-row q tile against 4096 keys; 150 q rows, one q tile, so that the
# cluster's other CTAs have no rows; kv below and across one 128-key tile;
# strided views of a fused QKV tensor; fp16 at UNet level 1
SHAPES = [((32, 4096, 5, 64), 4096, torch.bfloat16, False),
          ((32, 1024, 10, 64), 1024, torch.bfloat16, False),
          ((16, 4096, 5, 64), 4096, torch.bfloat16, False),
          ((2, 300, 5, 64), 513, torch.bfloat16, False),
          ((2, 300, 5, 64), 513, torch.float16, False),
          ((2, 256, 2, 64), 256, torch.bfloat16, False),
          ((1, 200, 3, 64), 4096, torch.bfloat16, False),
          ((2, 150, 3, 64), 1024, torch.bfloat16, False),
          ((2, 256, 3, 64), 100, torch.bfloat16, False),
          ((2, 256, 3, 64), 300, torch.bfloat16, False),
          ((2, 640, 4, 64), 640, torch.bfloat16, True),
          ((32, 1024, 10, 64), 1024, torch.float16, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,sk,dtype,fused", SHAPES)
def test_resident_kernel_matches_plain_and_streamed(shape, sk, dtype, fused):
    _need_card()
    q, k, v = _qkv(shape, sk, dtype, fused)
    want, want_lse = fa.flash_attention_reference(q, k, v, with_lse=True)
    before = fa.flash_attention_resident.launches
    got, lse = fa.flash_attention_resident(q, k, v, with_lse=True)
    got2 = fa.flash_attention_resident(q, k, v)
    streamed = fa.flash_attention(q, k, v)      # the budget is 0: the streamed kernel
    torch.cuda.synchronize()
    assert fa.flash_attention_resident.launches == before + 2
    for out in (got, got2):
        assert bool(((out.float() - want.float()).abs() <= fa.kernel_tolerance(want)).all())
    assert (lse - want_lse).abs().max().item() <= LSE_ATOL
    assert bool(((got.float() - streamed.float()).abs() <= fa.kernel_tolerance(streamed)).all())


@pytest.mark.cuda
def test_the_budget_routes_to_the_resident_kernel(monkeypatch):
    _need_card()
    monkeypatch.setenv(fa.RESIDENT_BUDGET_ENV, str(4 * 1024 * 1024))
    fa.reset_launch_counts()
    q, k, v = _qkv((2, 1024, 10, 64), 1024, torch.bfloat16)
    fa.flash_attention(q, k, v)
    vq, vk, vv = _qkv((1, 4096, 1, 512), 4096, torch.bfloat16)
    fa.flash_attention(vq, vk, vv)              # passes the budget, fits no cluster
    torch.cuda.synchronize()
    assert fa.flash_attention_resident.launches == 1
    assert fa.flash_attention_resident.refused == 1
    assert fa.flash_attention.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape,sk,dtype,error", [
    ((1, 256, 1, 512), 256, torch.bfloat16, ValueError),
    ((1, 256, 2, 64), 256, torch.float32, TypeError)])
def test_resident_kernel_refuses_other_shapes(shape, sk, dtype, error):
    _need_card()
    q, k, v = _qkv(shape, sk, dtype)
    with pytest.raises(error):
        fa.flash_attention_resident(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("sk", [4160, 9216])
def test_resident_kernel_takes_any_number_of_keys(sk):
    # K and V stream through the ring, so a head's keys need not fit in
    # shared memory: 4160 keys, and the 576x1024 level-0 attention's 9216
    _need_card()
    q, k, v = _qkv((1, 512, 2, 64), sk, torch.bfloat16)
    want = fa.flash_attention_reference(q, k, v)
    got = fa.flash_attention_resident(q, k, v)
    torch.cuda.synchronize()
    assert bool(((got.float() - want.float()).abs() <= fa.kernel_tolerance(want)).all())


@pytest.mark.cuda
def test_resident_clusters_fit_the_card():
    # clusters of one CTA per SM: at least one fits, and no more than the
    # SMs hold
    _need_card()
    n = fa.resident_max_clusters()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert 1 <= n * fa.RESIDENT_CLUSTER <= sms
