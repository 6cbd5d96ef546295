"""The port's resident-K/V flash-attention kernel on the card: against its
plain version and against the streamed kernel, at the 64-frame request's
UNet shapes, the training shape with lse, and ragged ones; the routing
under the budget; and the shapes it does not take.

Imports neither JAX nor the test configuration, so it runs on a machine
with the GPU and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_attention_resident_cuda.py -q
"""

import pytest
import torch

from stableanimator_tpu_torch.ops import flash_attention as fa

# lse is fp32 in both; they differ by summation order only
LSE_ATOL = 1e-3


def _qkv(shape, sk, dtype):
    gen = torch.Generator(device="cuda").manual_seed(sum(shape) + sk)
    b, sq, h, d = shape
    return [torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
            for s in (sq, sk, sk)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,sk,dtype", [((32, 4096, 5, 64), 4096, torch.bfloat16),
                                            ((32, 1024, 10, 64), 1024, torch.bfloat16),
                                            ((16, 4096, 5, 64), 4096, torch.bfloat16),
                                            ((2, 300, 5, 64), 513, torch.bfloat16),
                                            ((2, 300, 5, 64), 513, torch.float16),
                                            ((2, 256, 2, 64), 256, torch.bfloat16)])
def test_resident_kernel_matches_plain_and_streamed(shape, sk, dtype):
    _need_card()
    q, k, v = _qkv(shape, sk, dtype)
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
@pytest.mark.parametrize("shape,sk,dtype,error", [((1, 256, 1, 512), 256, torch.bfloat16, ValueError),
                                                  ((1, 256, 2, 64), 4160, torch.bfloat16, ValueError),
                                                  ((1, 256, 2, 64), 256, torch.float32, TypeError)])
def test_resident_kernel_refuses_other_shapes(shape, sk, dtype, error):
    _need_card()
    q, k, v = _qkv(shape, sk, dtype)
    with pytest.raises(error):
        fa.flash_attention_resident(q, k, v)
