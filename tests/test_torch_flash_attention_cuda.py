"""The port's CUDA flash-attention kernel against its plain version, on the
card, at the main path's full shapes (UNet levels 0 and 1 at CFG x 16
frames, the VAE's 512-wide head) and ragged ones.

Imports neither JAX nor the test configuration, so it runs on a machine
with the GPU and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_attention_cuda.py -q
"""

import pytest
import torch

from stableanimator_tpu_torch.ops import flash_attention as fa

# lse is fp32 in both; they differ by summation order only
LSE_ATOL = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((32, 4096, 5, 64), torch.bfloat16),
                                         ((32, 1024, 10, 64), torch.bfloat16),
                                         ((16, 4096, 1, 512), torch.bfloat16),
                                         ((2, 4096, 1, 512), torch.float16),
                                         ((2, 576, 20, 64), torch.bfloat16),
                                         ((1, 300, 2, 64), torch.bfloat16),
                                         ((1, 300, 2, 64), torch.float16)])
def test_cuda_kernel_matches_plain_version(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
    want, want_lse = fa.flash_attention_reference(q, k, v, with_lse=True)
    before = fa.flash_attention.launches
    got, lse = fa.flash_attention(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert bool(((got.float() - want.float()).abs() <= fa.kernel_tolerance(want)).all())
    assert (lse - want_lse).abs().max().item() <= LSE_ATOL
