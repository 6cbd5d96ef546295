"""The port's CUDA flash-attention kernels against their plain version, on
the card, at the main path's full shapes (UNet levels 0 and 1 at CFG x 16
frames, the VAE's 512-wide head), ragged ones and each kernel's edges (q and
kv tails, strided inputs, fp16; at d = 512 also a single 50-row q tile and
two heads).

Imports neither JAX nor the test configuration, so it runs on a machine
with the GPU and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_attention_cuda.py -q
"""

import pytest
import torch

from stableanimator_tpu_torch.ops import flash_attention as fa
from tests.torch_threads import share_cores

THREADS = share_cores()

# lse is fp32 in both; they differ by summation order only
LSE_ATOL = 1e-3


def _inputs(shape, sk, dtype, fused):
    """q [B, Sq, H, D] and k, v [B, sk, H, D]; `fused` makes them strided
    views of one [B, S, 3, H, D] tensor (a fused QKV projection's layout)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, sq, h, d = shape
    if fused:
        qkv = torch.randn((b, sq, 3, h, d), generator=gen, device="cuda").to(dtype)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return [torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
            for s in (sq, sk, sk)]


# (q shape, kv length, dtype, fused): the main path's full shapes (UNet
# levels 0 and 1 at CFG x 16 frames, the VAE's 512-wide head), ragged ones,
# and the d = 64 kernel's edges: a q length that is not a multiple of its
# 192-row q tile, kv lengths below and across one 128-key tile, strided views
# of a fused QKV tensor, fp16 at UNet level 1; then the d = 512 kernel's: a q
# length off its 64-row q tile against 4096 keys, 50 q rows (a single q tile
# with fewer than 64 rows), kv lengths below, across and just past a whole
# number of its 32-key tiles, two heads, strided views of a fused QKV tensor
# (tensor maps over a [B, S, 3, H, 512] tensor)
@pytest.mark.cuda
@pytest.mark.parametrize("shape,sk,dtype,fused", [
    ((32, 4096, 5, 64), 4096, torch.bfloat16, False),
    ((32, 1024, 10, 64), 1024, torch.bfloat16, False),
    ((16, 4096, 1, 512), 4096, torch.bfloat16, False),
    ((2, 4096, 1, 512), 4096, torch.float16, False),
    ((2, 576, 20, 64), 576, torch.bfloat16, False),
    ((1, 300, 2, 64), 300, torch.bfloat16, False),
    ((1, 300, 2, 64), 300, torch.float16, False),
    ((1, 200, 3, 64), 4096, torch.bfloat16, False),
    ((2, 256, 3, 64), 100, torch.bfloat16, False),
    ((2, 256, 3, 64), 300, torch.bfloat16, False),
    ((2, 640, 4, 64), 640, torch.bfloat16, True),
    ((32, 1024, 10, 64), 1024, torch.float16, False),
    ((1, 200, 1, 512), 4096, torch.bfloat16, False),
    ((1, 50, 1, 512), 1024, torch.bfloat16, False),
    ((2, 256, 1, 512), 100, torch.bfloat16, False),
    ((2, 256, 1, 512), 300, torch.bfloat16, False),
    ((2, 256, 1, 512), 4100, torch.bfloat16, False),
    ((2, 512, 2, 512), 512, torch.bfloat16, False),
    ((2, 640, 1, 512), 640, torch.bfloat16, True)])
def test_cuda_kernel_matches_plain_version(shape, sk, dtype, fused):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, k, v = _inputs(shape, sk, dtype, fused)
    want, want_lse = fa.flash_attention_reference(q, k, v, with_lse=True)
    before = fa.flash_attention.launches
    got, lse = fa.flash_attention(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.shape == q.shape and got.is_contiguous()
    assert bool(((got.float() - want.float()).abs() <= fa.kernel_tolerance(want)).all())
    assert (lse - want_lse).abs().max().item() <= LSE_ATOL
