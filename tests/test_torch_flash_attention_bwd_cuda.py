"""The port's CUDA flash-attention backward kernels against the plain
backward, on the card: the d = 64 pair at the training step's shapes (UNet
levels 0 and 1, 16 frames) and ragged ones, the d = 512 pair at the face
optimisation's (VAE mid attention at latent crops 23, 24 and 32) and its
edges; and the autograd route through them.

Imports neither JAX nor the test configuration, so it runs on a machine
with the GPU and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_attention_bwd_cuda.py -q
"""

import pytest
import torch

from stableanimator_tpu_torch.ops import flash_attention as fa
from stableanimator_tpu_torch.ops.attention import plain_attention
from tests.torch_threads import share_cores

THREADS = share_cores()

SHAPES = [((16, 4096, 5, 64), 4096, torch.bfloat16),
          ((16, 1024, 10, 64), 1024, torch.bfloat16),
          ((1, 300, 2, 64), 300, torch.bfloat16),
          ((1, 300, 2, 64), 300, torch.float16),
          ((2, 640, 2, 64), 576, torch.bfloat16),
          ((2, 640, 2, 64), 576, torch.float16),
          # the wgmma kernels' edges: q off the 64-row q tile (dK/dV) and the
          # 128-row one (dQ) against 4096 keys; kv below and across the
          # 128-row kv block (dK/dV) and off the 64-row kv tile (dQ); fp16 at
          # training level 1
          ((1, 200, 3, 64), 4096, torch.bfloat16),
          ((2, 256, 3, 64), 100, torch.bfloat16),
          ((2, 256, 3, 64), 300, torch.bfloat16),
          ((16, 1024, 10, 64), 1024, torch.float16)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in full fp32


def _inputs(shape, sk, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, sq, h, d = shape

    def randn(s):
        return torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)

    return randn(sq), randn(sk), randn(sk), randn(sq)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,sk,dtype", SHAPES)
def test_cuda_backward_kernels_match_plain_version(shape, sk, dtype):
    _card()
    q, k, v, do = _inputs(shape, sk, dtype, seed=0)
    o, lse = fa.flash_attention(q, k, v, with_lse=True)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
    before = dict(fa.flash_attention_bwd.launches)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for name in (fa.DKV_KERNEL, fa.DQ_KERNEL):
        assert fa.flash_attention_bwd.launches[name] == before.get(name, 0) + 1
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert bool(((g.float() - w.float()).abs() <= fa.grad_tolerance(w)).all())


@pytest.mark.cuda
def test_cuda_backward_kernels_take_strided_views_of_one_qkv_tensor():
    # q, k, v as views of one [B, S, 3, H, D] tensor: the tensor maps read
    # them through their strides, and autograd hands the gradients back
    _card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    fused = torch.randn((2, 640, 3, 4, 64), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (fused[:, :, i] for i in range(3))
    do = torch.randn((2, 640, 4, 64), generator=gen, device="cuda").to(torch.bfloat16)
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    assert not qkv[0].is_contiguous()
    got = torch.autograd.grad(fa.flash_attention(*qkv), qkv, do)
    o, lse = fa.flash_attention(q, k, v, with_lse=True)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        assert bool(((g.float() - w.float()).abs() <= fa.grad_tolerance(w)).all())


@pytest.mark.cuda
def test_cuda_flash_attention_output_carries_its_gradient():
    # the forward's output on the card has a grad_fn, and its gradients are
    # the plain version's (they were silently lost before the autograd route)
    _card()
    q, k, v, do = _inputs((2, 1024, 5, 64), 1024, torch.bfloat16, seed=1)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*qkv)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, qkv, do)
    o, lse = fa.flash_attention(q, k, v, with_lse=True)     # what the route saved
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        assert bool(((g.float() - w.float()).abs() <= fa.grad_tolerance(w)).all())
    # and they agree with fp32 autograd through the plain attention to within
    # the bf16 forward's rounding (a few bf16 ulps of the largest gradient)
    qkv32 = [t.float().requires_grad_() for t in (q, k, v)]
    plain = torch.autograd.grad(plain_attention(*qkv32), qkv32, do.float())
    for g, w in zip(got, plain):
        assert (g.float() - w).abs().max().item() <= 0.05 * w.abs().max().item()


# the d = 512 pair (the VAE decoder's mid attention under the face
# optimisation, [16 frames, crop^2 tokens, 1, 512]): crop 23 (529 tokens, off
# every tile), 24 and 32, fp16 at crop 32, q shorter than kv (200 x 1024),
# two heads with kv off the 16-row tile; the kernels' edges: kv off the dK/dV
# kernel's 64-row block with q off its 16-row tile (two heads), q off the dQ
# kernel's 64-row block with kv off its 16-row tile (fp16), a q length
# shorter than one streamed tile and a kv length of one streamed tile only
D512_SHAPES = [((16, 529, 1, 512), 529, torch.bfloat16),
               ((16, 576, 1, 512), 576, torch.bfloat16),
               ((16, 1024, 1, 512), 1024, torch.bfloat16),
               ((16, 1024, 1, 512), 1024, torch.float16),
               ((1, 200, 1, 512), 1024, torch.bfloat16),
               ((2, 100, 2, 512), 300, torch.bfloat16),
               ((2, 200, 2, 512), 300, torch.bfloat16),
               ((4, 72, 1, 512), 1000, torch.float16),
               ((1, 8, 1, 512), 40, torch.bfloat16),
               ((2, 40, 1, 512), 8, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,sk,dtype", D512_SHAPES)
def test_cuda_backward_d512_pair_matches_plain_version(shape, sk, dtype):
    _card()
    q, k, v, do = _inputs(shape, sk, dtype, seed=4)
    o, lse = fa.flash_attention(q, k, v, with_lse=True)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
    before = dict(fa.flash_attention_bwd.launches)
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]   # through the autograd route
    got = torch.autograd.grad(fa.flash_attention(*qkv), qkv, do)
    torch.cuda.synchronize()
    for name in (fa.DKV_D512_KERNEL, fa.DQ_D512_KERNEL):
        assert fa.flash_attention_bwd.launches[name] == before.get(name, 0) + 1
    for name in (fa.DKV_KERNEL, fa.DQ_KERNEL):
        assert fa.flash_attention_bwd.launches[name] == before.get(name, 0)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert bool(((g.float() - w.float()).abs() <= fa.grad_tolerance(w)).all())
    # no atomics: the same result on every run
    again = torch.autograd.grad(fa.flash_attention(*qkv), qkv, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_cuda_backward_refuses_head_dim_128():
    # the kernels take d = 64 and 512; on the card another head dim raises,
    # naming no queue item (on the CPU the plain backward takes every head dim)
    _card()
    q, k, v, do = _inputs((1, 1024, 1, 128), 1024, torch.bfloat16, seed=3)
    o, lse = fa.flash_attention_reference(q, k, v, with_lse=True)
    with pytest.raises(NotImplementedError, match="head dim 128") as raised:
        fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert "item" not in str(raised.value)
