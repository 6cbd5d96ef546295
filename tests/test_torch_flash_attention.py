"""The port's flash-attention module against the JAX package's Pallas
kernel (run in interpret mode on the CPU).

On the CPU the port's `flash_attention` computes its plain version, which
is the function the CUDA kernel computes; test_torch_flash_attention_cuda.py
holds the kernel itself against that plain version on the card, within
`kernel_tolerance`, whose power is tested here.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stableanimator_tpu.ops.flash_attention import _flash_fwd_bshd
from stableanimator_tpu.ops.flash_attention import flash_attention as jax_flash
from stableanimator_tpu_torch.ops import flash_attention as fa
from tests.torch_threads import share_cores

THREADS = share_cores()

# (q_len, kv_len, heads, head_dim): the ragged and multi-block cases of
# tests/test_ops.py, the UNet's head counts, and the VAE's single 512-wide head
# (also with a q length off its 64-row q tile against more keys)
CASES = [(256, 256, 2, 64), (300, 300, 2, 64), (128, 512, 2, 64), (640, 576, 2, 64),
         (256, 256, 5, 64), (300, 300, 5, 64), (128, 512, 5, 64), (640, 576, 5, 64),
         (300, 300, 1, 512), (200, 300, 1, 512)]
# fp32: the two paths differ only in summation order (tests/test_ops.py uses
# 2e-4 for flash vs XLA). bf16: both round q*scale, P and the output to bf16
# at the same places; exp and summation order can move an output by one
# bf16 ulp (2^-8 relative, outputs here are below 2 in magnitude).
TOL = {"float32": 2e-4, "bfloat16": 1.6e-2}


def _qkv(sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(1, sq, h, d)).astype(np.float32),
            rng.normal(size=(1, sk, h, d)).astype(np.float32),
            rng.normal(size=(1, sk, h, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,h,d", CASES)
def test_flash_matches_jax_interpret(sq, sk, h, d, dtype):
    q, k, v = _qkv(sq, sk, h, d, seed=sq + sk + h + d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    scale = 1.0 / np.sqrt(d)

    want = np.asarray(jax_flash(jq, jk, jv, interpret=True).astype(jnp.float32))
    _, want_lse = _flash_fwd_bshd(jq, jk, jv, scale, True, True)
    want_lse = np.asarray(want_lse)[..., 0]                       # [B, Sq, H]

    launches = fa.flash_attention.launches
    got = fa.flash_attention(tq, tk, tv)
    got2, got_lse = fa.flash_attention(tq, tk, tv, with_lse=True)
    assert fa.flash_attention.launches == launches    # the CPU path launches nothing
    assert got.dtype == tdt and got.shape == (1, sq, h, d)
    assert got_lse.dtype == torch.float32 and got_lse.shape == (1, sq, h)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=TOL[dtype])
    np.testing.assert_array_equal(got2.float().numpy(), got.float().numpy())
    # lse is fp32 in both; bf16 inputs only change the logits, not their rounding
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=0, atol=2e-4)


def test_non_cpu_non_cuda_tensors_raise():
    q = torch.empty((1, 128, 2, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(q, q, q)



LOG2E = 1.4426950408889634


def _online_softmax(q, k, v, bk, exp2=False, split=False, skip_tile=None, v_weight_tile=None,
                    acc_bf16=False):
    """The CUDA kernels' algorithm in plain PyTorch: kv tiles of `bk` keys,
    running row max, P rounded to the input dtype at that max, fp32
    accumulator rescaled per tile. `exp2` takes exp(x) as exp2(x log2 e) with
    log2 e folded into the product, as both kernels do. `split` forms the
    logits as the fp32 sum of the two head-dim halves' partial products, as
    the d = 512 kernel's two consumers do. The other keyword arguments
    inject faults."""
    dt = q.dtype
    qs = (q.float() / math.sqrt(q.shape[-1])).to(dt).float()
    b, sq, h, d = q.shape
    halves = (slice(0, d // 2), slice(d // 2, d)) if split else (slice(0, d),)
    m = torch.full((b, h, sq), -math.inf)
    l = torch.zeros((b, h, sq))
    acc = torch.zeros((b, h, sq, d))
    for i, t0 in enumerate(range(0, k.shape[1], bk)):
        if i == skip_tile:
            continue
        kt = k[:, t0:t0 + bk].float()
        s = sum(torch.einsum("bqhd,bkhd->bhqk", qs[..., c], kt[..., c]) for c in halves)
        m_new = torch.maximum(m, s.amax(-1))
        if exp2:
            p = torch.exp2(s * LOG2E - (m_new * LOG2E)[..., None])
            alpha = torch.exp2((m - m_new) * LOG2E)
        else:
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        vt = v[:, t0:t0 + bk].float() * (1.05 if i == v_weight_tile else 1.0)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p.to(dt).float(), vt)
        if acc_bf16:
            acc = acc.to(torch.bfloat16).float()
        m = m_new
    return (acc / l[..., None]).permute(0, 2, 1, 3).to(dt)


# (q/kv len, heads, head dim, dtype, kv tile, exp2, split): the earlier d = 64
# tiling (64-key tiles, exp), the d = 64 kernel (128-key tiles, exp2) and the
# d = 512 kernel (32-key tiles, exp2, the logits summed from two head-dim
# halves, also off a whole tile), bf16 and fp16
@pytest.mark.parametrize("s,h,d,dtype,bk,exp2,split", [
    (1024, 5, 64, torch.bfloat16, 64, False, False),
    (1024, 1, 512, torch.bfloat16, 32, True, True),
    (1024, 2, 64, torch.float16, 64, False, False),
    (1024, 5, 64, torch.bfloat16, 128, True, False),
    (1024, 2, 64, torch.float16, 128, True, False),
    (1000, 3, 64, torch.bfloat16, 128, True, False),
    (1000, 1, 512, torch.float16, 32, True, True)])
def test_kernel_tolerance_accepts_the_kernels_rounding_and_rejects_faults(s, h, d, dtype, bk, exp2,
                                                                          split):
    gen = torch.Generator().manual_seed(s + h + d)
    q, k, v = (torch.randn((1, s, h, d), generator=gen).to(dtype) for _ in range(3))
    ref = fa.flash_attention_reference(q, k, v)
    bound = fa.kernel_tolerance(ref)

    def share(out):          # the largest share of the bound an output uses
        return ((out.float() - ref.float()).abs() / bound).max().item()

    assert share(_online_softmax(q, k, v, bk, exp2, split)) < 1.0
    assert share(_online_softmax(q, k, v, bk, exp2, split, skip_tile=3)) > 1.0
    assert share(_online_softmax(q, k, v, bk, exp2, split, v_weight_tile=3)) > 1.0
    assert share(_online_softmax(q, k, v, bk, exp2, split, acc_bf16=True)) > 1.0
