"""The port's flash-attention backward against the JAX package's (its
Pallas backward kernels run in interpret mode on the CPU), and the power of
`grad_tolerance`.

On the CPU the port's autograd Function computes the plain forward and the
plain backward, the functions the CUDA kernels compute;
test_torch_flash_attention_bwd_cuda.py holds the kernels against them on
the card within `grad_tolerance`, whose power is tested here.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stableanimator_tpu.ops.flash_attention import flash_attention as jax_flash
from stableanimator_tpu_torch.ops import attention
from stableanimator_tpu_torch.ops import flash_attention as fa
from tests.torch_threads import share_cores

THREADS = share_cores()

# (q_len, kv_len, heads): the ragged and multi-block d = 64 cases of the
# forward's test, at the UNet's head counts
CASES = [(256, 256, 2), (300, 300, 2), (128, 512, 2), (640, 576, 2),
         (256, 256, 5), (300, 300, 5), (128, 512, 5), (640, 576, 5)]
# fp32: the same fp32 math in another summation order; the gradients here
# are O(1) (largest ~2), so 2e-5 is ~100 fp32 ulps. bf16: both sides round
# the forward's output and the gradients to bf16; one bf16 ulp of the
# largest gradient is 2^-7 * 2 = 1.6e-2, and o rounded one ulp apart moves
# delta, so the bound is two such ulps of each gradient's largest element.
FP32_ATOL = 2e-5
BF16_ULPS = 2


def _arrays(sq, sk, h, seed, d=64):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(1, sq, h, d)).astype(np.float32),
            rng.normal(size=(1, sk, h, d)).astype(np.float32),
            rng.normal(size=(1, sk, h, d)).astype(np.float32),
            rng.normal(size=(1, sq, h, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,h", CASES)
def test_grads_match_jax_interpret(sq, sk, h, dtype):
    q, k, v, do = _arrays(sq, sk, h, seed=sq + sk + h)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jdt) for x in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, interpret=True), jq, jk, jv)
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jdo)]

    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v))
    launches = sum(fa.flash_attention_bwd.launches.values())
    out = fa.flash_attention(tq, tk, tv)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do).to(tdt))
    assert sum(fa.flash_attention_bwd.launches.values()) == launches  # the CPU launches nothing
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == tdt and g.shape == w.shape
        atol = (FP32_ATOL if dtype == "float32"
                else BF16_ULPS * torch.finfo(tdt).eps * np.abs(w).max())
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=atol, err_msg=name)


def test_plain_and_flash_routes_are_differentiable():
    # the dispatcher's two routes give the same gradients (fp32, CPU)
    q, k, v, do = (torch.from_numpy(x) for x in _arrays(300, 576, 2, seed=1))
    grads = []
    for use_flash in (False, True):
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        out = attention.dot_product_attention(*qkv, use_flash=use_flash)
        grads.append(torch.autograd.grad(out, qkv, do))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5)


def test_no_function_when_autograd_is_off():
    # generate runs under inference_mode: the forward is called directly
    q = torch.randn(1, 128, 2, 64, requires_grad=True)
    with torch.inference_mode():
        assert fa.flash_attention(q, q, q).grad_fn is None
    with torch.no_grad():
        assert fa.flash_attention(q, q, q).grad_fn is None
    grad_fn = fa.flash_attention(q, q, q).grad_fn
    assert type(grad_fn).__name__ == "FlashAttentionFunctionBackward"


@pytest.mark.parametrize("d", [32, 128, 512])
def test_head_dim_512_backward_raises_naming_item_9(d):
    # the CPU backward at head dims other than the kernels' 64 (512 is the VAE
    # decoder's mid attention): the plain backward, against jax.vjp of the
    # Pallas kernels, in fp32 and bf16 (the name dates from when the port
    # refused every head dim but 64, even on the CPU)
    q, k, v, do = _arrays(256, 256, 1, seed=d, d=d)
    for dtype in ("float32", "bfloat16"):
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        jq, jk, jv, jdo = (jnp.asarray(x).astype(jdt) for x in (q, k, v, do))
        _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, interpret=True), jq, jk, jv)
        want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jdo)]
        tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v))
        launches = sum(fa.flash_attention_bwd.launches.values())
        got = torch.autograd.grad(fa.flash_attention(tq, tk, tv), (tq, tk, tv),
                                  torch.from_numpy(do).to(tdt))
        assert sum(fa.flash_attention_bwd.launches.values()) == launches  # the CPU launches nothing
        for g, w, name in zip(got, want, ("dq", "dk", "dv")):
            assert g.dtype == tdt and g.shape == w.shape
            atol = (FP32_ATOL if dtype == "float32"
                    else BF16_ULPS * torch.finfo(tdt).eps * np.abs(w).max())
            np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=atol,
                                       err_msg=f"{dtype} {name}")


@pytest.mark.parametrize("sq", [1, 64, 300])
def test_bwd_vectors_pad_lse_and_delta_to_whole_tiles(sq):
    # the kernels read lse and delta as [B, H, Sq_pad], Sq padded with zeros
    # to whole 64-row tiles, so that one tile's values are one aligned run
    gen = torch.Generator().manual_seed(sq)
    lse, delta = (torch.randn((2, sq, 3), generator=gen) for _ in range(2))
    sq_pad = -(-sq // fa.BWD_TILE) * fa.BWD_TILE
    for x, laid in zip((lse, delta), fa.bwd_vectors(lse, delta)):
        assert laid.shape == (2, 3, sq_pad) and laid.dtype == torch.float32
        assert laid.is_contiguous()
        torch.testing.assert_close(laid[..., :sq], x.permute(0, 2, 1), rtol=0, atol=0)
        assert not laid[..., sq:].any()


def _split(x, dt, single_part):
    """How the kernels feed an fp32 operand to the 16-bit tensor cores:
    hi + lo, or hi alone (a fault)."""
    hi = x.to(dt).float()
    return hi if single_part else hi + (x - hi).to(dt).float()


def _emulated_bwd(q, k, v, o, lse, do, tile=fa.BWD_TILE, kv_tile=fa.BWD_TILE, k_step=16,
                  d_split=1, drop_q_tile=None, no_delta=False, double_scale=False,
                  single_part=False):
    """The CUDA kernels' algorithm in plain PyTorch: dK/dV summed over q
    tiles of `tile` rows (the height of the dK/dV kernel's ring), dQ over kv
    tiles of `kv_tile` rows (the dQ kernel's), S and dP each the sum, in a
    fixed order, of `d_split` fp32 partials over equal parts of d (the
    consumers that split it), P and dS fed to the products as 16-bit
    hi + lo, fp32 accumulation in the wgmma kernels' order: each `k_step` of
    a tile's reduction adds its hi product and then its lo product to the
    fp32 accumulator (k_step=None: hi + lo summed first, one product per
    tile). The last four keyword arguments inject faults."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = torch.zeros_like(lse) if no_delta else fa.attention_delta(o, do)

    def logits(a, b):
        # a b^T over d, as d_split partials added in order
        parts = zip(a.chunk(d_split, dim=-1), b.chunk(d_split, dim=-1))
        out = None
        for ap, bp in parts:
            part = torch.einsum("bqhd,bkhd->bhqk", ap, bp)
            out = part if out is None else out + part
        return out

    def p_ds(qs, ks, vs, dos, lse_s, delta_s):
        s = logits(qs, ks) * scale
        p = torch.exp(s - lse_s.permute(0, 2, 1)[..., None])
        dp = logits(dos, vs)
        return p, p * (dp - delta_s.permute(0, 2, 1)[..., None])

    def add_product(acc, eq, x, y, axis):
        # acc += x . y, reduced over `axis` of x and axis 1 of y
        if k_step is None:
            acc += torch.einsum(eq, _split(x, dt, single_part), y)
            return
        n = x.shape[axis]
        for s0 in range(0, n, k_step):
            xs, ys = x.narrow(axis, s0, min(k_step, n - s0)), y.narrow(1, s0, min(k_step, n - s0))
            hi = xs.to(dt).float()
            acc += torch.einsum(eq, hi, ys)
            if not single_part:
                acc += torch.einsum(eq, (xs - hi).to(dt).float(), ys)

    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for i, q0 in enumerate(range(0, q.shape[1], tile)):
        if i == drop_q_tile:
            continue
        sl = slice(q0, q0 + tile)
        p, ds = p_ds(qf[:, sl], kf, vf, dof[:, sl], lse[:, sl], delta[:, sl])
        add_product(dv, "bhqk,bqhd->bkhd", p, dof[:, sl], 2)
        add_product(dk, "bhqk,bqhd->bkhd", ds, qf[:, sl], 2)
    dq = torch.zeros_like(qf)
    for k0 in range(0, k.shape[1], kv_tile):
        sl = slice(k0, k0 + kv_tile)
        _, ds = p_ds(qf, kf[:, sl], vf[:, sl], dof, lse, delta)
        add_product(dq, "bhqk,bkhd->bqhd", ds, kf[:, sl], 3)
    dk_scale = scale * scale if double_scale else scale
    return (dq * scale).to(dt), (dk * dk_scale).to(dt), (dv).to(dt)


@pytest.mark.parametrize("sq,sk,h,dtype", [(1024, 1024, 5, torch.bfloat16),
                                           (640, 576, 2, torch.bfloat16),
                                           (1024, 1024, 2, torch.float16),
                                           # the wgmma kernels' edges: q off the q tile
                                           # (64 rows) and the dQ kernel's 128-row one,
                                           # kv below and across the dK/dV kernel's
                                           # 128-row kv block
                                           (300, 1024, 2, torch.bfloat16),
                                           (300, 1024, 2, torch.float16),
                                           (320, 100, 3, torch.bfloat16),
                                           (256, 300, 2, torch.float16)])
def test_grad_tolerance_accepts_the_kernels_rounding_and_rejects_faults(sq, sk, h, dtype):
    gen = torch.Generator().manual_seed(sq + h)
    q = torch.randn((1, sq, h, 64), generator=gen).to(dtype)
    k, v = (torch.randn((1, sk, h, 64), generator=gen).to(dtype) for _ in range(2))
    do = torch.randn((1, sq, h, 64), generator=gen).to(dtype)
    o, lse = fa.flash_attention_reference(q, k, v, with_lse=True)
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
    bounds = [fa.grad_tolerance(r) for r in ref]

    def shares(got):      # the largest share of the bound each gradient uses
        return [((g.float() - r.float()).abs() / b).max().item()
                for g, r, b in zip(got, ref, bounds)]

    assert max(shares(_emulated_bwd(q, k, v, o, lse, do))) < 1.0
    dq, dk, dv = shares(_emulated_bwd(q, k, v, o, lse, do, drop_q_tile=3))
    assert dk > 1.0 and dv > 1.0
    dq, dk, dv = shares(_emulated_bwd(q, k, v, o, lse, do, no_delta=True))
    assert dq > 1.0 and dk > 1.0
    assert shares(_emulated_bwd(q, k, v, o, lse, do, double_scale=True))[1] > 1.0
    assert max(shares(_emulated_bwd(q, k, v, o, lse, do, single_part=True))) > 1.0


@pytest.mark.parametrize("sq,sk,dtype", [(529, 529, torch.bfloat16),
                                         (1024, 1024, torch.float16),
                                         (200, 1024, torch.bfloat16),
                                         # q and kv off the 64-row blocks and
                                         # the 16-row streamed tiles
                                         (300, 1000, torch.bfloat16)])
def test_grad_tolerance_holds_the_d512_kernels_tiling(sq, sk, dtype):
    # the d = 512 pair (csrc/flash_bwd_d512.cuh): 16-row q tiles (dK/dV) and
    # 16-row kv tiles (dQ), S and dP each the sum of two fp32 partials over
    # halves of d (the two consumers), P and dS as hi + lo per 16 rows; at the
    # face optimisation's shapes (crop 23: 529 tokens; crop 32: 1024), q
    # shorter than kv and both off the tiles, inside grad_tolerance, and its
    # faults outside
    gen = torch.Generator().manual_seed(sq + sk)
    q = torch.randn((1, sq, 1, 512), generator=gen).to(dtype)
    k, v = (torch.randn((1, sk, 1, 512), generator=gen).to(dtype) for _ in range(2))
    do = torch.randn((1, sq, 1, 512), generator=gen).to(dtype)
    o, lse = fa.flash_attention_reference(q, k, v, with_lse=True)
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
    bounds = [fa.grad_tolerance(r) for r in ref]

    def shares(got):
        return [((g.float() - r.float()).abs() / b).max().item()
                for g, r, b in zip(got, ref, bounds)]

    def emulated(**faults):
        return _emulated_bwd(q, k, v, o, lse, do, tile=16, kv_tile=16, k_step=16, d_split=2,
                             **faults)

    assert max(shares(emulated())) < 1.0
    dq, dk, dv = shares(emulated(drop_q_tile=2))
    assert dk > 1.0 and dv > 1.0
    dq, dk, dv = shares(emulated(no_delta=True))
    assert dq > 1.0 and dk > 1.0
    assert shares(emulated(double_scale=True))[1] > 1.0
    assert max(shares(emulated(single_part=True))) > 1.0
