"""Flash attention: the hand-written Hopper kernels and their plain
versions.

Forward: `csrc/flash_attention_fwd.cu` replaces the JAX package's Pallas
kernel `stableanimator_tpu/ops/flash_attention.py::_fwd_kernel`. It
computes softmax((q * scale) k^T) v over [B, S, H, D] tensors with the TPU
kernel's rounding: q is scaled in fp32 and rounded to the input dtype,
softmax statistics and the accumulator are fp32, and P is rounded to the
input dtype before P.V. `with_lse` also returns the fp32 log-sum-exp
[B, Sq, H]. Both head dims run Hopper designs: TMA loads through tensor
maps over the strided inputs, wgmma, a producer warpgroup and consumer
warpgroups. Head dim 64 (the UNet): three consumers of 64 q rows each. Head
dim 512 (the VAE decoder's mid block): one 64-row q tile per CTA and two
consumers that split d.

Backward: `csrc/flash_attention_bwd.cu` replaces `_bwd_dkv_kernel` and
`_bwd_dq_kernel` (driven there by `_flash_bwd`): from q, k, v, the output
o, its lse and the output gradient dO it computes, in fp32,
P = exp(s - lse), dP = dO V^T, delta = sum(dO * o), dS = P * (dP - delta),
dK = dS^T (scale q), dV = P^T dO and dQ = scale (dS K), with q * scale not
rounded (unlike the forward). Head dim 64 only. Both kernels are Hopper
designs (TMA loads into a ring of tiles, wgmma, a producer warpgroup and two
consumers); they read lse and delta as [B, H, Sq padded to 64]
(`bwd_vectors`).

Resident forward: `csrc/flash_attention_resident.cu` replaces
`_fwd_kernel_resident` (driven there by `_flash_fwd_resident`): the same
function and rounding as the streamed forward, with each K/V tile of one
(batch, head) fetched once for a thread-block cluster of 2 CTAs
(`RESIDENT_CLUSTER`), which take consecutive q tiles of that head, and
multicast by TMA into
the shared memory of each (the streamed kernel fetches it once per CTA).
The CTA program is the streamed d = 64 kernel's (`csrc/flash_fwd_d64.cuh`).
Head dim 64 only, any number of keys. `_flash_forward` routes a call to it
when two tests pass:
  (a) the JAX package's test, unchanged (`_use_resident`): one head step's
      padded K columns, kv_pad * heads_per_step * d * itemsize, fit the
      budget `SA_TPU_RESIDENT_KV_MAX_BYTES` (default 0, so off), read at
      call time so that one process can run both routes;
  (b) the kernel takes the call: d is 64.
A call that passes (a) and not (b) goes to the streamed kernel and is
counted in `flash_attention_resident.refused`; this is a routing rule (the
VAE decoder's 512-wide head), not a fallback from a failure.

`flash_attention` is differentiable: when autograd needs its gradient it
goes through `FlashAttentionFunction`, whose forward keeps the lse and whose
backward is `flash_attention_bwd`. Otherwise (inference) it calls the
forward directly. CUDA tensors go to the kernels, CPU tensors to the plain
versions `flash_attention_reference` / `flash_attention_bwd_reference`,
the same functions written with dense PyTorch ops (they materialise the
S x S logits); any other device raises. `kernel_tolerance` and
`grad_tolerance` bound how far a correct kernel's outputs may lie from the
plain versions'.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
import os

import torch

from stableanimator_tpu_torch.ops import build

KERNEL_NAME = "flash_attention_fwd"
HEAD_DIMS = (64, 512)
# the backward kernels: one source, two kernels
BWD_SOURCE = "flash_attention_bwd"
DKV_KERNEL = "flash_attention_bwd_dkv"
DQ_KERNEL = "flash_attention_bwd_dq"
BWD_HEAD_DIMS = (64,)
# the backward kernels' streamed tiles: q rows (dK/dV) and kv rows (dQ); lse
# and delta are padded to a whole number of them
BWD_TILE = 64
# the resident forward, and its CTAs per cluster (each K/V tile is fetched
# once for them; the kernel's compile-time CLUSTER)
RESIDENT_KERNEL = "flash_attention_resident"
RESIDENT_HEAD_DIMS = (64,)
RESIDENT_CLUSTER = 2
RESIDENT_BUDGET_ENV = "SA_TPU_RESIDENT_KV_MAX_BYTES"
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1}


def _default_scale(q: torch.Tensor, scale: float | None) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float | None = None, with_lse: bool = False):
    """The kernel's exact function in plain PyTorch. q [B, Sq, H, D];
    k, v [B, Sk, H, D]. Returns o [B, Sq, H, D] (and lse [B, Sq, H] fp32)."""
    scale = _default_scale(q, scale)
    qs = (q.float() * scale).to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    m = s.amax(dim=-1, keepdim=True)
    p = s.sub_(m).exp_()                                  # in place: S is large
    l = p.sum(dim=-1, keepdim=True)                       # [B, H, Sq, 1]
    p = p.to(v.dtype).float()                             # P rounded as in the kernel
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    del p
    o = (o / l.permute(0, 2, 1, 3)).to(q.dtype)
    if with_lse:
        return o, (m + torch.log(l)).squeeze(-1).permute(0, 2, 1).contiguous()
    return o


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = sum over the head dim of dO * o, fp32 [B, Sq, H]."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_attention_bwd_reference(q, k, v, o, lse, do, scale: float | None = None):
    """The backward kernels' exact function in plain PyTorch (the JAX
    package's `_flash_bwd`): q, o, dO [B, Sq, H, D]; k, v [B, Sk, H, D];
    lse [B, Sq, H] fp32. Everything in fp32, q * scale not rounded; returns
    (dq, dk, dv) in the input dtypes."""
    scale = _default_scale(q, scale)
    qs = q.float() * scale
    dof = do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    p = s.sub_(lse.float().permute(0, 2, 1)[..., None]).exp_()        # in place: S is large
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = dp.sub_(attention_delta(o, do).permute(0, 2, 1)[..., None]).mul_(p)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    del p
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _tolerance(ref: torch.Tensor, rms_share: float) -> torch.Tensor:
    eps = torch.finfo(ref.dtype).eps
    r = ref.float()
    return eps * r.abs() + rms_share * eps * r.square().mean().sqrt()


def kernel_tolerance(ref: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |kernel output - ref| for `ref`, the plain
    version's bf16/fp16 output on the same inputs.

    Both round P and the output to the 16-bit dtype, but the kernel rounds
    P = exp(s - m) at its running row max m, the plain version at the final
    one. So a correct kernel may differ by one output ulp (at most
    eps * |ref|) plus the sum over the keys of P's rounding differences,
    which is a fraction of eps times the output's rms: the bound allows
    2 * eps * rms. eps is 2^-7 for bf16 and 2^-10 for fp16. The CPU tests
    hold an online-softmax emulation of the kernel inside this bound and
    faulty ones (a kv tile dropped or mis-weighted, a bf16 P.V accumulator)
    outside it."""
    return _tolerance(ref, 2.0)


def grad_tolerance(ref: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on |kernel gradient - ref| for `ref`, one of the
    plain backward's bf16/fp16 gradients (dq, dk or dv) on the same inputs.

    The kernels feed P and dS, which are fp32, to the 16-bit tensor cores
    as a sum of two 16-bit parts (hi = round(x), lo = round(x - hi)), so
    each product is exact to about eps^2 relative, and they accumulate in
    fp32 in another order than the plain version. Their fp32 gradients
    therefore differ from the plain version's by far less than one output
    ulp, and after both round to the 16-bit dtype by at most one ulp
    (eps * |ref|, eps 2^-7 bf16, 2^-10 fp16). The bound adds eps/4 of the
    gradient's rms for the fp32 differences near a rounding boundary and
    for elements near zero. The CPU tests hold an emulation of the kernels'
    tiling and rounding inside it, and faults outside it: a q tile dropped
    from dK/dV, delta left out, the scale applied twice, and P and dS
    rounded to a single 16-bit part."""
    return _tolerance(ref, 0.25)


@functools.lru_cache(maxsize=None)
def _kernel():
    """Build (first use only) and bind the forward's C entry point."""
    lib = ctypes.CDLL(str(build.build_kernel(KERNEL_NAME)))
    fn = lib.sa_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_kernels() -> dict:
    """Build (first use only) and bind the backward's two C entry points.
    Both take (q, k, v, dO, lse, delta, dq, dk, dv, dtype, b, sq, sk, h, d,
    strides[21], scale, stream), lse and delta as `bwd_vectors` lays them
    out; dkv leaves dq null, dq leaves dk, dv null."""
    lib = ctypes.CDLL(str(build.build_kernel(BWD_SOURCE)))
    fns = {}
    for name, symbol in ((DKV_KERNEL, "sa_flash_attention_bwd_dkv"),
                         (DQ_KERNEL, "sa_flash_attention_bwd_dq")):
        fn = getattr(lib, symbol)
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


@functools.lru_cache(maxsize=None)
def _resident_lib():
    """Build (first use only) and bind the resident forward's C entry points:
    the kernel (the streamed one's arguments) and its occupancy query
    (int* count)."""
    lib = ctypes.CDLL(str(build.build_kernel(RESIDENT_KERNEL)))
    lib.sa_flash_attention_resident.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_void_p])
    lib.sa_flash_attention_resident_max_clusters.argtypes = [ctypes.c_void_p]
    for fn in (lib.sa_flash_attention_resident, lib.sa_flash_attention_resident_max_clusters):
        fn.restype = ctypes.c_int
    return lib


def resident_max_clusters() -> int:
    """How many clusters of `RESIDENT_CLUSTER` resident-kernel CTAs the card
    runs at once (`cudaOccupancyMaxActiveClusters`; each CTA takes one SM)."""
    count = ctypes.c_int(0)
    err = _resident_lib().sa_flash_attention_resident_max_clusters(ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"{RESIDENT_KERNEL} occupancy query failed: cudaError {err}")
    return count.value


# ---------------------------------------------------------------------------
# routing between the streamed and the resident forward
# ---------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pick_blocks(q_len: int, kv_len: int, hd: int = 64) -> tuple[int, int]:
    """The JAX package's VMEM-budgeted (block_q, block_k) (copy of
    `ops/flash_attention.py::_pick_blocks`); test (a) pads kv to block_k."""
    if hd <= 512:
        bq, bk = 512, 1024
    elif hd <= 1024:
        bq, bk = 256, 1024
    else:
        bq, bk = 256, 512
    return min(bq, _round_up(q_len, 128)), min(bk, _round_up(kv_len, 128))


def _resident_heads_per_step(h: int, d: int) -> tuple[int, int]:
    """(heads_per_step, padded head count) of the JAX resident kernel (copy
    of `_resident_heads_per_step`): d = 64 heads go in pairs."""
    if d % 128 == 0:
        return 1, h
    if 128 % d == 0:
        per = 128 // d
        return per, -(-h // per) * per
    return h, h


def resident_kv_budget() -> int:
    """The resident route's budget in bytes, read now from
    SA_TPU_RESIDENT_KV_MAX_BYTES (default 0: the route is off)."""
    return int(os.environ.get(RESIDENT_BUDGET_ENV, 0))


def passes_resident_budget(q_shape, k_shape, itemsize: int, budget: int | None = None) -> bool:
    """Test (a), the JAX package's `_use_resident`: one head step's padded
    K columns, kv_pad * heads_per_step * d * itemsize, fit the budget."""
    d = q_shape[-1]
    heads_per_step, _ = _resident_heads_per_step(q_shape[2], d)
    kv_pad = _round_up(k_shape[1], _pick_blocks(q_shape[1], k_shape[1], heads_per_step * d)[1])
    budget = resident_kv_budget() if budget is None else budget
    return kv_pad * heads_per_step * d * itemsize <= budget


def resident_kernel_takes(q_shape) -> bool:
    """Test (b): the resident kernel takes the call, d being 64 (it streams
    K and V through its ring, so any number of keys)."""
    return q_shape[-1] in RESIDENT_HEAD_DIMS


def resident_route(q_shape, k_shape, itemsize: int, budget: int | None = None) -> str:
    """"resident" when tests (a) and (b) pass, "refused" when (a) passes and
    (b) does not (the call then takes the streamed kernel), else
    "streamed"."""
    if not passes_resident_budget(q_shape, k_shape, itemsize, budget):
        return "streamed"
    return "resident" if resident_kernel_takes(q_shape) else "refused"


def _check_layout(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, q is {dtype}")
    if t.dim() != 4:
        raise ValueError(f"{name} must be [B, S, H, D], got {tuple(t.shape)}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: last dim must be contiguous")
    if any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{name}: strides must be multiples of 8 elements and "
                         "the data 16-byte aligned")


def _check_cuda_inputs(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"flash_attention kernel takes bf16/fp16, {name} is {t.dtype}")
        _check_layout(name, t, q.dtype)
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if sq == 0 or k.shape[1] == 0 or b > 65535:
        raise ValueError(f"unsupported sizes q {tuple(q.shape)} k {tuple(k.shape)}")


def _device_of(q: torch.Tensor, what: str) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {q.device}")
    return q.device.type


def _flash_forward(q, k, v, scale: float, with_lse: bool):
    """A forward kernel for a CUDA tensor (launched on the current stream
    without synchronising), the plain version for a CPU tensor. CUDA calls
    take the resident kernel when `resident_route` says so; the others the
    streamed kernel."""
    if _device_of(q, "flash_attention") == "cpu":
        return flash_attention_reference(q, k, v, scale, with_lse)
    route = resident_route(q.shape, k.shape, q.element_size())
    if route == "resident":
        return flash_attention_resident(q, k, v, scale, with_lse)
    if route == "refused":
        flash_attention_resident.refused += 1
    _check_cuda_inputs(q, k, v)
    b, sq, h, d = q.shape
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
           if with_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        _DTYPE_CODES[q.dtype], b, sq, k.shape[1], h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        float(scale), stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL_NAME} launch failed: cudaError {err} "
                           f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype})")
    flash_attention.launches += 1
    flash_attention.launches_by_shape[(b, sq, k.shape[1], h, d)] += 1
    return (o, lse) if with_lse else o


def flash_attention_resident(q, k, v, scale: float | None = None, with_lse: bool = False):
    """The resident-K/V forward: the streamed forward's function, with each
    K/V tile of a (batch, head) fetched once for a cluster of
    `RESIDENT_CLUSTER` CTAs and multicast into each.

    A CUDA tensor goes to the kernel (launched on the current stream without
    synchronising); a head dim other than 64 raises, and so does a cluster
    launch the driver refuses. A CPU tensor gets the
    plain version, `flash_attention_reference`."""
    scale = _default_scale(q, scale)
    if _device_of(q, "flash_attention_resident") == "cpu":
        return flash_attention_reference(q, k, v, scale, with_lse)
    _check_cuda_inputs(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if not resident_kernel_takes(q.shape):
        raise ValueError(f"the resident kernel takes head dims {RESIDENT_HEAD_DIMS}, got q "
                         f"{tuple(q.shape)}")
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
           if with_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _resident_lib().sa_flash_attention_resident(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        _DTYPE_CODES[q.dtype], b, sq, sk, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        float(scale), stream)
    if err != 0:
        raise RuntimeError(f"{RESIDENT_KERNEL} launch failed: cudaError {err} "
                           f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype})")
    flash_attention_resident.launches += 1
    flash_attention_resident.launches_by_shape[(b, sq, sk, h, d)] += 1
    return (o, lse) if with_lse else o


def flash_attention_bwd(q, k, v, o, lse, do, scale: float | None = None):
    """Gradients (dq, dk, dv) of flash attention, from the forward's inputs,
    its output o and lse, and the output gradient dO.

    CPU tensors get the plain version at any head dim. CUDA tensors go to
    the two Hopper kernels (dK/dV, then dQ), launched on the current stream
    without synchronising; they take head dim 64 only, and another raises
    NotImplementedError."""
    scale = _default_scale(q, scale)
    if _device_of(q, "flash_attention_bwd") == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, scale)
    d = q.shape[-1]
    if d not in BWD_HEAD_DIMS:
        raise NotImplementedError(
            f"flash-attention backward on the card for head dim {d}: the kernels take "
            f"{BWD_HEAD_DIMS}; the d = 512 backward kernel (the VAE decoder's mid attention) "
            "is not written yet")
    grads, launch = bwd_launchers(q, k, v, o, lse, do, scale)
    for name in (DKV_KERNEL, DQ_KERNEL):
        launch[name]()
    return grads


def bwd_vectors(lse: torch.Tensor, delta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """lse and delta ([B, Sq, H] fp32) as the backward kernels read them:
    [B, H, Sq_pad] fp32, contiguous, Sq padded with zeros to a multiple of
    `BWD_TILE`, so that one tile's values are one 16-byte-aligned run that
    TMA can copy (the [B, Sq, H] rows are 4 H bytes apart). `contiguous`
    because a pad of 0 keeps the permuted strides."""
    pad = _round_up(lse.shape[1], BWD_TILE) - lse.shape[1]
    return tuple(torch.nn.functional.pad(x.permute(0, 2, 1), (0, pad)).contiguous()
                 for x in (lse, delta))


def bwd_launchers(q, k, v, o, lse, do, scale: float):
    """Checks the CUDA inputs, computes delta and allocates dq, dk, dv;
    returns them and, by kernel name, a callable that launches that kernel
    into them (and counts the launch). `flash_attention_bwd` calls both;
    a benchmark can time each alone."""
    _check_cuda_inputs(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"the backward kernels take head dims {BWD_HEAD_DIMS}, got {d}")
    do = do.contiguous()
    for name, t in (("o", o), ("dO", do)):
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device} does not match q "
                             f"{tuple(q.shape)} on {q.device}")
    _check_layout("dO", do, q.dtype)
    if lse.shape != (b, sq, h) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 [B, Sq, H], got {lse.dtype} {tuple(lse.shape)}")
    lse, delta = bwd_vectors(lse, attention_delta(o, do))
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=q.device)
    strides = (ctypes.c_longlong * 21)(*(st for t in (q, k, v, do, dq, dk, dv)
                                         for st in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    fns = _bwd_kernels()

    def launcher(name, outs):
        def launch():
            err = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                            lse.data_ptr(), delta.data_ptr(), *outs,
                            _DTYPE_CODES[q.dtype], b, sq, sk, h, d, strides, float(scale),
                            stream)
            if err != 0:
                raise RuntimeError(f"{name} launch failed: cudaError {err} "
                                   f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype})")
            flash_attention_bwd.launches[name] += 1
            flash_attention_bwd.launches_by_shape[(name, (b, sq, sk, h, d))] += 1
        return launch

    return (dq, dk, dv), {DKV_KERNEL: launcher(DKV_KERNEL, (None, dk.data_ptr(), dv.data_ptr())),
                          DQ_KERNEL: launcher(DQ_KERNEL, (dq.data_ptr(), None, None))}


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention under autograd (the JAX package's custom VJP
    `_flash_attention_core`): the forward runs with lse and keeps q, k, v,
    o and lse; the backward is `flash_attention_bwd`. Returns (o, lse);
    lse is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        o, lse = _flash_forward(q, k, v, scale, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None, with_lse: bool = False):
    """Flash attention over [B, S, H, D] tensors, differentiable in q, k, v.

    When autograd records (grad enabled and an input requires grad) the call
    goes through `FlashAttentionFunction`; otherwise straight to the
    forward kernel (CUDA) or its plain version (CPU)."""
    scale = _default_scale(q, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        o, lse = FlashAttentionFunction.apply(q, k, v, scale)
        return (o, lse) if with_lse else o
    return _flash_forward(q, k, v, scale, with_lse)


def reset_launch_counts() -> None:
    """Zero the forward kernels' and the backward's launch counters and the
    resident route's refusals."""
    flash_attention.launches = 0
    flash_attention.launches_by_shape.clear()
    flash_attention_resident.launches = 0
    flash_attention_resident.launches_by_shape.clear()
    flash_attention_resident.refused = 0
    flash_attention_bwd.launches.clear()
    flash_attention_bwd.launches_by_shape.clear()


# kernel launches since the last reset; the CPU path does not count.
# forward (streamed and resident): in all and by (B, Sq, Sk, H, D);
# backward: by kernel name and by (kernel name, (B, Sq, Sk, H, D)); and the
# CUDA calls that passed the resident budget but not the card's capacity
flash_attention.launches = 0
flash_attention.launches_by_shape = collections.Counter()
flash_attention_resident.launches = 0
flash_attention_resident.launches_by_shape = collections.Counter()
flash_attention_resident.refused = 0
flash_attention_bwd.launches = collections.Counter()
flash_attention_bwd.launches_by_shape = collections.Counter()
