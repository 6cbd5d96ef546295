"""Normalisation with explicit fp32 statistics (port of the JAX package's
`ops/norms.py`), and its fused CUDA kernels.

The plain versions (`group_norm_reference`, `layer_norm_reference`):
statistics are accumulated in float32; the per-channel affine is folded
with the per-group statistics into `x * a + b`, and that multiply-add runs
in the input dtype. `torch.nn.GroupNorm` in bf16 rounds elsewhere and
drifts from this, so the port does not use it.

The kernels (`csrc/norms.cu`) compute the same fold with the statistics,
a, b and the multiply-add in fp32 and round once on the way out, SiLU
included where the caller asks for it: they read a 16-bit tensor once or
twice and write it once, where the plain versions make six or seven passes.
They replace no TPU kernel (the JAX package leaves these norms to XLA).

`group_norm` and `layer_norm` route a call to a kernel when the tensor is
on CUDA and 16-bit, its statistics are its own (no `stats_group`), and
autograd does not record the call (the kernels have no backward: training
keeps the plain versions). Every other call takes the plain version. A
kernel call is the custom op `torch.ops.stableanimator.group_norm_fwd` /
`layer_norm_fwd`, eager or traced by `torch.export` (or `torch.compile`),
which keeps it as one node and runs it as the kernel (the plain version
for a CPU tensor). A call the kernel should take and cannot (a width past
its registers or shared memory, more than 65535 samples) raises.

Counters, since `reset_counts`: `kernel_calls` and `launches_by_shape`
count the kernels' launches where they are made, so an exported program
counts each run; `eager_calls` counts the CUDA calls that ran the plain
version eagerly (a trace's calls are not runs and count nothing). The
CPU counts in none.

Channels-last layout: inputs are [N, ..., C]; GroupNorm reduces over all
non-batch axes within each contiguous channel group.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.distributed as dist
import torch.nn.functional as F

from stableanimator_tpu_torch.ops import build
from stableanimator_tpu_torch.parallel.sequence import all_reduce_sum

KERNEL_NAME = "norms"
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1}
# elements a load: the widest of these that divides C
VECTORS = (8, 4, 2, 1)
# GroupNorm: a CTA's threads at most (the kernels' launch bound; C / V of
# them own a row), the threads a CTA aims for, the rows each thread takes at
# least, and the full waves of the card a launch aims for (a sweep of both
# on the H100 at the request path's shapes: PERF.md)
GN_MAX_THREADS = 512        # csrc/norms.cu's kGnMaxThreads
GN_STEP_THREADS = 256
GN_MIN_ROWS_PER_THREAD = 16
GN_WAVES = 1
SM_THREADS = 2048           # resident threads an SM holds (Hopper)
# LayerNorm: vectors a lane holds at most (the row stays in registers), its
# CTAs' warps (a row a warp at a time), and its CTAs an SM at most (the
# warps stride over the rows past them)
LN_MAX_VECTORS = 8
LN_WARPS = 8                # csrc/norms.cu's kLnWarps
LN_CTAS_PER_SM = 32


def group_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         num_groups: int = 32, eps: float = 1e-5, stats_group=None,
                         silu: bool = False) -> torch.Tensor:
    """The plain version of `group_norm` (its arguments), in PyTorch ops."""
    n, c = x.shape[0], x.shape[-1]
    if c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by num_groups {num_groups}")
    cg = c // num_groups
    xg = x.reshape(n, -1, num_groups, cg)
    x32 = xg.float()
    if stats_group is None:
        mean = x32.mean(dim=(1, 3), keepdim=True)
        mean_sq = x32.square().mean(dim=(1, 3), keepdim=True)
    else:
        sums = torch.stack([x32.sum(dim=(1, 3), keepdim=True),
                            x32.square().sum(dim=(1, 3), keepdim=True)])
        sums = all_reduce_sum(sums, stats_group)
        sums = sums / (xg.shape[1] * cg * dist.get_world_size(stats_group))
        mean, mean_sq = sums[0], sums[1]
    del x32
    var = (mean_sq - mean.square()).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)                          # [n, 1, G, 1] fp32
    scale32 = weight.float().reshape(1, 1, num_groups, cg)
    a = inv * scale32
    b = bias.float().reshape(1, 1, num_groups, cg) - mean * a
    out = (xg * a.to(x.dtype) + b.to(x.dtype)).reshape(x.shape)
    return F.silu(out) if silu else out


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor | None,
                         bias: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
    """The plain version of `layer_norm`, in PyTorch ops."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    mean_sq = x32.square().mean(dim=-1, keepdim=True)
    del x32
    var = (mean_sq - mean.square()).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    a = inv * (weight.float() if weight is not None else 1.0)
    b = -mean * a + (bias.float() if bias is not None else 0.0)
    return x * a.to(x.dtype) + b.to(x.dtype)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-5, stats_group=None,
               silu: bool = False) -> torch.Tensor:
    """GroupNorm over a channels-last tensor x [N, *spatial, C], followed by
    SiLU when `silu`.

    stats_group: a process group whose ranks hold the other blocks of x's
    axes after N (equal blocks; the frame axis of a frame-sharded video,
    `parallel/sequence.py`): the statistics' two sums are all-reduced over
    it, so they cover the whole tensor, and so are their gradients in the
    backward (`sequence.all_reduce_sum`). Such a call takes the plain
    version; so does one that autograd records (module docstring)."""
    if stats_group is None and _takes_kernel(x, weight, bias):
        return torch.ops.stableanimator.group_norm_fwd(x, weight, bias, num_groups, eps, silu)
    if x.is_cuda and not torch.compiler.is_compiling():
        group_norm.eager_calls += 1
    return group_norm_reference(x, weight, bias, num_groups, eps, stats_group, silu)


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None,
               bias: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis: fp32 statistics; the affine in the
    input dtype (plain version) or in fp32 with one rounding (kernel)."""
    if _takes_kernel(x, weight, bias):
        return torch.ops.stableanimator.layer_norm_fwd(x, weight, bias, eps)
    if x.is_cuda and not torch.compiler.is_compiling():
        layer_norm.eager_calls += 1
    return layer_norm_reference(x, weight, bias, eps)


def reset_counts() -> None:
    """Zero both wrappers' counters (module docstring): `kernel_calls`,
    `eager_calls`, and `launches_by_shape`, keyed (N, rows, C, silu) for
    GroupNorm and (rows, C) for LayerNorm."""
    for fn in (group_norm, layer_norm):
        fn.kernel_calls = fn.eager_calls = 0
        fn.launches_by_shape = collections.Counter()


reset_counts()


def _takes_kernel(x: torch.Tensor, *params) -> bool:
    """A CUDA 16-bit tensor whose call autograd does not record."""
    if not (x.is_cuda and x.dtype in _DTYPE_CODES):
        return False
    return not (torch.is_grad_enabled()
                and (x.requires_grad or any(p is not None and p.requires_grad for p in params)))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def vector_width(c: int) -> int:
    """Elements a kernel loads or stores at once: the widest of `VECTORS`
    that divides C (the wrappers hand the kernels 16-byte aligned data, so
    every row starts on such a vector)."""
    return next(v for v in VECTORS if c % v == 0)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned: as it is, else copied (a view off
    an aligned address would otherwise fault the kernels' vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def group_norm_geometry(n: int, rows: int, c: int, vec: int, sms: int) -> dict:
    """The GroupNorm kernels' launch over x [n, rows, c] at `vec` elements a
    load on a card of `sms` SMs: `threads` a CTA, `rpb` rows it takes a step
    (c / vec threads a row), and each sample cut into `splits` ranges of
    `rows_per_split` whole rows, so that the n x splits CTAs make about
    `GN_WAVES` full waves of the card, each thread taking at least
    `GN_MIN_ROWS_PER_THREAD` rows. Raises where a row has more vectors than
    a CTA has threads."""
    vpr = c // vec
    if vpr > GN_MAX_THREADS:
        raise ValueError(f"group_norm kernel: {c} channels at {vec} a load need {vpr} threads a "
                         f"row, more than its {GN_MAX_THREADS}")
    if n > 65535:
        raise ValueError(f"group_norm kernel: {n} samples, more than 65535")
    rpb = max(1, GN_STEP_THREADS // vpr)
    threads = _round_up(vpr * rpb, 32)
    target = GN_WAVES * sms * (SM_THREADS // threads)
    splits = max(1, min(-(-target // n), -(-rows // (rpb * GN_MIN_ROWS_PER_THREAD))))
    rows_per_split = _round_up(-(-rows // splits), rpb)
    return dict(threads=threads, rpb=rpb, splits=-(-rows // rows_per_split),
                rows_per_split=rows_per_split)


def layer_norm_vectors(c: int, vec: int) -> int:
    """Vectors of `vec` elements a lane holds of a row of c; raises past
    `LN_MAX_VECTORS`."""
    k = -(-c // (32 * vec))
    if k > LN_MAX_VECTORS:
        raise ValueError(f"layer_norm kernel: a row of {c} at {vec} a load needs {k} vectors a "
                         f"lane, more than its {LN_MAX_VECTORS}")
    return k


def layer_norm_blocks(rows: int, sms: int) -> int:
    """The LayerNorm kernel's CTAs of `LN_WARPS` warps: a row a warp, at most
    `LN_CTAS_PER_SM` CTAs an SM (their warps then stride over the rows)."""
    return min(-(-rows // LN_WARPS), sms * LN_CTAS_PER_SM)


@functools.lru_cache(maxsize=None)
def _kernels():
    """Build (first use only) and bind the two C entry points."""
    lib = ctypes.CDLL(str(build.build_kernel(KERNEL_NAME)))
    gn = lib.sa_group_norm_fwd
    gn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int] * 5 + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])
    ln = lib.sa_layer_norm_fwd
    ln.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    gn.restype = ln.restype = ctypes.c_int
    return gn, ln


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _affine(t: torch.Tensor | None, c: int, what: str, x: torch.Tensor):
    """A weight or bias as the kernels read it: fp32 [c], contiguous, on x's
    device (None stays None)."""
    if t is None:
        return None
    if t.numel() != c or t.device != x.device:
        raise ValueError(f"{what} {tuple(t.shape)} on {t.device} does not fit x "
                         f"{tuple(x.shape)} on {x.device}")
    return _aligned(t.float())


def _group_norm_kernel(x, weight, bias, num_groups: int, eps: float, silu: bool):
    n, c = x.shape[0], x.shape[-1]
    if c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by num_groups {num_groups}")
    x = _aligned(x)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    rows = x.numel() // (n * c)
    w, b = _affine(weight, c, "weight", x), _affine(bias, c, "bias", x)
    vec = vector_width(c)
    geo = group_norm_geometry(n, rows, c, vec, _sm_count(x.device.index))
    part = torch.empty(n * num_groups * geo["splits"] * 3, dtype=torch.float32, device=x.device)
    stats = torch.empty(n * num_groups * 2, dtype=torch.float32, device=x.device)
    err = _kernels()[0](
        x.data_ptr(), y.data_ptr(), w.data_ptr() if w is not None else None,
        b.data_ptr() if b is not None else None, part.data_ptr(), stats.data_ptr(),
        _DTYPE_CODES[x.dtype], vec, int(silu), n, rows, c, num_groups, geo["threads"],
        geo["rpb"], geo["splits"], geo["rows_per_split"], float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"group_norm kernel launch failed: cudaError {err} (x {tuple(x.shape)}, "
                           f"{x.dtype}, {num_groups} groups, {geo})")
    group_norm.kernel_calls += 1
    group_norm.launches_by_shape[(n, rows, c, bool(silu))] += 1
    return y


def _layer_norm_kernel(x, weight, bias, eps: float):
    c = x.shape[-1]
    x = _aligned(x)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    w, b = _affine(weight, c, "weight", x), _affine(bias, c, "bias", x)
    vec = vector_width(c)
    k = layer_norm_vectors(c, vec)
    rows = x.numel() // c
    blocks = layer_norm_blocks(rows, _sm_count(x.device.index))
    err = _kernels()[1](
        x.data_ptr(), y.data_ptr(), w.data_ptr() if w is not None else None,
        b.data_ptr() if b is not None else None, _DTYPE_CODES[x.dtype], vec, k, rows, c, blocks,
        float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: cudaError {err} (x "
                           f"{tuple(x.shape)}, {x.dtype})")
    layer_norm.kernel_calls += 1
    layer_norm.launches_by_shape[(rows, c)] += 1
    return y


# The kernels as custom ops, the one route to them, eager or in a graph
# traced by torch.export or torch.compile (which cannot trace the ctypes
# call): their fake versions give the output's shape, and the op runs the
# kernel on CUDA tensors, the plain version on CPU ones.
@torch.library.custom_op("stableanimator::group_norm_fwd", mutates_args=())
def _group_norm_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int,
                   eps: float, silu: bool) -> torch.Tensor:
    if x.is_cuda:
        return _group_norm_kernel(x, weight, bias, num_groups, eps, silu)
    return group_norm_reference(x, weight, bias, num_groups, eps, None, silu)


@_group_norm_op.register_fake
def _(x, weight, bias, num_groups, eps, silu):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


@torch.library.custom_op("stableanimator::layer_norm_fwd", mutates_args=())
def _layer_norm_op(x: torch.Tensor, weight: torch.Tensor | None, bias: torch.Tensor | None,
                   eps: float) -> torch.Tensor:
    if x.is_cuda:
        return _layer_norm_kernel(x, weight, bias, eps)
    return layer_norm_reference(x, weight, bias, eps)


@_layer_norm_op.register_fake
def _(x, weight, bias, eps):
    return torch.empty_like(x, memory_format=torch.contiguous_format)
