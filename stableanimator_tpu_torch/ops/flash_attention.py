"""Flash-attention forward: the hand-written Hopper kernel and its plain
version.

The kernel (`csrc/flash_attention_fwd.cu`) replaces the JAX package's
Pallas kernel `stableanimator_tpu/ops/flash_attention.py::_fwd_kernel`. It
computes softmax((q * scale) k^T) v over [B, S, H, D] tensors with the TPU
kernel's rounding: q is scaled in fp32 and rounded to the input dtype,
softmax statistics and the accumulator are fp32, and P is rounded to the
input dtype before P.V. `with_lse` also returns the fp32 log-sum-exp
[B, Sq, H].

`flash_attention` launches the kernel for a CUDA tensor (bf16/fp16, head
dim 64 or 512) and raises on anything else; for a CPU tensor it computes
the plain version, `flash_attention_reference`, which is the same function
written with dense PyTorch ops (it materialises the S x S logits).
`kernel_tolerance` bounds how far a correct kernel's output may lie from
the plain version's.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from stableanimator_tpu_torch.ops import build

KERNEL_NAME = "flash_attention_fwd"
HEAD_DIMS = (64, 512)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1}


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float | None = None, with_lse: bool = False):
    """The kernel's exact function in plain PyTorch. q [B, Sq, H, D];
    k, v [B, Sk, H, D]. Returns o [B, Sq, H, D] (and lse [B, Sq, H] fp32)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
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
    eps = torch.finfo(ref.dtype).eps
    r = ref.float()
    return eps * r.abs() + 2.0 * eps * r.square().mean().sqrt()


@functools.lru_cache(maxsize=None)
def _kernel():
    """Build (first use only) and bind the C entry point."""
    lib = ctypes.CDLL(str(build.build_kernel(KERNEL_NAME)))
    fn = lib.sa_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_inputs(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"flash_attention kernel takes bf16/fp16, {name} is {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, S, H, D], got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: last dim must be contiguous")
        if any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: strides must be multiples of 8 elements and "
                             "the data 16-byte aligned")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if sq == 0 or k.shape[1] == 0 or b > 65535:
        raise ValueError(f"unsupported sizes q {tuple(q.shape)} k {tuple(k.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None, with_lse: bool = False):
    """Flash attention over [B, S, H, D] tensors (forward only).

    CUDA tensors go to the Hopper kernel, launched on the current stream
    without synchronising; CPU tensors to the plain version."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale, with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
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


def reset_launch_counts() -> None:
    flash_attention.launches = 0
    flash_attention.launches_by_shape.clear()


# kernel launches since the last reset, in all and by (B, Sq, Sk, H, D);
# the CPU path does not count
flash_attention.launches = 0
flash_attention.launches_by_shape = collections.Counter()
