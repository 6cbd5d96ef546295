"""The int8 matmul path (W8A8, dynamic per-token activation scales): port
of the JAX package's `ops/quant.py`.

  * symmetric per-output-channel weight quantisation: a torch weight is
    [out, in], so the scale is per row (the JAX kernel is [in, out], per
    column); the same weight gives the same int8 values and scales;
  * symmetric dynamic per-token activation quantisation in fp32;
  * the int8 x int8 -> int32 product (`torch._int_mm`, exact) with the
    dequantisation s_x * s_w after it.

`torch.round` rounds half to even, as `jnp.round` does, and every division
is a true division on every device (`_scale`), so the card, the CPU and the
JAX package give the same int8 values. On CUDA `torch._int_mm` takes more
than 16 rows and multiples of 8 in k and n; fewer rows are padded with zero
rows, which is exact.

Opt-in (`build_models(quant=True)`): it changes the numerics against the
bf16 path (about 1 % relative error per layer), as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# a symmetric range: -128 would be asymmetric
_QMAX = 127.0
# torch._int_mm on CUDA takes more than 16 rows
_MIN_ROWS = 17


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """max(|x|) / 127, floored at 1e-12. The divisor is a tensor on amax's
    device: CUDA computes a division by a Python number as a product with
    its reciprocal, which is not always the correctly rounded quotient
    (card and CPU then disagree on 1 in ~10^4 int8 values)."""
    return (amax / amax.new_tensor(_QMAX)).clamp_min(1e-12)


def quantize_weight(w: torch.Tensor):
    """Symmetric per-output-channel int8 quantisation of a torch weight
    [N, K] (out, in). Returns (w_q int8 [N, K], scale fp32 [N])."""
    w32 = w.float()
    s = _scale(w32.abs().amax(dim=1))
    wq = torch.round(w32 / s[:, None]).clamp(-_QMAX, _QMAX).to(torch.int8)
    return wq, s


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] (bf16/fp32) times the int8 weight [N, K] with dynamic
    per-token activation quantisation: scales max(|x|)/127 per token in
    fp32, the int32 product dequantised by s_x * s_w. Output [..., N] in
    x.dtype."""
    x32 = x.float()
    s_x = _scale(x32.abs().amax(dim=-1, keepdim=True))
    xq = torch.round(x32 / s_x).clamp(-_QMAX, _QMAX).to(torch.int8)
    rows = xq.reshape(-1, xq.shape[-1])
    m = rows.shape[0]
    if m < _MIN_ROWS:
        rows = F.pad(rows, (0, 0, 0, _MIN_ROWS - m))
    acc = torch._int_mm(rows, w_q.t())[:m].reshape(x.shape[:-1] + (w_q.shape[0],))
    out = acc.float() * (s_x * w_scale)
    return out.to(x.dtype)


def int8_dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None, *,
               quantized=None) -> torch.Tensor:
    """`F.linear(x, weight, bias)` through the int8 path. weight: the float
    [N, K] parameter, quantised here unless `quantized` (its
    `quantize_weight`) is given; the bias is added in x.dtype."""
    wq, ws = quantized if quantized is not None else quantize_weight(weight)
    out = int8_matmul(x, wq, ws)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def int8_geglu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None, *,
               quantized=None) -> torch.Tensor:
    """The GEGLU projection through the int8 path: weight [2N, K] holds
    [W_value; W_gate]; returns (x Wv + bv) * gelu_exact(x Wg + bg), [..., N]
    (models/layers.py::GEGLU's split order)."""
    out = int8_dense(x, weight, bias, quantized=quantized)
    value, gate = out.chunk(2, dim=-1)
    return value * F.gelu(gate)
