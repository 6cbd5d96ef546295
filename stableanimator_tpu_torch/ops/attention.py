"""Attention dispatch over [B, S, H, D] tensors (port of the JAX package's
`ops/attention.py`).

Long 16-bit attentions on the card go to the flash kernel; everything else
(temporal attention over the frames, ID cross-attention over a few keys,
UNet level 2, fp32 islands such as the VAE encoder) takes the plain path,
which rounds as the JAX package's `xla_attention` does: fp32 logits scaled
after the product, fp32 softmax, probabilities cast to the q dtype before
P.V.
"""

from __future__ import annotations

import math

import torch

from stableanimator_tpu_torch.ops.flash_attention import flash_attention

# below this many kv tokens the kernel has nothing to win (same cut-over as
# the JAX package)
FLASH_MIN_SEQ = 512


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """Reference-math attention, fp32 softmax. [B, S, H, D]."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float | None = None,
                          use_flash: bool | None = None) -> torch.Tensor:
    """Attention over [B, S, H, D]. use_flash True/False forces the path;
    None routes to the kernel for CUDA tensors with kv >= 512, q >= 128 and
    a 16-bit dtype."""
    if use_flash is None:
        use_flash = (q.is_cuda and k.shape[1] >= FLASH_MIN_SEQ
                     and q.shape[1] >= 128 and q.element_size() == 2)
    if use_flash:
        return flash_attention(q, k, v, scale=scale)
    return plain_attention(q, k, v, scale=scale)
