"""Normalisation with explicit fp32 statistics (port of the JAX package's
`ops/norms.py`).

Statistics are accumulated in float32; the per-channel affine is folded
with the per-group statistics into `x * a + b`, and that multiply-add runs
in the input dtype. `torch.nn.GroupNorm` in bf16 rounds elsewhere and
drifts from this, so the port does not use it.

Channels-last layout: inputs are [N, ..., C]; GroupNorm reduces over all
non-batch axes within each contiguous channel group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from stableanimator_tpu_torch.parallel.sequence import all_reduce_sum


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-5, stats_group=None) -> torch.Tensor:
    """GroupNorm over a channels-last tensor x [N, *spatial, C].

    stats_group: a process group whose ranks hold the other blocks of x's
    axes after N (equal blocks; the frame axis of a frame-sharded video,
    `parallel/sequence.py`): the statistics' two sums are all-reduced over
    it, so they cover the whole tensor, and so are their gradients in the
    backward (`sequence.all_reduce_sum`)."""
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
    out = xg * a.to(x.dtype) + b.to(x.dtype)
    return out.reshape(x.shape)


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None,
               bias: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis: fp32 statistics, affine applied in the
    input dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    mean_sq = x32.square().mean(dim=-1, keepdim=True)
    del x32
    var = (mean_sq - mean.square()).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)
    a = inv * (weight.float() if weight is not None else 1.0)
    b = -mean * a + (bias.float() if bias is not None else 0.0)
    return x * a.to(x.dtype) + b.to(x.dtype)
