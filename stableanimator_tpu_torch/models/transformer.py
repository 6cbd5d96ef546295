"""Spatio-temporal transformer stack with the StableAnimator ID adapter
(port of the JAX package's `models/transformer.py`).

Layouts: spatial tokens [N, H*W, C] with N = batch*frames. Temporal
attention mixes over the frames at a fixed spatial position: only q, k, v
and the output are transposed to the frame-major layout. Spatial
self-attention routes through `ops.attention.dot_product_attention` (the
flash kernel for long 16-bit sequences on the card); temporal and ID
attention always take the plain path, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from stableanimator_tpu_torch.models.layers import (
    AlphaBlender,
    FeedForward,
    GroupNorm,
    LayerNorm,
    TimestepEmbedding,
    sinusoidal_embedding,
)
from stableanimator_tpu_torch.ops.attention import dot_product_attention


class Attention(nn.Module):
    """Multi-head attention, self (context=None) or cross. to_q/to_k/to_v
    have no bias, to_out.0 does (diffusers keeps [Linear, Dropout] there)."""

    def __init__(self, query_dim: int, cross_dim: int | None, heads: int,
                 dim_head: int, use_flash: bool | None = None):
        super().__init__()
        inner = heads * dim_head
        cross_dim = cross_dim if cross_dim is not None else query_dim
        self.heads = heads
        self.dim_head = dim_head
        self.use_flash = use_flash
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(cross_dim, inner, bias=False)
        self.to_v = nn.Linear(cross_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim), nn.Identity()])

    def forward(self, x, context=None, seq_axis_group: tuple[int, int] | None = None):
        """seq_axis_group=(batch, frames): x is [batch*frames, S, C] and
        self-attention runs over the frame axis (temporal attention)."""
        is_self = context is None
        if context is None:
            context = x
        n, sq, _ = x.shape
        inner = self.heads * self.dim_head
        # softmax over a single key is exactly 1: the output is
        # to_out(to_v(context)) broadcast over the queries. Not valid for
        # temporal self-attention, whose attention axis is the frames.
        single_key = context.shape[1] == 1 and not (
            is_self and seq_axis_group is not None and seq_axis_group[1] != 1)
        if single_key:
            o = self.to_out[0](self.to_v(context))
            return o.expand(n, sq, o.shape[-1])
        q = self.to_q(x)
        k = self.to_k(context)
        v = self.to_v(context)
        sk = k.shape[1]
        q = q.reshape(n, sq, self.heads, self.dim_head)
        k = k.reshape(n, sk, self.heads, self.dim_head)
        v = v.reshape(n, sk, self.heads, self.dim_head)
        if is_self and seq_axis_group is not None:
            b, f = seq_axis_group

            def to_frame_major(t):
                t = t.reshape(b, f, sq, self.heads, self.dim_head)
                return t.transpose(1, 2).reshape(b * sq, f, self.heads, self.dim_head)

            o = dot_product_attention(to_frame_major(q), to_frame_major(k),
                                      to_frame_major(v), use_flash=False)
            o = o.reshape(b, sq, f, self.heads, self.dim_head).transpose(1, 2)
        else:
            o = dot_product_attention(q, k, v, use_flash=self.use_flash)
        return self.to_out[0](o.reshape(n, sq, inner))


class _IDProcessor(nn.Module):
    """Holds the ID-adapter projections under diffusers' `processor.` names."""

    def __init__(self, cross_dim: int, inner: int):
        super().__init__()
        self.id_to_k = nn.Linear(cross_dim, inner, bias=False)
        self.id_to_v = nn.Linear(cross_dim, inner, bias=False)


class IDCrossAttention(nn.Module):
    """Dual-stream cross-attention with distribution renormalisation:
    context = [base tokens | num_id_tokens face tokens]; the face stream is
    renormalised to the base stream's per-sample mean/std (fp32 statistics,
    Bessel-corrected) and added."""

    def __init__(self, query_dim: int, cross_dim: int, heads: int, dim_head: int,
                 num_id_tokens: int = 4):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.dim_head = dim_head
        self.num_id_tokens = num_id_tokens
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(cross_dim, inner, bias=False)
        self.to_v = nn.Linear(cross_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim), nn.Identity()])
        self.processor = _IDProcessor(cross_dim, inner)

    def forward(self, x, context):
        inner = self.heads * self.dim_head
        end_pos = context.shape[1] - self.num_id_tokens
        n, sq, _ = x.shape
        q = self.to_q(x).reshape(n, sq, self.heads, self.dim_head)

        def attend(ctx, to_k, to_v):
            k = to_k(ctx)
            v = to_v(ctx)
            sk = k.shape[1]
            if sk == 1:      # softmax over one key == 1
                return v.expand(n, sq, inner)
            k = k.reshape(n, sk, self.heads, self.dim_head)
            v = v.reshape(n, sk, self.heads, self.dim_head)
            return dot_product_attention(q, k, v, use_flash=False).reshape(n, sq, inner)

        base = attend(context[:, :end_pos], self.to_k, self.to_v)
        ident = attend(context[:, end_pos:], self.processor.id_to_k, self.processor.id_to_v)

        def stats(t):
            cnt = t.shape[1] * t.shape[2]
            t32 = t.float()
            mean = t32.mean(dim=(1, 2), keepdim=True)
            mean_sq = t32.square().mean(dim=(1, 2), keepdim=True)
            var = (mean_sq - mean.square()).clamp_min(0.0) * (cnt / max(cnt - 1, 1))
            # sqrt with a zero gradient at var == 0: a stream that is exactly
            # zero (both streams of a clip dropped by conditioning dropout)
            # would otherwise meet sqrt's infinite slope and turn every
            # gradient into NaN, as the JAX package's does. Same forward.
            pos = var > 0
            return mean, torch.where(pos, torch.sqrt(torch.where(pos, var, 1.0)), 0.0)

        mean_b, std_b = stats(base)
        mean_i, std_i = stats(ident)
        k_aff = std_b / (std_i + 1e-5)
        b_aff = mean_b - mean_i * k_aff
        ident = ident * k_aff.to(base.dtype) + b_aff.to(base.dtype)
        return self.to_out[0](base + ident)


class BasicTransformerBlock(nn.Module):
    """Spatial block: self-attn -> ID cross-attn -> GEGLU FF, pre-LN."""

    def __init__(self, dim: int, heads: int, dim_head: int, cross_dim: int,
                 num_id_tokens: int = 4):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, None, heads, dim_head)
        self.norm2 = LayerNorm(dim)
        self.attn2 = IDCrossAttention(dim, cross_dim, heads, dim_head, num_id_tokens)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class TemporalBasicTransformerBlock(nn.Module):
    """Temporal block over the frame axis, run in the spatial token layout
    [B*F, S, C]; returns a*x + (1-a)*block(x + frame_emb)."""

    def __init__(self, dim: int, heads: int, dim_head: int, cross_dim: int):
        super().__init__()
        self.norm_in = LayerNorm(dim)
        self.ff_in = FeedForward(dim, dim_out=dim)
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, None, heads, dim_head, use_flash=False)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, cross_dim, heads, dim_head, use_flash=False)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, time_context, frame_emb, mix_alpha, *, num_frames: int):
        b = x.shape[0] // num_frames
        h = x + frame_emb.to(x.dtype)
        h = self.ff_in(self.norm_in(h)) + h
        group = (b, num_frames)
        h = h + self.attn1(self.norm1(h), seq_axis_group=group)
        h = h + self.attn2(self.norm2(h), time_context, seq_axis_group=group)
        h = h + self.ff(self.norm3(h))
        a = mix_alpha.to(h.dtype)
        return a * x + (1.0 - a) * h


class TransformerSpatioTemporalModel(nn.Module):
    """Spatial + temporal transformer pair with frame positional embedding
    and a learned blend. Input [N, H, W, C] (N = B*F); context
    [N, 1+num_id_tokens, cross_dim]."""

    def __init__(self, heads: int, dim_head: int, in_ch: int, cross_dim: int,
                 num_layers: int = 1, num_id_tokens: int = 4):
        super().__init__()
        inner = heads * dim_head
        self.in_ch = in_ch
        self.num_id_tokens = num_id_tokens
        self.norm = GroupNorm(32, in_ch, eps=1e-6)
        self.proj_in = nn.Linear(in_ch, inner)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, cross_dim, num_id_tokens)
            for _ in range(num_layers)])
        self.temporal_transformer_blocks = nn.ModuleList([
            TemporalBasicTransformerBlock(inner, heads, dim_head, cross_dim)
            for _ in range(num_layers)])
        self.time_pos_embed = TimestepEmbedding(in_ch, in_ch * 4, out_dim=in_ch)
        self.time_mixer = AlphaBlender(0.5)
        self.proj_out = nn.Linear(inner, in_ch)

    def forward(self, x, context, *, num_frames: int):
        n, hh, ww, c_in = x.shape
        b = n // num_frames
        s = hh * ww
        # time context: frame 0's base (CLIP) tokens, repeated over frames
        end_pos = context.shape[1] - self.num_id_tokens
        tc_first = context[:, :end_pos].reshape(b, num_frames, end_pos, -1)[:, 0]
        time_context = tc_first[:, None].expand(b, num_frames, end_pos, tc_first.shape[-1])
        time_context = time_context.reshape(n, end_pos, tc_first.shape[-1])

        residual = x
        h = self.proj_in(self.norm(x).reshape(n, s, c_in))
        frame_ids = torch.arange(num_frames, dtype=torch.float32, device=x.device).repeat(b)
        t_emb = sinusoidal_embedding(frame_ids, c_in).to(h.dtype)
        emb = self.time_pos_embed(t_emb)[:, None, :]
        alpha = self.time_mixer.alpha()
        for blk, tblk in zip(self.transformer_blocks, self.temporal_transformer_blocks):
            h = blk(h, context)
            h = tblk(h, time_context, emb, alpha, num_frames=num_frames)
        h = self.proj_out(h).reshape(n, hh, ww, c_in)
        return h + residual
