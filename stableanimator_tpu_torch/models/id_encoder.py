"""FusionFaceId: the global content-aware Face Encoder (port of the JAX
package's `models/id_encoder.py`).

Maps a 512-d ArcFace identity embedding to `num_tokens` tokens and refines
them against the CLIP image embedding with a perceiver. Kept from the
reference: 1/sqrt(sqrt(dim_head)) applied to BOTH q and k, fp32 softmax,
keys/values over concat(clip tokens, latents), exact erf GELUs.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from stableanimator_tpu_torch.core.config import FaceEncoderConfig
from stableanimator_tpu_torch.models.layers import LayerNorm, module_dtype


class PerceiverAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.dim_head = dim_head
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x, latents):
        x = self.norm1(x)
        latents = self.norm2(latents)
        b, l, _ = latents.shape
        q = self.to_q(latents)
        kv_input = torch.cat([x, latents], dim=-2)
        k, v = self.to_kv(kv_input).chunk(2, dim=-1)
        s = kv_input.shape[1]
        q = q.reshape(b, l, self.heads, self.dim_head).transpose(1, 2)
        k = k.reshape(b, s, self.heads, self.dim_head).transpose(1, 2)
        v = v.reshape(b, s, self.heads, self.dim_head).transpose(1, 2)
        scale = 1.0 / math.sqrt(math.sqrt(self.dim_head))
        logits = torch.einsum("bhqd,bhkd->bhqk", (q * scale).float(), (k * scale).float())
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        return self.to_out(out.transpose(1, 2).reshape(b, l, -1))


class FusionFaceId(nn.Module):
    """forward(id_embeds [B, id_dim], clip_embeds [B, 1, clip_dim]) ->
    [B, num_tokens, cross_attention_dim]."""

    def __init__(self, config: FaceEncoderConfig | None = None):
        super().__init__()
        cfg = self.config = config or FaceEncoderConfig()
        d = cfg.cross_attention_dim
        self.proj = nn.Sequential(
            nn.Linear(cfg.id_embeddings_dim, cfg.id_embeddings_dim * 2), nn.GELU(),
            nn.Linear(cfg.id_embeddings_dim * 2, d * cfg.num_tokens))
        self.norm = LayerNorm(d)
        fusion = nn.Module()
        fusion.proj_in = nn.Linear(cfg.clip_embeddings_dim, d)
        fusion.layers = nn.ModuleList([
            nn.ModuleList([
                PerceiverAttention(d, cfg.heads, cfg.dim_head),
                nn.Sequential(LayerNorm(d), nn.Linear(d, d * cfg.ff_mult, bias=False),
                              nn.GELU(), nn.Linear(d * cfg.ff_mult, d, bias=False)),
            ]) for _ in range(cfg.depth)])
        fusion.proj_out = nn.Linear(d, d)
        fusion.norm_out = LayerNorm(d)
        self.fusion_model = fusion

    def forward(self, id_embeds, clip_embeds):
        cfg = self.config
        dt = module_dtype(self)
        x = self.proj(id_embeds.to(dt)).reshape(-1, cfg.num_tokens, cfg.cross_attention_dim)
        latents = self.norm(x)
        f = self.fusion_model
        ctx = f.proj_in(clip_embeds.to(dt))
        for attn, ff in f.layers:
            latents = latents + attn(ctx, latents)
            latents = latents + ff(latents)
        return f.norm_out(f.proj_out(latents))
