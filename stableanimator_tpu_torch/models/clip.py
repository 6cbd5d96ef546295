"""CLIP ViT vision tower with projection: the SVD image conditioner (port
of the JAX package's `models/clip.py`; HF CLIPVisionModelWithProjection
parameter names).

Attention over the 257 tokens is plain math (fp32 logits divided by
sqrt(head dim), fp32 softmax), not the flash kernel; GELUs are exact erf.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from stableanimator_tpu_torch.core.config import CLIPVisionConfig
from stableanimator_tpu_torch.models.layers import Conv2d, LayerNorm, module_dtype

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


class _SelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)


class _MLP(nn.Module):
    def __init__(self, d: int, inner: int):
        super().__init__()
        self.fc1 = nn.Linear(d, inner)
        self.fc2 = nn.Linear(inner, d)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.self_attn = _SelfAttention(d)
        self.layer_norm1 = LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = _MLP(d, cfg.intermediate_size)
        self.layer_norm2 = LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, x):
        heads = self.cfg.num_heads
        h = self.layer_norm1(x)
        n, s, d = h.shape
        hd = d // heads
        sa = self.self_attn
        q = sa.q_proj(h).reshape(n, s, heads, hd)
        k = sa.k_proj(h).reshape(n, s, heads, hd)
        v = sa.v_proj(h).reshape(n, s, heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        logits = logits / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        att = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(n, s, d)
        x = x + sa.out_proj(att)
        h = self.mlp.fc2(F.gelu(self.mlp.fc1(self.layer_norm2(x))))
        return x + h


class CLIPVisionModelWithProjection(nn.Module):
    """pixel_values [B, H, W, 3] (CLIP-normalised) -> image_embeds
    [B, projection_dim]."""

    def __init__(self, config: CLIPVisionConfig | None = None):
        super().__init__()
        cfg = self.config = config or CLIPVisionConfig()
        d = cfg.hidden_size
        vm = nn.Module()
        emb = nn.Module()
        emb.class_embedding = nn.Parameter(torch.zeros(d))
        emb.patch_embedding = Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size, bias=False)
        emb.position_embedding = nn.Embedding((cfg.image_size // cfg.patch_size) ** 2 + 1, d)
        vm.embeddings = emb
        vm.pre_layrnorm = LayerNorm(d, eps=cfg.layer_norm_eps)
        enc = nn.Module()
        enc.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])
        vm.encoder = enc
        vm.post_layernorm = LayerNorm(d, eps=cfg.layer_norm_eps)
        self.vision_model = vm
        self.visual_projection = nn.Linear(d, cfg.projection_dim, bias=False)

    def forward(self, pixel_values):
        cfg = self.config
        vm = self.vision_model
        dt = module_dtype(self)
        b = pixel_values.shape[0]
        patches = vm.embeddings.patch_embedding(pixel_values.to(dt)).reshape(b, -1, cfg.hidden_size)
        cls = vm.embeddings.class_embedding.to(dt)[None, None].expand(b, 1, cfg.hidden_size)
        x = torch.cat([cls, patches], dim=1)
        x = x + vm.embeddings.position_embedding.weight.to(dt)[None]
        x = vm.pre_layrnorm(x)
        for layer in vm.encoder.layers:
            x = layer(x)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))
