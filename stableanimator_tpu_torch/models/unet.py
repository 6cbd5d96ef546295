"""The SVD-XT spatio-temporal video UNet with StableAnimator conditioning
(port of the JAX package's `models/unet.py`).

Channels-last video layout [B, F, H, W, C]; frames fold into the batch for
all spatial ops. Classifier-free guidance batches cond and uncond in one
call (the uncond stream gets zero context and zero pose latents). The
PoseNet residual is added right after `conv_in`. Parameter names follow
diffusers' UNetSpatioTemporalConditionModel plus the ID adapter's
`attn2.processor.id_to_{k,v}`.

`remat=True` is gradient checkpointing: every SpatioTemporalResBlock and
TransformerSpatioTemporalModel of the down, mid and up blocks runs under
`torch.utils.checkpoint` (non-reentrant) when autograd records, keeping
only its inputs and recomputing it in the backward. These are the
boundaries where the JAX package rematerialises (its `_maybe_remat`). The
JAX package also rematerialises each transformer block inside the
TransformerSpatioTemporalModel; nesting a second checkpoint here would run
the inner forward three times (attention included) for no memory the outer
level does not already save, so the port takes the outer level only. The
function computed is the same either way.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from stableanimator_tpu_torch.core.config import UNetConfig
from stableanimator_tpu_torch.models.layers import (
    Conv2d,
    Downsample2D,
    GroupNorm,
    SpatioTemporalResBlock,
    TimestepEmbedding,
    Upsample2D,
    module_dtype,
    sinusoidal_embedding,
)
from stableanimator_tpu_torch.models.transformer import TransformerSpatioTemporalModel


def _run(remat: bool, module: nn.Module, *args, **kwargs):
    """module(*args, **kwargs), checkpointed when `remat` and autograd records."""
    if remat and torch.is_grad_enabled():
        return checkpoint(module, *args, use_reentrant=False, **kwargs)
    return module(*args, **kwargs)


def _transformer(cfg: UNetConfig, ch: int, heads: int):
    return TransformerSpatioTemporalModel(
        heads, ch // heads, ch, cfg.cross_attention_dim,
        num_layers=cfg.transformer_layers_per_block,
        num_id_tokens=cfg.num_id_tokens)


class DownBlock(nn.Module):
    """SpatioTemporalResBlocks (+ transformers) (+ strided-conv downsample);
    returns the output and the skip states it contributes."""

    def __init__(self, cfg: UNetConfig, in_ch: int, out_ch: int, heads: int | None,
                 eps: float, add_downsample: bool, remat: bool = False):
        super().__init__()
        self.remat = remat
        temb = cfg.time_embed_dim
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(in_ch if j == 0 else out_ch, out_ch, temb, eps=eps)
            for j in range(cfg.layers_per_block)])
        self.attentions = (nn.ModuleList([
            _transformer(cfg, out_ch, heads) for _ in range(cfg.layers_per_block)])
            if heads is not None else None)
        self.downsamplers = (nn.ModuleList([Downsample2D(out_ch)])
                             if add_downsample else None)

    def forward(self, x, temb, context, num_frames):
        states = []
        for j, res in enumerate(self.resnets):
            x = _run(self.remat, res, x, temb, num_frames=num_frames)
            if self.attentions is not None:
                x = _run(self.remat, self.attentions[j], x, context, num_frames=num_frames)
            states.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            states.append(x)
        return x, states


class MidBlock(nn.Module):
    """resnet -> transformer -> resnet (eps 1e-5)."""

    def __init__(self, cfg: UNetConfig, remat: bool = False):
        super().__init__()
        self.remat = remat
        ch, heads = cfg.block_out_channels[-1], cfg.num_attention_heads[-1]
        temb = cfg.time_embed_dim
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock(ch, ch, temb, eps=1e-5) for _ in range(2)])
        self.attentions = nn.ModuleList([_transformer(cfg, ch, heads)])

    def forward(self, x, temb, context, num_frames):
        x = _run(self.remat, self.resnets[0], x, temb, num_frames=num_frames)
        x = _run(self.remat, self.attentions[0], x, context, num_frames=num_frames)
        return _run(self.remat, self.resnets[1], x, temb, num_frames=num_frames)


class UpBlock(nn.Module):
    """SpatioTemporalResBlocks over skip-concatenated inputs (+ transformers)
    (+ nearest-2x upsample conv), resnet eps 1e-6."""

    def __init__(self, cfg: UNetConfig, in_ch: int, skip_chs: list[int], out_ch: int,
                 heads: int | None, add_upsample: bool, remat: bool = False):
        super().__init__()
        self.remat = remat
        temb = cfg.time_embed_dim
        self.resnets = nn.ModuleList([
            SpatioTemporalResBlock((in_ch if j == 0 else out_ch) + skip_chs[j], out_ch,
                                   temb, eps=1e-6)
            for j in range(len(skip_chs))])
        self.attentions = (nn.ModuleList([
            _transformer(cfg, out_ch, heads) for _ in skip_chs])
            if heads is not None else None)
        self.upsamplers = nn.ModuleList([Upsample2D(out_ch)]) if add_upsample else None

    def forward(self, x, skips, temb, context, num_frames):
        for j, res in enumerate(self.resnets):
            x = torch.cat([x, skips[len(skips) - 1 - j]], dim=-1)
            x = _run(self.remat, res, x, temb, num_frames=num_frames)
            if self.attentions is not None:
                x = _run(self.remat, self.attentions[j], x, context, num_frames=num_frames)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class UNetSpatioTemporal(nn.Module):
    """forward(sample, timestep, context, added_time_ids, pose_latents)
      sample:         [B, F, h, w, in_channels]  (noise ++ reference latent)
      timestep:       scalar tensor, continuous timestep 0.25*ln(sigma)
      context:        [B, 1 + num_id_tokens, cross_attention_dim]
      added_time_ids: [B, 3]  (fps-1, motion_bucket, noise_aug)
      pose_latents:   [B*F, h, w, block_out[0]] or None
    returns           [B, F, h, w, out_channels] in the compute dtype.
    remat: gradient checkpointing of the blocks' resnets and transformers."""

    def __init__(self, config: UNetConfig | None = None, remat: bool = False):
        super().__init__()
        cfg = self.config = config or UNetConfig()
        self.remat = remat
        ch = cfg.block_out_channels
        temb = cfg.time_embed_dim
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, temb)

        self.down_blocks = nn.ModuleList()
        skip_chs = [ch[0]]
        in_ch = ch[0]
        for i, block_type in enumerate(cfg.down_block_types):
            add_down = i < len(ch) - 1
            if block_type == "CrossAttnDownBlockSpatioTemporal":
                blk = DownBlock(cfg, in_ch, ch[i], cfg.num_attention_heads[i], 1e-6, add_down,
                                remat)
            elif block_type == "DownBlockSpatioTemporal":
                blk = DownBlock(cfg, in_ch, ch[i], None, 1e-5, False, remat)
            else:
                raise ValueError(block_type)
            self.down_blocks.append(blk)
            skip_chs += [ch[i]] * (cfg.layers_per_block + (blk.downsamplers is not None))
            in_ch = ch[i]

        self.mid_block = MidBlock(cfg, remat)

        rev_ch = list(reversed(ch))
        rev_heads = list(reversed(cfg.num_attention_heads))
        n_up = cfg.layers_per_block + 1
        self.up_blocks = nn.ModuleList()
        in_ch = ch[-1]
        for i, block_type in enumerate(cfg.up_block_types):
            block_skips = skip_chs[-n_up:]
            del skip_chs[-n_up:]
            if block_type == "UpBlockSpatioTemporal":
                heads = None
            elif block_type == "CrossAttnUpBlockSpatioTemporal":
                heads = rev_heads[i]
            else:
                raise ValueError(block_type)
            self.up_blocks.append(UpBlock(cfg, in_ch, block_skips[::-1], rev_ch[i], heads,
                                          i < len(ch) - 1, remat))
            in_ch = rev_ch[i]

        self.conv_norm_out = GroupNorm(32, ch[0], eps=1e-5)
        self.conv_out = Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample, timestep, context, added_time_ids, pose_latents=None):
        cfg = self.config
        dt = module_dtype(self)
        b, f, hh, ww, _ = sample.shape
        timesteps = torch.as_tensor(timestep, dtype=torch.float32,
                                    device=sample.device).reshape(-1).expand(b)
        t_emb = sinusoidal_embedding(timesteps, cfg.block_out_channels[0]).to(dt)
        emb = self.time_embedding(t_emb)
        add_embeds = sinusoidal_embedding(added_time_ids.reshape(-1).float(),
                                          cfg.addition_time_embed_dim).reshape(b, -1)
        emb = emb + self.add_embedding(add_embeds.to(dt))

        x = sample.reshape(b * f, hh, ww, sample.shape[-1]).to(dt)
        emb = emb.repeat_interleave(f, dim=0)
        context = context.to(dt).repeat_interleave(f, dim=0)

        x = self.conv_in(x)
        if pose_latents is not None:
            x = x + pose_latents.to(dt)
        skips = [x]
        for blk in self.down_blocks:
            x, states = blk(x, emb, context, f)
            skips.extend(states)
        x = self.mid_block(x, emb, context, f)
        n_up = cfg.layers_per_block + 1
        for blk in self.up_blocks:
            block_skips = skips[-n_up:]
            del skips[-n_up:]
            x = blk(x, block_skips, emb, context, f)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.reshape(b, f, hh, ww, cfg.out_channels)
