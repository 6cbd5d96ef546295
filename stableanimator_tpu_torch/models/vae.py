"""KL VAE with a plain-2D encoder and a temporal decoder (SVD's
AutoencoderKLTemporalDecoder; port of the JAX package's `models/vae.py`).

The encoder and quant_conv are an fp32 island (the reference force-upcasts
the encode); `build_models` leaves them fp32 and casts only the decoder to
the compute dtype. The decoder's AlphaBlenders run in reverse mode and its
resnets carry no time embedding; a Conv3d (3,1,1) mixes frames at the end.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from stableanimator_tpu_torch.core.config import VAEConfig
from stableanimator_tpu_torch.models.layers import (
    Conv2d,
    Conv3d,
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    SpatioTemporalResBlock,
    Upsample2D,
    module_dtype,
)
from stableanimator_tpu_torch.ops.attention import dot_product_attention


class VAEAttention(nn.Module):
    """Single-head attention over spatial tokens with GroupNorm input and an
    internal residual; q/k/v carry biases. Routes through the dispatcher
    (the flash kernel for the 16-bit decoder at 4096 tokens, d = 512)."""

    def __init__(self, ch: int, heads: int = 1):
        super().__init__()
        self.heads = heads
        self.group_norm = GroupNorm(32, ch, eps=1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch), nn.Identity()])

    def forward(self, x):
        n, hh, ww, c = x.shape
        tokens = self.group_norm(x.reshape(n, hh * ww, c))
        d = c // self.heads
        q = self.to_q(tokens).reshape(n, -1, self.heads, d)
        k = self.to_k(tokens).reshape(n, -1, self.heads, d)
        v = self.to_v(tokens).reshape(n, -1, self.heads, d)
        o = dot_product_attention(q, k, v).reshape(n, hh * ww, c)
        return self.to_out[0](o).reshape(n, hh, ww, c) + x


class _Block(nn.Module):
    """Container holding diffusers' resnets / attentions / samplers names."""


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        in_ch = ch[0]
        for i, out_ch in enumerate(ch):
            blk = _Block()
            blk.resnets = nn.ModuleList([
                ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, None, eps=1e-6)
                for j in range(cfg.layers_per_block)])
            blk.downsamplers = (nn.ModuleList([Downsample2D(out_ch, asymmetric_padding=True)])
                                if i < len(ch) - 1 else None)
            self.down_blocks.append(blk)
            in_ch = out_ch
        mid = _Block()
        mid.resnets = nn.ModuleList([ResnetBlock2D(ch[-1], ch[-1], None, eps=1e-6)
                                     for _ in range(2)])
        mid.attentions = nn.ModuleList([VAEAttention(ch[-1])])
        self.mid_block = mid
        self.conv_norm_out = GroupNorm(32, ch[-1], eps=1e-6)
        self.conv_out = Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                x = res(x)
            if blk.downsamplers is not None:
                x = blk.downsamplers[0](x)
        x = self.mid_block.resnets[0](x)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x)
        return self.conv_out(self.conv_norm_out(x, silu=True))


class TemporalDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels

        def st_block(cin, cout):
            return SpatioTemporalResBlock(cin, cout, None, eps=1e-6, temporal_eps=1e-5,
                                          merge_factor=0.0, reverse_time_mix=True)

        self.conv_in = Conv2d(cfg.latent_channels, ch[-1], 3, padding=1)
        mid = _Block()
        mid.resnets = nn.ModuleList([st_block(ch[-1], ch[-1]) for _ in range(2)])
        mid.attentions = nn.ModuleList([VAEAttention(ch[-1])])
        self.mid_block = mid
        rev = list(reversed(ch))
        self.up_blocks = nn.ModuleList()
        prev = rev[0]
        for i, out_ch in enumerate(rev):
            blk = _Block()
            blk.resnets = nn.ModuleList([
                st_block(prev if j == 0 else out_ch, out_ch)
                for j in range(cfg.layers_per_block + 1)])
            blk.upsamplers = (nn.ModuleList([Upsample2D(out_ch)])
                              if i < len(rev) - 1 else None)
            self.up_blocks.append(blk)
            prev = out_ch
        self.conv_norm_out = GroupNorm(32, ch[0], eps=1e-6)
        self.conv_out = Conv2d(ch[0], cfg.out_channels, 3, padding=1)
        self.time_conv_out = Conv3d(cfg.out_channels, cfg.out_channels, (3, 1, 1),
                                    padding=(1, 0, 0))

    def forward(self, z, *, num_frames: int):
        x = self.conv_in(z)
        x = self.mid_block.resnets[0](x, num_frames=num_frames)
        x = self.mid_block.attentions[0](x)
        x = self.mid_block.resnets[1](x, num_frames=num_frames)
        for blk in self.up_blocks:
            for res in blk.resnets:
                x = res(x, num_frames=num_frames)
            if blk.upsamplers is not None:
                x = blk.upsamplers[0](x)
        x = self.conv_out(self.conv_norm_out(x, silu=True))
        n, hh, ww, c = x.shape
        xv = self.time_conv_out(x.reshape(n // num_frames, num_frames, hh, ww, c))
        return xv.reshape(n, hh, ww, c)


class AutoencoderKLTemporalDecoder(nn.Module):
    """encode(x) -> (mean, logvar); decode(z, num_frames) -> frames.
    Images channels-last [N, H, W, 3] in [-1, 1]."""

    def __init__(self, config: VAEConfig | None = None):
        super().__init__()
        cfg = self.config = config or VAEConfig()
        self.encoder = Encoder(cfg)
        self.decoder = TemporalDecoder(cfg)
        self.quant_conv = Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)

    def encode(self, x):
        """Returns (mean, logvar), fp32; the mode of the posterior is mean."""
        moments = self.quant_conv(self.encoder(x.to(module_dtype(self.encoder))))
        mean, logvar = moments.float().chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z, *, num_frames: int):
        return self.decoder(z.to(module_dtype(self.decoder)), num_frames=num_frames)
