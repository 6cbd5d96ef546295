"""Plain PyTorch reference of SVD-XT + StableAnimator: the five models.

A frozen copy of the model definitions, written against nothing but
`torch`: float32 throughout, attention as softmax(q k^T / sqrt(d)) v in
blocks of rows (no kernel), GroupNorm / LayerNorm from their definitions.
Layouts are channels-last ([N, H, W, C], videos [B, F, H, W, C]) and
parameter names are diffusers' / the reference's, so one state dict loads
here and into the program with `load_state_dict(strict=True)`.

Departures from the published description, each the published function
computed another way:
  * the UNet's spatial attention over one key (the CLIP token) is the value
    projection broadcast (softmax over one key is 1);
  * `checkpoint=True` recomputes each resnet and transformer of the UNet in
    the backward (`torch.utils.checkpoint`), and every attention's row block
    when autograd records, so that a training step fits the card in float32.

`lower_precision(module, fmt)` makes the control: every linear layer and
convolution of `module` computes on operands rounded to `fmt` ("int8":
symmetric, 127 levels; "fp8": e4m3), weights scaled per output channel and
activations per token (per pixel for a convolution), dequantised, with a
straight-through gradient.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# one block of attention scores, in float32 elements (1 GiB)
SCORE_BLOCK = 2 ** 28


QMAX = {"int8": 127.0, "fp8": 448.0}


def _round(x: torch.Tensor, fmt: str, dims) -> torch.Tensor:
    """x rounded to `fmt` with one scale per slice over `dims` (max |x| to
    the format's largest value), dequantised, with a straight-through
    gradient."""
    s = (x.abs().amax(dim=dims, keepdim=True) / QMAX[fmt]).clamp_min(1e-12)
    if fmt == "int8":
        q = torch.round(x / s).clamp(-127.0, 127.0) * s
    else:
        q = (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (q - x).detach()


def _linear_lowp(m: nn.Linear, fmt: str, x):
    return F.linear(_round(x, fmt, -1), _round(m.weight, fmt, 1), m.bias)


def _conv_lowp(m: nn.Module, fmt: str, x):
    conv = F.conv2d if x.dim() == 4 else F.conv3d
    w = _round(m.weight, fmt, tuple(range(1, m.weight.dim())))
    perm = (0, x.dim() - 1) + tuple(range(1, x.dim() - 1))
    out = conv(_round(x, fmt, -1).permute(perm), w, m.bias, m.stride, m.padding)
    back = (0,) + tuple(range(2, x.dim())) + (1,)
    return out.permute(back)


def lower_precision(module: nn.Module, fmt: str) -> nn.Module:
    """Every linear layer and convolution of `module` computed in `fmt`."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            m.forward = functools.partial(_linear_lowp, m, fmt)
        elif isinstance(m, (Conv2d, Conv3d)):
            m.forward = functools.partial(_conv_lowp, m, fmt)
    return module


def _rows_attention(q, k, v, scale):
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)


def attention(q, k, v, scale: float | None = None):
    """softmax(q k^T * scale) v over [B, S, H, D], in blocks of batch rows
    and query rows so that a block's scores stay under SCORE_BLOCK
    elements."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    per_row = h * sk
    rows = max(1, SCORE_BLOCK // per_row)          # query rows of one batch item
    if rows >= sq:
        nb = max(1, rows // sq)
        blocks = [(i, min(i + nb, b), 0, sq) for i in range(0, b, nb)]
    else:
        blocks = [(i, i + 1, j, min(j + rows, sq)) for i in range(b) for j in range(0, sq, rows)]
    if len(blocks) == 1:
        return _rows_attention(q, k, v, scale)
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    outs = []
    for b0, b1, q0, q1 in blocks:
        args = (q[b0:b1, q0:q1], k[b0:b1], v[b0:b1], scale)
        outs.append(checkpoint(_rows_attention, *args, use_reentrant=False) if grad
                    else _rows_attention(*args))
    if rows >= sq:
        return torch.cat(outs, dim=0)
    per_b = -(-sq // rows)
    return torch.cat([torch.cat(outs[i * per_b:(i + 1) * per_b], dim=1) for i in range(b)], 0)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class Conv3d(nn.Conv3d):
    def forward(self, x):
        return super().forward(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)


class GroupNorm(nn.Module):
    """GroupNorm over the channels-last layout (biased variance)."""

    def __init__(self, groups: int, ch: int, eps: float):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        n, c = x.shape[0], x.shape[-1]
        xg = x.reshape(n, -1, self.groups, c // self.groups)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = xg.var(dim=(1, 3), keepdim=True, unbiased=False)
        y = ((xg - mean) / torch.sqrt(var + self.eps)).reshape(x.shape)
        return y * self.weight + self.bias


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)


NORMS = (GroupNorm, LayerNorm)


def timestep_embedding(t, dim: int):
    """[cos | sin] sinusoidal embedding, max period 10000."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, n_in: int, n: int, n_out: int | None = None):
        super().__init__()
        self.linear_1 = nn.Linear(n_in, n)
        self.linear_2 = nn.Linear(n, n_out or n)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class AlphaBlender(nn.Module):
    def __init__(self, reverse: bool = False):
        super().__init__()
        self.reverse = reverse
        self.mix_factor = nn.Parameter(torch.zeros(1))

    def alpha(self):
        a = torch.sigmoid(self.mix_factor)
        return 1.0 - a if self.reverse else a


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, temb: int | None, eps: float):
        super().__init__()
        self.norm1 = GroupNorm(32, cin, eps)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb, cout) if temb else None
        self.norm2 = GroupNorm(32, cout, eps)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class TemporalResnetBlock(nn.Module):
    def __init__(self, ch: int, temb: int | None, eps: float):
        super().__init__()
        self.norm1 = GroupNorm(32, ch, eps)
        self.conv1 = Conv3d(ch, ch, (3, 1, 1), padding=(1, 0, 0))
        self.time_emb_proj = nn.Linear(temb, ch) if temb else None
        self.norm2 = GroupNorm(32, ch, eps)
        self.conv2 = Conv3d(ch, ch, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, x, temb=None):                       # x [B, F, H, W, C]
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        return x + self.conv2(F.silu(self.norm2(h)))


class SpatioTemporalResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb: int | None, eps: float,
                 temporal_eps: float | None = None, reverse: bool = False):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(cin, cout, temb, eps)
        self.temporal_res_block = TemporalResnetBlock(cout, temb, temporal_eps or eps)
        self.time_mixer = AlphaBlender(reverse)

    def forward(self, x, temb=None, *, num_frames: int):
        h = self.spatial_res_block(x, temb)
        n, hh, ww, c = h.shape
        hv = h.reshape(n // num_frames, num_frames, hh, ww, c)
        tv = None if temb is None else temb.reshape(n // num_frames, num_frames, -1)
        ht = self.temporal_res_block(hv, tv)
        a = self.time_mixer.alpha()
        return (a * hv + (1.0 - a) * ht).reshape(n, hh, ww, c)


class Downsample2D(nn.Module):
    def __init__(self, ch: int, asymmetric: bool = False):
        super().__init__()
        self.asymmetric = asymmetric
        self.conv = Conv2d(ch, ch, 3, stride=2, padding=0 if asymmetric else 1)

    def forward(self, x):
        if self.asymmetric:
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))


class FeedForward(nn.Module):
    """GEGLU (value * gelu(gate), exact erf) then a linear."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([nn.Module(), nn.Identity(), nn.Linear(4 * dim, dim)])
        self.net[0].proj = nn.Linear(dim, 8 * dim)

    def forward(self, x):
        value, gate = self.net[0].proj(x).chunk(2, dim=-1)
        return self.net[2](value * F.gelu(gate))


class Attention(nn.Module):
    def __init__(self, dim: int, cross: int | None, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(cross or dim, dim, bias=False)
        self.to_v = nn.Linear(cross or dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim), nn.Identity()])

    def split(self, t):
        return t.reshape(t.shape[0], t.shape[1], self.heads, -1)

    def forward(self, x, context=None):
        ctx = x if context is None else context
        if ctx.shape[1] == 1:
            return self.to_out[0](self.to_v(ctx)).expand(x.shape)
        o = attention(self.split(self.to_q(x)), self.split(self.to_k(ctx)),
                      self.split(self.to_v(ctx)))
        return self.to_out[0](o.reshape(x.shape))


class IDCrossAttention(Attention):
    """Cross-attention to [CLIP token | face tokens]: the face stream is
    renormalised to the CLIP stream's per-sample mean and (Bessel) std,
    then added."""

    def __init__(self, dim: int, cross: int, heads: int, num_id: int):
        super().__init__(dim, cross, heads)
        self.num_id = num_id
        self.processor = nn.Module()
        self.processor.id_to_k = nn.Linear(cross, dim, bias=False)
        self.processor.id_to_v = nn.Linear(cross, dim, bias=False)

    def forward(self, x, context):
        q = self.split(self.to_q(x))
        end = context.shape[1] - self.num_id

        def stream(ctx, to_k, to_v):
            if ctx.shape[1] == 1:
                return to_v(ctx).expand(x.shape)
            return attention(q, self.split(to_k(ctx)), self.split(to_v(ctx))).reshape(x.shape)

        def stats(t):
            # a stream that is all zero (the unconditioned one) has std 0;
            # its gradient is taken as 0 there rather than sqrt's infinity
            var = t.var(dim=(1, 2), keepdim=True)
            pos = var > 0
            return t.mean(dim=(1, 2), keepdim=True), torch.where(
                pos, torch.sqrt(torch.where(pos, var, 1.0)), 0.0)

        base = stream(context[:, :end], self.to_k, self.to_v)
        ident = stream(context[:, end:], self.processor.id_to_k, self.processor.id_to_v)
        (mean_b, std_b), (mean_i, std_i) = stats(base), stats(ident)
        ident = (ident - mean_i) * (std_b / (std_i + 1e-5)) + mean_b
        return self.to_out[0](base + ident)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, cross: int, num_id: int):
        super().__init__()
        self.norm1, self.norm2, self.norm3 = LayerNorm(dim), LayerNorm(dim), LayerNorm(dim)
        self.attn1 = Attention(dim, None, heads)
        self.attn2 = IDCrossAttention(dim, cross, heads, num_id)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class TemporalBasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, cross: int):
        super().__init__()
        self.norm_in = LayerNorm(dim)
        self.ff_in = FeedForward(dim)
        self.norm1, self.norm2, self.norm3 = LayerNorm(dim), LayerNorm(dim), LayerNorm(dim)
        self.attn1 = Attention(dim, None, heads)
        self.attn2 = Attention(dim, cross, heads)
        self.ff = FeedForward(dim)

    def forward(self, x, time_context, frame_emb, num_frames: int):
        n, s, c = x.shape
        b = n // num_frames
        h = x + frame_emb
        h = self.ff_in(self.norm_in(h)) + h
        # self-attention over the frames at each spatial position
        t = self.norm1(h).reshape(b, num_frames, s, c).transpose(1, 2).reshape(b * s, num_frames, c)
        t = self.attn1(t).reshape(b, s, num_frames, c).transpose(1, 2).reshape(n, s, c)
        h = h + t
        h = h + self.attn2(self.norm2(h), time_context)
        return h + self.ff(self.norm3(h))


class TransformerSpatioTemporal(nn.Module):
    def __init__(self, ch: int, heads: int, cross: int, num_id: int):
        super().__init__()
        self.num_id = num_id
        self.norm = GroupNorm(32, ch, 1e-6)
        self.proj_in = nn.Linear(ch, ch)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(ch, heads, cross, num_id)])
        self.temporal_transformer_blocks = nn.ModuleList([
            TemporalBasicTransformerBlock(ch, heads, cross)])
        self.time_pos_embed = TimestepEmbedding(ch, 4 * ch, ch)
        self.time_mixer = AlphaBlender()
        self.proj_out = nn.Linear(ch, ch)

    def forward(self, x, context, *, num_frames: int):
        n, hh, ww, c = x.shape
        b = n // num_frames
        end = context.shape[1] - self.num_id
        # the time context: frame 0's CLIP token of each video, for every frame
        tc = context[:, :end].reshape(b, num_frames, end, -1)[:, :1]
        time_context = tc.expand(b, num_frames, end, tc.shape[-1]).reshape(n, end, -1)
        h = self.proj_in(self.norm(x).reshape(n, hh * ww, c))
        frames = torch.arange(num_frames, device=x.device).repeat(b)
        emb = self.time_pos_embed(timestep_embedding(frames, c))[:, None]
        a = self.time_mixer.alpha()
        for blk, tblk in zip(self.transformer_blocks, self.temporal_transformer_blocks):
            h = blk(h, context)
            h = a * h + (1.0 - a) * tblk(h, time_context, emb, num_frames)
        return self.proj_out(h).reshape(n, hh, ww, c) + x


def _call(ckpt: bool, module, *args, **kwargs):
    if ckpt and torch.is_grad_enabled():
        return checkpoint(module, *args, use_reentrant=False, **kwargs)
    return module(*args, **kwargs)


class _Blocks(nn.Module):
    """A down / up block: resnets, optional attentions and a resampler."""

    def __init__(self, resnets, attentions, sampler_name: str | None, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        self.sampler_name = sampler_name
        if sampler_name:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class UNet(nn.Module):
    """UNetSpatioTemporalConditionModel with PoseNet input and the ID
    adapter. forward(sample [B, F, h, w, 8], timestep [B], context
    [B, 1 + num_id, cross], added_time_ids [B, 3], pose [B*F, h, w, C0])
    -> [B, F, h, w, 4]."""

    DOWN = ["CrossAttnDownBlockSpatioTemporal"] * 3 + ["DownBlockSpatioTemporal"]
    UP = ["UpBlockSpatioTemporal"] + ["CrossAttnUpBlockSpatioTemporal"] * 3

    def __init__(self, cfg: dict, checkpoint: bool = False):
        super().__init__()
        if list(cfg["down_block_types"]) != self.DOWN or list(cfg["up_block_types"]) != self.UP:
            raise ValueError("the reference UNet has SVD's four levels of blocks only")
        self.cfg, self.ckpt = cfg, checkpoint
        ch, heads, lpb = cfg["block_out_channels"], cfg["num_attention_heads"], cfg["layers_per_block"]
        temb = 4 * ch[0]
        cross, num_id = cfg["cross_attention_dim"], cfg["num_id_tokens"]

        def tr(c, h):
            return TransformerSpatioTemporal(c, h, cross, num_id)

        self.conv_in = Conv2d(cfg["in_channels"], ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.add_embedding = TimestepEmbedding(cfg["projection_class_embeddings_input_dim"], temb)
        self.down_blocks = nn.ModuleList()
        skips, cin = [ch[0]], ch[0]
        for i, c in enumerate(ch):
            attn = i < len(ch) - 1           # CrossAttnDown x3, then Down
            eps = 1e-6 if attn else 1e-5
            res = [SpatioTemporalResBlock(cin if j == 0 else c, c, temb, eps) for j in range(lpb)]
            down = Downsample2D(c) if i < len(ch) - 1 else None
            self.down_blocks.append(_Blocks(res, [tr(c, heads[i]) for _ in range(lpb)] if attn
                                            else None, "downsamplers" if down else None, down))
            skips += [c] * (lpb + (down is not None))
            cin = c
        self.mid_block = _Blocks([SpatioTemporalResBlock(ch[-1], ch[-1], temb, 1e-5)
                                  for _ in range(2)], [tr(ch[-1], heads[-1])], None)
        self.up_blocks = nn.ModuleList()
        rev, rheads = ch[::-1], heads[::-1]
        for i, c in enumerate(rev):
            blk_skips = skips[-(lpb + 1):][::-1]
            del skips[-(lpb + 1):]
            res = [SpatioTemporalResBlock((cin if j == 0 else c) + s, c, temb, 1e-6)
                   for j, s in enumerate(blk_skips)]
            attn = [tr(c, rheads[i]) for _ in blk_skips] if i > 0 else None
            up = Upsample2D(c) if i < len(ch) - 1 else None
            self.up_blocks.append(_Blocks(res, attn, "upsamplers" if up else None, up))
            cin = c
        self.conv_norm_out = GroupNorm(32, ch[0], 1e-5)
        self.conv_out = Conv2d(ch[0], cfg["out_channels"], 3, padding=1)

    def forward(self, sample, timestep, context, added_time_ids, pose=None):
        b, f, hh, ww, _ = sample.shape
        c0 = self.cfg["block_out_channels"][0]
        emb = self.time_embedding(timestep_embedding(timestep.reshape(-1).expand(b), c0))
        add = timestep_embedding(added_time_ids.reshape(-1), self.cfg["addition_time_embed_dim"])
        emb = (emb + self.add_embedding(add.reshape(b, -1))).repeat_interleave(f, dim=0)
        context = context.repeat_interleave(f, dim=0)
        x = self.conv_in(sample.reshape(b * f, hh, ww, -1))
        if pose is not None:
            x = x + pose
        skips = [x]

        def run_block(blk, x):
            for j, res in enumerate(blk.resnets):
                x = _call(self.ckpt, res, x, emb, num_frames=f)
                if blk.attentions is not None:
                    x = _call(self.ckpt, blk.attentions[j], x, context, num_frames=f)
                yield x

        for blk in self.down_blocks:
            for x in run_block(blk, x):
                skips.append(x)
            if blk.sampler_name:
                x = blk.downsamplers[0](x)
                skips.append(x)
        mid = self.mid_block
        x = _call(self.ckpt, mid.resnets[0], x, emb, num_frames=f)
        x = _call(self.ckpt, mid.attentions[0], x, context, num_frames=f)
        x = _call(self.ckpt, mid.resnets[1], x, emb, num_frames=f)
        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                x = _call(self.ckpt, res, torch.cat([x, skips.pop()], dim=-1), emb, num_frames=f)
                if blk.attentions is not None:
                    x = _call(self.ckpt, blk.attentions[j], x, context, num_frames=f)
            if blk.sampler_name:
                x = blk.upsamplers[0](x)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.reshape(b, f, hh, ww, -1)


class VAEAttention(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.group_norm = GroupNorm(32, ch, 1e-6)
        self.to_q, self.to_k, self.to_v = nn.Linear(ch, ch), nn.Linear(ch, ch), nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch), nn.Identity()])

    def forward(self, x):
        n, hh, ww, c = x.shape
        t = self.group_norm(x.reshape(n, hh * ww, c))
        q, k, v = (m(t).reshape(n, -1, 1, c) for m in (self.to_q, self.to_k, self.to_v))
        return self.to_out[0](attention(q, k, v).reshape(n, hh * ww, c)).reshape(x.shape) + x


class _Mid(nn.Module):
    def __init__(self, resnets, ch):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList([VAEAttention(ch)])


class VAE(nn.Module):
    """AutoencoderKLTemporalDecoder: encode(x [N, H, W, 3] in [-1, 1]) ->
    (mean, logvar); decode(z, num_frames) -> [N, H, W, 3] in about [-1, 1]."""

    def __init__(self, cfg: dict):
        super().__init__()
        ch, lpb, lat = cfg["block_out_channels"], cfg["layers_per_block"], cfg["latent_channels"]
        enc = nn.Module()
        enc.conv_in = Conv2d(3, ch[0], 3, padding=1)
        enc.down_blocks = nn.ModuleList()
        cin = ch[0]
        for i, c in enumerate(ch):
            down = Downsample2D(c, asymmetric=True) if i < len(ch) - 1 else None
            enc.down_blocks.append(_Blocks([ResnetBlock2D(cin if j == 0 else c, c, None, 1e-6)
                                            for j in range(lpb)], None,
                                           "downsamplers" if down else None, down))
            cin = c
        enc.mid_block = _Mid([ResnetBlock2D(ch[-1], ch[-1], None, 1e-6) for _ in range(2)], ch[-1])
        enc.conv_norm_out = GroupNorm(32, ch[-1], 1e-6)
        enc.conv_out = Conv2d(ch[-1], 2 * lat, 3, padding=1)
        self.encoder = enc
        self.scaling_factor = cfg["scaling_factor"]

        def st(a, b):
            return SpatioTemporalResBlock(a, b, None, 1e-6, temporal_eps=1e-5, reverse=True)

        dec = nn.Module()
        dec.conv_in = Conv2d(lat, ch[-1], 3, padding=1)
        dec.mid_block = _Mid([st(ch[-1], ch[-1]) for _ in range(2)], ch[-1])
        dec.up_blocks = nn.ModuleList()
        prev = ch[-1]
        for i, c in enumerate(ch[::-1]):
            up = Upsample2D(c) if i < len(ch) - 1 else None
            dec.up_blocks.append(_Blocks([st(prev if j == 0 else c, c) for j in range(lpb + 1)],
                                         None, "upsamplers" if up else None, up))
            prev = c
        dec.conv_norm_out = GroupNorm(32, ch[0], 1e-6)
        dec.conv_out = Conv2d(ch[0], 3, 3, padding=1)
        dec.time_conv_out = Conv3d(3, 3, (3, 1, 1), padding=(1, 0, 0))
        self.decoder = dec
        self.quant_conv = Conv2d(2 * lat, 2 * lat, 1)

    def encode(self, x):
        e = self.encoder
        x = e.conv_in(x)
        for blk in e.down_blocks:
            for res in blk.resnets:
                x = res(x)
            if blk.sampler_name:
                x = blk.downsamplers[0](x)
        x = e.mid_block.resnets[1](e.mid_block.attentions[0](e.mid_block.resnets[0](x)))
        mean, logvar = self.quant_conv(e.conv_out(F.silu(e.conv_norm_out(x)))).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z, num_frames: int):
        d = self.decoder
        x = d.conv_in(z)
        x = d.mid_block.resnets[0](x, num_frames=num_frames)
        x = d.mid_block.attentions[0](x)
        x = d.mid_block.resnets[1](x, num_frames=num_frames)
        for blk in d.up_blocks:
            for res in blk.resnets:
                x = res(x, num_frames=num_frames)
            if blk.sampler_name:
                x = blk.upsamplers[0](x)
        x = d.conv_out(F.silu(d.conv_norm_out(x)))
        n, hh, ww, c = x.shape
        return d.time_conv_out(x.reshape(n // num_frames, num_frames, hh, ww, c)).reshape(x.shape)


class CLIPVision(nn.Module):
    """CLIPVisionModelWithProjection: pixel_values [B, S, S, 3] (CLIP
    normalised) -> image_embeds [B, projection_dim]."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        d, p, eps = cfg["hidden_size"], cfg["patch_size"], cfg["layer_norm_eps"]
        vm = nn.Module()
        vm.embeddings = nn.Module()
        vm.embeddings.class_embedding = nn.Parameter(torch.zeros(d))
        vm.embeddings.patch_embedding = Conv2d(3, d, p, stride=p, bias=False)
        vm.embeddings.position_embedding = nn.Embedding((cfg["image_size"] // p) ** 2 + 1, d)
        vm.pre_layrnorm = LayerNorm(d, eps)
        vm.encoder = nn.Module()
        layers = []
        for _ in range(cfg["num_hidden_layers"]):
            layer = nn.Module()
            layer.self_attn = nn.Module()
            for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
                setattr(layer.self_attn, name, nn.Linear(d, d))
            layer.layer_norm1, layer.layer_norm2 = LayerNorm(d, eps), LayerNorm(d, eps)
            layer.mlp = nn.Module()
            layer.mlp.fc1 = nn.Linear(d, cfg["intermediate_size"])
            layer.mlp.fc2 = nn.Linear(cfg["intermediate_size"], d)
            layers.append(layer)
        vm.encoder.layers = nn.ModuleList(layers)
        vm.post_layernorm = LayerNorm(d, eps)
        self.vision_model = vm
        self.visual_projection = nn.Linear(d, cfg["projection_dim"], bias=False)

    def forward(self, pixels):
        vm, heads = self.vision_model, self.cfg["num_attention_heads"]
        b = pixels.shape[0]
        x = vm.embeddings.patch_embedding(pixels).reshape(b, -1, self.cfg["hidden_size"])
        x = torch.cat([vm.embeddings.class_embedding.expand(b, 1, -1), x], dim=1)
        x = vm.pre_layrnorm(x + vm.embeddings.position_embedding.weight[None])
        for layer in vm.encoder.layers:
            h = layer.layer_norm1(x)
            sa = layer.self_attn
            q, k, v = (m(h).reshape(b, h.shape[1], heads, -1) for m in (sa.q_proj, sa.k_proj,
                                                                          sa.v_proj))
            x = x + sa.out_proj(attention(q, k, v).reshape(h.shape))
            x = x + layer.mlp.fc2(F.gelu(layer.mlp.fc1(layer.layer_norm2(x))))
        return self.visual_projection(vm.post_layernorm(x[:, 0]))


class PoseNet(nn.Module):
    """3x3 / 4x4-stride-2 convolutions with SiLU, a 1x1 projection, times a
    learned scale: [N, H, W, 3] -> [N, H/8, W/8, C0]."""

    def __init__(self, cfg: dict):
        super().__init__()
        c = cfg["conv_channels"]
        specs = [(c[0], c[0], 3, 1), (c[0], c[1], 4, 2), (c[1], c[1], 3, 1), (c[1], c[2], 4, 2),
                 (c[2], c[2], 3, 1), (c[2], c[3], 4, 2), (c[3], c[3], 3, 1), (c[3], c[4], 3, 1)]
        layers = []
        for cin, cout, k, s in specs:
            layers += [Conv2d(cin, cout, k, stride=s, padding=1), nn.SiLU()]
        self.conv_layers = nn.Sequential(*layers)
        self.final_proj = Conv2d(c[4], cfg["noise_latent_channels"], 1)
        self.scale = nn.Parameter(torch.ones(1))

    def forward(self, x):
        return self.final_proj(self.conv_layers(x)) * self.scale


class FusionFaceId(nn.Module):
    """The face encoder: ArcFace embedding [B, id_dim] and CLIP embedding
    [B, 1, clip_dim] -> [B, num_tokens, cross] through a perceiver whose q
    and k are both scaled by dim_head ** -0.25."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        d, idd, nt = cfg["cross_attention_dim"], cfg["id_embeddings_dim"], cfg["num_tokens"]
        self.proj = nn.Sequential(nn.Linear(idd, 2 * idd), nn.GELU(), nn.Linear(2 * idd, d * nt))
        self.norm = LayerNorm(d)
        f = nn.Module()
        f.proj_in = nn.Linear(cfg["clip_embeddings_dim"], d)
        inner = d
        layers = []
        for _ in range(cfg["depth"]):
            attn = nn.Module()
            attn.norm1, attn.norm2 = LayerNorm(d), LayerNorm(d)
            attn.to_q = nn.Linear(d, inner, bias=False)
            attn.to_kv = nn.Linear(d, 2 * inner, bias=False)
            attn.to_out = nn.Linear(inner, d, bias=False)
            ff = nn.Sequential(LayerNorm(d), nn.Linear(d, d * cfg["ff_mult"], bias=False),
                               nn.GELU(), nn.Linear(d * cfg["ff_mult"], d, bias=False))
            layers.append(nn.ModuleList([attn, ff]))
        f.layers = nn.ModuleList(layers)
        f.proj_out = nn.Linear(d, d)
        f.norm_out = LayerNorm(d)
        self.fusion_model = f

    def forward(self, id_embeds, clip_embeds):
        cfg = self.cfg
        d, dh = cfg["cross_attention_dim"], cfg["dim_head"]
        heads = d // dh
        latents = self.norm(self.proj(id_embeds).reshape(-1, cfg["num_tokens"], d))
        f = self.fusion_model
        x = f.proj_in(clip_embeds)
        for attn, ff in f.layers:
            xn, ln = attn.norm1(x), attn.norm2(latents)
            b, nl, _ = ln.shape
            kv_in = torch.cat([xn, ln], dim=1)
            k, v = attn.to_kv(kv_in).chunk(2, dim=-1)
            q = attn.to_q(ln).reshape(b, nl, heads, dh)
            k, v = k.reshape(b, -1, heads, dh), v.reshape(b, -1, heads, dh)
            s = dh ** -0.25
            o = attention(q * s, k * s, v, scale=1.0)
            latents = latents + attn.to_out(o.reshape(b, nl, d))
            latents = latents + ff(latents)
        return f.norm_out(f.proj_out(latents))


def build(cfg: dict, device, *, checkpoint: bool = False, meta: bool = False) -> dict:
    """The five models of a configuration file's `models` section, with
    uninitialised float32 parameters on `device` (or on the meta device)."""
    m = cfg["models"]
    with torch.device("meta"):
        models = {"unet": UNet(m["unet"], checkpoint=checkpoint), "vae": VAE(m["vae"]),
                  "clip": CLIPVision(m["clip"]), "pose_net": PoseNet(m["pose_net"]),
                  "face_encoder": FusionFaceId(m["face_encoder"])}
    if not meta:
        for mod in models.values():
            mod.to_empty(device=device)
    return models
