"""Shared building blocks of the video UNet and temporal VAE (port of the
JAX package's `models/layers.py`).

Layout is channels-last, as in the JAX package: spatial tensors
[N, H, W, C] (N = batch * frames) and video tensors [B, F, H, W, C].
Convolutions permute to NCHW views with channels-last strides, which cuDNN
takes as they are. Parameter names follow diffusers, so released torch
checkpoints load with `load_state_dict(strict=True)`.

Parameters are stored in the compute dtype (`cast_compute`), except the
norms' affine and the AlphaBlender mix factor, which stay fp32 as the JAX
package keeps them (statistics and the sigmoid are computed in fp32).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from stableanimator_tpu_torch.ops.norms import group_norm, layer_norm
from stableanimator_tpu_torch.ops.quant import int8_dense, quantize_weight
from stableanimator_tpu_torch.parallel import sequence


class Conv2d(nn.Conv2d):
    """nn.Conv2d on channels-last [N, H, W, C] input."""

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class Conv3d(nn.Conv3d):
    """nn.Conv3d on channels-last [B, F, H, W, C] input."""

    def forward(self, x):
        return super().forward(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)

    def forward_halo(self, x):
        """The convolution of a frame block that `sequence.halo_exchange`
        extended by the padding's frames: no padding over frames."""
        pad = (0,) + tuple(self.padding[1:])
        out = F.conv3d(x.permute(0, 4, 1, 2, 3), self.weight, self.bias, self.stride, pad,
                       self.dilation, self.groups)
        return out.permute(0, 2, 3, 4, 1)


class GroupNorm(nn.Module):
    """GroupNorm with fp32 statistics over channels-last input, followed by
    SiLU when the call asks (`ops/norms.py::group_norm`)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x, stats_group=None, silu: bool = False):
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps, stats_group,
                          silu)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with fp32 statistics."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


def sinusoidal_embedding(timesteps: torch.Tensor, dim: int,
                         max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding, [cos | sin] order, always fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device)
                      / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """linear -> SiLU -> linear."""

    def __init__(self, in_dim: int, embed_dim: int, out_dim: int | None = None):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, out_dim if out_dim is not None else embed_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class AlphaBlender(nn.Module):
    """Learned sigmoid blend: a*spatial + (1-a)*temporal, a = sigmoid(mix)
    computed in fp32 and cast to the activation dtype; reverse=True uses
    a = 1 - sigmoid(mix) (the VAE temporal decoder)."""

    def __init__(self, alpha: float = 0.5, reverse: bool = False):
        super().__init__()
        self.reverse = reverse
        self.mix_factor = nn.Parameter(torch.tensor([alpha], dtype=torch.float32))

    def alpha(self) -> torch.Tensor:
        a = torch.sigmoid(self.mix_factor.float())
        return 1.0 - a if self.reverse else a

    def forward(self, x_spatial, x_temporal):
        a = self.alpha().to(x_spatial.dtype)
        return a * x_spatial + (1.0 - a) * x_temporal


class ResnetBlock2D(nn.Module):
    """GroupNorm/SiLU/conv x2 with optional time-embedding add and a 1x1
    shortcut on channel change. Input [N, H, W, C]."""

    def __init__(self, in_ch: int, out_ch: int, temb_ch: int | None = None,
                 eps: float = 1e-6):
        super().__init__()
        self.norm1 = GroupNorm(32, in_ch, eps)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_ch, out_ch) if temb_ch is not None else None
        self.norm2 = GroupNorm(32, out_ch, eps)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x, silu=True))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(self.norm2(h, silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


def _temporal_conv(conv: Conv3d, x, group):
    """conv over the frames of x; with a frame group, of x's frame block."""
    if group is None:
        return conv(x)
    return conv.forward_halo(sequence.halo_exchange(x, 1, conv.padding[0]))


class TemporalResnetBlock(nn.Module):
    """Resnet over the frame axis: Conv3d (3,1,1) on [B, F, H, W, C].

    Under a frame-sharded mesh (`parallel/sequence.py`) x is this rank's
    block of frames: each convolution takes a one-frame halo from the
    neighbouring blocks and both norms' statistics cover every frame."""

    def __init__(self, in_ch: int, out_ch: int, temb_ch: int | None = None,
                 eps: float = 1e-6):
        super().__init__()
        self.norm1 = GroupNorm(32, in_ch, eps)
        self.conv1 = Conv3d(in_ch, out_ch, (3, 1, 1), padding=(1, 0, 0))
        self.time_emb_proj = nn.Linear(temb_ch, out_ch) if temb_ch is not None else None
        self.norm2 = GroupNorm(32, out_ch, eps)
        self.conv2 = Conv3d(out_ch, out_ch, (3, 1, 1), padding=(1, 0, 0))
        self.conv_shortcut = Conv3d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x, temb=None):
        group = sequence.frame_group()
        h = _temporal_conv(self.conv1, self.norm1(x, group, silu=True), group)
        if self.time_emb_proj is not None and temb is not None:
            # temb: [B, F, E]
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None, :]
        h = _temporal_conv(self.conv2, self.norm2(h, group, silu=True), group)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class SpatioTemporalResBlock(nn.Module):
    """Spatial resnet -> temporal resnet -> AlphaBlender.
    Input [N, H, W, C] with N = B * num_frames; temb [N, E] or None."""

    def __init__(self, in_ch: int, out_ch: int, temb_ch: int | None = None,
                 eps: float = 1e-6, temporal_eps: float | None = None,
                 merge_factor: float = 0.5, reverse_time_mix: bool = False):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(in_ch, out_ch, temb_ch, eps)
        self.temporal_res_block = TemporalResnetBlock(
            out_ch, out_ch, temb_ch, temporal_eps if temporal_eps is not None else eps)
        self.time_mixer = AlphaBlender(merge_factor, reverse=reverse_time_mix)

    def forward(self, x, temb=None, *, num_frames: int):
        h = self.spatial_res_block(x, temb)
        n, hh, ww, c = h.shape
        b = n // num_frames
        h_video = h.reshape(b, num_frames, hh, ww, c)
        temb_video = temb.reshape(b, num_frames, -1) if temb is not None else None
        h_temporal = self.temporal_res_block(h_video, temb_video)
        return self.time_mixer(h_video, h_temporal).reshape(n, hh, ww, c)


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv; symmetric padding 1 (UNet) or (0,1)x(0,1) (VAE
    encoder)."""

    def __init__(self, ch: int, asymmetric_padding: bool = False):
        super().__init__()
        self.asymmetric_padding = asymmetric_padding
        self.conv = Conv2d(ch, ch, 3, stride=2, padding=0 if asymmetric_padding else 1)

    def forward(self, x):
        if self.asymmetric_padding:
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
        return self.conv(x)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsample of [N, H, W, C]."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)


class Upsample2D(nn.Module):
    """Nearest x2 + 3x3 conv. (The JAX package computes the same function
    as four 2x2 phase convolutions; the plain form is exact.)"""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(upsample_nearest_2x(x))


class QuantLinear(nn.Linear):
    """nn.Linear computed through the int8 path (W8A8, `ops/quant.py`). Its
    parameters are nn.Linear's, so the same state dict loads either way
    (strict); only the forward differs. The weight's int8 form is kept until
    the weight changes: the JAX package quantises inside the denoise loop
    and XLA hoists the loop-invariant quantisation out of it."""

    _cache: tuple | None = None

    def quantized(self):
        """(int8 weight [out, in], fp32 scale [out]) of the current weight."""
        w = self.weight
        key = (w.data_ptr(), w._version, w.dtype, torch.is_inference_mode_enabled())
        if self._cache is None or self._cache[0] != key:
            with torch.no_grad():
                self._cache = (key, quantize_weight(w))
        return self._cache[1]

    def forward(self, x):
        return int8_dense(x, self.weight, self.bias, quantized=self.quantized())


def make_linear(in_features: int, out_features: int, bias: bool = True,
                quant: bool = False) -> nn.Linear:
    """nn.Linear, or its int8 twin QuantLinear when `quant`."""
    return (QuantLinear if quant else nn.Linear)(in_features, out_features, bias=bias)


class GEGLU(nn.Module):
    """x W1 * gelu(x W2) from one projection; exact erf GELU. quant: the
    projection is a QuantLinear (the computation of
    `ops/quant.py::int8_geglu`)."""

    def __init__(self, dim: int, inner: int, quant: bool = False):
        super().__init__()
        self.proj = make_linear(dim, inner * 2, quant=quant)

    def forward(self, x):
        value, gate = self.proj(x).chunk(2, dim=-1)
        return value * F.gelu(gate)


class FeedForward(nn.Module):
    """diffusers FeedForward: net = [GEGLU(proj), dropout slot, Linear]."""

    def __init__(self, dim: int, dim_out: int | None = None, mult: int = 4,
                 quant: bool = False):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.ModuleList([GEGLU(dim, inner, quant), nn.Identity(),
                                  make_linear(inner, dim_out if dim_out is not None else dim,
                                              quant=quant)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


FP32_MODULES = (GroupNorm, LayerNorm, AlphaBlender)


def cast_compute(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Store `module`'s parameters in the compute dtype, keeping the fp32
    ones (norm affine, AlphaBlender mix) in fp32."""
    for m in module.modules():
        if isinstance(m, FP32_MODULES):
            continue
        for name, p in m.named_parameters(recurse=False):
            p.data = p.data.to(dtype)
    return module


def module_dtype(module: nn.Module) -> torch.dtype:
    """The compute dtype of a module: that of its first non-fp32-island
    parameter."""
    for m in module.modules():
        if isinstance(m, FP32_MODULES):
            continue
        for p in m.parameters(recurse=False):
            return p.dtype
    return torch.float32
