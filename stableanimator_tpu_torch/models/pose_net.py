"""PoseNet: skeleton-image encoder whose output is added to the UNet's
conv_in activations per frame (port of the JAX package's
`models/pose_net.py`).

Input [N, H, W, 3] pose renderings in [-1, 1]; output
[N, H/8, W/8, noise_latent_channels] times a learned scalar `scale`.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from stableanimator_tpu_torch.core.config import PoseNetConfig
from stableanimator_tpu_torch.models.layers import Conv2d, module_dtype


class PoseNet(nn.Module):
    def __init__(self, config: PoseNetConfig | None = None):
        super().__init__()
        cfg = self.config = config or PoseNetConfig()
        c = cfg.conv_channels
        # 3x3 refine + 4x4/2 downsample pairs, SiLU after each conv
        # (conv_layers.{0,2,...,14} as in the reference's nn.Sequential)
        specs = [(c[0], c[0], 3, 1), (c[0], c[1], 4, 2), (c[1], c[1], 3, 1),
                 (c[1], c[2], 4, 2), (c[2], c[2], 3, 1), (c[2], c[3], 4, 2),
                 (c[3], c[3], 3, 1), (c[3], c[4], 3, 1)]
        layers = []
        for cin, cout, k, s in specs:
            layers += [Conv2d(cin, cout, k, stride=s, padding=1), nn.SiLU()]
        self.conv_layers = nn.Sequential(*layers)
        self.final_proj = Conv2d(c[4], cfg.noise_latent_channels, 1)
        self.scale = nn.Parameter(torch.full((1,), cfg.scale_init))

    def forward(self, x):
        x = self.final_proj(self.conv_layers(x.to(module_dtype(self))))
        return x * self.scale.to(x.dtype)
