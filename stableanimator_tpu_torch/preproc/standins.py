"""Stand-ins for the antelopev2 ONNX files, exported from torch with seeded
weights, for smoke runs and tests while the real files are not at hand.

  * `IResNet` is insightface's iresnet (the architecture of antelopev2's
    glintr100.onnx recogniser is `iresnet100`: blocks [3, 13, 30, 3] at
    widths 64/128/256/512, BN-PReLU units, a BN-Dropout-FC(512x7x7 -> 512)-
    BN1d head on a 112x112 input);
  * `ScrfdStandin` has SCRFD's signature (scrfd_10g_bnkps.onnx): for each
    of the strides 8/16/32 a score, a box-distance and a keypoint head over
    2 anchors per cell, 9 outputs in the order scores, boxes, keypoints.

`export_onnx` writes a module with torch's legacy (TorchScript) exporter,
which needs the `onnx` package only to inject onnxscript functions that
these modules never use; the injection is skipped for the call.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def _conv3x3(cin, cout, stride=1):
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


class IBasicBlock(nn.Module):
    """BN - conv3x3 - BN - PReLU - conv3x3(stride) - BN, plus the shortcut."""

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(inplanes, eps=1e-5)
        self.conv1 = _conv3x3(inplanes, planes)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-5)
        self.prelu = nn.PReLU(planes)
        self.conv2 = _conv3x3(planes, planes, stride)
        self.bn3 = nn.BatchNorm2d(planes, eps=1e-5)
        self.downsample = downsample

    def forward(self, x):
        out = self.bn3(self.conv2(self.prelu(self.bn2(self.conv1(self.bn1(x))))))
        return out + (x if self.downsample is None else self.downsample(x))


class IResNet(nn.Module):
    """insightface's iresnet; `IResNet()` is iresnet100 (glintr100's)."""

    def __init__(self, layers=(3, 13, 30, 3), widths=(64, 128, 256, 512),
                 num_features=512, input_size=112):
        super().__init__()
        self.inplanes = widths[0]
        self.conv1 = _conv3x3(3, widths[0])
        self.bn1 = nn.BatchNorm2d(widths[0], eps=1e-5)
        self.prelu = nn.PReLU(widths[0])
        self.layers = nn.Sequential(*(self._make_layer(w, n) for w, n in zip(widths, layers)))
        self.bn2 = nn.BatchNorm2d(widths[-1], eps=1e-5)
        self.dropout = nn.Dropout(p=0.0)
        side = input_size // 2 ** len(layers)
        self.fc = nn.Linear(widths[-1] * side * side, num_features)
        self.features = nn.BatchNorm1d(num_features, eps=1e-5)

    def _make_layer(self, planes, blocks):
        downsample = nn.Sequential(nn.Conv2d(self.inplanes, planes, 1, stride=2, bias=False),
                                   nn.BatchNorm2d(planes, eps=1e-5))
        layers = [IBasicBlock(self.inplanes, planes, 2, downsample)]
        self.inplanes = planes
        layers += [IBasicBlock(planes, planes) for _ in range(1, blocks)]
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.layers(self.prelu(self.bn1(self.conv1(x))))
        x = self.dropout(torch.flatten(self.bn2(x), 1))
        return self.features(self.fc(x))


@torch.no_grad()
def seeded_iresnet(seed: int = 0, **kwargs) -> IResNet:
    """An `IResNet` in eval mode with seeded weights and BatchNorm running
    statistics and affines that are not the identity. Each block's last
    BatchNorm scales its branch by ~0.2 (as training leaves it, roughly), so
    the residual stream stays O(1) through the 49 blocks of iresnet100."""
    gen = torch.Generator().manual_seed(seed)
    model = IResNet(**kwargs).eval()
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * (1.0 / fan_in) ** 0.5)
            if m.bias is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.01)
        elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
            n = m.num_features
            m.weight.copy_(1.0 + 0.1 * torch.randn(n, generator=gen))
            m.bias.copy_(0.1 * torch.randn(n, generator=gen))
            m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
            m.running_var.copy_(1.0 + 0.2 * torch.rand(n, generator=gen))
        elif isinstance(m, nn.PReLU):
            m.weight.copy_(0.25 + 0.05 * torch.randn(m.weight.shape, generator=gen))
    for m in model.modules():
        if isinstance(m, IBasicBlock):
            m.bn3.weight.mul_(0.2)
    return model


class ScrfdStandin(nn.Module):
    """SCRFD's output signature over one strided conv per stride: 2 anchors
    a cell, outputs (scores x3, box distances x3, keypoints x3). `score_bias`
    is added to the score logits (a positive one makes it detect) and the
    box distances are scaled by `box_scale`."""

    def __init__(self, score_bias: float = 0.0, box_scale: float = 1.0, strides=(8, 16, 32)):
        super().__init__()
        self.heads = nn.ModuleList(nn.Conv2d(3, 2 * (1 + 4 + 10), s, stride=s) for s in strides)
        self.score_bias = score_bias
        self.box_scale = box_scale

    def forward(self, x):
        outs_s, outs_b, outs_k = [], [], []
        for head in self.heads:
            y = head(x)                                    # [1, 30, h, w]
            _, _, hh, ww = y.shape
            y = y.reshape(1, 2, 15, hh, ww).permute(0, 3, 4, 1, 2).reshape(1, hh * ww * 2, 15)
            outs_s.append((y[..., :1] + self.score_bias).sigmoid().reshape(-1, 1))
            outs_b.append(y[..., 1:5].abs().reshape(-1, 4) * self.box_scale)
            outs_k.append(y[..., 5:].reshape(-1, 10))
        return tuple(outs_s) + tuple(outs_b) + tuple(outs_k)


def export_onnx(model: nn.Module, inputs: tuple, path: str, opset: int = 17,
                constant_folding: bool = True) -> str:
    """Export `model` (eval mode, CPU) at `inputs` to `path` with the legacy
    exporter; returns the path. `constant_folding=False` keeps each
    BatchNorm a node of its own (folding it into the convolution before it
    makes the file a slightly different function from the module: its
    pre-activations move by ~1e-6, enough to flip PReLU kinks, which moves
    the input gradient of iresnet100 by ~1e-4 of its norm)."""
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    saved = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, custom_opsets: model_bytes
    try:
        with torch.no_grad():
            torch.onnx.export(model.eval(), inputs, path, opset_version=opset, dynamo=False,
                              do_constant_folding=constant_folding)
    finally:
        onnx_proto_utils._add_onnxscript_fn = saved
    return path


def write_antelopev2(directory: str, recogniser: nn.Module | None = None, seed: int = 0) -> str:
    """Write scrfd_10g_bnkps.onnx (a `ScrfdStandin` at SCRFD's 640x640 input
    that detects at stride 32 only, so at most 800 candidate boxes, x16 in
    size, reach the NMS) and glintr100.onnx (`recogniser` at 112x112, by
    default the seeded full `IResNet`, its BatchNorms unfolded) into
    `directory`; returns it."""
    import os

    os.makedirs(directory, exist_ok=True)
    torch.manual_seed(seed)
    detector = ScrfdStandin(score_bias=3.0, box_scale=16.0)
    with torch.no_grad():
        for head in detector.heads[:2]:          # strides 8 and 16 never score
            head.bias[0::15].fill_(-6.0)
    export_onnx(detector, (torch.zeros(1, 3, 640, 640),),
                os.path.join(directory, "scrfd_10g_bnkps.onnx"))
    export_onnx(recogniser if recogniser is not None else seeded_iresnet(seed),
                (torch.zeros(1, 3, 112, 112),), os.path.join(directory, "glintr100.onnx"),
                constant_folding=False)
    return directory
