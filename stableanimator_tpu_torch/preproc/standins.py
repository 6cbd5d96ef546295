"""Stand-ins for the antelopev2 and DWPose ONNX files, exported from torch
with seeded weights, for smoke runs and tests while the real files are not
at hand.

  * `IResNet` is insightface's iresnet (the architecture of antelopev2's
    glintr100.onnx recogniser is `iresnet100`: blocks [3, 13, 30, 3] at
    widths 64/128/256/512, BN-PReLU units, a BN-Dropout-FC(512x7x7 -> 512)-
    BN1d head on a 112x112 input);
  * `ScrfdStandin` has SCRFD's signature (scrfd_10g_bnkps.onnx): for each
    of the strides 8/16/32 a score, a box-distance and a keypoint head over
    2 anchors per cell, 9 outputs in the order scores, boxes, keypoints;
  * `Yolox` is Megvii YOLOX (exps/default/yolox_l.py: depth 1.0, width 1.0
    by default): Focus stem, CSPDarknet, SPP, PAFPN and the decoupled head
    with 80 classes, [N,3,640,640] -> [N,8400,85], obj and cls through
    sigmoid, as DWPose's yolox_l.onnx;
  * `RTMPose` is mmpose's RTMPose-l for COCO-WholeBody at 384x288
    (rtmpose-l_8xb32-270e_coco-wholebody-384x288.py, the architecture of
    DWPose's dw-ll_ucoco_384.onnx): a CSPNeXt backbone (P5, deepen and widen
    1.0, channel attention) and an RTMCC head (7x7 final conv, ScaleNorm +
    108 -> 256 linear, a gated attention unit with s 128 and expansion 2,
    SimCC split ratio 2), [N,3,384,288] -> [N,133,576], [N,133,768].

  * `I3DStandin` is the I3D-shaped Conv3d network of the evaluation drill
    (the root tools/eval_drill.py's stand-in): [1, 3, T, H, W] clips to
    [1, 16] features, for FVD smoke runs while no I3D export is at hand.

`export_onnx` writes a module with torch's legacy (TorchScript) exporter,
which needs the `onnx` package only to inject onnxscript functions that
these modules never use; the injection is skipped for the call.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


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
                constant_folding: bool = True, names=None) -> str:
    """Export `model` (eval mode, CPU) at `inputs` to `path` with the legacy
    exporter; returns the path. `constant_folding=False` keeps each
    BatchNorm a node of its own (folding it into the convolution before it
    makes the file a slightly different function from the module: its
    pre-activations move by ~1e-6, enough to flip PReLU kinks, which moves
    the input gradient of iresnet100 by ~1e-4 of its norm). `names`
    (input names, output names) names the graph's values and makes their
    first dimension, the batch, dynamic."""
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    kwargs = {}
    if names is not None:
        kwargs = dict(input_names=list(names[0]), output_names=list(names[1]),
                      dynamic_axes={n: {0: "batch"} for n in (*names[0], *names[1])})
    saved = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, custom_opsets: model_bytes
    try:
        with torch.no_grad():
            torch.onnx.export(model.eval(), inputs, path, opset_version=opset, dynamo=False,
                              do_constant_folding=constant_folding, **kwargs)
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


class I3DStandin(nn.Module):
    """An I3D-shaped network for FVD: a 7x7x7 Conv3d (3 -> 8 channels, padding
    3) at `stride`, ReLU, an average pool of window `pool` at stride 2, a
    1x1x1 Conv3d to 16 channels and the mean over time and space. The
    defaults are the evaluation drill's; tests/test_misc.py::TestFVD's
    stand-in is stride (2, 4, 4), pool (2, 8, 8)."""

    def __init__(self, stride=(2, 8, 8), pool=(2, 4, 4)):
        super().__init__()
        self.conv = nn.Conv3d(3, 8, (7, 7, 7), stride=stride, padding=3)
        self.head = nn.Conv3d(8, 16, 1)
        self.pool = tuple(pool)

    def forward(self, x):
        h = torch.relu(self.conv(x))
        h = F.avg_pool3d(h, self.pool, stride=2)
        return self.head(h).mean(dim=(2, 3, 4))


# --- DWPose: YOLOX-L and RTMPose-l -----------------------------------------

class ConvBnAct(nn.Sequential):
    """YOLOX's BaseConv / mmcv's ConvModule: conv (no bias), BatchNorm, SiLU."""

    def __init__(self, cin, cout, k, stride=1, groups=1, eps=1e-3):
        super().__init__(nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, groups=groups, bias=False),
                         nn.BatchNorm2d(cout, eps=eps), nn.SiLU())


class SPPBottleneck(nn.Module):
    """1x1 conv to half width, max pools 5/9/13 concatenated, 1x1 conv (the
    same block in YOLOX and CSPNeXt)."""

    def __init__(self, cin, cout, eps=1e-3):
        super().__init__()
        self.conv1 = ConvBnAct(cin, cin // 2, 1, eps=eps)
        self.pools = nn.ModuleList(nn.MaxPool2d(k, 1, k // 2) for k in (5, 9, 13))
        self.conv2 = ConvBnAct(cin // 2 * 4, cout, 1, eps=eps)

    def forward(self, x):
        x = self.conv1(x)
        return self.conv2(torch.cat([x] + [pool(x) for pool in self.pools], 1))


class _DarknetBottleneck(nn.Module):
    def __init__(self, c, shortcut):
        super().__init__()
        self.conv1 = ConvBnAct(c, c, 1)
        self.conv2 = ConvBnAct(c, c, 3)
        self.use_add = shortcut

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.use_add else y


class _YoloxCSP(nn.Module):
    """YOLOX's CSPLayer (expansion 0.5)."""

    def __init__(self, cin, cout, n, shortcut=True):
        super().__init__()
        hidden = cout // 2
        self.conv1 = ConvBnAct(cin, hidden, 1)
        self.conv2 = ConvBnAct(cin, hidden, 1)
        self.conv3 = ConvBnAct(2 * hidden, cout, 1)
        self.m = nn.Sequential(*(_DarknetBottleneck(hidden, shortcut) for _ in range(n)))

    def forward(self, x):
        return self.conv3(torch.cat([self.m(self.conv1(x)), self.conv2(x)], 1))


class Yolox(nn.Module):
    """YOLOX (YOLOPAFPN + YOLOXHead) in its exported inference form; the
    defaults are YOLOX-L."""

    NUM_CLASSES = 80

    def __init__(self, depth=1.0, width=1.0):
        super().__init__()
        base, d = int(width * 64), max(round(depth * 3), 1)
        c3, c4, c5 = base * 4, base * 8, base * 16
        self.stem = ConvBnAct(12, base, 3)                   # Focus: space-to-depth, conv
        self.dark2 = nn.Sequential(ConvBnAct(base, base * 2, 3, 2), _YoloxCSP(base * 2, base * 2, d))
        self.dark3 = nn.Sequential(ConvBnAct(base * 2, c3, 3, 2), _YoloxCSP(c3, c3, d * 3))
        self.dark4 = nn.Sequential(ConvBnAct(c3, c4, 3, 2), _YoloxCSP(c4, c4, d * 3))
        self.dark5 = nn.Sequential(ConvBnAct(c4, c5, 3, 2), SPPBottleneck(c5, c5),
                                   _YoloxCSP(c5, c5, d, shortcut=False))
        n = round(3 * depth)
        self.lateral_conv0 = ConvBnAct(c5, c4, 1)
        self.C3_p4 = _YoloxCSP(2 * c4, c4, n, False)
        self.reduce_conv1 = ConvBnAct(c4, c3, 1)
        self.C3_p3 = _YoloxCSP(2 * c3, c3, n, False)
        self.bu_conv2 = ConvBnAct(c3, c3, 3, 2)
        self.C3_n3 = _YoloxCSP(2 * c3, c4, n, False)
        self.bu_conv1 = ConvBnAct(c4, c4, 3, 2)
        self.C3_n4 = _YoloxCSP(2 * c4, c5, n, False)
        hw = int(256 * width)
        self.stems = nn.ModuleList(ConvBnAct(c, hw, 1) for c in (c3, c4, c5))
        self.cls_convs = nn.ModuleList(nn.Sequential(ConvBnAct(hw, hw, 3), ConvBnAct(hw, hw, 3))
                                       for _ in range(3))
        self.reg_convs = nn.ModuleList(nn.Sequential(ConvBnAct(hw, hw, 3), ConvBnAct(hw, hw, 3))
                                       for _ in range(3))
        self.cls_preds = nn.ModuleList(nn.Conv2d(hw, self.NUM_CLASSES, 1) for _ in range(3))
        self.reg_preds = nn.ModuleList(nn.Conv2d(hw, 4, 1) for _ in range(3))
        self.obj_preds = nn.ModuleList(nn.Conv2d(hw, 1, 1) for _ in range(3))

    def levels(self, x):
        """The PAFPN's outputs at strides 8, 16, 32."""
        x = self.stem(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2],
                                 x[..., 1::2, 1::2]], 1))
        x2 = self.dark3(self.dark2(x))
        x1 = self.dark4(x2)
        x0 = self.dark5(x1)
        fpn_out0 = self.lateral_conv0(x0)
        f_out0 = self.C3_p4(torch.cat([F.interpolate(fpn_out0, scale_factor=2.0), x1], 1))
        fpn_out1 = self.reduce_conv1(f_out0)
        pan_out2 = self.C3_p3(torch.cat([F.interpolate(fpn_out1, scale_factor=2.0), x2], 1))
        pan_out1 = self.C3_n3(torch.cat([self.bu_conv2(pan_out2), fpn_out1], 1))
        pan_out0 = self.C3_n4(torch.cat([self.bu_conv1(pan_out1), fpn_out0], 1))
        return pan_out2, pan_out1, pan_out0

    def forward(self, x):
        outs = []
        for k, feat in enumerate(self.levels(x)):
            f = self.stems[k](feat)
            reg = self.reg_convs[k](f)
            outs.append(torch.cat([self.reg_preds[k](reg), self.obj_preds[k](reg).sigmoid(),
                                   self.cls_preds[k](self.cls_convs[k](f)).sigmoid()],
                                  1).flatten(2))
        return torch.cat(outs, 2).permute(0, 2, 1)


class _ChannelAttention(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.fc = nn.Conv2d(c, c, 1)
        self.act = nn.Hardsigmoid()

    def forward(self, x):
        return x * self.act(self.fc(F.adaptive_avg_pool2d(x, 1)))


class _CSPNeXtBlock(nn.Module):
    """3x3 conv, then a depthwise-separable 5x5 conv, plus the identity."""

    def __init__(self, c, add_identity, eps):
        super().__init__()
        self.conv1 = ConvBnAct(c, c, 3, eps=eps)
        self.conv2_dw = ConvBnAct(c, c, 5, groups=c, eps=eps)
        self.conv2_pw = ConvBnAct(c, c, 1, eps=eps)
        self.add_identity = add_identity

    def forward(self, x):
        y = self.conv2_pw(self.conv2_dw(self.conv1(x)))
        return y + x if self.add_identity else y


class _CSPNeXtLayer(nn.Module):
    """mmdet's CSPLayer with CSPNeXt blocks and channel attention."""

    def __init__(self, cin, cout, n, add_identity, eps):
        super().__init__()
        mid = cout // 2
        self.main_conv = ConvBnAct(cin, mid, 1, eps=eps)
        self.short_conv = ConvBnAct(cin, mid, 1, eps=eps)
        self.final_conv = ConvBnAct(2 * mid, cout, 1, eps=eps)
        self.blocks = nn.Sequential(*(_CSPNeXtBlock(mid, add_identity, eps) for _ in range(n)))
        self.attention = _ChannelAttention(2 * mid)

    def forward(self, x):
        x_final = torch.cat([self.blocks(self.main_conv(x)), self.short_conv(x)], 1)
        return self.final_conv(self.attention(x_final))


class _ScaleNorm(nn.Module):
    def __init__(self, dim, eps=1e-5):
        super().__init__()
        self.scale, self.eps = dim ** -0.5, eps
        self.g = nn.Parameter(torch.ones(1))

    def forward(self, x):
        norm = torch.linalg.norm(x, dim=-1, keepdim=True) * self.scale
        return x / norm.clamp(min=self.eps) * self.g


class _RTMCCBlock(nn.Module):
    """The gated attention unit of the RTMCC head (self-attention, no
    relative bias, no position encoding): ScaleNorm, one linear to u, v and
    a shared base of width s, q and k from the base by per-dim scale and
    offset, relu(qk / sqrt(s))^2 weights, gated output, scaled residual."""

    def __init__(self, dims, expansion=2, s=128, eps=1e-5):
        super().__init__()
        self.e, self.s = int(dims * expansion), s
        self.ln = _ScaleNorm(dims, eps)
        self.uv = nn.Linear(dims, 2 * self.e + s, bias=False)
        self.gamma = nn.Parameter(torch.rand(2, s))
        self.beta = nn.Parameter(torch.rand(2, s))
        self.o = nn.Linear(self.e, dims, bias=False)
        self.res_scale = nn.Parameter(torch.ones(dims))

    def forward(self, x):
        uv = F.silu(self.uv(self.ln(x)))
        u, v, base = torch.split(uv, [self.e, self.e, self.s], dim=2)
        q, k = torch.unbind(base.unsqueeze(2) * self.gamma[None, None] + self.beta, dim=2)
        kernel = torch.square(F.relu(torch.bmm(q, k.permute(0, 2, 1)) / math.sqrt(self.s)))
        return x * self.res_scale + self.o(u * torch.bmm(kernel, v))


class RTMPose(nn.Module):
    """CSPNeXt (P5) + RTMCC head for COCO-WholeBody's 133 keypoints at 384x288
    (INPUT_SIZE is (w, h)); the defaults are RTMPose-l."""

    ARCH = ((64, 128, 3, True, False), (128, 256, 6, True, False), (256, 512, 6, True, False),
            (512, 1024, 3, False, True))
    INPUT_SIZE, KEYPOINTS, SPLIT_RATIO = (288, 384), 133, 2.0

    def __init__(self, deepen=1.0, widen=1.0):
        super().__init__()
        eps = 1e-5
        stem = int(self.ARCH[0][0] * widen // 2)
        self.stem = nn.Sequential(ConvBnAct(3, stem, 3, 2, eps=eps), ConvBnAct(stem, stem, 3, eps=eps),
                                  ConvBnAct(stem, int(self.ARCH[0][0] * widen), 3, eps=eps))
        stages = []
        for cin, cout, n, add_identity, spp in self.ARCH:
            cin, cout, n = int(cin * widen), int(cout * widen), max(round(n * deepen), 1)
            stage = [ConvBnAct(cin, cout, 3, 2, eps=eps)]
            if spp:
                stage.append(SPPBottleneck(cout, cout, eps=eps))
            stage.append(_CSPNeXtLayer(cout, cout, n, add_identity, eps))
            stages.append(nn.Sequential(*stage))
        self.stages = nn.Sequential(*stages)
        w, h = self.INPUT_SIZE
        flat = (w // 32) * (h // 32)
        self.final_layer = nn.Conv2d(cout, self.KEYPOINTS, 7, padding=3)
        self.mlp = nn.Sequential(_ScaleNorm(flat), nn.Linear(flat, 256, bias=False))
        self.gau = _RTMCCBlock(256)
        self.cls_x = nn.Linear(256, int(w * self.SPLIT_RATIO), bias=False)
        self.cls_y = nn.Linear(256, int(h * self.SPLIT_RATIO), bias=False)

    def forward(self, x):
        feats = self.gau(self.mlp(self.final_layer(self.stages(self.stem(x))).flatten(2)))
        return self.cls_x(feats), self.cls_y(feats)


@torch.no_grad()
def _seed_and_calibrate(model: nn.Module, gen: torch.Generator, calib: torch.Tensor) -> nn.Module:
    """Seeded weights (N(0, 1/fan_in) convolutions and linears, BatchNorm
    affines near the identity), then each BatchNorm's running statistics from
    one forward over `calib` in training mode, so that every normalised
    activation is O(1) through the whole depth, as trained statistics keep
    it. Returns the model in eval mode."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * m.weight[0].numel() ** -0.5)
            if m.bias is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.01)
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.copy_(1.0 + 0.1 * torch.randn(m.num_features, generator=gen))
            m.bias.copy_(0.1 * torch.randn(m.num_features, generator=gen))
            m.reset_running_stats()
            m.momentum = None                     # a cumulative average: one batch's statistics
        elif isinstance(m, _RTMCCBlock):
            m.gamma.copy_(torch.rand(m.gamma.shape, generator=gen))
            m.beta.copy_(torch.rand(m.beta.shape, generator=gen))
    model.train()(calib)
    return model.eval()


# the stand-in detector's boxes: square, DETECTOR_BOX_PX (in the 640x640
# letterboxed input) on a side, from the stride-32 level only; an anchor's
# person score passes the 0.3 final threshold at about the top
# DETECTOR_TOP_SHARE of the calibration's stride-32 objectness logits
DETECTOR_BOX_PX = 640.0
DETECTOR_TOP_SHARE = 0.01


@torch.no_grad()
def seeded_yolox(seed: int = 0, depth: float = 1.0, width: float = 1.0) -> Yolox:
    """A `Yolox` in eval mode, seeded and calibrated on uniform 0-255 noise at
    640x640, whose head says: class 0 (person) only, at stride 32 only,
    square boxes of DETECTOR_BOX_PX centred on their anchors (so that the
    IoUs the NMS compares with its 0.45 threshold are a few fixed values,
    none within 3e-3 of it), objectness from the features (its weights
    scaled by 0.1) with its bias set so that a few anchors of a noise frame
    pass the detector's thresholds: a small, non-zero number of boxes after
    NMS, which move with the frame's content."""
    gen = torch.Generator().manual_seed(seed)
    model = Yolox(depth, width)
    calib = torch.rand((2, 3, 640, 640), generator=gen) * 255.0
    _seed_and_calibrate(model, gen, calib)
    for k, stride in enumerate((8, 16, 32)):
        model.reg_preds[k].weight.zero_()
        model.reg_preds[k].bias.copy_(torch.tensor(
            [0.0, 0.0, math.log(DETECTOR_BOX_PX / stride), math.log(DETECTOR_BOX_PX / stride)]))
        model.cls_preds[k].weight.zero_()
        model.cls_preds[k].bias.fill_(-12.0)
        model.cls_preds[k].bias[0] = 3.0
        if k < 2:
            model.obj_preds[k].weight.zero_()
            model.obj_preds[k].bias.fill_(-12.0)
    model.obj_preds[2].weight.mul_(0.1)
    feat = model.reg_convs[2](model.stems[2](model.levels(calib)[2]))
    logits = model.obj_preds[2].weight.flatten() @ feat.transpose(0, 1).flatten(1)
    # person score = sigmoid(obj) * sigmoid(3) > 0.3 from the top share on
    threshold = math.log(0.3 / (1.0 / (1.0 + math.exp(-3.0))) /
                         (1.0 - 0.3 / (1.0 / (1.0 + math.exp(-3.0)))))
    top = torch.quantile(logits, 1.0 - DETECTOR_TOP_SHARE).item()
    model.obj_preds[2].bias.fill_(threshold - top)
    return model


# the stand-in pose head: each keypoint's SimCC x and y vectors are bumps of
# POSE_BUMP_BINS (standard deviation, in bins) centred on seeded bins in the
# middle 60 % of the crop, of seeded heights in [0.6, 1.5] (the next bin
# 0.36 of the peak); one keypoint in POSE_HIDDEN_EVERY gets height 0.1, under
# the 0.3 visibility threshold
POSE_BUMP_BINS, POSE_HIDDEN_EVERY = 0.7, 10


@torch.no_grad()
def seeded_rtmpose(seed: int = 0, deepen: float = 1.0, widen: float = 1.0) -> RTMPose:
    """An `RTMPose` in eval mode, seeded and calibrated on two N(0, 1) crops
    (the ImageNet-normalised input's scale), whose outputs are shaped as a
    trained head's: sharp SimCC peaks. The backbone's last BatchNorm has
    scale 0 and N(0, 1) offsets, so the head sees a fixed feature map,
    whatever the crop (the whole backbone still runs); the SimCC linears are
    then solved (least squares) so that each keypoint's x and y vectors are
    bumps POSE_BUMP_BINS wide at seeded positions with seeded heights. The
    stand-in thus puts a fixed skeleton into every person box, and its
    decoded keypoints do not depend on the summation order."""
    gen = torch.Generator().manual_seed(seed + 1)
    model = RTMPose(deepen, widen)
    w, h = RTMPose.INPUT_SIZE
    _seed_and_calibrate(model, gen, torch.randn((2, 3, h, w), generator=gen))
    last_bn = model.stages[-1][-1].final_conv[1]
    last_bn.weight.zero_()
    last_bn.bias.copy_(torch.randn(last_bn.bias.shape, generator=gen))
    feats = model.gau(model.mlp(model.final_layer(model.stages(model.stem(
        torch.randn((1, 3, h, w), generator=gen)))).flatten(2)))[0]      # [keypoints, 256]
    keypoints = feats.shape[0]
    heights = 0.6 + 0.9 * torch.rand(keypoints, generator=gen)
    heights[::POSE_HIDDEN_EVERY] = 0.1
    for head in (model.cls_x, model.cls_y):
        bins = torch.arange(head.out_features, dtype=torch.float32)
        centers = ((0.2 + 0.6 * torch.rand(keypoints, generator=gen))
                   * head.out_features).round()                       # on a bin: no tie
        bumps = heights[:, None] * torch.exp(-0.5 * ((bins[None] - centers[:, None])
                                                     / POSE_BUMP_BINS) ** 2)
        head.weight.copy_((torch.linalg.pinv(feats) @ bumps).T)
    return model


def write_dwpose(directory: str, seed: int = 0, depth: float = 1.0, width: float = 1.0,
                 models=None) -> str:
    """Write yolox_l.onnx (input "images" [N,3,640,640], output "output") and
    dw-ll_ucoco_384.onnx (input "input" [N,3,384,288], outputs "simcc_x",
    "simcc_y"), the batch dynamic, as DWPose's files are named: `models`, a
    (Yolox, RTMPose) pair, or by default `seeded_yolox` and `seeded_rtmpose`
    with depth and width scaling both networks (1.0: YOLOX-L and RTMPose-l).
    Returns `directory`."""
    import os

    os.makedirs(directory, exist_ok=True)
    detector, pose = models or (seeded_yolox(seed, depth, width),
                                seeded_rtmpose(seed, depth, width))
    export_onnx(detector.cpu(), (torch.zeros(1, 3, 640, 640),),
                os.path.join(directory, "yolox_l.onnx"), names=(["images"], ["output"]))
    export_onnx(pose.cpu(), (torch.zeros(1, 3, 384, 288),),
                os.path.join(directory, "dw-ll_ucoco_384.onnx"),
                names=(["input"], ["simcc_x", "simcc_y"]))
    return directory
