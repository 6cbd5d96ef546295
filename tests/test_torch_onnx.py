"""The port's ONNX reader and ONNX -> torch executor
(`stableanimator_tpu_torch.preproc.onnx_{reader,to_torch}`) against the JAX
package's (`preproc/onnx_{reader,to_jax}.py`) and against torch's own
forward, on the CPU.

torch's legacy exporter writes the files (the models of
tests/test_onnx.py); single nodes built by hand cover every op family the
exported models miss, through both executors' dispatch. Outputs within
rtol 1e-4 / atol 1e-4; input gradients too.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from stableanimator_tpu.preproc import onnx_to_jax as jax_exec
from stableanimator_tpu.preproc.onnx_reader import load_onnx as jax_load_onnx
from stableanimator_tpu_torch.preproc import onnx_to_torch as port_exec
from stableanimator_tpu_torch.preproc.onnx_reader import Node, load_onnx
from stableanimator_tpu_torch.preproc.standins import export_onnx
from tests.torch_threads import share_cores

THREADS = share_cores()

RTOL = ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes at once, and torch's thread pools then spend their time
    waiting for each other on these small shapes."""
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(THREADS)


def _export(tmp_path, model, inputs, name="m.onnx"):
    return export_onnx(model, inputs, str(tmp_path / name))


class ConvSiluStack(nn.Sequential):
    def __init__(self):
        super().__init__(nn.Conv2d(3, 8, 3, stride=2, padding=1), nn.SiLU(),
                         nn.Conv2d(8, 8, 3, padding=1, groups=2), nn.BatchNorm2d(8), nn.ReLU(),
                         nn.Conv2d(8, 4, 1))


class YoloxBlock(nn.Module):
    """CSP-ish block: focus slice+concat, maxpool SPP, upsample, concat."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(12, 16, 1)
        self.conv2 = nn.Conv2d(64, 16, 1)
        self.head = nn.Conv2d(19, 6, 1)

    def forward(self, x):
        p = torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2],
                       x[..., 1::2, 1::2]], dim=1)
        y = F.silu(self.conv1(p))
        spp = torch.cat([y, F.max_pool2d(y, 5, 1, 2), F.max_pool2d(y, 9, 1, 4),
                         F.max_pool2d(y, 13, 1, 6)], dim=1)
        y = F.silu(self.conv2(spp))
        up = F.interpolate(y, scale_factor=2.0, mode="nearest")
        return self.head(torch.cat([up, x], dim=1)).sigmoid()


class RtmposeHead(nn.Module):
    """GAP + fc + simcc-style reshape/split + softmax."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 7, stride=4, padding=3)
        self.fc = nn.Linear(8 * 8 * 8, 12 * 16)

    def forward(self, x):
        y = self.fc(F.gelu(self.conv(x)).flatten(1)).reshape(-1, 12, 16)
        sx, sy = y.split([8, 8], dim=2)
        return sx.softmax(-1), sy.softmax(-1)


class ArcfaceNet(nn.Module):
    """PReLU resnet-ish blocks + BN + flatten + linear + l2 norm."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 8, 3, padding=1)
        self.prelu = nn.PReLU(8)
        self.conv2 = nn.Conv2d(8, 8, 3, stride=2, padding=1)
        self.bn = nn.BatchNorm2d(8)
        self.fc = nn.Linear(8 * 16 * 16, 16)

    def forward(self, x):
        emb = self.fc(self.bn(self.conv2(self.prelu(self.conv1(x)))).flatten(1))
        return emb / emb.norm(dim=1, keepdim=True)


class Misc(nn.Module):
    def forward(self, x):
        y = x.permute(0, 2, 3, 1)
        y = torch.clamp(y, -0.5, 0.5)
        y = F.avg_pool2d(x, 2)
        z = torch.exp(-y.abs())
        w = torch.where(y > 0, y, z)
        return w.mean(dim=(2, 3)), w.max(dim=1).values


class AttentionChain(nn.Module):
    def __init__(self):
        super().__init__()
        self.q = nn.Linear(16, 16)
        self.k = nn.Linear(16, 16)

    def forward(self, x):
        b, s, _ = x.shape
        q = self.q(x).reshape(b, s, 2, 8).transpose(1, 2)
        k = self.k(x).reshape(b, s, 2, 8).transpose(1, 2)
        return (q @ k.transpose(-1, -2)).softmax(-1).reshape(b, -1)


class ArcTiny(nn.Module):
    """tests/test_face_opt.py's gradient model: Conv/BN/PReLU/FC/BN1d."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, stride=2, padding=1)
        self.bn = nn.BatchNorm2d(8)
        self.prelu = nn.PReLU(8)
        self.fc = nn.Linear(8 * 8 * 8, 16)
        self.feat = nn.BatchNorm1d(16)

    def forward(self, x):
        return self.feat(self.fc(self.prelu(self.bn(self.conv(x))).flatten(1)))


# name -> (module class, torch seed, input shape, numpy seed): tests/test_onnx.py's cases
EXPORTED = {
    "conv_silu_stack": (ConvSiluStack, 0, (1, 3, 32, 32), 0),
    "yolox_style_block": (YoloxBlock, 1, (1, 3, 32, 32), 1),
    "rtmpose_style_head": (RtmposeHead, 2, (2, 3, 32, 32), 2),
    "arcface_style_net": (ArcfaceNet, 3, (1, 3, 32, 32), 3),
    "misc_ops": (Misc, 4, (2, 4, 8, 8), 4),
    "transpose_matmul_reshape_chain": (AttentionChain, 5, (2, 4, 16), 5),
}


def test_reader_parses_what_the_jax_reader_parses(tmp_path):
    torch.manual_seed(0)
    model = nn.Sequential(nn.Conv2d(3, 8, 3, padding=1), nn.SiLU(), nn.Conv2d(8, 4, 1))
    path = _export(tmp_path, model, (torch.randn(1, 3, 16, 16),))
    g, jg = load_onnx(path), jax_load_onnx(path)
    assert len(g.nodes) >= 3 and len(g.inputs) == 1 and len(g.outputs) == 1
    assert any(v.ndim == 4 for v in g.initializers.values())
    assert [(n.op_type, n.inputs, n.outputs) for n in g.nodes] == \
        [(n.op_type, n.inputs, n.outputs) for n in jg.nodes]
    assert g.inputs == jg.inputs and g.outputs == jg.outputs
    assert set(g.initializers) == set(jg.initializers)
    for k, v in g.initializers.items():
        np.testing.assert_array_equal(v, jg.initializers[k])


@pytest.mark.parametrize("name", list(EXPORTED))
def test_exported_model_matches_jax_and_torch(tmp_path, name):
    cls, tseed, shape, nseed = EXPORTED[name]
    torch.manual_seed(tseed)
    model = cls().eval()
    x = np.random.default_rng(nseed).normal(size=shape).astype(np.float32)
    path = _export(tmp_path, model, (torch.from_numpy(x),))
    got = port_exec.load_onnx_function(path, device="cpu")(x)
    want_jax = jax_exec.load_onnx_function(path)(x)
    with torch.no_grad():
        ref = model(torch.from_numpy(x))
    refs = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(want_jax) == len(refs)
    for g, j, r in zip(got, want_jax, refs):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=RTOL, atol=ATOL)


def test_input_gradient_matches_jax_grad_and_torch(tmp_path):
    """tests/test_face_opt.py's ArcTiny case: d sum(emb^2) / d x through the
    port's executor, jax.grad through the JAX executor, and torch autograd
    of the module."""
    torch.manual_seed(0)
    model = ArcTiny().eval()
    x = np.random.default_rng(0).normal(size=(2, 3, 16, 16)).astype(np.float32)
    path = _export(tmp_path, model, (torch.from_numpy(x),))
    jfn = jax_exec.load_onnx_function(path)
    g_jax = np.asarray(jax.grad(lambda xj: jnp.sum(jnp.square(jfn(xj)[0])))(jnp.asarray(x)))
    fn = port_exec.load_onnx_function(path, device="cpu")
    xp = torch.from_numpy(x).requires_grad_(True)
    (g_port,) = torch.autograd.grad(fn(xp)[0].square().sum(), xp)
    xt = torch.from_numpy(x).requires_grad_(True)
    model(xt).square().sum().backward()
    np.testing.assert_allclose(g_port.numpy(), g_jax, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g_port.numpy(), xt.grad.numpy(), rtol=RTOL, atol=ATOL)


def test_weights_move_to_the_device_once_and_shapes_stay_on_the_host(tmp_path):
    torch.manual_seed(5)
    model = AttentionChain().eval()
    path = _export(tmp_path, model, (torch.zeros(2, 4, 16),))
    fn = port_exec.load_onnx_function(path, device="cpu")
    assert fn.weights and all(isinstance(w, torch.Tensor) for w in fn.weights.values())
    assert all(isinstance(v, np.ndarray) for v in fn.static_params.values())
    node = Node("Shape", ["x"], ["s"], "shape", {})
    out = fn._exec(node, [torch.zeros(2, 3, 4)])
    assert isinstance(out, np.ndarray) and out.dtype == np.int64
    gather = Node("Gather", ["s", "i"], ["g"], "gather", {"axis": 0})
    assert isinstance(fn._exec(gather, [out, np.asarray(1)]), (np.ndarray, np.generic))


# ---------------------------------------------------------------------------
# single nodes through both executors: the op families the exports miss
# ---------------------------------------------------------------------------

def _r(seed, *shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, size=shape).astype(np.float32)


_I = lambda *v: np.asarray(v, np.int64)          # noqa: E731
_F = lambda *v: np.asarray(v, np.float32)        # noqa: E731
_NONE = np.zeros((0,), np.float32)

RESIZE = [
    (f"resize_{mode}_{coord}_{near}_{tag}", "Resize",
     {"mode": mode.encode(), "coordinate_transformation_mode": coord.encode(),
      "nearest_mode": near.encode()}, [_r(10, 1, 2, 5, 7), _NONE, scales])
    for mode, coord, near in [
        ("nearest", "asymmetric", "floor"), ("nearest", "asymmetric", "ceil"),
        ("nearest", "half_pixel", "round_prefer_ceil"),
        ("nearest", "half_pixel", "round_prefer_floor"),
        ("nearest", "align_corners", "round_prefer_floor"),
        ("nearest", "tf_crop_and_resize", "round_prefer_ceil"),
        ("linear", "half_pixel", "round_prefer_floor"),
        ("linear", "asymmetric", "round_prefer_floor"),
        ("linear", "align_corners", "round_prefer_floor"),
        ("linear", "pytorch_half_pixel", "round_prefer_floor"),
        ("cubic", "half_pixel", "round_prefer_floor")]
    for tag, scales in (("up", _F(1, 1, 2.0, 1.5)), ("down", _F(1, 1, 0.6, 0.5)))
] + [
    ("resize_sizes_linear", "Resize", {"mode": b"linear"},
     [_r(11, 1, 1, 6, 6), _NONE, _NONE, _I(1, 1, 9, 4)]),
    ("upsample_nearest", "Upsample", {"mode": b"nearest"}, [_r(12, 1, 2, 3, 4), _F(1, 1, 2, 2)]),
    ("upsample_linear", "Upsample", {"mode": b"linear"}, [_r(13, 1, 2, 3, 4), _F(1, 1, 2, 3)]),
]

OPS = RESIZE + [
    ("pad_constant", "Pad", {"mode": b"constant"},
     [_r(20, 1, 2, 4, 5), _I(0, 0, 1, 2, 0, 0, 3, 0), _F(0.5)]),
    ("pad_reflect", "Pad", {"mode": b"reflect"}, [_r(21, 1, 2, 4, 5), _I(0, 0, 1, 2, 0, 0, 2, 1)]),
    ("pad_edge", "Pad", {"mode": b"edge"}, [_r(22, 1, 2, 4, 5), _I(0, 0, 2, 0, 0, 0, 1, 3)]),
    ("pad_attr", "Pad", {"pads": [0, 1, 0, 0, 1, 0]}, [_r(23, 2, 3, 4)]),
    ("conv_transpose_s2", "ConvTranspose", {"strides": [2, 2], "pads": [1, 0, 0, 1]},
     [_r(30, 1, 3, 5, 4), _r(31, 3, 2, 3, 3), _r(32, 2)]),
    ("conv_transpose_3d", "ConvTranspose", {"strides": [2, 1, 3]},
     [_r(33, 1, 2, 3, 4, 3), _r(34, 2, 3, 2, 3, 2)]),
    ("conv_same_upper_even", "Conv", {"auto_pad": b"SAME_UPPER", "strides": [2, 2]},
     [_r(35, 1, 3, 7, 6), _r(36, 4, 3, 4, 4)]),
    ("conv_same_lower_dilated", "Conv",
     {"auto_pad": b"SAME_LOWER", "dilations": [2, 1], "group": 3},
     [_r(37, 1, 3, 9, 8), _r(38, 6, 1, 2, 3), _r(39, 6)]),
    ("conv_asym_pads", "Conv", {"pads": [0, 1, 2, 0]}, [_r(40, 1, 2, 6, 6), _r(41, 3, 2, 3, 3)]),
    ("slice_neg_step", "Slice", {}, [_r(50, 3, 8, 5), _I(-1, 6), _I(-100, 0), _I(1, 2), _I(-1, -2)]),
    ("slice_clamped_ends", "Slice", {}, [_r(51, 3, 8), _I(1, -3), _I(2**62, 2**62), _I(0, 1)]),
    ("slice_steps", "Slice", {}, [_r(52, 9, 7), _I(1, 0), _I(9, 7), _I(0, 1), _I(3, 2)]),
    ("slice_attrs", "Slice", {"starts": [1, -3], "ends": [3, 100], "axes": [0, 1]},
     [_r(53, 4, 6)]),
    ("reduce_mean_attr", "ReduceMean", {"axes": [1, 2], "keepdims": 0}, [_r(60, 2, 3, 4)]),
    ("reduce_sum_input", "ReduceSum", {"keepdims": 1}, [_r(61, 2, 3, 4), _I(-1)]),
    ("reduce_max_all", "ReduceMax", {"keepdims": 0}, [_r(62, 2, 3, 4)]),
    ("reduce_min", "ReduceMin", {"axes": [0]}, [_r(63, 2, 3, 4)]),
    ("reduce_prod", "ReduceProd", {"axes": [1, 2], "keepdims": 1}, [_r(64, 2, 3, 2, lo=0.5)]),
    ("reduce_l2", "ReduceL2", {"axes": [2]}, [_r(65, 2, 3, 4)]),
    ("maxpool_ceil_pads", "MaxPool",
     {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 0, 1, 1], "ceil_mode": 1},
     [_r(70, 1, 2, 8, 7)]),
    ("maxpool_same_upper", "MaxPool",
     {"kernel_shape": [2, 2], "strides": [2, 2], "auto_pad": b"SAME_UPPER"}, [_r(71, 1, 2, 5, 7)]),
    ("avgpool_exclude_pad", "AveragePool",
     {"kernel_shape": [3, 3], "strides": [2, 1], "pads": [1, 1, 1, 1]}, [_r(72, 1, 2, 6, 5)]),
    ("avgpool_include_pad", "AveragePool",
     {"kernel_shape": [2, 3], "pads": [1, 0, 0, 1], "count_include_pad": 1},
     [_r(73, 1, 2, 6, 5)]),
    ("gemm_trans_alpha_beta", "Gemm", {"transA": 1, "transB": 1, "alpha": 0.5, "beta": 2.0},
     [_r(80, 4, 3), _r(81, 5, 4), _r(82, 5)]),
    ("gemm_plain", "Gemm", {}, [_r(83, 3, 4), _r(84, 4, 2)]),
    ("topk_largest", "TopK", {"axis": 1}, [_r(90, 2, 9), _I(3)]),
    ("topk_smallest", "TopK", {"axis": 0, "largest": 0}, [_r(91, 6, 2), _I(2)]),
    ("argmax_keep", "ArgMax", {"axis": 1}, [_r(92, 3, 5)]),
    ("argmin_drop", "ArgMin", {"axis": 0, "keepdims": 0}, [_r(93, 3, 5)]),
    ("gather_negative", "Gather", {"axis": 1}, [_r(94, 3, 5, 2), _I(-1, 0, 2)]),
    ("gather_scalar", "Gather", {"axis": 0}, [_r(95, 3, 5), np.asarray(2, np.int64)]),
    ("expand", "Expand", {}, [_r(96, 3, 1), _I(2, 3, 4)]),
    ("tile", "Tile", {}, [_r(97, 2, 3), _I(2, 1)]),
    ("where", "Where", {}, [_r(98, 3, 4) > 0, _r(99, 3, 4), _r(100, 1, 4)]),
    ("einsum", "Einsum", {"equation": b"bij,bjk->bik"}, [_r(101, 2, 3, 4), _r(102, 2, 4, 5)]),
    ("gelu_tanh", "Gelu", {"approximate": b"tanh"}, [_r(103, 3, 4)]),
    ("gelu_erf", "Gelu", {}, [_r(104, 3, 4)]),
    ("mod_fmod", "Mod", {"fmod": 1}, [_r(105, 3, 4, lo=-5, hi=5), _F(1.5)]),
    ("mod_floor", "Mod", {}, [_r(106, 3, 4, lo=-5, hi=5), _F(1.5)]),
    ("instance_norm", "InstanceNormalization", {"epsilon": 1e-3},
     [_r(107, 2, 3, 4, 5), _r(108, 3), _r(109, 3)]),
    ("layer_norm", "LayerNormalization", {"axis": -1}, [_r(110, 2, 3, 8), _r(111, 8), _r(112, 8)]),
    ("split_attr", "Split", {"axis": 1, "split": [1, 3]}, [_r(113, 2, 4)]),
    ("clip_inputs", "Clip", {}, [_r(114, 3, 4), _F(-0.3), _F(0.4)]),
    ("hard_sigmoid", "HardSigmoid", {"alpha": 0.3}, [_r(115, 3, 4, lo=-4, hi=4)]),
    ("hard_swish", "HardSwish", {}, [_r(116, 3, 4, lo=-4, hi=4)]),
    ("leaky_relu", "LeakyRelu", {"alpha": 0.2}, [_r(117, 3, 4)]),
    ("softplus_erf_round", "Softplus", {}, [_r(118, 3, 4, lo=-3, hi=3)]),
    ("erf", "Erf", {}, [_r(119, 3, 4)]),
    ("round_half_even", "Round", {}, [_F(0.5, 1.5, 2.5, -0.5, 0.49)]),
    ("pow_sign_recip", "Pow", {}, [_r(120, 3, 4, lo=0.1, hi=2), _F(1.5)]),
    ("global_avg_pool", "GlobalAveragePool", {}, [_r(121, 2, 3, 4, 5)]),
    ("prelu", "PRelu", {}, [_r(122, 2, 3, 4), _r(123, 3)]),
    # the node forms of the DWPose stand-ins (preproc/standins.py): RTMPose's
    # ScaleNorm clamp, channel attention, GAU split / unbind, YOLOX's upsample
    ("clip_min_only", "Clip", {}, [_r(130, 3, 4), _F(0.1), None]),
    ("hard_sigmoid_sixth", "HardSigmoid", {"alpha": 1.0 / 6.0}, [_r(131, 3, 4, lo=-5, hi=5)]),
    ("reduce_l2_last_keep", "ReduceL2", {"axes": [-1], "keepdims": 1}, [_r(132, 2, 5, 7)]),
    ("split_sizes_input", "Split", {"axis": 2}, [_r(133, 2, 3, 10), _I(4, 4, 2)]),
    ("squeeze_axes_input", "Squeeze", {}, [_r(134, 2, 1, 3), _I(1)]),
    ("unsqueeze_axes_input", "Unsqueeze", {}, [_r(135, 2, 3), _I(2)]),
    ("resize_nearest_str_attrs", "Resize",
     {"mode": "nearest", "coordinate_transformation_mode": "asymmetric", "nearest_mode": "floor"},
     [_r(136, 1, 2, 3, 4), _NONE, _F(1, 1, 2, 2)]),
]


@pytest.mark.parametrize("case", OPS, ids=[c[0] for c in OPS])
def test_single_node_matches_the_jax_executor(case):
    name, op, attrs, inputs = case
    node = Node(op, [f"in{i}" for i in range(len(inputs))],
                ["out0", "out1"] if op == "TopK" else ["out0"], name, dict(attrs))
    # the data input is a device value, the others the host values a graph's
    # initializers would give
    jargs = [jnp.asarray(inputs[0])] + list(inputs[1:])
    want = jax_exec.OnnxFunction.__new__(jax_exec.OnnxFunction)._exec(node, jargs, {})
    targs = [torch.from_numpy(np.ascontiguousarray(inputs[0]))] + list(inputs[1:])
    got = port_exec.OnnxFunction.__new__(port_exec.OnnxFunction)._exec(node, targs)
    want = want if isinstance(want, (list, tuple)) else [want]
    got = got if isinstance(got, (list, tuple)) else [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape, (g.shape, w.shape)
        if np.issubdtype(w.dtype, np.integer) or w.dtype == np.bool_:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
