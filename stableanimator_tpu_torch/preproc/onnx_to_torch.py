"""ONNX graph -> differentiable PyTorch function (port of the JAX package's
`preproc/onnx_to_jax.py`).

Executes the Graph IR of `onnx_reader.py` eagerly with torch ops, covering
the op set of the preprocessing models (YOLOX-L person detector, RTMPose
dw-ll_ucoco_384, SCRFD face detector, ArcFace glintr100 recogniser, BiSeNet
parser) and every op the JAX executor handles, with its semantics. It is
differentiable with respect to its inputs by ordinary autograd: the HJB face
optimisation backpropagates through the recogniser this way.

Notes:
  * initializers split as in the JAX executor: small and integer tensors
    (reshape targets, resize scales, TopK k, ...) stay host-side numpy, the
    rest are WEIGHTS, moved to the device once, at load. Shape chains
    (Shape / Gather / Unsqueeze / Concat -> Reshape) are computed on numpy
    values, so no node waits on the device for a shape;
  * a numpy value meets a tensor only inside an op, where it becomes a
    tensor on the tensor's device, a float one in the tensor's float dtype
    (float64 as float32 where there is none, as JAX without x64);
  * layout follows ONNX (NCHW).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from stableanimator_tpu_torch.preproc.onnx_reader import Graph, Node, load_onnx


def _is_host(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic, int, float, bool))


def _host(x) -> np.ndarray:
    """A value as numpy (a tensor is copied to the host: only attribute-like
    inputs, such as Resize scales computed on the device, come here)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _tensor(x, device=None, float_dtype=None) -> torch.Tensor:
    """numpy -> tensor on `device`, a float array in `float_dtype` (float64
    as float32 without one); tensors pass."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    if not (a.flags.writeable and a.flags.c_contiguous):   # e.g. a view of the file
        a = np.array(a, order="C")
    t = torch.from_numpy(a).to(device)
    return t.to(float_dtype) if float_dtype is not None and t.is_floating_point() else t


def _tensors(*args):
    """Every argument as a tensor on the device (and, for a float one, in the
    float dtype) of the first tensor among them."""
    first = next((a for a in args if isinstance(a, torch.Tensor)), None)
    dev = None if first is None else first.device
    fdt = next((a.dtype for a in args if isinstance(a, torch.Tensor) and a.is_floating_point()),
               None)
    return [None if a is None else _tensor(a, dev, fdt) for a in args]


def _auto_pad(node, x_shape, k_shape, strides, dilations):
    ap = node.attrs.get("auto_pad", "NOTSET")
    if isinstance(ap, bytes):
        ap = ap.decode()
    spatial = len(k_shape)
    if ap in ("NOTSET", ""):
        pads = node.attrs.get("pads", [0] * (2 * spatial))
        return [(int(pads[i]), int(pads[i + spatial])) for i in range(spatial)]
    if ap == "VALID":
        return [(0, 0)] * spatial
    # SAME_UPPER / SAME_LOWER
    out = []
    for i in range(spatial):
        in_dim = x_shape[2 + i]
        eff_k = (k_shape[i] - 1) * dilations[i] + 1
        out_dim = -(-in_dim // strides[i])
        total = max(0, (out_dim - 1) * strides[i] + eff_k - in_dim)
        lo = total // 2
        hi = total - lo
        out.append((lo, hi) if ap == "SAME_UPPER" else (hi, lo))
    return out


def _pad_spatial(x, pads, value=0.0):
    """Pad the trailing len(pads) dims with (lo, hi) pairs (F.pad wants the
    last dim first)."""
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    if not any(flat):
        return x
    return F.pad(x, flat, mode="constant", value=value)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _op_conv(node, x, w, b=None):
    x, w, b = _tensors(x, w, b)
    spatial = w.ndim - 2
    strides = [int(s) for s in node.attrs.get("strides", [1] * spatial)]
    dilations = [int(d) for d in node.attrs.get("dilations", [1] * spatial)]
    groups = int(node.attrs.get("group", 1))
    pads = _auto_pad(node, x.shape, w.shape[2:], strides, dilations)
    if all(lo == hi for lo, hi in pads):
        padding = [lo for lo, _ in pads]
    else:   # asymmetric (SAME_* with an even window, or explicit pads)
        x, padding = _pad_spatial(x, pads), 0
    return _CONV[spatial](x, w, b, stride=strides, padding=padding, dilation=dilations,
                          groups=groups)


def _op_maxpool(node, x):
    k = [int(v) for v in node.attrs["kernel_shape"]]
    spatial = len(k)
    strides = [int(s) for s in node.attrs.get("strides", [1] * spatial)]
    pads = _auto_pad(node, x.shape, k, strides, [1] * spatial)
    ceil_mode = int(node.attrs.get("ceil_mode", 0))
    if ceil_mode:
        new_pads = []
        for i in range(spatial):
            in_dim = x.shape[2 + i] + pads[i][0] + pads[i][1]
            rem = (in_dim - k[i]) % strides[i]
            extra = (strides[i] - rem) % strides[i] if rem else 0
            new_pads.append((pads[i][0], pads[i][1] + extra))
        pads = new_pads
    x = _pad_spatial(_tensor(x), pads, value=-math.inf)
    return _MAX_POOL[spatial](x, k, strides)


def _op_avgpool(node, x):
    x = _tensor(x)
    k = [int(v) for v in node.attrs["kernel_shape"]]
    spatial = len(k)
    strides = [int(s) for s in node.attrs.get("strides", [1] * spatial)]
    pads = _auto_pad(node, x.shape, k, strides, [1] * spatial)
    summed = _AVG_POOL[spatial](_pad_spatial(x, pads), k, strides) * float(np.prod(k))
    if int(node.attrs.get("count_include_pad", 0)):
        return summed / float(np.prod(k))
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
    counts = _AVG_POOL[spatial](_pad_spatial(ones, pads), k, strides) * float(np.prod(k))
    return summed / counts


def _resize_1d_indices(in_dim, out_dim, scale, coord_mode):
    """x_original coordinate for each output index (ONNX Resize spec)."""
    i = np.arange(out_dim, dtype=np.float64)
    if coord_mode == "align_corners":
        if out_dim == 1:
            return np.zeros(1)
        return i * (in_dim - 1) / (out_dim - 1)
    if coord_mode == "asymmetric":
        return i / scale
    if coord_mode == "pytorch_half_pixel":
        return (i + 0.5) / scale - 0.5 if out_dim > 1 else np.zeros(out_dim)
    # default: half_pixel (also what other modes fall back to, as in JAX)
    return (i + 0.5) / scale - 0.5


def _take(x, idx: np.ndarray, axis: int):
    return x.index_select(axis, torch.from_numpy(idx.astype(np.int64)).to(x.device))


def _resize_axis(x, axis, out_dim, scale, mode, coord_mode, nearest_mode):
    in_dim = x.shape[axis]
    if in_dim == out_dim:
        return x
    coords = _resize_1d_indices(in_dim, out_dim, scale, coord_mode)
    if mode == "nearest":
        if nearest_mode == "floor":
            idx = np.floor(coords)
        elif nearest_mode == "ceil":
            idx = np.ceil(coords)
        elif nearest_mode == "round_prefer_ceil":
            idx = np.floor(coords + 0.5)
        else:  # round_prefer_floor (default)
            idx = np.ceil(coords - 0.5)
        return _take(x, np.clip(idx, 0, in_dim - 1), axis)
    # linear: gather the two neighbours and lerp
    lo = np.clip(np.floor(coords), 0, in_dim - 1).astype(np.int64)
    hi = np.clip(lo + 1, 0, in_dim - 1)
    w = np.clip(coords - lo, 0.0, 1.0).astype(np.float32)
    shape = [1] * x.ndim
    shape[axis] = out_dim
    wj = torch.from_numpy(w).to(x.device).reshape(shape)
    return _take(x, lo, axis) * (1.0 - wj) + _take(x, hi, axis) * wj


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x):
    return np.maximum(0.0, 1.0 - x)


@functools.lru_cache(maxsize=64)
def _jax_resize_weights(in_dim: int, out_dim: int, kernel: str) -> np.ndarray:
    """[in, out] float32 weights of `jax.image.resize` (antialiased,
    half-pixel centres, samples outside the input dropped and the rest
    renormalised): jax/_src/image/scale.py::compute_weight_mat."""
    inv_scale = np.float32(1.0 / (out_dim / in_dim))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (np.arange(out_dim, dtype=np.float32) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_dim, dtype=np.float32)[:, None]) / kernel_scale
    w = (_keys_cubic if kernel == "cubic" else _triangle)(x).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample_f >= -0.5) & (sample_f <= in_dim - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _jax_image_resize(x, sizes, method: str):
    """`jax.image.resize(x, sizes, method)` (antialias on): nearest,
    linear or cubic, axis by axis."""
    for axis, out_dim in enumerate(sizes):
        in_dim = x.shape[axis]
        if in_dim == out_dim:
            continue
        if method == "nearest":
            off = np.floor(((np.arange(out_dim, dtype=np.float32) + 0.5) * in_dim
                            / out_dim).astype(np.float32))
            x = _take(x, off, axis)
            continue
        w = torch.from_numpy(_jax_resize_weights(in_dim, out_dim, method)).to(x.device, x.dtype)
        x = torch.movedim(torch.tensordot(torch.movedim(x, axis, -1), w, dims=1), -1, axis)
    return x


def _op_resize(node, x, *rest):
    # inputs: X, roi?, scales?, sizes?
    def dec(v, default):
        v = node.attrs.get(v, default)
        return v.decode() if isinstance(v, bytes) else v

    x = _tensor(x)
    mode = dec("mode", "nearest")
    coord_mode = dec("coordinate_transformation_mode", "half_pixel")
    nearest_mode = dec("nearest_mode", "round_prefer_floor")
    scales = sizes = None
    rest = list(rest)
    # rest[0] is the roi, used by tf_crop_and_resize only: ignored, as in JAX
    if len(rest) >= 2 and rest[1] is not None and np.size(_host(rest[1])):
        scales = _host(rest[1]).astype(np.float64)
    if len(rest) >= 3 and rest[2] is not None and np.size(_host(rest[2])):
        sizes = [int(v) for v in _host(rest[2])]
    if sizes is None:
        sizes = [int(np.floor(d * s)) for d, s in zip(x.shape, scales)]
    if scales is None:
        scales = [o / d for o, d in zip(sizes, x.shape)]
    if mode == "cubic":
        # bicubic only appears with half_pixel in the wild; the JAX executor
        # takes jax.image.resize's, and so does this one
        return _jax_image_resize(x, sizes, "cubic")
    out = x
    for axis, (out_dim, scale) in enumerate(zip(sizes, scales)):
        out = _resize_axis(out, axis, out_dim, scale, mode, coord_mode, nearest_mode)
    return out


def _op_batchnorm(node, x, scale, bias, mean, var):
    x, scale, bias, mean, var = _tensors(x, scale, bias, mean, var)
    eps = float(node.attrs.get("epsilon", 1e-5))
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = torch.rsqrt(var.reshape(shape) + eps)
    return (x - mean.reshape(shape)) * inv * scale.reshape(shape) + bias.reshape(shape)


def _op_gemm(node, a, b, c=None):
    a, b, c = _tensors(a, b, c)
    if int(node.attrs.get("transA", 0)):
        a = a.T
    if int(node.attrs.get("transB", 0)):
        b = b.T
    out = (a @ b) * float(node.attrs.get("alpha", 1.0))
    if c is not None:
        out = out + float(node.attrs.get("beta", 1.0)) * c
    return out


def _op_slice(node, x, *rest):
    if rest:  # opset >= 10: starts/ends/axes/steps as inputs
        starts = [int(v) for v in _host(rest[0])]
        ends = [int(v) for v in _host(rest[1])]
        axes = ([int(v) for v in _host(rest[2])] if len(rest) > 2 and rest[2] is not None
                else list(range(len(starts))))
        steps = ([int(v) for v in _host(rest[3])] if len(rest) > 3 and rest[3] is not None
                 else [1] * len(starts))
    else:
        starts = [int(v) for v in node.attrs["starts"]]
        ends = [int(v) for v in node.attrs["ends"]]
        axes = [int(v) for v in node.attrs.get("axes", range(len(starts)))]
        steps = [1] * len(starts)
    for s, e, a, st in zip(starts, ends, axes, steps):
        dim = x.shape[a]
        # ONNX clamps INT64_MAX/MIN style sentinels
        sl = slice(max(-dim, min(s, dim)), max(-dim - 1, min(e, dim)), st)
        if _is_host(x):
            idx = [slice(None)] * x.ndim
            idx[a] = sl
            x = x[tuple(idx)]
        elif st > 0:
            idx = [slice(None)] * x.ndim
            idx[a] = slice(*sl.indices(dim))
            x = x[tuple(idx)]
        else:   # torch slicing takes no negative step: gather the indices
            x = _take(x, np.arange(*sl.indices(dim)), a)
    return x


def _np_erf(x):
    return np.vectorize(math.erf, otypes=[np.float64])(x).astype(np.asarray(x).dtype)


# op -> (torch version, numpy version for host values or None)
_ELEMENTWISE = {
    "Relu": (torch.relu, lambda x: np.maximum(x, 0)),
    "Sigmoid": (torch.sigmoid, lambda x: 1.0 / (1.0 + np.exp(-x))),
    "Tanh": (torch.tanh, np.tanh),
    "Exp": (torch.exp, np.exp),
    "Log": (torch.log, np.log),
    "Sqrt": (torch.sqrt, np.sqrt),
    "Neg": (torch.neg, np.negative),
    "Abs": (torch.abs, np.abs),
    "Floor": (torch.floor, np.floor),
    "Ceil": (torch.ceil, np.ceil),
    "Erf": (torch.erf, _np_erf),
    "Identity": (lambda x: x, lambda x: x),
    "Softplus": (F.softplus, lambda x: np.logaddexp(0, x)),
    "Round": (torch.round, np.round),
}

# binary / n-ary ops: (torch version, numpy version)
_BINARY = {
    "Add": (torch.add, np.add),
    "Sub": (torch.sub, np.subtract),
    "Mul": (torch.mul, np.multiply),
    "Div": (torch.true_divide, np.true_divide),
    "Pow": (torch.pow, np.power),
    "Equal": (torch.eq, np.equal),
    "Greater": (torch.gt, np.greater),
    "Less": (torch.lt, np.less),
    "And": (torch.logical_and, np.logical_and),
    "Or": (torch.logical_or, np.logical_or),
}

_ONNX_TO_NP = {
    1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32, 7: np.int64,
    9: np.bool_, 10: np.float16, 11: np.float64,
}
# float64 is computed in float32, as JAX does without x64
_ONNX_TO_TORCH = {
    1: torch.float32, 2: torch.uint8, 3: torch.int8, 6: torch.int32, 7: torch.int64,
    9: torch.bool, 10: torch.float16, 11: torch.float32,
}


class OnnxFunction:
    """Callable wrapper: fn(*inputs) -> list of outputs.

    Initializers split two ways, as in the JAX executor: small / integer
    tensors stay host-side numpy so shape-affecting ops compute on them
    without the device; everything else is a WEIGHT, a tensor on `device`
    from the load on (`self.weights`). Inputs may be tensors (used where
    they are) or numpy arrays (moved to `device`). Outputs are tensors,
    or numpy arrays where the graph computed them from host values only
    (e.g. a Shape).

    A call holds each value only until the last node that reads it has run
    (graph outputs until the end): `self.release[i]` names the values that
    node i reads or writes last, worked out at load. Autograd keeps the
    tensors a backward needs by its own references. `self.peak_values` is
    the most computed values (inputs and node outputs) held at once in the
    last call."""

    def __init__(self, graph: Graph, device: torch.device | str = "cuda"):
        from stableanimator_tpu_torch.pipeline.animation import resolve_device

        self.graph = graph
        self.device = resolve_device(device)
        self.input_names = [n for n, _ in graph.inputs]
        self.static_params = {
            k: v for k, v in graph.initializers.items()
            if v.dtype in (np.int64, np.int32, np.bool_) or v.size <= 64}
        self.weights = {k: _tensor(v, self.device) for k, v in graph.initializers.items()
                        if k not in self.static_params}
        last: Dict[str, int] = {}
        for i, node in enumerate(graph.nodes):
            for name in list(node.inputs) + list(node.outputs):
                if name and name not in graph.initializers:
                    last[name] = i
        self.release = [[] for _ in graph.nodes]
        for name, i in last.items():
            if name not in graph.outputs:
                self.release[i].append(name)
        self.peak_values = 0

    def __call__(self, *inputs, _weights=None):
        params = dict(self.static_params)
        params.update(self.weights if _weights is None else _weights)
        env: Dict[str, Any] = {name: _tensor(x, self.device)
                               for name, x in zip(self.input_names, inputs)}
        peak = len(env)
        for node, release in zip(self.graph.nodes, self.release):
            args = [(env[i] if i in env else params[i]) if i else None for i in node.inputs]
            outs = self._exec(node, args)
            if not isinstance(outs, (list, tuple)):
                outs = [outs]
            for name, val in zip(node.outputs, outs):
                if name:
                    env[name] = val
            del args, outs
            peak = max(peak, len(env))
            for name in release:
                env.pop(name, None)
        self.peak_values = peak
        return [env[o] if o in env else params[o] for o in self.graph.outputs]

    # -- single-node dispatch ------------------------------------------------

    def _exec(self, node: Node, args: list):
        op = node.op_type
        if op in _ELEMENTWISE:
            t_fn, np_fn = _ELEMENTWISE[op]
            return np_fn(args[0]) if _is_host(args[0]) else t_fn(args[0])
        if op in _BINARY:
            t_fn, np_fn = _BINARY[op]
            if _is_host(args[0]) and _is_host(args[1]):
                return np_fn(args[0], args[1])
            return t_fn(*_tensors(args[0], args[1]))
        if op in ("Min", "Max"):
            if all(_is_host(a) for a in args):
                return functools.reduce(np.minimum if op == "Min" else np.maximum, args)
            return functools.reduce(torch.minimum if op == "Min" else torch.maximum,
                                    _tensors(*args))
        if op == "Conv":
            return _op_conv(node, *args)
        if op == "ConvTranspose":
            return self._conv_transpose(node, *args)
        if op == "MatMul":
            a, b = _tensors(*args)
            return torch.matmul(a, b)
        if op == "Gemm":
            return _op_gemm(node, *args)
        if op == "MaxPool":
            return _op_maxpool(node, args[0])
        if op == "AveragePool":
            return _op_avgpool(node, args[0])
        if op == "GlobalAveragePool":
            return args[0].mean(dim=tuple(range(2, args[0].ndim)), keepdim=True)
        if op == "BatchNormalization":
            return _op_batchnorm(node, *args[:5])
        if op == "LayerNormalization":
            axis = int(node.attrs.get("axis", -1))
            eps = float(node.attrs.get("epsilon", 1e-5))
            x, scale, bias = _tensors(args[0], *(args[1:3] + [None] * (3 - len(args))))
            mean = x.mean(dim=axis, keepdim=True)
            var = (x - mean).square().mean(dim=axis, keepdim=True)
            out = (x - mean) * torch.rsqrt(var + eps)
            if scale is not None:
                out = out * scale
            if bias is not None:
                out = out + bias
            return out
        if op == "Softmax":
            return torch.softmax(args[0], dim=int(node.attrs.get("axis", -1)))
        if op == "LeakyRelu":
            return F.leaky_relu(args[0], float(node.attrs.get("alpha", 0.01)))
        if op == "HardSigmoid":
            a = float(node.attrs.get("alpha", 0.2))
            b = float(node.attrs.get("beta", 0.5))
            return torch.clamp(a * args[0] + b, 0, 1)
        if op == "HardSwish":
            return args[0] * torch.clamp(args[0] / 6.0 + 0.5, 0, 1)
        if op == "Clip":
            lo = args[1] if len(args) > 1 and args[1] is not None else node.attrs.get("min")
            hi = args[2] if len(args) > 2 and args[2] is not None else node.attrs.get("max")
            bound = lambda v: None if v is None else (float(_host(v)) if _is_host(v) else v)
            return torch.clamp(args[0], bound(lo), bound(hi))
        if op == "PRelu":
            x, slope = _tensors(args[0], args[1])
            if slope.ndim == 1 and x.ndim > 1:
                slope = slope.reshape((1, -1) + (1,) * (x.ndim - 2))
            return torch.where(x >= 0, x, x * slope)
        if op == "Concat":
            axis = int(node.attrs["axis"])
            if all(_is_host(a) for a in args):
                return np.concatenate(args, axis=axis)
            return torch.cat(_tensors(*args), dim=axis)
        if op == "Reshape":
            shape = [int(v) for v in _host(args[1])]
            if int(node.attrs.get("allowzero", 0)) == 0:
                shape = [args[0].shape[i] if s == 0 else s for i, s in enumerate(shape)]
            return args[0].reshape(shape)
        if op == "Transpose":
            perm = node.attrs.get("perm")
            perm = perm if perm is not None else list(range(args[0].ndim))[::-1]
            perm = [int(p) for p in perm]
            return (np.transpose(args[0], perm) if _is_host(args[0])
                    else args[0].permute(perm))
        if op == "Flatten":
            axis = int(node.attrs.get("axis", 1))
            lead = int(np.prod(args[0].shape[:axis])) if axis else 1
            return args[0].reshape(lead, -1)
        if op == "Shape":
            return np.asarray(tuple(args[0].shape), dtype=np.int64)
        if op == "Size":
            return np.asarray(int(np.prod(tuple(args[0].shape))), dtype=np.int64)
        if op == "Gather":
            axis = int(node.attrs.get("axis", 0))
            x, indices = args[0], args[1]
            if _is_host(x) and _is_host(indices):
                return np.take(x, np.asarray(indices).astype(np.int64), axis=axis)
            axis %= x.ndim
            idx = _host(indices).astype(np.int64)
            idx = np.where(idx < 0, idx + x.shape[axis], idx)
            out = _take(_tensor(x), idx.reshape(-1), axis)
            return out.reshape(tuple(x.shape[:axis]) + idx.shape + tuple(x.shape[axis + 1:]))
        if op == "Unsqueeze":
            axes = (node.attrs.get("axes") if "axes" in node.attrs
                    else [int(v) for v in _host(args[1])])
            x = args[0]
            for a in sorted(int(v) for v in axes):
                x = np.expand_dims(x, a) if _is_host(x) else x.unsqueeze(a)
            return x
        if op == "Squeeze":
            axes = (node.attrs.get("axes") if "axes" in node.attrs
                    else ([int(v) for v in _host(args[1])]
                          if len(args) > 1 and args[1] is not None else None))
            x = args[0]
            if axes is None:
                return np.squeeze(x) if _is_host(x) else x.squeeze()
            for a in sorted((int(v) for v in axes), reverse=True):
                x = np.squeeze(x, a) if _is_host(x) else x.squeeze(a)
            return x
        if op == "Cast":
            to = int(node.attrs["to"])
            if _is_host(args[0]):
                return np.asarray(args[0]).astype(_ONNX_TO_NP[to])
            return args[0].to(_ONNX_TO_TORCH[to])
        if op == "Constant":
            for key in ("value", "value_float", "value_int", "value_ints", "value_floats"):
                if key in node.attrs:
                    return np.asarray(node.attrs[key])
            raise ValueError("Constant node without value")
        if op == "ConstantOfShape":
            shape = [int(v) for v in _host(args[0])]
            value = node.attrs.get("value", np.zeros((1,), np.float32))
            return np.full(shape, np.asarray(value).reshape(-1)[0],
                           dtype=np.asarray(value).dtype)
        if op == "Range":
            return np.arange(int(_host(args[0])), int(_host(args[1])), int(_host(args[2])),
                             dtype=np.int64)
        if op == "Slice":
            return _op_slice(node, *args)
        if op == "Split":
            axis = int(node.attrs.get("axis", 0))
            if "split" in node.attrs:
                sizes = [int(v) for v in node.attrs["split"]]
            elif len(args) > 1 and args[1] is not None:
                sizes = [int(v) for v in _host(args[1])]
            else:
                n_out = len(node.outputs)
                sizes = [args[0].shape[axis] // n_out] * n_out
            if _is_host(args[0]):
                return np.split(args[0], np.cumsum(sizes)[:-1].tolist(), axis=axis)
            return list(torch.split(args[0], sizes, dim=axis))
        if op == "Resize":
            return _op_resize(node, *args)
        if op == "Upsample":
            scales = _host(args[1]) if len(args) > 1 else np.asarray(node.attrs["scales"])
            sizes = [int(round(d * s)) for d, s in zip(args[0].shape, scales)]
            mode = node.attrs.get("mode", "nearest")
            method = "nearest" if "nearest" in str(mode) else "linear"
            return _jax_image_resize(_tensor(args[0]), sizes, method)
        if op == "Pad":
            return self._pad(node, args)
        if op == "ReduceMean":
            return self._reduce("mean", node, args)
        if op == "ReduceSum":
            return self._reduce("sum", node, args)
        if op == "ReduceMax":
            return self._reduce("max", node, args)
        if op == "ReduceMin":
            return self._reduce("min", node, args)
        if op == "ReduceProd":
            return self._reduce("prod", node, args)
        if op == "ReduceL2":
            return self._reduce("l2", node, args)
        if op in ("ArgMax", "ArgMin"):
            axis = int(node.attrs.get("axis", 0))
            keep = bool(int(node.attrs.get("keepdims", 1)))
            fn = torch.argmax if op == "ArgMax" else torch.argmin
            return fn(_tensor(args[0]), dim=axis, keepdim=keep).to(torch.int64)
        if op == "Expand":
            shape = [int(v) for v in _host(args[1])]
            target = torch.broadcast_shapes(tuple(args[0].shape), tuple(shape))
            if _is_host(args[0]):
                return np.broadcast_to(args[0], target)
            return args[0].expand(target)
        if op == "Tile":
            reps = [int(v) for v in _host(args[1])]
            return np.tile(args[0], reps) if _is_host(args[0]) else args[0].repeat(reps)
        if op == "Where":
            if all(_is_host(a) for a in args):
                return np.where(*args)
            cond, a, b = _tensors(*args)
            return torch.where(cond.to(torch.bool), a, b)
        if op == "Not":
            return (np.logical_not(args[0]) if _is_host(args[0])
                    else torch.logical_not(args[0]))
        if op == "Einsum":
            eq = node.attrs["equation"]
            eq = eq.decode() if isinstance(eq, bytes) else eq
            return torch.einsum(eq, *_tensors(*args))
        if op == "Gelu":
            approx = node.attrs.get("approximate", "none")
            approx = approx.decode() if isinstance(approx, bytes) else approx
            return F.gelu(args[0], approximate="tanh" if approx == "tanh" else "none")
        if op == "Mod":
            fmod = int(node.attrs.get("fmod", 0))
            if _is_host(args[0]) and _is_host(args[1]):
                return (np.fmod if fmod else np.mod)(args[0], args[1])
            a, b = _tensors(args[0], args[1])
            return torch.fmod(a, b) if fmod else torch.remainder(a, b)
        if op == "Reciprocal":
            return 1.0 / args[0]
        if op == "Sign":
            return np.sign(args[0]) if _is_host(args[0]) else torch.sign(args[0])
        if op == "Sin":
            return torch.sin(_tensor(args[0]))
        if op == "Cos":
            return torch.cos(_tensor(args[0]))
        if op == "TopK":
            # k must be a host value (standard in detector graphs)
            k = int(_host(args[1]).reshape(-1)[0])
            axis = int(node.attrs.get("axis", -1))
            largest = bool(int(node.attrs.get("largest", 1)))
            vals, idx = torch.topk(_tensor(args[0]), k, dim=axis, largest=largest,
                                   sorted=True)
            return vals, idx.to(torch.int64)
        if op == "InstanceNormalization":
            eps = float(node.attrs.get("epsilon", 1e-5))
            x, scale, bias = _tensors(*args[:3])
            axes = tuple(range(2, x.ndim))
            mean = x.mean(dim=axes, keepdim=True)
            var = (x - mean).square().mean(dim=axes, keepdim=True)
            shape = (1, -1) + (1,) * (x.ndim - 2)
            return ((x - mean) * torch.rsqrt(var + eps) * scale.reshape(shape)
                    + bias.reshape(shape))
        raise NotImplementedError(f"ONNX op '{op}' (node {node.name})")

    def _reduce(self, kind: str, node, args):
        if "axes" in node.attrs:
            axes = tuple(int(v) for v in node.attrs["axes"])
        elif len(args) > 1 and args[1] is not None:
            axes = tuple(int(v) for v in _host(args[1]))
        else:
            axes = None
        keep = bool(int(node.attrs.get("keepdims", 1)))
        x = args[0]
        if _is_host(x):
            fn = {"mean": np.mean, "sum": np.sum, "max": np.max, "min": np.min,
                  "prod": np.prod,
                  "l2": lambda x, axis, keepdims: np.sqrt(np.sum(x * x, axis=axis,
                                                                 keepdims=keepdims))}[kind]
            return fn(x, axis=axes, keepdims=keep)
        dims = tuple(range(x.ndim)) if axes is None else axes
        if kind == "mean":
            return x.mean(dim=dims, keepdim=keep)
        if kind == "sum":
            return x.sum(dim=dims, keepdim=keep)
        if kind == "max":
            return x.amax(dim=dims, keepdim=keep)
        if kind == "min":
            return x.amin(dim=dims, keepdim=keep)
        if kind == "l2":
            return (x * x).sum(dim=dims, keepdim=keep).sqrt()
        for d in sorted((d % x.ndim for d in dims), reverse=True):   # prod: one dim at a time
            x = x.prod(dim=d, keepdim=keep)
        return x

    def _pad(self, node, args):
        mode = node.attrs.get("mode", "constant")
        mode = mode.decode() if isinstance(mode, bytes) else mode
        if "pads" in node.attrs:
            pads = [int(v) for v in node.attrs["pads"]]
        else:
            pads = [int(v) for v in _host(args[1])]
        x = _tensor(args[0])
        n = x.ndim
        pairs = [(pads[i], pads[i + n]) for i in range(n)]
        if mode == "constant":
            value = 0.0
            if len(args) > 2 and args[2] is not None:
                value = float(_host(args[2]).reshape(-1)[0])
            return _pad_spatial(x, pairs, value)
        # reflect / edge pad the trailing dims only (torch's F.pad)
        first = next((i for i, p in enumerate(pairs) if any(p)), n)
        flat = [p for lo_hi in reversed(pairs[first:]) for p in lo_hi]
        if not flat:
            return x
        torch_mode = {"reflect": "reflect", "edge": "replicate"}[mode]
        lead = x.shape[:first]
        y = x.reshape((1, -1) + tuple(x.shape[first:]))   # batch, channel + padded dims
        return F.pad(y, flat, mode=torch_mode).reshape(tuple(lead) + tuple(
            d + lo + hi for d, (lo, hi) in zip(x.shape[first:], pairs[first:])))

    def _conv_transpose(self, node, x, w, b=None):
        x, w, b = _tensors(x, w, b)
        spatial = w.ndim - 2
        strides = [int(s) for s in node.attrs.get("strides", [1] * spatial)]
        pads = node.attrs.get("pads", [0] * (2 * spatial))
        pairs = [(int(pads[i]), int(pads[i + spatial])) for i in range(spatial)]
        if int(node.attrs.get("group", 1)) != 1:
            raise NotImplementedError("grouped ConvTranspose")
        # ONNX ConvTranspose weight is [in, out, *k], torch's layout; the
        # full output is cropped by the (possibly asymmetric) pads
        out = _CONV_T[spatial](x, w, b, stride=strides)
        for i, (lo, hi) in enumerate(pairs):
            out = out.narrow(2 + i, lo, out.shape[2 + i] - lo - hi)
        return out


def load_onnx_function(path: str, device: torch.device | str = "cuda") -> OnnxFunction:
    """The graph at `path` as an OnnxFunction whose weights are on `device`
    (the card unless the caller asks for the CPU)."""
    from stableanimator_tpu_torch.pipeline.animation import resolve_device

    device = resolve_device(device)
    return OnnxFunction(load_onnx(path), device=device)
