"""The norms' routing and the fused kernels' host side on the CPU: the SiLU
flag of the plain version, the counters, the kernels' launch geometry at
the request path's shapes, the GroupNorm kernels' statistics (a shift, then
Chan's pairwise merges over the launch's threads and splits) emulated in
fp32 against an fp64 truth, and the kernel route's custom ops under
torch.export. The kernels themselves run on the card
(`tests/test_torch_norms_cuda.py`). JAX-free.
"""

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from stableanimator_tpu_torch.models import layers
from stableanimator_tpu_torch.ops import norms
from tests.torch_norm_shapes import GROUP_NORM_SHAPES, LAYER_NORM_SHAPES
from tests.torch_threads import share_cores

THREADS = share_cores()
H100_SMS = 132
# the GroupNorm kernels' shared memory: a (mean, M2) a channel of each of a
# CTA's rows (csrc/norms.cu, kGnMaxFloats)
GN_SHARED_FLOATS = norms.GN_MAX_THREADS * 8


def _x(shape, dtype=torch.float32, seed=0, offset=0.0):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=gen) * 2.0 + offset).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [((2, 6, 5, 32), 8), ((2, 3, 4, 4, 64), 32),
                                          ((1, 7, 96), 32)])
def test_silu_flag_is_silu_after_the_norm(shape, groups, dtype):
    x = _x(shape, dtype)
    w, b = _x(shape[-1:], seed=1), _x(shape[-1:], seed=2)
    want = F.silu(norms.group_norm(x, w, b, groups, 1e-6))
    got = norms.group_norm(x, w, b, groups, 1e-6, silu=True)
    assert got.dtype == dtype and torch.equal(got, want)


def test_the_cpu_counts_in_neither():
    norms.reset_counts()
    x = _x((2, 8, 64), torch.bfloat16)
    w, b = torch.ones(64, requires_grad=True), torch.zeros(64)
    norms.group_norm(x, w, b, 32, silu=True)
    norms.layer_norm(x, w, b).float().sum().backward()
    with torch.no_grad():
        norms.layer_norm(x, None, None)
    for fn in (norms.group_norm, norms.layer_norm):
        assert fn.kernel_calls == 0 and fn.eager_calls == 0


@pytest.mark.parametrize("n,rows,c", GROUP_NORM_SHAPES)
def test_group_norm_geometry_covers_the_rows_and_fills_the_card(n, rows, c):
    geo = norms.group_norm_geometry(n, rows, c, 8, H100_SMS)
    threads, rpb, splits, per = geo["threads"], geo["rpb"], geo["splits"], geo["rows_per_split"]
    assert threads % 32 == 0 and threads <= norms.GN_MAX_THREADS
    assert rpb * (c // 8) <= threads and rpb * c <= GN_SHARED_FLOATS
    # the splits cover the rows once, none of them empty
    assert per % rpb == 0 and (splits - 1) * per < rows <= splits * per
    target = H100_SMS * norms.GN_WAVES * (norms.SM_THREADS // threads)
    least = rpb * norms.GN_MIN_ROWS_PER_THREAD
    if -(-rows // least) >= -(-target // n):
        # a sample of many rows spreads until the launch fills the card; a
        # split of at least 8 steps rounded up to whole steps of rpb rows
        # loses at most an eighth of the splits
        assert n * splits >= 0.875 * target
    else:
        # a few rows: a thread takes the least it may
        assert per <= least


def test_group_norm_geometry_raises_past_its_threads():
    norms.group_norm_geometry(1, 10, 8 * norms.GN_MAX_THREADS, 8, H100_SMS)
    with pytest.raises(ValueError, match="threads a row"):
        norms.group_norm_geometry(1, 10, 8 * norms.GN_MAX_THREADS + 8, 8, H100_SMS)
    with pytest.raises(ValueError, match="65535"):
        norms.group_norm_geometry(65536, 1, 64, 8, H100_SMS)


@pytest.mark.parametrize("rows,c", LAYER_NORM_SHAPES)
def test_layer_norm_rows_fit_a_warp(rows, c):
    assert 1 <= norms.layer_norm_vectors(c, 8) <= norms.LN_MAX_VECTORS


def test_layer_norm_vectors_raise_past_the_registers():
    assert norms.layer_norm_vectors(2048, 8) == 8
    with pytest.raises(ValueError, match="vectors a lane"):
        norms.layer_norm_vectors(2056, 8)
    with pytest.raises(ValueError, match="vectors a lane"):
        norms.layer_norm_vectors(257, 1)


def test_vector_width_follows_the_channels_and_views_are_aligned():
    assert [norms.vector_width(c) for c in (320, 36, 30, 33)] == [8, 4, 2, 1]
    # the kernels' wrappers copy a view off a 16-byte boundary
    base = torch.zeros(4096, dtype=torch.bfloat16)
    view = base[1:641].view(2, 320)
    copied = norms._aligned(view)
    assert copied.data_ptr() % 16 == 0 and torch.equal(copied, view)
    assert norms._aligned(base) is base


@pytest.mark.parametrize("rows,c", LAYER_NORM_SHAPES)
def test_layer_norm_blocks_give_each_warp_its_rows(rows, c):
    blocks = norms.layer_norm_blocks(rows, H100_SMS)
    assert 1 <= blocks <= H100_SMS * norms.LN_CTAS_PER_SM
    warps = blocks * norms.LN_WARPS
    assert warps >= rows or blocks == H100_SMS * norms.LN_CTAS_PER_SM
    assert warps < rows + norms.LN_WARPS


def _merge(a, b):
    """Chan's pairwise update of moments (count, mean, M2), elementwise, in
    the kernels' fp32 order (csrc/norms.cu::merge)."""
    na, ma, qa = a
    nb, mb, qb = b
    n = na + nb
    d = mb - ma
    f = torch.where(nb > 0, nb / n.clamp_min(1), torch.zeros_like(nb))
    return (n, ma + d * f, qa + torch.where(nb > 0, qb + d * d * na * f, torch.zeros_like(qb)))


def _tree(m):
    """The moments over the last axis of m, merged pairwise."""
    while m[0].shape[-1] > 1:
        if m[0].shape[-1] % 2:
            m = tuple(F.pad(t, (0, 1)) for t in m)
        m = _merge(tuple(t[..., 0::2] for t in m), tuple(t[..., 1::2] for t in m))
    return tuple(t[..., 0] for t in m)


def _emulated_stats(x, groups, geo):
    """The GroupNorm kernels' mean and variance [n, groups] of x [n, rows,
    c] (fp32) under the launch `geo`: each thread shifts its channel by the
    first value it reads, sums the shifted values and their squares over its
    rows, turns them into (count, mean, M2); the CTA merges its rows and
    channels of a group, then the splits are merged."""
    n, rows, c = x.shape
    rpb, per, splits = geo["rpb"], geo["rows_per_split"], geo["splits"]
    valid = (torch.arange(splits * per) < rows).float().reshape(1, splits, per // rpb, rpb, 1)
    xt = F.pad(x, (0, 0, 0, splits * per - rows)).reshape(n, splits, per // rpb, rpb, c)
    shift = xt[:, :, :1]
    d = (xt - shift) * valid
    cnt = valid.sum(2).expand(n, splits, rpb, c)
    s1, s2 = d.sum(2), (d * d).sum(2)
    q = s1 / cnt.clamp_min(1)
    some = cnt > 0
    m = (cnt, torch.where(some, shift[:, :, 0] + q, 0.0),
         torch.where(some, (s2 - s1 * q).clamp_min(0), 0.0))
    cg = c // groups
    # [n, splits, rpb, groups, cg] -> the CTA's items of a group, then splits
    m = tuple(t.reshape(n, splits, rpb, groups, cg).permute(0, 3, 1, 2, 4)
              .reshape(n, groups, splits, rpb * cg) for t in m)
    total = _tree(_tree(m))
    return total[1], total[2] / total[0]


@pytest.mark.parametrize("n,rows,c,offset", [(2, 1007, 320, 0.0), (3, 130, 640, 0.0),
                                             (1, 4099, 128, 40.0), (2, 600, 96, 300.0)])
def test_emulated_group_norm_statistics_are_exact_to_fp32(n, rows, c, offset):
    """Against fp64, the emulated statistics err by fp32 roundings: no more
    than the plain version's E[x^2] - E[x]^2, and far less where the mean
    is large beside the spread (offset)."""
    groups = 32
    x = _x((n, rows, c), seed=3, offset=offset).bfloat16().float()
    geo = norms.group_norm_geometry(n, rows, c, 8, H100_SMS)
    mean, var = _emulated_stats(x, groups, geo)
    xg = x.double().reshape(n, rows, groups, c // groups)
    var64, mean64 = torch.var_mean(xg, dim=(1, 3), unbiased=False)
    x32 = xg.float()
    naive = x32.square().mean(dim=(1, 3)) - x32.mean(dim=(1, 3)).square()
    err = ((var.double() - var64) / var64).abs().max().item()
    naive_err = ((naive.double() - var64) / var64).abs().max().item()
    assert ((mean.double() - mean64).abs() <= 1e-6 * (mean64.abs() + var64.sqrt())).all()
    assert err <= max(naive_err, 2e-6)
    if offset:
        assert err < naive_err / 10


class _Norms(nn.Module):
    def __init__(self):
        super().__init__()
        self.gn = layers.GroupNorm(32, 64, eps=1e-6)
        self.ln = layers.LayerNorm(64)

    def forward(self, x):
        return self.ln(self.gn(x, silu=True))


def test_the_kernel_route_exports_as_custom_ops(monkeypatch):
    """Traced by torch.export, a call that takes the kernels (forced here on
    the CPU) is their custom op, one node each, which the program runs (the
    plain version on a CPU tensor; tests/test_torch_export_cuda.py and
    tests/test_torch_norms_cuda.py run the kernels from a program exported
    on the card). The trace launches nothing and counts nothing."""
    monkeypatch.setattr(norms, "_takes_kernel", lambda x, *params: True)
    module = _Norms().eval()
    with torch.no_grad():
        module.gn.weight.normal_()
        module.ln.bias.normal_()
    x = _x((2, 9, 64), seed=4)
    norms.reset_counts()
    with torch.no_grad():
        program = torch.export.export(module, (x,), strict=False)
    for fn in (norms.group_norm, norms.layer_norm):
        assert fn.kernel_calls == fn.eager_calls == 0 and not fn.launches_by_shape
    ops = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert {"stableanimator.group_norm_fwd.default", "stableanimator.layer_norm_fwd.default"} <= ops
    want = norms.layer_norm_reference(
        norms.group_norm_reference(x, module.gn.weight, module.gn.bias, 32, 1e-6, silu=True),
        module.ln.weight, module.ln.bias)
    torch.testing.assert_close(program.module()(x), want, rtol=0, atol=0)


class _Ops(TorchDispatchMode):
    """The operators dispatched inside the block, by name."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def test_an_eager_kernel_call_is_the_custom_op(monkeypatch):
    """Eager too, a call that takes the kernels (forced here on the CPU) is
    one dispatch of its custom op, the single route to the launch (whose
    counters then count every launch, eager or exported); a call that
    takes the plain version dispatches its PyTorch ops."""
    x = _x((2, 5, 64), seed=5)
    w, b = _x((64,), seed=6), _x((64,), seed=7)
    with torch.no_grad(), _Ops() as plain:
        norms.group_norm(x, w, b, 32, silu=True)
    assert not any(n.startswith("stableanimator.") for n in plain.names)
    monkeypatch.setattr(norms, "_takes_kernel", lambda x, *params: True)
    with torch.no_grad(), _Ops() as kernel:
        got = norms.group_norm(x, w, b, 32, silu=True)
        norms.layer_norm(x, w, None)
    assert kernel.names == ["stableanimator.group_norm_fwd.default",
                            "stableanimator.layer_norm_fwd.default"]
    assert torch.equal(got, norms.group_norm_reference(x, w, b, 32, silu=True))
