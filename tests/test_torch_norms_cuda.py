"""The port's fused GroupNorm and LayerNorm kernels on the card, at every
shape a 16-frame request at 512 x 512 and 576 x 1024 reaches
(`tests/torch_norm_shapes.py`), SiLU both ways, and at ragged ones: row
counts off the kernels' steps and splits, channel counts whose vector is
narrower than 16 bytes, misaligned data, fp16, no affine; then the routing
and its counters, eager and from an exported program.

Imports neither JAX nor the test configuration, so it runs on a machine
with the GPU and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_norms_cuda.py -q
"""

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from stableanimator_tpu_torch.models import layers
from stableanimator_tpu_torch.ops import norms
from tests.torch_norm_shapes import GROUP_NORM_SHAPES, LAYER_NORM_SHAPES
from tests.torch_threads import share_cores

THREADS = share_cores()
MANTISSA = {torch.bfloat16: 8, torch.float16: 11}     # significand bits


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    norms.reset_counts()


def _inputs(shape, c, dtype, seed):
    """x [shape] with a per-channel offset and scale (so that the statistics
    and the affine matter), and fp32 weight and bias [c]."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=gen, device="cuda")
    x = x * (0.5 + torch.rand(c, generator=gen, device="cuda") * 3) \
        + torch.randn(c, generator=gen, device="cuda") * 4
    w = 1 + 0.5 * torch.randn(c, generator=gen, device="cuda")
    b = torch.randn(c, generator=gen, device="cuda")
    return x.to(dtype), w, b


def _truth(x, w, b, stats_dims, groups=None, eps=1e-5, silu=False):
    """The kernels' formula in fp64: y = x a + b with a = rstd w and b =
    bias - mean a, statistics over `stats_dims` of x (grouped when
    `groups`), then SiLU where asked; also |x a| + |mean a| + |bias|, the
    size of the terms that make y."""
    x64 = x.double()
    shape = x64.shape
    c = shape[-1]
    if groups is not None:
        x64 = x64.reshape(shape[0], -1, groups, c // groups)
    var, mean = torch.var_mean(x64, dim=stats_dims, keepdim=True, unbiased=False)
    wv = torch.ones(c, dtype=torch.float64, device=x.device) if w is None else w.double()
    bv = torch.zeros(c, dtype=torch.float64, device=x.device) if b is None else b.double()
    if groups is not None:
        wv, bv = wv.reshape(groups, c // groups), bv.reshape(groups, c // groups)
    a = torch.rsqrt(var + eps) * wv
    y = x64 * a + (bv - mean * a)
    size = (x64 * a).abs() + (mean * a).abs() + bv.abs()
    if silu:
        y = F.silu(y)
    return y.reshape(shape), size.reshape(shape)


def _assert_within_two_ulps(got, want, size):
    """|got - want| <= 2 ulps of want in got's dtype, plus 2^-20 of the terms
    that make y. The kernels compute the statistics, a, b = bias - mean a and
    x a + b in fp32, each within a few 2^-24 of its terms, and round once
    (half an ulp): 2 ulps leave room for an fp32 error that carries a value
    across a rounding boundary, and the term-sized floor covers outputs near
    0, where x a + bias - mean a cancels and leaves the fp32 error larger
    than an ulp of the output (2^-20 of the terms is still some 8000 times
    under an ulp of them: a wrong group, channel or statistic shows)."""
    _, e = torch.frexp(want)
    ulp = torch.ldexp(torch.ones_like(want), e - MANTISSA[got.dtype])
    err = (got.double() - want).abs()
    bound = 2 * ulp + size * 2.0 ** -20
    worst = (err / bound).max().item()
    assert worst <= 1.0, f"worst error {worst:.3f} of the bound"


@pytest.mark.cuda
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("n,rows,c", GROUP_NORM_SHAPES + [
    # rows off the steps and splits; channel counts at 4, 2 and 1 a load
    (3, 1007, 320), (2, 37, 1280), (1, 5, 2560), (5, 999, 36), (2, 77, 30), (4, 301, 33)])
def test_group_norm_kernel_matches_the_formula(card, n, rows, c, silu):
    groups = 32 if c % 32 == 0 else c // 3
    x, w, b = _inputs((n, rows, c), c, torch.bfloat16, seed=n + rows + c)
    got = norms.group_norm(x, w, b, groups, 1e-6, silu=silu)
    torch.cuda.synchronize()
    assert norms.group_norm.kernel_calls == 1 and norms.group_norm.eager_calls == 0
    assert got.dtype == x.dtype and got.shape == x.shape
    want, size = _truth(x, w, b, (1, 3), groups, 1e-6, silu)
    del x
    _assert_within_two_ulps(got, want, size)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fp16", "misaligned", "no_affine", "five_dims", "offset"])
def test_group_norm_kernel_edges(card, case):
    """fp16; data 2 bytes off a 16-byte boundary (the wrapper copies it to
    an aligned buffer); no weight or bias; a [B, F, H, W, C] video; a mean
    64 times the spread."""
    dtype = torch.float16 if case == "fp16" else torch.bfloat16
    shape = (2, 16, 8, 8, 320) if case == "five_dims" else (3, 500, 320)
    x, w, b = _inputs(shape, 320, dtype, seed=7)
    if case == "misaligned":
        x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(shape)
        assert x.data_ptr() % 16 == 2
    if case == "no_affine":
        w = b = None
    if case == "offset":
        x = (x.float() / 64 + 64).to(dtype)
    if w is None:
        got = norms._group_norm_kernel(x, w, b, 32, 1e-5, True)
    else:
        got = norms.group_norm(x, w, b, 32, silu=True)
    want, size = _truth(x, w, b, (1, 3), 32, 1e-5, True)
    _assert_within_two_ulps(got, want, size)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c", LAYER_NORM_SHAPES + [
    (1000, 2048), (333, 1000), (100, 300), (64, 77), (7, 8), (3, 1)])
def test_layer_norm_kernel_matches_the_formula(card, rows, c):
    x, w, b = _inputs((rows, c), c, torch.bfloat16, seed=rows + c)
    got = norms.layer_norm(x, w, b)
    torch.cuda.synchronize()
    assert norms.layer_norm.kernel_calls == 1 and norms.layer_norm.eager_calls == 0
    want, size = _truth(x, w, b, (-1,))
    _assert_within_two_ulps(got, want, size)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fp16", "misaligned", "no_affine", "four_dims"])
def test_layer_norm_kernel_edges(card, case):
    dtype = torch.float16 if case == "fp16" else torch.bfloat16
    shape = (2, 16, 64, 640) if case == "four_dims" else (999, 640)
    x, w, b = _inputs(shape, 640, dtype, seed=11)
    if case == "misaligned":
        x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(shape)
        assert x.data_ptr() % 16 == 2
    if case == "no_affine":
        w = b = None
    got = norms.layer_norm(x, w, b)
    want, size = _truth(x, w, b, (-1,))
    _assert_within_two_ulps(got, want, size)


@pytest.mark.cuda
@pytest.mark.parametrize("call", ["group_norm_channels", "group_norm_samples", "layer_norm_width"])
def test_a_call_the_kernel_cannot_take_raises(card, call):
    """A CUDA 16-bit call goes to its kernel or raises: no fallback."""
    with pytest.raises(ValueError):
        if call == "group_norm_channels":         # 513 vectors a row, past 512 threads
            c = 8 * (norms.GN_MAX_THREADS + 1)
            norms.group_norm(torch.zeros(1, 4, c, device="cuda", dtype=torch.bfloat16),
                             torch.ones(c, device="cuda"), torch.zeros(c, device="cuda"), 8)
        elif call == "group_norm_samples":        # past the grid's 65535 rows
            norms.group_norm(torch.zeros(65536, 1, 64, device="cuda", dtype=torch.bfloat16),
                             torch.ones(64, device="cuda"), torch.zeros(64, device="cuda"))
        else:                                     # 9 vectors a lane, past the registers' 8
            norms.layer_norm(torch.zeros(4, 2056, device="cuda", dtype=torch.bfloat16),
                             torch.ones(2056, device="cuda"), torch.zeros(2056, device="cuda"))
    assert norms.group_norm.kernel_calls == 0 and norms.layer_norm.kernel_calls == 0


@pytest.mark.cuda
def test_recording_autograd_routes_to_the_plain_version(card):
    """A call that autograd records, or whose tensor is fp32, takes the plain
    version and counts as eager; the same call without grad takes the
    kernel; a CPU call counts in neither."""
    x, w, b = _inputs((2, 64, 320), 320, torch.bfloat16, seed=3)
    w.requires_grad_(True)
    out = norms.group_norm(x, w, b, silu=True)
    out.float().sum().backward()
    assert w.grad is not None
    norms.layer_norm(x, w, b)
    norms.group_norm(x.float(), w.detach(), b)
    assert (norms.group_norm.eager_calls, norms.layer_norm.eager_calls) == (2, 1)
    assert norms.group_norm.kernel_calls == norms.layer_norm.kernel_calls == 0
    with torch.no_grad():
        got = norms.group_norm(x, w, b, silu=True)
    with torch.inference_mode():
        norms.layer_norm(x, w, b)
    assert norms.group_norm.kernel_calls == norms.layer_norm.kernel_calls == 1
    # the same function: the plain version rounds a, b, x a and the sum to
    # bf16, four roundings of terms under 8 here, 4 x 2^-9 x 8 = 0.0625
    torch.testing.assert_close(got, out.detach(), atol=0.0625, rtol=0.0)
    norms.group_norm(x.cpu(), w.detach().cpu(), b.cpu())
    assert (norms.group_norm.eager_calls, norms.group_norm.kernel_calls) == (2, 1)


class _Norms(nn.Module):
    def __init__(self):
        super().__init__()
        self.gn = layers.GroupNorm(32, 320, eps=1e-6)
        self.ln = layers.LayerNorm(320)

    def forward(self, x):
        return self.ln(self.gn(x, silu=True))


@pytest.mark.cuda
def test_an_exported_program_counts_its_launches(card):
    """A program exported on the card launches each norm kernel once a run,
    and the counters count those launches, not the trace; its output is the
    eager module's, bit for bit."""
    module = _Norms().to("cuda", torch.bfloat16).eval()
    x, w, b = _inputs((2, 300, 320), 320, torch.bfloat16, seed=13)
    with torch.no_grad():
        module.gn.weight.copy_(w)
        module.gn.bias.copy_(b)
        program = torch.export.export(module, (x,), strict=False)
    assert norms.group_norm.kernel_calls == norms.layer_norm.kernel_calls == 0
    norms.reset_counts()
    with torch.no_grad():
        got = program.module()(x)
        torch.cuda.synchronize()
        assert norms.group_norm.kernel_calls == norms.layer_norm.kernel_calls == 1
        assert dict(norms.group_norm.launches_by_shape) == {(2, 300, 320, True): 1}
        assert dict(norms.layer_norm.launches_by_shape) == {(600, 320): 1}
        assert norms.group_norm.eager_calls == norms.layer_norm.eager_calls == 0
        assert torch.equal(got, module(x))
