"""The port's int8 path (W8A8, `ops/quant.py`) against the JAX package's,
on the CPU, on the same numpy inputs; and the micro UNet built with
`quant=True` against the JAX package's `quant=True` UNet, fp32.

Tolerances. The weights' int8 values and scales are equal (the same fp32
division and round-half-to-even; the torch weight is the JAX kernel
transposed). The int8 x int8 -> int32 product is exact on both sides, so
int8_dense and int8_geglu agree to fp32 rounding of the dequantisation
(1e-6 relative). Through the UNet the int8 path is discontinuous: fp32
rounding of an activation that sits on a rounding boundary of x / s_x
changes its int8 value by one, the next layers' inputs then move by ~1e-3
and many of their int8 values change in turn. Any two fp32 evaluation
orders of the same quant UNet therefore differ by its quantisation noise
itself: the port's micro quant UNet at 1 and at 8 CPU threads differs by
6.2e-2 at most (of 2.4; correlation 0.9997), as much as the port differs
from JAX (5.2e-2) and the quant forward from the full-precision one
(5.8e-2; `test_quant_unet_two_evaluation_orders` and this file's UNet test
print these), while the full-precision forwards agree to fp32 rounding
(tests/test_torch_unet.py). So the UNet is held to: correlation with JAX's quant output above
0.999, rms difference within 1.5 times the rms quantisation error (JAX's
quant forward against the full-precision one), and the port's own
quantisation error (quant against full precision, same weights) within
20 % of JAX's in rms.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stableanimator_tpu.core.config import micro_model_kwargs as jax_micro_kwargs
from stableanimator_tpu.ops import quant as jq
from stableanimator_tpu.pipeline import build_models as jax_build_models
from stableanimator_tpu.pipeline import fast_init_params
from stableanimator_tpu_torch.convert.from_jax import state_dict_from_jax, state_dicts_from_jax
from stableanimator_tpu_torch.core.config import micro_model_kwargs
from stableanimator_tpu_torch.models.layers import QuantLinear
from stableanimator_tpu_torch.models.unet import UNetSpatioTemporal
from stableanimator_tpu_torch.ops import quant
from stableanimator_tpu_torch.pipeline.animation import build_models, generate
from tests.torch_threads import share_cores

THREADS = share_cores()


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _dense_inputs():
    """tests/test_ops.py::TestInt8Quant's shapes, plus a few rows (the
    padded case) and a row of zeros (the scale's floor)."""
    x = _rand(64, 320, seed=5)
    x[3] = 0.0
    return x, _rand(320, 1280, seed=6) * 0.05, _rand(1280, seed=7) * 0.1


def test_quantize_weight_gives_the_jax_int8_values():
    _, w, _ = _dense_inputs()
    want_q, want_s = (np.asarray(a) for a in jq.quantize_weight(jnp.asarray(w)))
    got_q, got_s = quant.quantize_weight(torch.from_numpy(w.T.copy()))
    assert got_q.dtype == torch.int8
    np.testing.assert_array_equal(got_q.numpy().T, want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


@pytest.mark.parametrize("rows", [64, 5])
@pytest.mark.parametrize("fn", ["int8_dense", "int8_geglu"])
def test_int8_functions_match_jax(fn, rows):
    x, w, b = _dense_inputs()
    x = x[:rows]
    want = np.asarray(getattr(jq, fn)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = getattr(quant, fn)(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                             torch.from_numpy(b)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_int8_dense_close_to_fp32():
    """The JAX test's bounds against the fp32 product."""
    x, w, b = _dense_inputs()
    out = quant.int8_dense(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                           torch.from_numpy(b)).numpy()
    ref = x @ w + b
    denom = np.maximum(np.abs(ref), np.percentile(np.abs(ref), 50))
    assert np.median(np.abs(out - ref) / denom) < 0.02
    assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] > 0.999


@pytest.fixture(scope="module")
def zoo():
    quantized = jax_build_models(**jax_micro_kwargs(), dtype=None, use_flash=False, quant=True)
    return quantized, fast_init_params(quantized, height=64, width=64)


def test_quant_unet_matches_jax(zoo):
    quantized, params = zoo
    cfg = micro_model_kwargs()["unet_cfg"]
    rng = np.random.default_rng(12)
    b, f, hw = 2, 3, 16
    sample = rng.normal(size=(b, f, hw, hw, cfg.in_channels)).astype(np.float32)
    context = rng.normal(size=(b, 1 + cfg.num_id_tokens, cfg.cross_attention_dim))
    context = context.astype(np.float32)
    ids = np.asarray([[6.0, 127.0, 0.02]] * b, np.float32)
    pose = rng.normal(size=(b * f, hw, hw, cfg.block_out_channels[0])).astype(np.float32)
    t = np.float32(0.25 * np.log(37.0))
    args = (sample, t, context, ids, pose)
    want = np.asarray(jax.jit(quantized.unet.apply)({"params": params["unet"]},
                                                    *(jnp.asarray(a) for a in args)))
    ports = {}
    for q in (False, True):
        ports[q] = UNetSpatioTemporal(cfg, quant=q).eval()
        ports[q].load_state_dict(state_dict_from_jax("unet", params["unet"]), strict=True)
    with torch.no_grad():
        got, got_full = (ports[q](*(torch.as_tensor(a) for a in args)).numpy()
                         for q in (True, False))

    def rms(a):
        return float(np.sqrt(np.mean(np.square(a))))

    # the full-precision forward: the port's, which equals JAX's to fp32
    # rounding (tests/test_torch_unet.py)
    print(f"quant UNet: port vs JAX max {np.abs(got - want).max():.3e} of "
          f"{np.abs(want).max():.3e}; quant vs full precision max "
          f"{np.abs(got - got_full).max():.3e}")
    noise = rms(want - got_full)
    assert noise > 1e-3 * rms(want)                       # the int8 path is on
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999
    assert rms(got - want) <= 1.5 * noise, (rms(got - want), noise)
    assert abs(rms(got - got_full) / noise - 1.0) <= 0.2, (rms(got - got_full), noise)


def _thread_pair(fn):
    """fn() at 1 and at 8 CPU threads."""
    threads, outs = torch.get_num_threads(), []
    try:
        for n in (1, 8):
            torch.set_num_threads(n)
            with torch.no_grad():
                outs.append(fn())
    finally:
        torch.set_num_threads(threads)
    return outs


def test_quant_unet_two_evaluation_orders(zoo):
    """The quant UNet and the micro quant generate at 1 and 8 threads: they
    differ by quantisation noise, not by rounding (the plain generate:
    rounding). chip_smoke's micro quant bound (card vs CPU) rests on the
    generate's numbers printed here."""
    from stableanimator_tpu_torch.core.config import PipelineConfig

    _, params = zoo
    cfg = micro_model_kwargs()["unet_cfg"]
    rng = np.random.default_rng(12)
    args = (rng.normal(size=(2, 3, 16, 16, cfg.in_channels)), np.log(37.0) / 4,
            rng.normal(size=(2, 1 + cfg.num_id_tokens, cfg.cross_attention_dim)),
            np.asarray([[6.0, 127.0, 0.02]] * 2), rng.normal(size=(6, 16, 16, 32)))
    args = [torch.as_tensor(np.float32(a)) for a in args]
    port = UNetSpatioTemporal(cfg, quant=True).eval()
    port.load_state_dict(state_dict_from_jax("unet", params["unet"]), strict=True)
    a, b = _thread_pair(lambda: port(*args))
    unet_corr = np.corrcoef(a.flatten(), b.flatten())[0, 1]
    print(f"quant UNet, 1 vs 8 threads: max {(a - b).abs().max().item():.3e} of "
          f"{a.abs().max().item():.3e}, corrcoef {unet_corr:.5f}")
    assert (a - b).abs().max() > 1e-4 * a.abs().max()     # discontinuous, not rounding
    gcfg = PipelineConfig(num_frames=4, tile_size=4, tile_overlap=1, num_inference_steps=2,
                          decode_chunk_size=2)
    gen = torch.Generator().manual_seed(3)
    ref, pose = torch.rand((1, 64, 64, 3), generator=gen), torch.rand((4, 64, 64, 3), generator=gen)
    face, aug = torch.randn((1, 32), generator=gen), torch.randn((1, 64, 64, 3), generator=gen)
    init = torch.randn((1, 4, 8, 8, 4), generator=torch.Generator().manual_seed(4))
    for quant_on in (False, True):
        models = build_models(**micro_model_kwargs(), dtype=torch.float32, device="cpu", seed=0,
                              quant=quant_on)
        a, b = _thread_pair(lambda: generate(models, ref, pose * 2 - 1, face, gcfg,
                                             aug_noise=aug, init_noise=init, device="cpu"))
        d = (a - b).abs()
        corr = np.corrcoef(a.flatten(), b.flatten())[0, 1]
        print(f"micro {'quant' if quant_on else 'plain'} generate, 1 vs 8 threads: max "
              f"{d.max().item():.3e}, mean {d.mean().item():.3e}, corrcoef {corr:.5f}")
        assert corr > 0.99 and d.mean() < 3e-2          # chip_smoke's card-vs-CPU bound


def test_build_models_quant_loads_the_bf16_state_dict(zoo):
    """The same state dict loads with strict=True either way: QuantLinear
    keeps nn.Linear's parameters."""
    _, params = zoo
    bf16 = build_models(**micro_model_kwargs(), dtype=torch.bfloat16, device="cpu", seed=0)
    quantized = build_models(**micro_model_kwargs(), dtype=torch.bfloat16, device="cpu",
                             seed=None, quant=True)
    for name in bf16._fields:
        getattr(quantized, name).load_state_dict(getattr(bf16, name).state_dict(), strict=True)
    n_quant = sum(isinstance(m, QuantLinear) for m in quantized.unet.modules())
    assert n_quant > 20 and not any(isinstance(m, QuantLinear) for m in bf16.unet.modules())
    fp32 = build_models(**micro_model_kwargs(), dtype=torch.float32, device="cpu", seed=None,
                        quant=True)
    for name, sd in state_dicts_from_jax(params).items():
        getattr(fp32, name).load_state_dict(sd, strict=True)
