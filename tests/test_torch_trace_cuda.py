"""The port's spans on the card: they record under a CUDA-only profile (the
benchmark's), their host clock is the clock the profiler stamps the card's
kernels with (no kernel a span launches starts before the span opened on
the host), their CUDA events time the work they enclose, and `timings=`
waits for the card.

Imports neither JAX nor the test configuration, so it runs on a machine
with the GPU and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_trace_cuda.py -q
"""

import time

import pytest
import torch

from stableanimator_tpu_torch.core import trace

pytestmark = pytest.mark.cuda

SLEEP_S = 0.02


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the spans' CUDA events have no CPU mode")
    a = torch.randn(4096, 4096, device="cuda")
    a @ a                                           # cuBLAS's set-up outside the spans
    torch.cuda.synchronize()
    trace.clear()
    yield a
    trace.clear()


def _cuda_profile(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        on = torch._C._autograd._profiler_enabled()
        fn()
        torch.cuda.synchronize()
    acts = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA)
    return on, acts


def test_spans_record_under_a_cuda_profile_on_its_clock(card):
    """A span opens, the host sleeps, then launches matmuls: the first
    kernel starts after the span's host start plus the sleep; a second
    span's kernels start after its own open; the card's kernels fall
    inside the slice the spans bound."""
    a = card

    def work():
        with trace.span("first", unit=True):
            time.sleep(SLEEP_S)
            for _ in range(4):
                a @ a
        time.sleep(SLEEP_S)
        with trace.span("second"):
            a @ a

    on, acts = _cuda_profile(work)
    assert on
    got = {s["name"]: s for s in trace.spans()}
    assert set(got) == {"first", "second"}
    first, second = got["first"], got["second"]
    gemms = [x for x in acts if "gemm" in x[2].lower() or "sm90" in x[2] or "cutlass" in x[2]]
    assert len(gemms) == 5, [x[2] for x in acts]
    print(f"first kernel {(gemms[0][0] - first['start_ns']) / 1e6:.3f} ms after its span "
          f"opened; second {(gemms[4][0] - second['start_ns']) / 1e6:.3f} ms")
    assert gemms[0][0] >= first["start_ns"] + SLEEP_S * 1e9
    assert gemms[4][0] >= second["start_ns"] >= first["end_ns"]
    assert all(s >= first["start_ns"] for s, _, _ in acts)
    # the events time the four products, and the sleep before them
    kernel_s = sum(e - s for s, e, _ in gemms[:4]) / 1e9
    assert kernel_s <= first["device_s"] <= kernel_s + SLEEP_S + 0.01
    assert set(first["counts"]) == {"flash_fwd", "flash_resident", "flash_bwd", "norm_kernel",
                                    "norm_eager"}


def test_timings_wait_for_the_card(card):
    a = card
    timings: dict = {}
    t = time.perf_counter()
    with trace.span("work", timings):
        for _ in range(20):
            a @ a
    host = time.perf_counter() - t
    assert trace.spans() == []                      # timings alone record nothing
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        a @ a
    end.record()
    end.synchronize()
    device = start.elapsed_time(end) / 1e3
    assert 0.8 * device <= timings["work"] <= host
