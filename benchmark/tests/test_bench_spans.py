"""The span metrics' arithmetic (`benchmark/spans.py`) on synthetic device
activities and program spans, with exact sums; and every span metric's
reader giving None, not an error, where no span was recorded."""

import pytest

from benchmark import common, spans, trace

US = 1000       # ns in a µs
SPAN_METRICS = [m["name"] for m in common.benchmark_spec()["per_layer"]
                if m["name"].split(".")[0] in (
                    "conditioning_dev_s", "denoise_dev_s_per_step", "decode_dev_s",
                    "encode_dev_s", "forward_dev_s", "backward_dev_s", "optimizer_dev_s",
                    "program_idle_pct", "caller_idle_pct", "flash_launches")]


def _span(name, sid, parent, unit, start_us, end_us, device_s=None, counts=None, **attrs):
    return {"name": name, "id": sid, "parent": parent, "unit": unit, "attrs": attrs,
            "start_ns": start_us * US, "end_ns": end_us * US, "counts": counts,
            "device_s": device_s}


COUNTS = {"flash_fwd": 250, "flash_resident": 0, "flash_bwd": 1}
# a request [10, 90] µs with denoise [20, 60] and decode [60, 85]; the slice
# ends at the last activity (95 µs) and lasts 95 µs, so it starts at 0
SPANS = [_span("request", 1, None, 1, 10, 90, 0.5, COUNTS),
         _span("conditioning", 2, 1, 1, 10, 15, 0.01),
         _span("pose", 3, 1, 1, 15, 20, 0.02),
         _span("denoise", 4, 1, 1, 20, 60, 0.3, steps=25),
         _span("decode", 5, 1, 1, 60, 85, 0.1)]
ACTIVITIES = [("k1", 12.0, 30.0), ("k2", 40.0, 50.0), ("k3", 70.0, 95.0)]
PROFILE = {"activities": ACTIVITIES, "wall_s": 95e-6, "units": 1, "handover_s": 0.0}


def _rec():
    """A traced run's record, fresh: the idle attribution is kept in it."""
    return {"profile": PROFILE, "units": [], "work": {"steps": 25}}


@pytest.fixture
def recorded(monkeypatch):
    def use(spans_):
        monkeypatch.setattr(spans, "recorded", lambda: spans_)
    return use


def test_a_gap_goes_to_the_innermost_span_or_the_caller():
    busy = trace.busy_intervals(ACTIVITIES)
    by = spans.attribute(busy, SPANS, 0.0, 95.0)
    # [0, 10] caller; [10, 15] conditioning, busy from 12; [15, 20] pose,
    # busy; [20, 60] denoise, busy 20-30 and 40-50; [60, 85] decode, busy
    # from 70; [85, 90] request and [90, 95] caller, busy
    want = {"caller": 10e-6, "conditioning": 2e-6, "pose": 0.0, "denoise": 20e-6,
            "decode": 10e-6, "request": 0.0}
    assert by.keys() == want.keys()
    for name, v in want.items():
        assert by[name] == pytest.approx(v, abs=1e-15), name


def test_nested_spans_put_the_gap_on_the_innermost():
    """Three levels open over one idle stretch: the deepest takes it all,
    its parents the idle time around it."""
    nested = [_span("train_step", 1, None, 1, 0, 100, counts=COUNTS),
              _span("forward", 2, 1, 1, 10, 90),
              _span("inner", 3, 2, 1, 30, 60)]
    busy = trace.busy_intervals([("k", 0.0, 5.0), ("k", 95.0, 100.0)])
    by = spans.attribute(busy, nested, 0.0, 100.0)
    assert by == pytest.approx({"train_step": 10e-6, "forward": 50e-6, "inner": 30e-6})


def test_program_and_caller_add_up_to_the_idle_share(recorded):
    recorded(SPANS)
    rec = _rec()
    program = spans.idle_pct(rec, program=True)
    caller = spans.idle_pct(rec, program=False)
    assert caller == pytest.approx(100 * 10 / 95)
    assert program == pytest.approx(100 * 32 / 95)
    assert program + caller == pytest.approx(trace.idle_pct(rec), rel=1e-12)


def test_the_span_readers(recorded):
    recorded(SPANS + [_span("request", 6, None, 2, 100, 200, 0.7, dict(COUNTS, flash_fwd=252)),
                      _span("conditioning", 7, 6, 2, 100, 110, 0.03),
                      _span("pose", 8, 6, 2, 110, 120, 0.04),
                      _span("denoise", 9, 6, 2, 120, 180, 0.5, steps=25),
                      _span("decode", 10, 6, 2, 180, 190, 0.3)])
    rec = _rec()
    read = {n: common.metric_reader(n).read(rec) for n in SPAN_METRICS if n.endswith(".animate")}
    assert read["conditioning_dev_s.animate"] == pytest.approx((0.03 + 0.07) / 2)
    assert read["denoise_dev_s_per_step.animate"] == pytest.approx((0.3 + 0.5) / 2 / 25)
    assert read["decode_dev_s.animate"] == pytest.approx(0.2)
    assert read["flash_launches.animate"] == 252.0


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_reader_without_spans_gives_none(recorded, monkeypatch, name):
    recorded([])
    assert common.metric_reader(name).read(_rec()) is None
    # a program without the recorder (the parent of the span metrics)
    from stableanimator_tpu_torch.core import trace as program

    monkeypatch.undo()
    monkeypatch.delattr(program, "spans")
    assert spans.recorded() == []
    assert common.metric_reader(name).read(_rec()) is None


def test_every_span_metric_is_listed():
    assert len(SPAN_METRICS) == 13


def test_the_idle_table_is_printed_once_a_run(recorded, capsys):
    """The two idle readers share one attribution, kept in the run's record."""
    recorded(SPANS)
    rec = _rec()
    first = spans.idle_by_span(rec)
    assert spans.idle_pct(rec, program=True) + spans.idle_pct(rec, program=False) > 0
    assert spans.idle_by_span(rec) is first
    assert capsys.readouterr().err.count("[spans] idle by span") == 1
    spans.idle_by_span(_rec())
    assert capsys.readouterr().err.count("[spans] idle by span") == 1
