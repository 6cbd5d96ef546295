"""The port's `core/trace.py`: the reference's dump line (the format
tests/test_misc.py::TestTrace checks on the JAX package's) for tensors,
numpy arrays and nested containers, line for line the JAX package's
`dump` on the same inputs (leaves in jax.tree_util's order: a dict's by
sorted key), silence when disabled; and the spans of a micro request and
training step: nothing made while off, their tree while recording, the
profiler's clock, and `timings=` as their host seconds."""

import collections
import time

import numpy as np
import pytest
import torch

from stableanimator_tpu.core import trace as jax_trace
from stableanimator_tpu_torch.core import trace
from tests.torch_threads import share_cores

THREADS = share_cores()


def test_dump_format(capsys):
    trace.enable(True)
    try:
        trace.dump("latents", np.ones((2, 3), np.float32) * 2)
        trace.dump("t", torch.arange(4.0).reshape(1, 4))
        trace.dump("tree", {"a": torch.zeros(2), "b": [np.ones(3)]})
    finally:
        trace.enable(False)
    out = capsys.readouterr().out
    assert "tensor [latents] size: [2, 3]" in out
    assert "mean: 2.0" in out
    assert "tensor [t] size: [1, 4], min: 0.000000, max: 3.000000, mean: 1.500000" in out
    assert "tensor [tree.0] size: [2]" in out and "tensor [tree.1] size: [3]" in out


def _inputs():
    rng = np.random.default_rng(3)
    t1 = rng.normal(size=(2, 3)).astype(np.float32)
    t2 = rng.uniform(size=(4,)).astype(np.float32)
    t3 = rng.normal(size=(1, 2, 2)).astype(np.float32)
    return {
        "array": t1,
        "unsorted_dict": {"b": t1, "a": t2, "c": [t3, None]},
        "nested": [(t2, {"z": t3, "y": t1}), collections.OrderedDict(q=t1, p=t2)],
        "empty": None,
    }


@pytest.mark.parametrize("case", ["array", "unsorted_dict", "nested", "empty"])
def test_dump_matches_the_jax_package(capsys, case):
    x = _inputs()[case]
    jax_trace.dump("x", x, force=True)
    want = capsys.readouterr().out.splitlines()
    as_torch = (lambda v: torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
    trace.dump("x", x, force=True)
    got = capsys.readouterr().out.splitlines()
    assert got == want
    if case == "unsorted_dict":
        assert len(got) == 3 and got[0].startswith("tensor [x.0] size: [4]")   # key "a"
        trace.dump("x", {k: as_torch(v) for k, v in x.items() if k != "c"}, force=True)
        assert capsys.readouterr().out.splitlines() == want[:2]


def test_disabled_is_silent(capsys):
    trace.enable(False)
    x = torch.zeros(1)
    assert trace.dump("x", x) is x
    assert capsys.readouterr().out == ""


# -- spans ---------------------------------------------------------------------

REQUEST = {"conditioning", "pose", "denoise", "decode"}
STEP = {"encode", "forward", "backward", "optimizer"}
STEPS = 2


@pytest.fixture(scope="module")
def micro():
    """A micro-width request and training step on the CPU, in float32:
    run(timings=None, generate_timings=None) runs one of each."""
    from stableanimator_tpu_torch.core.config import (
        PipelineConfig,
        TrainConfig,
        micro_model_kwargs,
    )
    from stableanimator_tpu_torch.pipeline.animation import build_models, generate
    from stableanimator_tpu_torch.train.train_step import create_train_state, make_train_step

    infer = build_models(**micro_model_kwargs(), dtype=torch.float32, device="cpu", seed=0)
    train = build_models(**micro_model_kwargs(), dtype=torch.float32, device="cpu", seed=0)
    tc = TrainConfig(mixed_precision="no")
    state = create_train_state(train, tc)
    step_fn = make_train_step(train, tc, PipelineConfig())
    g = torch.Generator().manual_seed(0)
    id_dim = infer.face_encoder.config.id_embeddings_dim
    b, f, h, w = 1, 2, 64, 64
    request = dict(ref_image=torch.randint(0, 256, (1, h, w, 3), generator=g, dtype=torch.uint8),
                   pose_pixels=torch.randint(0, 256, (4, h, w, 3), generator=g,
                                             dtype=torch.uint8),
                   face_embedding=torch.randn((1, id_dim), generator=g))
    batch = {"frames": torch.rand((b, f, h, w, 3), generator=g) * 2 - 1,
             "ref_image": torch.rand((b, h, w, 3), generator=g),
             "pose_pixels": torch.rand((b, f, h, w, 3), generator=g) * 2 - 1,
             "face_embed": torch.randn((b, id_dim), generator=g),
             "face_mask": (torch.rand((b, f, h, w, 1), generator=g) > 0.5).float()}
    cfg = PipelineConfig(num_inference_steps=STEPS, tile_size=4, tile_overlap=2, output_uint8=True)

    def run(request_timings=None, step_timings=None):
        frames = generate(infer, cfg=cfg, device="cpu", timings=request_timings,
                          generator=torch.Generator().manual_seed(1), **request)
        step_fn(state, batch, generator=torch.Generator().manual_seed(2), timings=step_timings)
        return frames

    return run


class _FakeEvent:
    """torch.cuda.Event on the host clock: elapsed_time in ms between two
    records."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA as in use (its events on the host clock), and record_function
    counted: what a span makes shows on the CPU."""
    made = {"record_function": 0}
    real = torch.profiler.record_function

    def counted(name):
        made["record_function"] += 1
        return real(name)

    _FakeEvent.made = 0
    monkeypatch.setattr(trace, "_cuda_in_use", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    trace.clear()
    yield made
    trace.clear()


def test_spans_off_make_nothing(micro, fake_cuda):
    """No profiler and no recording(): a request and a training step record
    no span, make no CUDA event and open no record_function."""
    micro()
    assert trace.spans() == []
    assert _FakeEvent.made == 0 and fake_cuda["record_function"] == 0


def _tree(spans):
    by_id = {s["id"]: s for s in spans}
    roots = [s for s in spans if s["parent"] is None]
    children = {r["id"]: [s for s in spans if s["parent"] == r["id"]] for r in roots}
    return by_id, roots, children


def test_recording_gives_the_span_tree(micro, fake_cuda):
    with trace.recording():
        micro()
        micro()
    spans = trace.spans()
    by_id, roots, children = _tree(spans)
    assert [r["name"] for r in roots] == ["request", "train_step"] * 2
    assert len({r["unit"] for r in roots}) == 4
    for root in roots:
        kids = children[root["id"]]
        assert {k["name"] for k in kids} == (REQUEST if root["name"] == "request" else STEP)
        assert len(kids) == 4
        assert set(root["counts"]) == {"flash_fwd", "flash_resident", "flash_bwd", "norm_kernel",
                                       "norm_eager"}
        assert all(v == 0 for v in root["counts"].values())     # the CPU path counts none
        for k in kids:
            assert k["unit"] == root["unit"] and k["counts"] is None
            assert root["start_ns"] <= k["start_ns"] <= k["end_ns"] <= root["end_ns"]
            assert 0.0 <= k["device_s"] <= root["device_s"]
            if k["name"] == "denoise":
                assert k["attrs"] == {"steps": STEPS}
    order = [s["id"] for s in spans]
    assert order == sorted(order) and len(set(order)) == len(order)
    # children of one parent follow each other on the host clock
    for kids in children.values():
        assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(kids, kids[1:]))
    assert _FakeEvent.made == 2 * len(spans) and fake_cuda["record_function"] == len(spans)
    trace.clear()
    assert trace.spans() == []


def test_spans_share_the_profilers_clock(micro):
    """Under a CPU profile (no recording()), each span records, and its host
    interval holds the profiler's own event of its record_function."""
    from torch.profiler import ProfilerActivity, profile

    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        micro()
    spans = trace.spans()
    trace.clear()
    names = REQUEST | STEP | {"request", "train_step"}
    assert sorted(s["name"] for s in spans) == sorted(names)
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            events.setdefault(e.name(), []).append(e)
    slack = 1_000_000                                   # ns
    for s in spans:
        (e,) = events[s["name"]]
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        assert s["start_ns"] - slack <= start <= end <= s["end_ns"] + slack, s["name"]


def test_timings_are_the_spans_host_seconds(micro):
    """timings= keeps its keys; forward_backward is forward + backward."""
    request, step = {}, {}
    trace.clear()
    with trace.recording():
        micro(request, step)
    spans = {s["name"]: (s["end_ns"] - s["start_ns"]) / 1e9 for s in trace.spans()}
    trace.clear()
    assert set(request) == REQUEST
    assert set(step) == {"encode", "forward_backward", "optimizer"}
    assert all(v > 0 for v in (*request.values(), *step.values()))
    assert step["forward_backward"] == pytest.approx(spans["forward"] + spans["backward"],
                                                     abs=5e-3)
    for name in ("encode", "optimizer", *REQUEST):
        got = step.get(name, request.get(name))
        assert got == pytest.approx(spans[name], abs=5e-3), name
