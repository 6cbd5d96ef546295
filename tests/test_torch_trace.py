"""The port's `core/trace.py`: the reference's dump line (the format
tests/test_misc.py::TestTrace checks on the JAX package's) for tensors,
numpy arrays and nested containers, line for line the JAX package's
`dump` on the same inputs (leaves in jax.tree_util's order: a dict's by
sorted key), silence when disabled, and a torch.profiler trace under
logdir that holds an `annotate` region."""

import collections
import json

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


def test_profile_writes_a_trace_with_the_annotation(tmp_path, capsys):
    with trace.profile("step", logdir=str(tmp_path)) as prof:
        with trace.annotate("my_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    path = tmp_path / "step.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "my_region" for e in events)
    assert "[trace] step:" in capsys.readouterr().out
