"""Debug tracing and the port's spans (port of the JAX package's
`core/trace.py`).

The reference's only observability is the `todos.debug` shape/stat dump
idiom scattered through its modules. This keeps that idiom as a flag-gated
tool (`dump`) and adds spans: named, nested intervals at the program's layer
boundaries. A request (`generate`) is the unit span "request" with the
children "conditioning", "pose", "denoise" and "decode"; a training step
(`make_train_step`'s step) is the unit span "train_step" with "encode",
"forward", "backward" and "optimizer".

A span records while a torch profiler is collecting, or inside
`recording()`; otherwise it costs one check and makes nothing. A recorded
span keeps its name, id, its parent's id, its unit's id (the id a unit span
takes, carried by every span under it), its host start and end from
`time.time_ns()` (the clock the profiler stamps its events with), and, when
CUDA is in use, a pair of CUDA events recorded on the current stream at its
open and close, which `spans()` turns into the seconds between them on the
stream when read (the card's idle time inside the span included). A unit
span also keeps the deltas over it of the flash-attention launch counters
and of the norms' counters (`_launch_counts`). While
recording, a span is a `record_function` of its name too, so a
`torch.profiler` export shows it. Recording synchronises nothing.

`timings=`: a span given a caller's dict synchronises the device at its
open and close and adds its host seconds under its key (its name, or
`key`), recording or not. `generate(timings=)` and the training step's
`timings=` are this view of the spans.

Usage:
    from stableanimator_tpu_torch.core import trace
    trace.enable()                      # or STABLEANIMATOR_TRACE=1
    trace.dump("latents", latents)      # shape/min/max/mean, the reference's
                                        # todos.debug.output_var line

    with trace.recording():
        frames = generate(...)
    for s in trace.spans():             # waits for each span's closing event
        print(s["name"], s["unit"], s["device_s"], s["counts"])
    trace.clear()
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time

import numpy as np
import torch

_enabled = os.environ.get("STABLEANIMATOR_TRACE", "0") == "1"


def enable(value: bool = True):
    global _enabled
    _enabled = value


def enabled() -> bool:
    return _enabled


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _leaves(x) -> list:
    """The leaves of a nested container in jax.tree_util's order: a dict's
    values by sorted key, an OrderedDict's in its own order, lists and
    tuples in order, None holding none."""
    if x is None:
        return []
    if isinstance(x, collections.OrderedDict):
        items = list(x.values())
    elif isinstance(x, dict):
        items = [x[k] for k in sorted(x)]
    elif isinstance(x, (list, tuple)):
        items = list(x)
    else:
        return [x]
    return [leaf for item in items for leaf in _leaves(item)]


def dump(name: str, x, force: bool = False):
    """Shape/stat dump in the reference's trace format, e.g.
    `tensor [latents] size: [1, 16, 64, 64, 4], min: -6.613, max: 7.504,
    mean: -0.161`. Takes tensors, numpy arrays and nested containers of
    them (one line per leaf). Returns x."""
    if not (_enabled or force):
        return x

    def one(prefix, arr):
        try:
            a = _as_numpy(arr)
            print(f"tensor [{prefix}] size: {list(arr.shape)}, "
                  f"min: {a.min():.6f}, max: {a.max():.6f}, mean: {a.mean():.6f}")
        except Exception:
            print(f"[{prefix}] type: {type(arr)}")

    leaves = _leaves(x)
    if len(leaves) == 1:
        one(name, leaves[0])
    else:
        for i, leaf in enumerate(leaves):
            one(f"{name}.{i}", leaf)
    return x


# -- spans -------------------------------------------------------------------

_recording = 0                      # open `recording()` blocks
_records: list[dict] = []           # recorded spans, in the order they opened
_ids = itertools.count(1)
_units = itertools.count(1)
_local = threading.local()          # each thread's stack of open recorded spans
_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


@contextlib.contextmanager
def recording():
    """Record spans inside the block, whether or not a profiler collects."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def _cuda_in_use() -> bool:
    return torch.cuda.is_initialized()


def _synchronize() -> None:
    if _cuda_in_use():
        torch.cuda.synchronize()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _launch_counts() -> dict[str, int]:
    """The kernel counters as a unit span reads them: the flash-attention
    launches (`ops/flash_attention.py`: the streamed forward's, the resident
    forward's, and the backward's, dK/dV and dQ kernels together), and of
    the norms (`ops/norms.py`, GroupNorm and LayerNorm together) the fused
    kernels' launches and the CUDA calls that ran the plain version."""
    from stableanimator_tpu_torch.ops import flash_attention as fa
    from stableanimator_tpu_torch.ops import norms

    return {"flash_fwd": fa.flash_attention.launches,
            "flash_resident": fa.flash_attention_resident.launches,
            "flash_bwd": sum(fa.flash_attention_bwd.launches.values()),
            "norm_kernel": norms.group_norm.kernel_calls + norms.layer_norm.kernel_calls,
            "norm_eager": norms.group_norm.eager_calls + norms.layer_norm.eager_calls}


class _Span:
    __slots__ = ("name", "timings", "key", "unit", "attrs", "rec", "rf", "t0", "counts0",
                 "start")

    def __init__(self, name, timings, key, unit, attrs):
        self.name, self.timings, self.key, self.unit, self.attrs = name, timings, key, unit, attrs
        self.rec = None

    def __enter__(self):
        if self.timings is not None:
            _synchronize()
            self.t0 = time.perf_counter()
        if _recording or _profiling():
            self._open()
        return self

    def _open(self) -> None:
        stack = _stack()
        parent = stack[-1] if stack else None
        unit = next(_units) if self.unit else (parent["unit"] if parent else None)
        self.rec = {"name": self.name, "id": next(_ids),
                    "parent": parent["id"] if parent else None, "unit": unit,
                    "attrs": self.attrs, "start_ns": time.time_ns(), "end_ns": None,
                    "counts": None, "events": None}
        if self.unit:
            self.counts0 = _launch_counts()
        self.start = None
        if _cuda_in_use():
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        stack.append(self.rec)
        _records.append(self.rec)

    def __exit__(self, *exc):
        rec = self.rec
        if self.timings is not None:
            _synchronize()
            self.timings[self.key] = (self.timings.get(self.key, 0.0)
                                      + time.perf_counter() - self.t0)
        if rec is not None:
            self.rf.__exit__(*exc)
            if self.start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                rec["events"] = (self.start, end)
            if self.unit:
                rec["counts"] = {k: v - self.counts0[k] for k, v in _launch_counts().items()}
            rec["end_ns"] = time.time_ns()
            _stack().pop()
        return False


def span(name: str, timings: dict | None = None, key: str | None = None, unit: bool = False,
         **attrs):
    """A span of the program (module docstring) around a `with` block.

    timings: a caller's dict; the span then synchronises at its open and
      close and adds its host seconds under `key` (default `name`).
    unit: a unit span (a request, a training step): it takes a new unit id
      and keeps the kernel counters' deltas (`_launch_counts`).
    attrs: kept with the record (e.g. `steps` of a denoise).

    Off (no timings, no profiler collecting, no `recording()`), it returns
    one shared empty context."""
    if timings is None and not (_recording or _profiling()):
        return _OFF
    return _Span(name, timings, key or name, unit, attrs)


def spans() -> list[dict]:
    """The closed recorded spans, in the order they opened: {"name", "id",
    "parent", "unit", "attrs", "start_ns", "end_ns", "counts", "device_s"}.
    device_s, the seconds between the span's two CUDA events on the stream
    (the card's idle time inside the span included), waits for the closing
    one; None where CUDA was not in use."""
    out = []
    for rec in list(_records):
        if rec["end_ns"] is None:
            continue
        events = rec["events"]
        device_s = None
        if events is not None:
            events[1].synchronize()
            device_s = events[0].elapsed_time(events[1]) / 1e3
        out.append({**{k: v for k, v in rec.items() if k != "events"}, "device_s": device_s})
    return out


def clear() -> None:
    """Forget the recorded spans."""
    _records.clear()
