"""The traced run's device trace, and the arithmetic the per-layer metric
readers share.

`profile(fn)` runs `fn` under `torch.profiler` with CUDA activity only (no
host events, so the hand-over of the events stays short) and returns every
device activity as (name, start_us, end_us), with the wall seconds of the
slice and of the hand-over. From those: the busy time (the union of the
activities' intervals), the idle gaps, the device time by name, and a
kernel's share of its roofline against the benchmark's own count of its
work (`counts.py`).
"""

from __future__ import annotations

import re
import time

from benchmark import counts


def profile(fn) -> dict:
    """{"activities": [(name, start_us, end_us)], "wall_s", "handover_s"}
    of one call of `fn` on the card; the hand-over is the profiler's stop
    and the reading of its events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    prof = torch_profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof.stop()
    raw = getattr(getattr(prof.profiler, "kineto_results", None), "events", None)
    if raw is not None:           # the raw events: no host-side event tree to build
        acts = [(e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
                for e in raw() if e.device_type() == DeviceType.CUDA]
    else:
        acts = [(ev.name, float(ev.time_range.start), float(ev.time_range.end))
                for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    acts.sort(key=lambda a: a[1])
    return {"activities": acts, "wall_s": wall,
            "handover_s": time.perf_counter() - t0 - wall}


def busy_intervals(acts) -> list[tuple[float, float, str, str]]:
    """The union of the activities' intervals, sorted: (start_us, end_us,
    first activity's name, last activity's name)."""
    out: list = []
    for name, s, e in acts:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e, out[-1][2], name)
        else:
            out.append((s, e, name, name))
    return out


def busy_seconds(prof: dict) -> float:
    return sum(e - s for s, e, _, _ in busy_intervals(prof["activities"])) / 1e6


def idle_gaps(prof: dict, top: int = 10) -> list[list]:
    """The longest idle stretches between device activities, named by the
    activity that ran last before each: [[name, seconds]]."""
    spans = busy_intervals(prof["activities"])
    gaps = [(f"idle after {a[3][:80]}", (b[0] - a[1]) / 1e6) for a, b in zip(spans, spans[1:])]
    return [list(g) for g in sorted(gaps, key=lambda g: -g[1])[:top]]


def device_ops(prof: dict, top: int = 10) -> list[list]:
    """The device activities that took most time, summed by name."""
    by_name: dict[str, float] = {}
    for name, s, e in prof["activities"]:
        by_name[name[:120]] = by_name.get(name[:120], 0.0) + (e - s) / 1e6
    return [[n, t] for n, t in sorted(by_name.items(), key=lambda x: -x[1])[:top]]


def roofline_pct(rec: dict, pattern: str, passes: tuple[str, ...]) -> float | None:
    """100 x the least time of the profiled slice's attention calls of
    `passes` (counts.attention_calls, times the units profiled) over the
    device time of the activities whose name matches `pattern`; None when
    the slice holds no such call or no such activity."""
    prof = rec.get("profile")
    if not prof:
        return None
    bound = sum(counts.bound_seconds(c) * c["n"] for c in rec["attention_calls"]
                if c["pass"] in passes) * prof["units"]
    rx = re.compile(pattern)
    measured = sum(e - s for name, s, e in prof["activities"] if rx.search(name)) / 1e6
    if bound <= 0 or measured <= 0:
        return None
    return 100.0 * bound / measured


def mean_timing(rec: dict, *names: str) -> float | None:
    """The mean over the traced window's units of the sum of phases
    `names` of `timings=`; None without timings."""
    units = [u for u in rec.get("units", []) if u.get("timings")]
    if not units:
        return None
    return sum(sum(u["timings"][n] for n in names) for u in units) / len(units)


def idle_pct(rec: dict) -> float | None:
    prof = rec.get("profile")
    if not prof or prof["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - busy_seconds(prof) / prof["wall_s"])


def mfu_pct(rec: dict) -> float | None:
    """100 x the model FLOPs of the traced window's completed units over the
    window's seconds at the bf16 peak."""
    if not rec.get("window_s"):
        return None
    done = len(rec["units"])
    return 100.0 * rec["model_flops"] * done / (rec["window_s"] * counts.PEAKS["bf16_flops"])
