"""The program's spans in the traced run's profiled slice, and the arithmetic
the span metrics' readers share.

The port (`stableanimator_tpu_torch.core.trace`) records its spans while a
profiler collects, so after `trace.profile` they are the slice's spans. A
program without the recorder gives none, and every reader then None. A
span's host start and end are `time.time_ns()`, the clock the profile's
activities are stamped on (in µs there); its device seconds come from the
CUDA events it recorded: the seconds between them on the stream under the
profiler, so the card's idle time inside the span and the profiler's cost
per launch are in them.

The idle attribution: each stretch of the slice in which no device activity
ran is put down to the innermost program span open on the host at that
moment, or to "caller" where none is open (the cell's own code between
units: its inputs, its reads of the results). The slice ends at the later
of its last activity and its last span, and starts `wall_s` before.
"""

from __future__ import annotations

import sys

from benchmark import trace

CALLER = "caller"


def recorded() -> list[dict]:
    """The program's closed spans (`core/trace.spans()`), or [] where the
    program has no recorder."""
    from stableanimator_tpu_torch.core import trace as program

    read = getattr(program, "spans", None)
    return read() if read is not None else []


def units(spans: list[dict], root: str) -> list[tuple[dict, list[dict]]]:
    """The unit spans named `root`, each with the spans of its unit."""
    return [(r, [s for s in spans if s["unit"] == r["unit"] and s is not r])
            for r in spans if r["name"] == root and r["counts"] is not None]


def mean_device_s(root: str, *names: str, per_attr: str | None = None) -> float | None:
    """The mean over the recorded units `root` of the device seconds of their
    spans named `names` (each span's elapsed seconds on the stream, idle
    included), summed (each over its attribute `per_attr` when given); None
    without such units or without device seconds."""
    values = []
    for _, spans in units(recorded(), root):
        got = [s for s in spans if s["name"] in names]
        if not got or any(s["device_s"] is None for s in got):
            return None
        values.append(sum(s["device_s"] / (s["attrs"][per_attr] if per_attr else 1)
                          for s in got))
    return sum(values) / len(values) if values else None


def mean_launches(root: str) -> float | None:
    """The mean over the recorded units `root` of their flash-attention
    launches (streamed and resident forward, backward)."""
    counts = [r["counts"] for r, _ in units(recorded(), root)]
    if not counts:
        return None
    return sum(c["flash_fwd"] + c["flash_resident"] + c["flash_bwd"] for c in counts) / len(counts)


def _innermost(spans: list[dict], a: float, b: float) -> str:
    """The name of the innermost span open over all of [a, b] (µs), else
    CALLER."""
    open_ = [s for s in spans if s["start_ns"] / 1e3 <= a and s["end_ns"] / 1e3 >= b]
    if not open_:
        return CALLER
    return max(open_, key=lambda s: (s["start_ns"], s["id"]))["name"]


def attribute(busy: list, spans: list[dict], start: float, end: float) -> dict[str, float]:
    """Idle seconds of [start, end] (µs) by innermost span name (CALLER
    where none is open): `busy` is `trace.busy_intervals`, sorted and
    disjoint."""
    marks = sorted({start, end} | {t / 1e3 for s in spans for t in (s["start_ns"], s["end_ns"])
                                   if start < t / 1e3 < end})
    out: dict[str, float] = {}
    j = 0
    for a, b in zip(marks, marks[1:]):
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        covered, k = 0.0, j
        while k < len(busy) and busy[k][0] < b:
            covered += max(0.0, min(b, busy[k][1]) - max(a, busy[k][0]))
            k += 1
        name = _innermost(spans, a, b)
        out[name] = out.get(name, 0.0) + (b - a - covered) / 1e6
    return out


def idle_by_span(rec: dict) -> dict[str, float] | None:
    """The profiled slice's idle seconds by innermost span (`attribute`);
    None without a profile or without spans. Kept in `rec`, so the table
    goes to stderr once a run."""
    if "idle_by_span" not in rec:
        rec["idle_by_span"] = _idle_by_span(rec)
    return rec["idle_by_span"]


def _idle_by_span(rec: dict) -> dict[str, float] | None:
    prof = rec.get("profile")
    if not prof or prof["wall_s"] <= 0:
        return None
    spans = recorded()
    if not spans:
        return None
    busy = trace.busy_intervals(prof["activities"])
    end = max([b[1] for b in busy] + [s["end_ns"] / 1e3 for s in spans])
    by = attribute(busy, spans, end - prof["wall_s"] * 1e6, end)
    wall = prof["wall_s"]
    table = sorted(by.items(), key=lambda x: -x[1])
    print("[spans] idle by span: " + ", ".join(f"{n} {v:.4f} s ({100 * v / wall:.2f} %)"
                                               for n, v in table)
          + f"; wall {wall:.4f} s", file=sys.stderr, flush=True)
    device: dict[str, float] = {}
    for s in spans:
        if s["device_s"] is not None:
            device[s["name"]] = device.get(s["name"], 0.0) + s["device_s"]
    print("[spans] device s by span: " + ", ".join(f"{n} {v:.4f}" for n, v in device.items()),
          file=sys.stderr, flush=True)
    return by


def idle_pct(rec: dict, program: bool) -> float | None:
    """100 x the slice's idle seconds with a program span open (program) or
    with none (not program), over the slice's wall seconds."""
    by = idle_by_span(rec)
    if by is None:
        return None
    idle = sum(v for n, v in by.items() if (n != CALLER) == program)
    return 100.0 * idle / rec["profile"]["wall_s"]
