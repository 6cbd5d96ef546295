"""One run of one cell of the port's benchmark.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout that holds `stableanimator_tpu_torch`, on
the card. The cell's entry in BENCHMARK.json names its configuration
(`benchmark/configs/<config>.json`) and its traffic
(`benchmark/traffic/<traffic>.json`), which names its driver
(`benchmark/drivers/<driver>.py`); each per-layer metric is read by
`benchmark/metrics/<metric>.py`. Set-up (weights made from the seed on the
card, the program built, its kernels built or loaded, the traffic's shapes
warmed) counts in `setup_s`, from the start of the process. The window then
runs units of work (requests, steps) back to back until --seconds have
passed, finishes the one in flight, and measures rates over all its work
and all its time. With --trace 1 the window passes `timings=` (phase
boundaries synchronised) and one slice more of the same traffic runs under
the profiler; the line then carries the per-layer metrics. Last, the
program is freed and `correct` is decided against the plain reference
(the driver's `check`, the traffic file's limits).

The last line of standard output is the result; the compared numbers and
their limits end standard error and the result. Without a card (or with
fewer than the cell asks for), with a module of JAX or of the JAX package
loaded, or without the program, the run fails and prints no result.
`--seconds 0` runs one unit in the window: the quickest reading of the
compared numbers on a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache of a run at a fixed place inside the checkout
_CACHE = os.path.join(ROOT, ".bench_cache")
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(_CACHE, _sub)
sys.path.insert(0, ROOT)

from benchmark import common, counts, guard, trace  # noqa: E402


def process_age() -> float:
    """Seconds since this process started (its start time in /proc), or
    since this module was loaded where /proc has none."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cell_spec(spec: dict, workload: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def applies(metric: dict, workload: str, reported: set) -> bool:
    """Whether a metric belongs on this cell's line: listed for it, or, with
    no list, every cell (end to end) or every cell that reports the metric
    it moves (per layer)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def make_cell(wl: dict, seed: int, device, cfg=None, traffic=None):
    cfg = cfg or common.config(wl["config"])
    traffic = traffic or common.traffic(wl["traffic"])
    return common.driver(traffic["driver"]).Cell(cfg, traffic, seed, device), cfg, traffic


def window(cell, first: int, seconds: float, traced: bool) -> tuple[list, float, int]:
    """Units back to back from index `first` until `seconds` have passed,
    the last one finished; returns (units, seconds, work done)."""
    units, done, i = [], 0, first
    t_open = time.perf_counter()
    while True:
        timings = {} if traced else None
        t = time.perf_counter()
        done += cell.unit(i, timings)
        t_end = time.perf_counter()
        units.append({"index": i, "seconds": t_end - t, "timings": timings})
        i += 1
        if t_end - t_open >= seconds:
            return units, t_end - t_open, done


def run_cell(spec: dict, workload: str, seed: int, seconds: float, traced: bool, device,
             cfg=None, traffic=None) -> dict:
    """One run of `workload` on `device`; returns the result line."""
    import torch

    wl = cell_spec(spec, workload)
    cell, cfg, traffic = make_cell(wl, seed, device, cfg, traffic)
    device = cell.device
    cell.setup()
    first = cell.FIRST_UNIT
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = process_age()
    units, window_s, done = window(cell, first, seconds, traced)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    rate = done * cell.RATE_SCALE / window_s
    print(f"[window] {len(units)} {traffic['driver']} units, {done} {cell.UNIT} in "
          f"{window_s:.3f} s; unit seconds " + " ".join(f"{u['seconds']:.3f}" for u in units),
          flush=True)
    e2e = {m["name"]: m for m in spec["end_to_end"] if applies(m, workload, set())}
    values = {cell.RATE_METRIC: rate, "peak_gib": peak / 2 ** 30, "setup_s": setup_s}
    metrics = {n: {"value": values[n], "unit": m["unit"]} for n, m in e2e.items()}
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"metrics": metrics}
    if traced:
        n_prof = traffic["profiled_units"]
        nxt = units[-1]["index"] + 1
        prof = trace.profile(lambda: [cell.unit(nxt + k) for k in range(n_prof)])
        prof["units"] = n_prof
        print(f"[trace] profiled {n_prof} unit(s): wall {prof['wall_s']:.3f} s, "
              f"{len(prof['activities'])} device activities, the profiler's hand-over "
              f"{prof['handover_s']:.2f} s", flush=True)
        work = cell.work()
        rec = {"units": units, "window_s": window_s, "profile": prof, "work": work,
               "model_flops": counts.model_flops(cfg, work),
               "attention_calls": counts.attention_calls(cfg, work)}
        per_layer = {}
        for m in spec["per_layer"]:
            if applies(m, workload, set(e2e)):
                v = common.metric_reader(m["name"]).read(rec)
                if v is not None:
                    per_layer[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = per_layer
        device_info.update(busy_s=trace.busy_seconds(prof), window_s=prof["wall_s"])
        result["breakdown"] = {"device_ops": trace.device_ops(prof),
                               "idle_gaps": trace.idle_gaps(prof)}
    failed = sum(not cell.valid(u["index"]) for u in units)
    cell.free_program()
    t = time.perf_counter()
    numbers = cell.check([u["index"] for u in units if cell.valid(u["index"])])
    print(f"[check] the reference took {time.perf_counter() - t:.1f} s: "
          + json.dumps(numbers), flush=True)
    limits = traffic["limits"]
    checks = {n: {"value": numbers[n], "limit": lim} for n, lim in limits.items()}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    return {"correct": correct, "attempted": len(units), "failed": failed, **result,
            "device": device_info, "checks": checks}


def _cuda_or_exit(chips: int):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {chips} CUDA device(s); {n} available", file=sys.stderr)
        raise SystemExit(2)
    return torch.device("cuda", 0)


def _forbidden_or_exit(when: str) -> None:
    bad = guard.loaded_forbidden()
    if bad:
        print(f"JAX or the JAX package is loaded {when}: {', '.join(bad)}", file=sys.stderr)
        raise SystemExit(3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _forbidden_or_exit("at start-up")
    spec = common.benchmark_spec()
    wl = cell_spec(spec, args.workload)
    device = _cuda_or_exit(wl["chips"])
    seconds = args.seconds if args.seconds is not None else spec["run_seconds"]
    result = run_cell(spec, args.workload, args.seed, seconds, bool(args.trace), device)
    _forbidden_or_exit("once the window closed")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
