"""Share of a request's norm calls on the card that took a fused kernel
(`ops/norms.py`: GroupNorm, GroupNorm with SiLU, LayerNorm): 100 x
norm_kernel / (norm_kernel + norm_eager), the kernels' launches and the
CUDA calls that ran the plain version, the deltas of the program's
counters over the span "request", summed over the profiled requests. None
where the counts lack the two keys (a program without the counters)."""

from benchmark import spans


def read(rec: dict):
    counts = [r["counts"] for r, _ in spans.units(spans.recorded(), "request")]
    counts = [c for c in counts if "norm_kernel" in c and "norm_eager" in c]
    kernel = sum(c["norm_kernel"] for c in counts)
    calls = kernel + sum(c["norm_eager"] for c in counts)
    return 100.0 * kernel / calls if calls else None
