"""Share of its roofline reached by the backward attention kernels of the profiled steps (dK/dV and dQ): the least time of
their work as counts.py counts it, over the device time of every activity
whose name matches PATTERN: the port's kernels and PyTorch's flash,
memory-efficient and cuDNN attention, so the same work is read whatever
implements it."""

from benchmark import trace

PATTERN = r"flash_bwd|fmha_cutlassB|sdpa\w*bprop"


def read(rec: dict):
    return trace.roofline_pct(rec, PATTERN, ("bwd",))
