"""Share of the profiled steps in which no activity ran on the device."""

from benchmark import trace


def read(rec: dict):
    return trace.idle_pct(rec)
