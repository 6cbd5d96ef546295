"""Seconds of one Euler step of a request (the UNet call at batch 2 x frames,
the blend, the guidance and the update): the traced window's mean
"denoise" over the number of steps."""

from benchmark import trace


def read(rec: dict):
    value = trace.mean_timing(rec, "denoise")
    return None if value is None else value / rec["work"]["steps"]
