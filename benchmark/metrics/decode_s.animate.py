"""Seconds of a request's temporal VAE decode and its uint8 frames: the
traced window's mean "decode"."""

from benchmark import trace


def read(rec: dict):
    return trace.mean_timing(rec, "decode")
