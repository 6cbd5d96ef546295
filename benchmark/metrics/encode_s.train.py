"""Seconds of a training step's frozen float32 VAE encode of the clip and the
reference frame: the traced window's mean "encode"."""

from benchmark import trace


def read(rec: dict):
    return trace.mean_timing(rec, "encode")
