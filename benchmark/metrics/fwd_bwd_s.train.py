"""Seconds of a training step's conditioning, UNet forward and backward
(gradient checkpointing) and loss: the traced window's mean
"forward_backward"."""

from benchmark import trace


def read(rec: dict):
    return trace.mean_timing(rec, "forward_backward")
