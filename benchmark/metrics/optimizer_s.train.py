"""Seconds of a training step's update: the gradients' upcast, global-norm
clipping, AdamW over the float32 masters and the copy to the models: the
traced window's mean "optimizer"."""

from benchmark import trace


def read(rec: dict):
    return trace.mean_timing(rec, "optimizer")
