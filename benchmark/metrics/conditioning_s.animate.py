"""Seconds of a request's conditioning (CLIP, the face encoder, the float32
VAE encode) and PoseNet: the mean over the traced window's requests of
`generate(timings=)`'s "conditioning" + "pose"."""

from benchmark import trace


def read(rec: dict):
    return trace.mean_timing(rec, "conditioning", "pose")
