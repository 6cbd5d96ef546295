"""Stream seconds of a training step's backward (the checkpointed blocks'
recompute included): the span "backward", its elapsed time on the stream
between its CUDA events under the CUDA profiler (the card's idle time inside
the span and the profiler's cost per launch included), mean over the
profiled steps."""

from benchmark import spans


def read(rec: dict):
    return spans.mean_device_s("train_step", "backward")
