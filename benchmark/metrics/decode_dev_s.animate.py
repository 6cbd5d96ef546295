"""Stream seconds of a request's VAE decode, through the uint8 frames on the
card: the span "decode", its elapsed time on the stream between its CUDA
events under the CUDA profiler (the card's idle time inside the span and the
profiler's cost per launch included), mean over the profiled requests."""

from benchmark import spans


def read(rec: dict):
    return spans.mean_device_s("request", "decode")
