"""Stream seconds of one Euler step of a request: the span "denoise", its
elapsed time on the stream between its CUDA events under the CUDA profiler
(the card's idle time inside the span and the profiler's cost per launch
included), over its steps, mean over the profiled requests."""

from benchmark import spans


def read(rec: dict):
    return spans.mean_device_s("request", "denoise", per_attr="steps")
