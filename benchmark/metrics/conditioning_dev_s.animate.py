"""Stream seconds of a request's conditioning (CLIP, the face encoder, the float32
VAE encode, from the inputs' copies to the card) and PoseNet: the spans
"conditioning" + "pose", each its elapsed time on the stream between its CUDA
events under the CUDA profiler (the card's idle time inside the span and the
profiler's cost per launch included), mean over the profiled requests."""

from benchmark import spans


def read(rec: dict):
    return spans.mean_device_s("request", "conditioning", "pose")
