"""Flash-attention launches of a request (streamed and resident forward): the
deltas of the program's launch counters over the span "request", mean over
the profiled requests."""

from benchmark import spans


def read(rec: dict):
    return spans.mean_launches("request")
