"""Flash-attention launches of a training step (forward, its recompute under
checkpointing, the dK/dV and dQ kernels): the deltas of the program's
launch counters over the span "train_step", mean over the profiled steps."""

from benchmark import spans


def read(rec: dict):
    return spans.mean_launches("train_step")
