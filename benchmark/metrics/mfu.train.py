"""The model FLOPs of the traced window's steps (counts.model_flops: three
times the trained models' forward, once the frozen ones') over the window's
seconds at the card's bf16 peak."""

from benchmark import trace


def read(rec: dict):
    return trace.mfu_pct(rec)
