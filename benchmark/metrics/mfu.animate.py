"""The model FLOPs of the traced window's requests (counts.model_flops) over
the window's seconds at the card's bf16 peak."""

from benchmark import trace


def read(rec: dict):
    return trace.mfu_pct(rec)
