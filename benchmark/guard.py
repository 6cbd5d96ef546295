"""The run's guard against the JAX package: nothing of JAX may be loaded in
a process that measures the port."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "stableanimator_tpu")


def loaded_forbidden(modules=None) -> list[str]:
    """The names in `modules` (default sys.modules) whose top-level name,
    the part before the first dot compared whole, is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
