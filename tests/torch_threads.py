"""Torch's intra-op threads for the port's tests.

pytest-xdist runs the suite in several worker processes at once, and each
of them would otherwise start torch with a thread per core: on small
shapes the pools then spend their time waiting for each other. Every
`tests/test_torch_*.py` file calls `share_cores` at import, so that the
workers split the machine's cores between them. JAX-free.
"""

from __future__ import annotations

import os

import torch


def share_cores() -> int:
    """Set torch's intra-op threads to this process's share of the cores
    (all of them outside xdist) and return that count."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, (os.cpu_count() or 1) // workers)
    torch.set_num_threads(n)
    return n
