"""Debug tracing and profiling (port of the JAX package's `core/trace.py`).

The reference's only observability is the `todos.debug` shape/stat dump
idiom scattered through its modules. This keeps that idiom as a flag-gated
tool and adds the profiler hook, here torch.profiler.

Usage:
    from stableanimator_tpu_torch.core import trace
    trace.enable()                      # or STABLEANIMATOR_TRACE=1
    trace.dump("latents", latents)      # shape/min/max/mean, the reference's
                                        # todos.debug.output_var line

    with trace.profile("denoise", logdir="/tmp/trace"):
        with trace.annotate("request"):
            frames = generate(...)      # writes a Chrome trace (chrome://tracing,
                                        # Perfetto) under logdir
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

_enabled = os.environ.get("STABLEANIMATOR_TRACE", "0") == "1"


def enable(value: bool = True):
    global _enabled
    _enabled = value


def enabled() -> bool:
    return _enabled


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _leaves(x) -> list:
    """The leaves of a nested container in jax.tree_util's order: a dict's
    values by sorted key, an OrderedDict's in its own order, lists and
    tuples in order, None holding none."""
    if x is None:
        return []
    if isinstance(x, collections.OrderedDict):
        items = list(x.values())
    elif isinstance(x, dict):
        items = [x[k] for k in sorted(x)]
    elif isinstance(x, (list, tuple)):
        items = list(x)
    else:
        return [x]
    return [leaf for item in items for leaf in _leaves(item)]


def dump(name: str, x, force: bool = False):
    """Shape/stat dump in the reference's trace format, e.g.
    `tensor [latents] size: [1, 16, 64, 64, 4], min: -6.613, max: 7.504,
    mean: -0.161`. Takes tensors, numpy arrays and nested containers of
    them (one line per leaf). Returns x."""
    if not (_enabled or force):
        return x

    def one(prefix, arr):
        try:
            a = _as_numpy(arr)
            print(f"tensor [{prefix}] size: {list(arr.shape)}, "
                  f"min: {a.min():.6f}, max: {a.max():.6f}, mean: {a.mean():.6f}")
        except Exception:
            print(f"[{prefix}] type: {type(arr)}")

    leaves = _leaves(x)
    if len(leaves) == 1:
        one(name, leaves[0])
    else:
        for i, leaf in enumerate(leaves):
            one(f"{name}.{i}", leaf)
    return x


@contextlib.contextmanager
def profile(name: str, logdir: Optional[str] = None):
    """torch.profiler around a block (the CPU, and the card when there is
    one) when `logdir` is given, its Chrome trace written to
    `<logdir>/<name>.json`; then the wall time printed. Yields the
    profiler (None without logdir)."""
    t0 = time.time()
    if logdir:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with torch_profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, f"{name}.json"))
    else:
        yield None
    print(f"[trace] {name}: {time.time() - t0:.3f}s"
          + (f" (profile in {logdir})" if logdir else ""))


@contextlib.contextmanager
def annotate(name: str):
    """A named region in the profiler's timeline (record_function), and an
    NVTX range on CUDA."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
