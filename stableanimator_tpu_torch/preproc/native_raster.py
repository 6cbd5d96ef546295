"""ctypes bindings for the C++ skeleton raster (`csrc/raster.cpp`, a copy of
the JAX package's `native/raster.cpp`); port of its
`preproc/native_raster.py`.

Byte-exact re-implementations of the OpenCV drawing primitives the reference
uses for skeleton rendering (DWPose/skeleton_extraction.py:16-100):
ellipse2Poly+fillConvexPoly, filled circle, thick line (LINE_8, shift 0),
and the canvas dimming.
The library is built with g++ on first use by `ops/build.py` into
`csrc/_build/` (keyed by a hash of the source and flags). A failed build or
load raises: the port has no other raster.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np

from stableanimator_tpu_torch.ops import build

LIBRARY = "raster"


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (first use only) and bind the raster library."""
    lib = ctypes.CDLL(str(build.build_kernel(LIBRARY)))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ci = ctypes.c_int
    lib.cv_fill_ellipse.argtypes = [u8p, ci, ci, ci, ci, ci, ci, ci, ci, ci, u8p]
    lib.cv_fill_circle.argtypes = [u8p, ci, ci, ci, ci, ci, ci, u8p]
    lib.cv_thick_line.argtypes = [u8p, ci, ci, ci, ci, ci, ci, ci, ci, u8p]
    lib.scale_canvas.argtypes = [u8p, ctypes.c_int64, ctypes.c_double]
    for fn in (lib.cv_fill_ellipse, lib.cv_fill_circle, lib.cv_thick_line, lib.scale_canvas):
        fn.restype = None
    return lib


def _canvas_args(canvas: np.ndarray):
    if not (canvas.dtype == np.uint8 and canvas.ndim == 3 and canvas.flags.c_contiguous):
        raise ValueError("the canvas must be a C-contiguous uint8 [H, W, C] array")
    h, w, c = canvas.shape
    return (canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), int(h), int(w), int(c))


def _color(color: Sequence[float], channels: int = 3):
    """OpenCV scalar -> uint8 raw color: saturate_cast (round-half-even,
    clamp) per channel. The caller keeps the returned array alive over the
    call."""
    vals = [int(np.clip(np.rint(float(v)), 0, 255)) for v in color]
    while len(vals) < channels:
        vals.append(0)
    return (ctypes.c_uint8 * channels)(*vals[:channels])


def fill_ellipse(canvas, center, axes, angle, color, delta: int = 1):
    """cv2.ellipse2Poly(center, axes, angle, 0, 360, delta) +
    cv2.fillConvexPoly, byte-exact."""
    args = _canvas_args(canvas)
    col = _color(color, args[3])
    load().cv_fill_ellipse(*args, int(center[0]), int(center[1]), int(axes[0]), int(axes[1]),
                           int(angle), int(delta), col)


def fill_circle(canvas, cx, cy, radius, color):
    args = _canvas_args(canvas)
    col = _color(color, args[3])
    load().cv_fill_circle(*args, int(cx), int(cy), int(radius), col)


def draw_line(canvas, x0, y0, x1, y1, thickness, color):
    args = _canvas_args(canvas)
    col = _color(color, args[3])
    load().cv_thick_line(*args, int(x0), int(y0), int(x1), int(y1), int(thickness), col)


def scale_canvas(canvas, factor: float):
    """canvas = (canvas * factor).astype(uint8), in place."""
    _canvas_args(canvas)
    flat = canvas.reshape(-1)
    load().scale_canvas(flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                        ctypes.c_int64(flat.size), ctypes.c_double(factor))
