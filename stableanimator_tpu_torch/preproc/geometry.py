"""A copy of the JAX package's `preproc/geometry.py` (numpy only).

First-party image geometry: bilinear resize, affine warp, affine solves,
filled rectangles — numpy re-implementations of the exact OpenCV fixed-point
algorithms (reference dep surface: SURVEY.md §2.3 "image IO/resize/
warpAffine"; call sites DWPose/dwpose_utils/onnxdet.py:85 letterbox resize,
onnxpose.py:283 warpAffine crop, face alignment).

Bit-exactness matters: resized pixels feed detection thresholds and
SimCC argmaxes, so "close enough" float resizes can flip discrete
decisions vs the reference stack. Both hot functions replicate OpenCV's
integer pipelines exactly (fuzz-asserted byte-identical in
tests/test_preproc.py; tests/test_torch_face.py holds this copy to it):

  * resize: INTER_LINEAR fixed-point — 11-bit coefficient scale, cvRound
    (round-half-to-even) on the coefficients, (sum + 2^21) >> 22 descale
    (OpenCV resize.cpp, INTER_RESIZE_COEF_BITS = 11).
  * warpAffine: inverse-map bilinear — 10-bit affine accumulator
    (AB_BITS), 5-bit coordinate fraction (INTER_BITS), per-corner weights
    (32-fy)(32-fx)·32 which are exact in the 15-bit remap scale
    (INTER_REMAP_COEF_BITS = 15; the weight table needs no normalisation
    because 32768/1024 = 32 is an integer), (sum + 2^14) >> 15 descale,
    constant border.

Host-side preprocessing only — the per-frame arrays are tiny next to the
diffusion graphs; numpy gather/madd is plenty (~1 ms for a 640^2 letterbox).
"""

from __future__ import annotations

import numpy as np

_RESIZE_BITS = 11                      # INTER_RESIZE_COEF_BITS
_RESIZE_SCALE = 1 << _RESIZE_BITS
_AB_BITS = 10                          # warpAffine accumulator bits
_AB_SCALE = 1 << _AB_BITS
_INTER_BITS = 5                        # coordinate fraction bits
_INTER_TAB = 1 << _INTER_BITS
_REMAP_BITS = 15                       # INTER_REMAP_COEF_BITS
_ROUND_DELTA = _AB_SCALE // _INTER_TAB // 2   # 16


def _rint_i(x):
    """cvRound: round half to even (IEEE rint), as int64."""
    return np.rint(x).astype(np.int64)


def _linear_coeffs(dst: int, src: int):
    """Per-output-pixel source index + fixed-point (1-f, f) coefficients,
    OpenCV edge semantics (clamp with f=0 at both borders)."""
    x = np.arange(dst, dtype=np.float64)
    # OpenCV computes the source coordinate in double but casts to FLOAT
    # before deriving the coefficients ((float)((dx+0.5)*scale - 0.5));
    # the f32 cast shifts cvRound by one 1/2048 step on some columns, so
    # byte-exactness requires replicating it
    fx = ((x + 0.5) * (src / dst) - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx).astype(np.float32)
    # border semantics: clamp the sample INDICES but keep the split
    # fractional coefficients — at a clamped row both samples read the same
    # line, so mathematically (1-f)+f == 1, BUT the uchar vertical descale
    # rounds each term separately, making the split observable (cv2 5.0
    # keeps the split; zeroing f reproduces +1 on border rows)
    sx1 = np.clip(sx + 1, 0, src - 1)
    sx = np.clip(sx, 0, src - 1)
    a0 = _rint_i((np.float32(1.0) - fx) * np.float32(_RESIZE_SCALE))
    a1 = _rint_i(fx * np.float32(_RESIZE_SCALE))
    return sx, sx1, a0, a1


def resize_bilinear(img: np.ndarray, dsize) -> np.ndarray:
    """cv2.resize(img, dsize, interpolation=INTER_LINEAR) for uint8 images,
    byte-identical. dsize = (width, height) (OpenCV argument order).
    [H, W] or [H, W, C]."""
    w2, h2 = int(dsize[0]), int(dsize[1])
    assert img.dtype == np.uint8, "uint8 path (all call sites); see tests"
    h, w = img.shape[:2]
    if (w2, h2) == (w, h):
        return img.copy()
    sx, sx1, ax0, ax1 = _linear_coeffs(w2, w)
    sy, sy1, ay0, ay1 = _linear_coeffs(h2, h)
    chan = img.reshape(h, w, -1).astype(np.int64)
    horiz = chan[:, sx] * ax0[None, :, None] + chan[:, sx1] * ax1[None, :, None]
    # OpenCV's uchar VResizeLinear rounds each term separately:
    #   dst = (((b0*(S0>>4)) >> 16) + ((b1*(S1>>4)) >> 16) + 2) >> 2
    # (resize.cpp, the uchar/int/short specialisation) — NOT one combined
    # (sum + 2^21) >> 22; replicating it is what makes this byte-identical
    t0 = (ay0[:, None, None] * (horiz[sy] >> 4)) >> 16
    t1 = (ay1[:, None, None] * (horiz[sy1] >> 4)) >> 16
    out = np.clip((t0 + t1 + 2) >> 2, 0, 255).astype(np.uint8)
    return out.reshape((h2, w2) + img.shape[2:])


def invert_affine(m: np.ndarray) -> np.ndarray:
    """cv2.invertAffineTransform: closed-form 2x3 inverse (float64)."""
    m = np.asarray(m, np.float64)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a00 = m[1, 1] * d
    a01 = -m[0, 1] * d
    a10 = -m[1, 0] * d
    a11 = m[0, 0] * d
    b0 = -a00 * m[0, 2] - a01 * m[1, 2]
    b1 = -a10 * m[0, 2] - a11 * m[1, 2]
    return np.array([[a00, a01, b0], [a10, a11, b1]], np.float64)


def get_affine_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """cv2.getAffineTransform: the 2x3 map sending three src points to
    three dst points (float64 solve)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    a = np.zeros((6, 6), np.float64)
    b = np.zeros((6,), np.float64)
    for i in range(3):
        a[i, :2] = src[i]
        a[i, 2] = 1.0
        a[i + 3, 3:5] = src[i]
        a[i + 3, 5] = 1.0
        b[i] = dst[i, 0]
        b[i + 3] = dst[i, 1]
    x = np.linalg.solve(a, b)
    return x.reshape(2, 3)


def warp_affine(src: np.ndarray, m: np.ndarray, dsize,
                border_value: float = 0.0, inverse_map: bool = False
                ) -> np.ndarray:
    """cv2.warpAffine(src, m, dsize, flags=INTER_LINEAR,
    borderMode=BORDER_CONSTANT, borderValue=border_value).

    OpenCV 5's rewritten warp engine computes float32 inverse-map
    coordinates and interpolates in float (probed empirically: the classic
    4.x fixed-point pipeline — 1/32-quantised coordinates + 15-bit weight
    table — differs from cv2 5.0 output by up to +-5, while this float32
    path matches except off-by-one at exact rounding boundaries:
    <0.03% of pixels in fuzz, asserted in tests/test_preproc.py). The +-1
    residue is below the quantisation the downstream consumers apply
    (RTMPose crop normalisation, face-alignment crops).
    dsize = (width, height)."""
    w2, h2 = int(dsize[0]), int(dsize[1])
    m = np.asarray(m, np.float64)
    if not inverse_map:
        m = invert_affine(m)
    mi = m.astype(np.float32)
    xs = np.arange(w2, dtype=np.float32)
    ys = np.arange(h2, dtype=np.float32)
    gx = (mi[0, 0] * xs[None, :] + (mi[0, 1] * ys[:, None] + mi[0, 2]))
    gy = (mi[1, 0] * xs[None, :] + (mi[1, 1] * ys[:, None] + mi[1, 2]))
    sx = np.floor(gx).astype(np.int64)
    sy = np.floor(gy).astype(np.int64)
    fx = (gx - sx).astype(np.float32)[..., None]
    fy = (gy - sy).astype(np.float32)[..., None]

    h, w = src.shape[:2]
    chan = src.reshape(h, w, -1)
    c = chan.shape[2]

    def sample(iy, ix):
        """Constant-border gather."""
        inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        flat = np.where(inside, iy * w + ix, 0).ravel()
        vals = chan.reshape(-1, c)[flat].reshape(h2, w2, c)
        return np.where(inside[..., None], vals.astype(np.float32),
                        np.float32(border_value))

    p00 = sample(sy, sx)
    p01 = sample(sy, sx + 1)
    p10 = sample(sy + 1, sx)
    p11 = sample(sy + 1, sx + 1)
    out = ((1 - fy) * ((1 - fx) * p00 + fx * p01)
           + fy * ((1 - fx) * p10 + fx * p11))
    if src.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    else:
        out = out.astype(src.dtype)
    return out.reshape((h2, w2) + src.shape[2:])


def fill_rect(img: np.ndarray, pt1, pt2, value) -> None:
    """cv2.rectangle(..., thickness=FILLED): inclusive corners, clipped;
    in-place."""
    h, w = img.shape[:2]
    x1, y1 = int(pt1[0]), int(pt1[1])
    x2, y2 = int(pt2[0]), int(pt2[1])
    x1, x2 = min(x1, x2), max(x1, x2)
    y1, y2 = min(y1, y2), max(y1, y2)
    x1, y1 = max(x1, 0), max(y1, 0)
    x2, y2 = min(x2, w - 1), min(y2, h - 1)
    if x2 < x1 or y2 < y1:
        return
    img[y1:y2 + 1, x1:x2 + 1] = value
