"""Image resampling with the reference's semantics (port of the JAX
package's `ops/resize.py`).

The conditioning image is resized for CLIP with a gaussian pre-blur
followed by bicubic interpolation with align_corners=True. The separable
resize is two small dense products with interpolation matrices computed on
the host in float64. Layout: channels-last [N, H, W, C].
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel, a=-0.75 (torch's bicubic)."""
    ax = np.abs(x)
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax**3 - (a + 3.0) * ax**2 + 1.0,
        np.where(ax < 2.0, a * ax**3 - 5.0 * a * ax**2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=64)
def _bicubic_weights_align_corners(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] float32 interpolation matrix, bicubic align_corners=True."""
    if out_size == 1:
        w = np.zeros((1, in_size), dtype=np.float32)
        w[0, 0] = 1.0
        return w
    scale = (in_size - 1) / (out_size - 1)
    coords = np.arange(out_size, dtype=np.float64) * scale
    i0 = np.floor(coords).astype(np.int64)
    t = coords - i0
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for tap in range(-1, 3):
        idx = np.clip(i0 + tap, 0, in_size - 1)
        np.add.at(mat, (np.arange(out_size), idx), _cubic_kernel(tap - t))
    return mat.astype(np.float32)


def resize_bicubic_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bicubic align-corners resize of [..., H, W, C] channels-last images."""
    h, w = x.shape[-3], x.shape[-2]
    wh = torch.from_numpy(_bicubic_weights_align_corners(h, out_h)).to(x.device)
    ww = torch.from_numpy(_bicubic_weights_align_corners(w, out_w)).to(x.device)
    x32 = x.float()
    x32 = torch.einsum("oh,...hwc->...owc", wh, x32)
    x32 = torch.einsum("ow,...hwc->...hoc", ww, x32)
    return x32.to(x.dtype)


def _gaussian_1d(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - size // 2
    if size % 2 == 0:
        x = x + 0.5
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _sepconv(x: torch.Tensor, kernel: torch.Tensor, dim: int) -> torch.Tensor:
    """1-D valid convolution along `dim` as a shifted-slice weighted sum, in
    the same tap order as the JAX version."""
    k = kernel.shape[0]
    out = x.shape[dim] - k + 1
    acc = x.narrow(dim, 0, out) * kernel[0]
    for i in range(1, k):
        acc = acc + x.narrow(dim, i, out) * kernel[i]
    return acc


def gaussian_blur(x: torch.Tensor, kernel_size: tuple[int, int],
                  sigma: tuple[float, float]) -> torch.Tensor:
    """Separable gaussian blur with reflect padding, [N, H, W, C]:
    x-pass then y-pass (kornia-style, as the reference)."""
    ky, kx = kernel_size
    gy = torch.from_numpy(_gaussian_1d(ky, sigma[0])).to(x.device)
    gx = torch.from_numpy(_gaussian_1d(kx, sigma[1])).to(x.device)
    x32 = x.float().permute(0, 3, 1, 2)                   # NCHW for F.pad
    pl_, pr = (kx - 1) // 2, (kx - 1) - (kx - 1) // 2
    x32 = _sepconv(F.pad(x32, (pl_, pr, 0, 0), mode="reflect"), gx, dim=3)
    pt, pb = (ky - 1) // 2, (ky - 1) - (ky - 1) // 2
    x32 = _sepconv(F.pad(x32, (0, 0, pt, pb), mode="reflect"), gy, dim=2)
    return x32.permute(0, 2, 3, 1).to(x.dtype)


def resize_antialias(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Gaussian blur + bicubic(align_corners=True) downscale of [N, H, W, C]
    in [-1, 1]: the CLIP-conditioning resize of the reference."""
    h, w = x.shape[1], x.shape[2]
    factors = (h / out_h, w / out_w)
    sigmas = (max((factors[0] - 1.0) / 2.0, 0.001), max((factors[1] - 1.0) / 2.0, 0.001))
    ks = (int(max(2.0 * 2 * sigmas[0], 3)), int(max(2.0 * 2 * sigmas[1], 3)))
    ks = (ks[0] + 1 if ks[0] % 2 == 0 else ks[0], ks[1] + 1 if ks[1] % 2 == 0 else ks[1])
    return resize_bicubic_align_corners(gaussian_blur(x, ks, sigmas), out_h, out_w)
