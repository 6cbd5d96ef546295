"""Anchor-conditioned temporal tiling (port of the JAX package's
`diffusion/tiling.py`; numpy only, the same tables).

The reference denoises videos longer than `tile_size` frames in overlapping
windows whose first frame is always replaced by the global frame 0 (the
anchor), blending window outputs with triangular weights and count
normalisation (reference inference_pipeline_animation.py:613-616, 654-689).

The windows depend only on num_frames / tile_size / tile_overlap, so the
whole tile set becomes one extra batch dimension of a single UNet call, and
the overlap-blend is a scatter-add.
"""

from __future__ import annotations

import numpy as np


def tile_indices(num_frames: int, tile_size: int, tile_overlap: int) -> np.ndarray:
    """Static window index sets, [n_tiles, tile_size] int32.

    Mirrors reference inference_pipeline_animation.py:613-616: windows of
    `tile_size` at stride `tile_size - tile_overlap`, frame 0 as the anchor
    replacing each window's first frame, plus a tail window if needed.
    """
    if num_frames < tile_size:
        raise ValueError(f"num_frames ({num_frames}) < tile_size ({tile_size})")
    idx = [
        [0, *range(i + 1, min(i + tile_size, num_frames))]
        for i in range(0, num_frames - tile_size + 1, tile_size - tile_overlap)
    ]
    if idx[-1][-1] < num_frames - 1:
        idx.append([0, *range(num_frames - tile_size + 1, num_frames)])
    return np.asarray(idx, dtype=np.int32)


def auto_tile_batch(num_frames: int, tile_size: int,
                    tile_overlap: int) -> int | None:
    """Default `PipelineConfig.max_tile_batch` policy.

    Short videos (<= 4 tiles, i.e. up to ~52 frames at 16/4) keep every
    tile in one UNet call (None); longer ones denoise in groups of at most 2
    tiles per call, chosen so that no padded duplicate tile is computed.
    """
    if num_frames <= tile_size:
        return None
    n_tiles = tile_indices(num_frames, tile_size, tile_overlap).shape[0]
    if n_tiles <= 4:
        return None
    return 2 if n_tiles % 2 == 0 else 1


def tile_blend_weight(tile_size: int) -> np.ndarray:
    """Triangular blend weights, [tile_size] float32.

    w_k = min(w, 2 - w) with w = (k + 0.5) * 2 / tile_size
    (reference inference_pipeline_animation.py:656-657)."""
    w = (np.arange(tile_size, dtype=np.float32) + 0.5) * 2.0 / tile_size
    return np.minimum(w, 2.0 - w)
