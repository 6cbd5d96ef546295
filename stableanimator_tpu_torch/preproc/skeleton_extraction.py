"""High-level skeleton extraction (port of the JAX package's
`preproc/skeleton_extraction.py`; reference DWPose/skeleton_extraction.py
get_video_pose:137-178 / get_image_pose:181-187, array-level API; file
walking lives in cli/)."""

from __future__ import annotations

from typing import List

import numpy as np

from stableanimator_tpu_torch.preproc.skeleton_render import align_to_reference, draw_pose
from stableanimator_tpu_torch.preproc.wholebody import WholebodyDetector


def get_image_pose(detector: WholebodyDetector, ref_image_rgb: np.ndarray) -> np.ndarray:
    """Pose rendering of a single image -> RGB CHW uint8."""
    h, w = ref_image_rgb.shape[:2]
    return draw_pose(detector(ref_image_rgb), h, w)


def get_video_pose(detector: WholebodyDetector, frames_rgb: List[np.ndarray],
                   ref_image_rgb: np.ndarray) -> np.ndarray:
    """Detect per-frame skeletons, align them to the reference body shape,
    render -> [F, 3, H, W] uint8 (H, W of the reference image). Raises
    ValueError when no frame has exactly one body to fit the alignment on."""
    h, w = ref_image_rgb.shape[:2]
    ref_pose = detector(ref_image_rgb)
    # batched clip path (detector calls over all frames + pose calls over all
    # crops); per-frame for detectors without one
    if hasattr(detector, "video_poses"):
        detected = detector.video_poses(list(frames_rgb))
    else:
        detected = [detector(f) for f in frames_rgb]
    detected = align_to_reference(detected, ref_pose, h, w)
    return np.stack([draw_pose(p, h, w) for p in detected])


def render_training_pose(detector: WholebodyDetector, image_rgb: np.ndarray) -> np.ndarray:
    """Training-path rendering: no reference alignment (reference
    DWPose/training_skeleton_extraction.py:117-123)."""
    return get_image_pose(detector, image_rgb)
