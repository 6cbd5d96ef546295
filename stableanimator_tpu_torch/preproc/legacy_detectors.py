"""Legacy ControlNet-lineage DWPose wrappers (port of the JAX package's
`preproc/legacy_detectors.py`; reference DWPose/dwpose_utils/__init__.py:33-120
+ util.py): the unaligned detector variants kept for API completeness. Not
on the main animation path (the aligned detector in wholebody.py +
skeleton_render.py is), but provided so users of the reference's
`DWposeDetector` / `DWposeDetectorOnlyOnePerson` find the same capabilities.

Differences from the aligned path: keypoints below the 0.3 confidence
threshold are marked invisible (-1) and skipped, rendering happens at the
image's own resolution without the hi-res canvas, and limbs/points use
full-intensity colors (no confidence alpha). Drawn with the C++ raster
(`native_raster.py`), byte-identical to the JAX package's OpenCV drawing.
"""

from __future__ import annotations

import colorsys
import math
from typing import Optional

import numpy as np
import torch

from stableanimator_tpu_torch.preproc import native_raster as nr
from stableanimator_tpu_torch.preproc.skeleton_render import BODY_COLORS, HAND_EDGES, LIMB_SEQ
from stableanimator_tpu_torch.preproc.wholebody import WholebodyDetector

EPS = 0.01


def _draw_bodypose_legacy(canvas, candidate, subset):
    h, w = canvas.shape[:2]
    for i in range(17):
        for n in range(len(subset)):
            index = subset[n][np.array(LIMB_SEQ[i]) - 1]
            if -1 in index:
                continue
            y = candidate[index.astype(int), 0] * float(w)
            x = candidate[index.astype(int), 1] * float(h)
            mx, my = np.mean(x), np.mean(y)
            length = ((x[0] - x[1]) ** 2 + (y[0] - y[1]) ** 2) ** 0.5
            angle = math.degrees(math.atan2(x[0] - x[1], y[0] - y[1]))
            nr.fill_ellipse(canvas, (int(my), int(mx)), (int(length / 2), 4), int(angle),
                            BODY_COLORS[i])
    nr.scale_canvas(canvas, 0.6)
    for i in range(18):
        for n in range(len(subset)):
            index = int(subset[n][i])
            if index == -1:
                continue
            x, y = candidate[index][0:2]
            nr.fill_circle(canvas, int(x * w), int(y * h), 4, BODY_COLORS[i])
    return canvas


def _draw_handpose_legacy(canvas, all_hand_peaks):
    h, w = canvas.shape[:2]
    for peaks in all_hand_peaks:
        for ie, e in enumerate(HAND_EDGES):
            x1, y1 = peaks[e[0]]
            x2, y2 = peaks[e[1]]
            if min(x1, y1, x2, y2) > EPS:
                rgb = np.array(colorsys.hsv_to_rgb(ie / len(HAND_EDGES), 1.0, 1.0))
                nr.draw_line(canvas, int(x1 * w), int(y1 * h), int(x2 * w), int(y2 * h), 2,
                             rgb * 255)
        for kpt in peaks:
            x, y = kpt
            if x > EPS and y > EPS:
                nr.fill_circle(canvas, int(x * w), int(y * h), 4, (0, 0, 255))
    return canvas


def _draw_facepose_legacy(canvas, all_lmks):
    h, w = canvas.shape[:2]
    for lmks in all_lmks:
        for lmk in lmks:
            x, y = lmk
            if x > EPS and y > EPS:
                nr.fill_circle(canvas, int(x * w), int(y * h), 3, (255, 255, 255))
    return canvas


class DWposeDetector:
    """Unaligned detector returning a rendered pose map (reference
    dwpose_utils/__init__.py:33-71); the networks run on `device`."""

    only_one_person = False

    def __init__(self, det_onnx_path: str, pose_onnx_path: str,
                 detector: Optional[WholebodyDetector] = None,
                 device: torch.device | str = "cuda"):
        self.wholebody = detector or WholebodyDetector(det_onnx_path, pose_onnx_path,
                                                       device=device)

    def __call__(self, image_rgb: np.ndarray, remain_face: bool = True) -> np.ndarray:
        h, w = image_rgb.shape[:2]
        candidate, score = self.wholebody.keypoints(image_rgb)
        if self.only_one_person and len(candidate) > 1:
            candidate, score = candidate[:1], score[:1]
        nums, _, locs = candidate.shape
        candidate = candidate.astype(np.float64)
        candidate[..., 0] /= float(w)
        candidate[..., 1] /= float(h)
        body = candidate[:, :18].copy().reshape(nums * 18, locs)
        subset = score[:, :18].copy()
        for i in range(len(subset)):
            for j in range(len(subset[i])):
                subset[i][j] = int(18 * i + j) if subset[i][j] > 0.3 else -1
        if not self.only_one_person:
            candidate[score < 0.3] = -1
        faces = candidate[:, 24:92]
        hands = np.vstack([candidate[:, 92:113], candidate[:, 113:]])

        canvas = np.zeros((h, w, 3), np.uint8)
        canvas = _draw_bodypose_legacy(canvas, body, subset)
        canvas = _draw_handpose_legacy(canvas, hands)
        if remain_face:
            canvas = _draw_facepose_legacy(canvas, faces)
        return canvas


class DWposeDetectorOnlyOnePerson(DWposeDetector):
    """Single-person variant (reference dwpose_utils/__init__.py:75-120)."""

    only_one_person = True


def hand_detect(candidate: np.ndarray, subset: np.ndarray, image_shape) -> list:
    """OpenPose-heuristic hand boxes from body keypoints (re-expression of
    reference DWPose/dwpose_utils/util.py:155 handDetect; the heuristic is
    openpose's handDetector.cpp). candidate: [M, 2] absolute pixel coords,
    subset: [N, 18] keypoint indices (-1 = invisible).

    Returns [[x, y, width, is_left], ...] with (x, y) the top-left of a
    square crop; boxes narrower than 20 px are dropped.
    """
    img_h, img_w = image_shape[:2]
    ratio_wrist_elbow = 0.33
    out = []
    for person in np.asarray(subset).astype(int):
        # (shoulder, elbow, wrist) triplets: left = 5,6,7; right = 2,3,4
        for idx, is_left in (((5, 6, 7), True), ((2, 3, 4), False)):
            if np.any(person[list(idx)] == -1):
                continue
            shoulder, elbow, wrist = (candidate[person[i]][:2] for i in idx)
            center = wrist + ratio_wrist_elbow * (wrist - elbow)
            d_we = float(np.hypot(*(wrist - elbow)))
            d_es = float(np.hypot(*(elbow - shoulder)))
            width = 1.5 * max(d_we, 0.9 * d_es)
            x = max(center[0] - width / 2, 0.0)
            y = max(center[1] - width / 2, 0.0)
            width = min(width,
                        img_w - x if x + width > img_w else width,
                        img_h - y if y + width > img_h else width)
            if width >= 20:
                out.append([int(x), int(y), int(width), is_left])
    return out


def face_detect(candidate: np.ndarray, subset: np.ndarray, image_shape) -> list:
    """Face boxes from nose/eyes/ears geometry (re-expression of reference
    DWPose/dwpose_utils/util.py:221 faceDetect). Square half-width = the
    largest of 3x the nose-eye chebyshev distance and 1.5x the nose-ear
    distance. Returns [[x, y, width], ...] (top-left, square)."""
    img_h, img_w = image_shape[:2]
    out = []
    for person in np.asarray(subset).astype(int):
        if person[0] == -1:  # nose
            continue
        parts = {14: 3.0, 15: 3.0, 16: 1.5, 17: 1.5}  # eyes x3, ears x1.5
        visible = [(i, f) for i, f in parts.items() if person[i] > -1]
        if not visible:
            continue
        nose = candidate[person[0]][:2]
        width = 0.0
        for i, factor in visible:
            p = candidate[person[i]][:2]
            width = max(width, float(np.abs(nose - p).max()) * factor)
        x = max(nose[0] - width, 0.0)
        y = max(nose[1] - width, 0.0)
        w = min(width * 2,
                img_w - x if x + width > img_w else width * 2,
                img_h - y if y + width > img_h else width * 2)
        if w >= 20:
            out.append([int(x), int(y), int(w)])
    return out
