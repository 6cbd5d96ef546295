"""OpenPose-style skeleton rasterisation + reference-shape alignment (port of
the JAX package's `preproc/skeleton_render.py`).

Re-expresses reference DWPose/skeleton_extraction.py:
  * draw_bodypose (:16-59): limbs as filled ellipses with the 18-colour
    palette and confidence alpha, canvas dimmed x0.6, keypoint circles,
  * draw_handpose (:61-88): HSV-coloured hand edges + blue fingertips,
  * draw_facepose (:90-100): white confidence dots,
  * draw_pose (:102-135): hi-res canvas (ref_w=2160-normalised) then resize,
  * align_to_reference (:137-178): least-squares y-fit -> per-axis affine
    that maps driving-video skeletons onto the reference body shape.

Rasterisation runs on the C++ raster (`csrc/raster.cpp` through
`native_raster.py`), byte-identical to the reference's OpenCV drawing; the
port has no cv2 path.
"""

from __future__ import annotations

import colorsys
import math
from typing import Dict, List, Sequence

import numpy as np

from stableanimator_tpu_torch.preproc import native_raster as nr
from stableanimator_tpu_torch.preproc.geometry import resize_bilinear

EPS = 0.01

LIMB_SEQ = [[2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
            [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
            [1, 16], [16, 18], [3, 17], [6, 18]]

BODY_COLORS = [[255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0],
               [170, 255, 0], [85, 255, 0], [0, 255, 0], [0, 255, 85],
               [0, 255, 170], [0, 255, 255], [0, 170, 255], [0, 85, 255],
               [0, 0, 255], [85, 0, 255], [170, 0, 255], [255, 0, 255],
               [255, 0, 170], [255, 0, 85]]

HAND_EDGES = [[0, 1], [1, 2], [2, 3], [3, 4], [0, 5], [5, 6], [6, 7], [7, 8],
              [0, 9], [9, 10], [10, 11], [11, 12], [0, 13], [13, 14], [14, 15],
              [15, 16], [0, 17], [17, 18], [18, 19], [19, 20]]


def _blend(color: Sequence[int], alpha: float) -> List[int]:
    return [int(c * alpha) for c in color]


def draw_bodypose(canvas, candidate, subset, score):
    """Limbs and joints onto `canvas` (uint8 HWC, drawn in place)."""
    h, w = canvas.shape[:2]
    candidate = np.asarray(candidate)
    subset = np.asarray(subset)
    for i in range(17):
        for n in range(len(subset)):
            index = subset[n][np.array(LIMB_SEQ[i]) - 1]
            conf = score[n][np.array(LIMB_SEQ[i]) - 1]
            if conf[0] < 0.3 or conf[1] < 0.3:
                continue
            y = candidate[index.astype(int), 0] * float(w)
            x = candidate[index.astype(int), 1] * float(h)
            mx, my = np.mean(x), np.mean(y)
            length = ((x[0] - x[1]) ** 2 + (y[0] - y[1]) ** 2) ** 0.5
            angle = math.degrees(math.atan2(x[0] - x[1], y[0] - y[1]))
            nr.fill_ellipse(canvas, (int(my), int(mx)), (int(length / 2), 4), int(angle),
                            _blend(BODY_COLORS[i], conf[0] * conf[1]))
    nr.scale_canvas(canvas, 0.6)
    for i in range(18):
        for n in range(len(subset)):
            index = int(subset[n][i])
            if index == -1:
                continue
            x, y = candidate[index][0:2]
            nr.fill_circle(canvas, int(x * w), int(y * h), 4, _blend(BODY_COLORS[i], score[n][i]))
    return canvas


def draw_handpose(canvas, all_hand_peaks, all_hand_scores):
    h, w = canvas.shape[:2]
    n_edges = len(HAND_EDGES)
    for peaks, scores in zip(all_hand_peaks, all_hand_scores):
        for ie, e in enumerate(HAND_EDGES):
            x1, y1 = int(peaks[e[0]][0] * w), int(peaks[e[0]][1] * h)
            x2, y2 = int(peaks[e[1]][0] * w), int(peaks[e[1]][1] * h)
            s = int(scores[e[0]] * scores[e[1]] * 255)
            if x1 > EPS and y1 > EPS and x2 > EPS and y2 > EPS:
                rgb = np.array(colorsys.hsv_to_rgb(ie / float(n_edges), 1.0, 1.0))
                nr.draw_line(canvas, x1, y1, x2, y2, 2, rgb * s)
        for i, kpt in enumerate(peaks):
            x, y = int(kpt[0] * w), int(kpt[1] * h)
            s = int(scores[i] * 255)
            if x > EPS and y > EPS:
                nr.fill_circle(canvas, x, y, 4, (0, 0, s))
    return canvas


def draw_facepose(canvas, all_lmks, all_scores):
    h, w = canvas.shape[:2]
    for lmks, scores in zip(all_lmks, all_scores):
        for lmk, score in zip(lmks, scores):
            x, y = int(lmk[0] * w), int(lmk[1] * h)
            conf = int(score * 255)
            if x > EPS and y > EPS:
                nr.fill_circle(canvas, x, y, 3, (conf, conf, conf))
    return canvas


def draw_pose(pose: Dict, height: int, width: int, ref_w: int = 2160) -> np.ndarray:
    """Render a pose dict to an RGB CHW uint8 image (reference :102-135): the
    skeleton on a canvas whose short side is `ref_w`, then resized to
    height x width (bilinear, byte-identical to cv2.INTER_LINEAR) and
    BGR -> RGB."""
    bodies = pose["bodies"]
    sz = min(height, width)
    sr = (ref_w / sz) if sz != ref_w else 1
    canvas = np.zeros((int(height * sr), int(width * sr), 3), np.uint8)
    draw_bodypose(canvas, bodies["candidate"], bodies["subset"], score=bodies["score"])
    draw_handpose(canvas, pose["hands"], pose["hands_score"])
    draw_facepose(canvas, pose["faces"], pose["faces_score"])
    resized = resize_bilinear(canvas, (width, height))
    return resized[..., ::-1].transpose(2, 0, 1)


REF_KEYPOINT_IDS = [0, 1, 2, 5, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17]


def align_to_reference(detected_poses: List[Dict], ref_pose: Dict,
                       height: int, width: int) -> List[Dict]:
    """Affine-align driving skeletons onto the reference body shape
    (reference :137-178): least-squares fit of target y-coords to the
    reference y-coords gives (ay, by); ax follows from the aspect ratio and
    bx from the mean x offset. Applied in place to bodies/faces/hands.
    Raises ValueError when no pose has exactly one body (18 joints)."""
    ref_ids = [i for i in REF_KEYPOINT_IDS
               if len(ref_pose["bodies"]["subset"]) > 0
               and ref_pose["bodies"]["subset"][0][i] >= 0.0]
    ref_body = ref_pose["bodies"]["candidate"][ref_ids]

    detected_bodies = np.stack(
        [p["bodies"]["candidate"] for p in detected_poses
         if p["bodies"]["candidate"].shape[0] == 18])[:, ref_ids]
    ay, by = np.polyfit(detected_bodies[:, :, 1].flatten(),
                        np.tile(ref_body[:, 1], len(detected_bodies)), 1)
    ax = ay / (height / width / height * width)
    bx = np.mean(np.tile(ref_body[:, 0], len(detected_bodies))
                 - detected_bodies[:, :, 0].flatten() * ax)
    a = np.array([ax, ay])
    b = np.array([bx, by])
    for pose in detected_poses:
        pose["bodies"]["candidate"] = pose["bodies"]["candidate"] * a + b
        pose["faces"] = pose["faces"] * a + b
        pose["hands"] = pose["hands"] * a + b
    return detected_poses
