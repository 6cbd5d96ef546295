"""DWPose wholebody composition (port of the JAX package's
`preproc/wholebody.py`): detector + pose estimator + neck synthesis +
mmpose->openpose joint remap + normalised pose dict.

Re-expresses reference DWPose/dwpose_utils/wholebody.py:20-47 and
dwpose_detector.py:11-54.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from stableanimator_tpu_torch.preproc.detection import PersonDetector
from stableanimator_tpu_torch.preproc.pose_estimation import PoseEstimator

MMPOSE_IDX = [17, 6, 8, 10, 7, 9, 12, 14, 16, 13, 15, 2, 1, 4, 3]
OPENPOSE_IDX = [1, 2, 3, 4, 6, 7, 8, 9, 10, 12, 13, 14, 15, 16, 17]


class WholebodyDetector:
    def __init__(self, det_onnx_path: str, pose_onnx_path: str, max_det: int | None = None,
                 device: torch.device | str = "cuda"):
        """max_det: per-frame person cap (None -> PersonDetector.
        MAX_PERSONS_PER_FRAME = 10). The reference keeps every surviving box;
        raise this for crowd frames with >10 people. Both networks run on
        `device`."""
        self.detector = PersonDetector(det_onnx_path, device=device)
        self.pose = PoseEstimator(pose_onnx_path, device=device)
        self.max_det = max_det

    @staticmethod
    def _compose(kpts: np.ndarray, scores: np.ndarray):
        """Neck synthesis + mmpose->openpose remap (reference
        wholebody.py:26-31)."""
        info = np.concatenate([kpts, scores[..., None]], axis=-1)
        # synthetic neck = mean of shoulders, visible iff both visible
        neck = info[:, [5, 6]].mean(axis=1)
        neck[:, 2:] = np.logical_and(info[:, 5, 2:] > 0.3,
                                     info[:, 6, 2:] > 0.3).astype(info.dtype)
        info = np.insert(info, 17, neck, axis=1)
        info[:, OPENPOSE_IDX] = info[:, MMPOSE_IDX]
        return info[..., :2], info[..., 2]

    def keypoints(self, image_rgb: np.ndarray):
        """-> (keypoints [N, 134, 2] px coords, scores [N, 134])."""
        boxes = self.detector(image_rgb, max_det=self.max_det)
        kpts, scores = self.pose(image_rgb, boxes)
        return self._compose(kpts, scores)

    def video_poses(self, frames_rgb) -> list:
        """Batched clip path: detector calls over all frames + pose calls over
        all person crops (the reference loops both networks serially per
        frame / per crop, onnxpose.py:353-359). The same math as calling
        `self(frame)` per frame."""
        if len(frames_rgb) == 0:
            return []
        boxes_list = self.detector.detect_batch(frames_rgb, max_det=self.max_det)
        per_frame = self.pose.batch_call(frames_rgb, boxes_list)
        out = []
        for img, (kpts, scores) in zip(frames_rgb, per_frame):
            candidate, score = self._compose(kpts, scores)
            out.append(self._to_pose_dict(candidate, score, *img.shape[:2]))
        return out

    def __call__(self, image_rgb: np.ndarray) -> Dict:
        """Normalised pose dict (reference dwpose_detector.py:20-54)."""
        h, w = image_rgb.shape[:2]
        candidate, score = self.keypoints(image_rgb)
        return self._to_pose_dict(candidate, score, h, w)

    @staticmethod
    def _to_pose_dict(candidate: np.ndarray, score: np.ndarray, h: int, w: int) -> Dict:
        nums, _, locs = candidate.shape
        candidate = candidate.astype(np.float64)
        candidate[..., 0] /= float(w)
        candidate[..., 1] /= float(h)
        body = candidate[:, :18].copy().reshape(nums * 18, locs)
        subset = score[:, :18].copy()
        for i in range(len(subset)):
            for j in range(len(subset[i])):
                subset[i][j] = int(18 * i + j) if subset[i][j] > 0.3 else -1
        faces = candidate[:, 24:92]
        hands = np.vstack([candidate[:, 92:113], candidate[:, 113:]])
        faces_score = score[:, 24:92]
        hands_score = np.vstack([score[:, 92:113], score[:, 113:]])
        return dict(
            bodies=dict(candidate=body, subset=subset, score=score[:, :18]),
            hands=hands, hands_score=hands_score,
            faces=faces, faces_score=faces_score,
        )
