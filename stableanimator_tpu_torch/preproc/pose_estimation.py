"""RTMPose 133-keypoint wholebody estimation, DWPose stage 2 (port of the JAX
package's `preproc/pose_estimation.py`).

Re-expresses reference DWPose/dwpose_utils/onnxpose.py: per-box top-down
affine crop to the model's input size, ImageNet normalisation, SimCC argmax
decode, and rescale back to image coordinates. The network runs through the
port's ONNX -> torch executor on `device`, batched over person crops; the
affine geometry stays host-side.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from stableanimator_tpu_torch.preproc.geometry import get_affine_transform, warp_affine
from stableanimator_tpu_torch.preproc.onnx_to_torch import load_onnx_function

_MEAN = np.array([123.675, 116.28, 103.53])
_STD = np.array([58.395, 57.12, 57.375])


def bbox_xyxy2cs(bbox: np.ndarray, padding: float = 1.25):
    """(x1,y1,x2,y2) -> center, scale*padding (reference onnxpose.py:115-146)."""
    x1, y1, x2, y2 = bbox[:4]
    center = np.array([(x1 + x2) * 0.5, (y1 + y2) * 0.5])
    scale = np.array([(x2 - x1) * padding, (y2 - y1) * padding])
    return center, scale


def fix_aspect_ratio(scale: np.ndarray, aspect_ratio: float) -> np.ndarray:
    w, h = scale
    if w > h * aspect_ratio:
        return np.array([w, w / aspect_ratio])
    return np.array([h * aspect_ratio, h])


def _rotate_point(pt, angle_rad):
    sn, cs = np.sin(angle_rad), np.cos(angle_rad)
    return np.array([[cs, -sn], [sn, cs]]) @ pt


def _third_point(a, b):
    d = a - b
    return b + np.array([-d[1], d[0]])


def get_warp_matrix(center, scale, rot, output_size):
    """mmpose top-down affine (reference onnxpose.py:201-252)."""
    src_w = scale[0]
    dst_w, dst_h = output_size
    rot_rad = np.deg2rad(rot)
    src_dir = _rotate_point(np.array([0.0, src_w * -0.5]), rot_rad)
    dst_dir = np.array([0.0, dst_w * -0.5])
    src = np.zeros((3, 2), np.float32)
    src[0] = center
    src[1] = center + src_dir
    src[2] = _third_point(src[0], src[1])
    dst = np.zeros((3, 2), np.float32)
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = dst[0] + dst_dir
    dst[2] = _third_point(dst[0], dst[1])
    return get_affine_transform(src, dst)


def top_down_affine(input_size, scale, center, img):
    w, h = input_size
    scale = fix_aspect_ratio(scale, aspect_ratio=w / h)
    mat = get_warp_matrix(center, scale, 0, (w, h))
    crop = warp_affine(img, mat, (int(w), int(h)))
    return crop, scale


def simcc_decode(simcc_x: np.ndarray, simcc_y: np.ndarray, split_ratio: float = 2.0):
    """SimCC argmax decode (reference onnxpose.py:288-350)."""
    n, k, _ = simcc_x.shape
    sx = simcc_x.reshape(n * k, -1)
    sy = simcc_y.reshape(n * k, -1)
    locs = np.stack([sx.argmax(1), sy.argmax(1)], axis=-1).astype(np.float32)
    vals = np.minimum(sx.max(1), sy.max(1))
    locs[vals <= 0.0] = -1
    return locs.reshape(n, k, 2) / split_ratio, vals.reshape(n, k)


def graph_input_size(graph) -> Tuple[int, int]:
    """(w, h) of an image model's declared [N, 3, H, W] input, as the
    reference reads it (DWPose onnxpose.py inference_pose:
    session.get_inputs()[0].shape[2:]); raises where it is not static."""
    _, shape = graph.inputs[0]
    if not shape or len(shape) != 4 or not all(isinstance(d, int) and d > 0
                                               for d in shape[2:]):
        raise ValueError(f"the pose model's input {graph.inputs[0]} has no static H x W: "
                         "pass input_size=(w, h)")
    return int(shape[3]), int(shape[2])


class PoseEstimator:
    """inference_pose equivalent (reference onnxpose.py:353-359), batched: the
    reference runs the network once per person crop in a Python loop; here
    every crop, within a frame or across a whole clip, goes through one
    network call per chunk of MAX_CROP_BATCH.

    input_size (w, h) defaults to the graph's declared input (384x288 h x w
    for dw-ll_ucoco_384.onnx, whose SimCC head takes no other size)."""

    #: largest single network call; bigger crop sets run as sequential chunks
    MAX_CROP_BATCH = 256

    def __init__(self, onnx_path: str, input_size: Optional[Tuple[int, int]] = None,
                 device: torch.device | str = "cuda"):
        self._graph = load_onnx_function(onnx_path, device=device)
        self.input_size = (tuple(input_size) if input_size is not None
                           else graph_input_size(self._graph.graph))
        dev = self._graph.device
        self._mean = torch.tensor(_MEAN.reshape(3, 1, 1), dtype=torch.float32, device=dev)
        self._std = torch.tensor(_STD.reshape(3, 1, 1), dtype=torch.float32, device=dev)

    def _prep(self, image_rgb: np.ndarray, bboxes: np.ndarray):
        """Host-side geometry: affine person crops (CHW uint8)."""
        h_img, w_img = image_rgb.shape[:2]
        if len(bboxes) == 0:
            bboxes = np.array([[0, 0, w_img, h_img]], np.float32)
        crops, centers, scales = [], [], []
        for bbox in bboxes:
            center, scale = bbox_xyxy2cs(np.asarray(bbox, np.float64), padding=1.25)
            crop, scale = top_down_affine(self.input_size, scale, center, image_rgb)
            crops.append(np.ascontiguousarray(crop.astype(np.uint8).transpose(2, 0, 1)))
            centers.append(center)
            scales.append(scale)
        return crops, centers, scales

    @torch.no_grad()
    def _fn(self, batch_u8: np.ndarray):
        """[N, 3, h, w] uint8 crops -> (simcc_x, simcc_y) numpy; the ImageNet
        normalise runs on the device in fp32 (1/4 the transfer)."""
        x = torch.from_numpy(batch_u8).to(self._graph.device)
        simcc_x, simcc_y = self._graph((x.float() - self._mean) / self._std)
        return simcc_x.cpu().numpy(), simcc_y.cpu().numpy()

    def _run_crops(self, crops):
        """Network call(s) over a list of crops -> (simcc_x, simcc_y), in
        chunks of at most MAX_CROP_BATCH (no power-of-two padding: it only
        served XLA's compile cache)."""
        xs, ys = [], []
        for s in range(0, len(crops), self.MAX_CROP_BATCH):
            x, y = self._fn(np.stack(crops[s:s + self.MAX_CROP_BATCH]))
            xs.append(x)
            ys.append(y)
        return np.concatenate(xs), np.concatenate(ys)

    def _decode(self, simcc_x, simcc_y, centers, scales):
        kpts, vals = simcc_decode(simcc_x, simcc_y)
        out_k, out_s = [], []
        for i, (center, scale) in enumerate(zip(centers, scales)):
            out_k.append(kpts[i] / np.asarray(self.input_size) * scale + center - scale / 2)
            out_s.append(vals[i])
        return np.asarray(out_k), np.asarray(out_s)

    def __call__(self, image_rgb: np.ndarray, bboxes: np.ndarray):
        crops, centers, scales = self._prep(image_rgb, bboxes)
        simcc_x, simcc_y = self._run_crops(crops)
        return self._decode(simcc_x, simcc_y, centers, scales)

    def batch_call(self, images_rgb, bboxes_per_image):
        """Clip-level batching: all person crops from all frames through one
        network call per chunk. Returns [(keypoints, scores)] per frame."""
        all_crops, all_centers, all_scales, counts = [], [], [], []
        for img, boxes in zip(images_rgb, bboxes_per_image):
            crops, centers, scales = self._prep(img, boxes)
            all_crops += crops
            all_centers += centers
            all_scales += scales
            counts.append(len(crops))
        simcc_x, simcc_y = self._run_crops(all_crops)
        out, pos = [], 0
        for c in counts:
            out.append(self._decode(simcc_x[pos:pos + c], simcc_y[pos:pos + c],
                                    all_centers[pos:pos + c], all_scales[pos:pos + c]))
            pos += c
        return out
