"""YOLOX-L person detection, DWPose stage 1 (port of the JAX package's
`preproc/detection.py`).

Re-expresses reference DWPose/dwpose_utils/onnxdet.py: letterbox preprocess,
grid decode over strides (8, 16, 32), class-aware NMS, person-class filter.
The network runs through the port's ONNX -> torch executor from the original
yolox_l.onnx on `device` (the card unless the caller asks for the CPU);
geometry stays host-side numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from stableanimator_tpu_torch.preproc.geometry import resize_bilinear
from stableanimator_tpu_torch.preproc.onnx_to_torch import load_onnx_function


def letterbox(img: np.ndarray, input_size=(640, 640)):
    """Resize keeping aspect ratio, pad with 114 (reference onnxdet.py:80-96).
    Returns (CHW uint8 image, ratio): the fp32 cast happens on the device
    (YOLOX consumes raw 0-255 pixel values; the cast is value-exact)."""
    padded = np.full((input_size[0], input_size[1], 3), 114, dtype=np.uint8)
    r = min(input_size[0] / img.shape[0], input_size[1] / img.shape[1])
    resized = resize_bilinear(img, (int(img.shape[1] * r), int(img.shape[0] * r)))
    padded[: int(img.shape[0] * r), : int(img.shape[1] * r)] = resized
    return padded.transpose(2, 0, 1), r


def decode_outputs(outputs: np.ndarray, img_size=(640, 640)) -> np.ndarray:
    """YOLOX grid decode: xy = (pred + grid) * stride, wh = exp(pred) * stride
    (reference onnxdet.py:58-78)."""
    grids, strides_full = [], []
    for stride in (8, 16, 32):
        hs, ws = img_size[0] // stride, img_size[1] // stride
        xv, yv = np.meshgrid(np.arange(ws), np.arange(hs))
        grid = np.stack((xv, yv), 2).reshape(1, -1, 2)
        grids.append(grid)
        strides_full.append(np.full((1, grid.shape[1], 1), stride))
    grids = np.concatenate(grids, 1)
    strides_full = np.concatenate(strides_full, 1)
    outputs = outputs.copy()
    outputs[..., :2] = (outputs[..., :2] + grids) * strides_full
    outputs[..., 2:4] = np.exp(outputs[..., 2:4]) * strides_full
    return outputs


def nms_single_class(boxes: np.ndarray, scores: np.ndarray, thr: float):
    """Greedy NMS (reference onnxdet.py:6-33; +1 area convention preserved)."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0.0, xx2 - xx1 + 1) * np.maximum(0.0, yy2 - yy1 + 1)
        iou = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[np.where(iou <= thr)[0] + 1]
    return keep


def multiclass_nms(boxes, scores, nms_thr, score_thr):
    """Class-aware NMS (reference onnxdet.py:35-56)."""
    final = []
    for cls in range(scores.shape[1]):
        cls_scores = scores[:, cls]
        mask = cls_scores > score_thr
        if not mask.any():
            continue
        keep = nms_single_class(boxes[mask], cls_scores[mask], nms_thr)
        if keep:
            dets = np.concatenate(
                [boxes[mask][keep], cls_scores[mask][keep, None],
                 np.full((len(keep), 1), cls)], axis=1)
            final.append(dets)
    return np.concatenate(final, 0) if final else None


class PersonDetector:
    """inference_detector equivalent (reference onnxdet.py:98-125), plus a
    batched-over-frames path the reference's serial per-frame loop lacks: one
    network call per chunk of MAX_FRAME_BATCH frames."""

    #: Per-frame person cap: every surviving box becomes a pose crop, so an
    #: untrained or degenerate detector emitting hundreds of spurious boxes
    #: would inflate the crop batch. Real workloads are 1-few people.
    MAX_PERSONS_PER_FRAME = 10

    #: Upper bound on frames per network call (64 frames are 315 MB of fp32
    #: input at 640x640, plus YOLOX's activations).
    MAX_FRAME_BATCH = 64

    def __init__(self, onnx_path: str, input_size=(640, 640),
                 device: torch.device | str = "cuda"):
        self.input_size = input_size
        self._graph = load_onnx_function(onnx_path, device=device)

    @torch.no_grad()
    def _fn(self, batch_u8: np.ndarray) -> np.ndarray:
        """[N, 3, H, W] uint8 -> the network's [N, A, 85] output; uint8 to the
        device, fp32 cast there (1/4 the transfer)."""
        x = torch.from_numpy(np.ascontiguousarray(batch_u8)).to(self._graph.device)
        return self._graph(x.float())[0].cpu().numpy()

    def _postprocess(self, raw_one: np.ndarray, ratio: float, nms_thr: float, score_thr: float,
                     final_thr: float, max_det: int | None = None) -> np.ndarray:
        preds = decode_outputs(raw_one[None], self.input_size)[0]
        boxes = preds[:, :4]
        scores = preds[:, 4:5] * preds[:, 5:]
        xyxy = np.empty_like(boxes)
        xyxy[:, 0] = boxes[:, 0] - boxes[:, 2] / 2
        xyxy[:, 1] = boxes[:, 1] - boxes[:, 3] / 2
        xyxy[:, 2] = boxes[:, 0] + boxes[:, 2] / 2
        xyxy[:, 3] = boxes[:, 1] + boxes[:, 3] / 2
        xyxy /= ratio
        dets = multiclass_nms(xyxy, scores, nms_thr=nms_thr, score_thr=score_thr)
        if dets is None:
            return np.zeros((0, 4), np.float32)
        keep = (dets[:, 4] > final_thr) & (dets[:, 5] == 0)  # person class
        dets = dets[keep]
        cap = self.MAX_PERSONS_PER_FRAME if max_det is None else max_det
        if len(dets) > cap:  # keep the most confident persons only
            dets = dets[np.argsort(dets[:, 4])[::-1][:cap]]
        return dets[:, :4]

    def __call__(self, image_rgb: np.ndarray, nms_thr=0.45, score_thr=0.1, final_thr=0.3,
                 max_det: int | None = None) -> np.ndarray:
        img, ratio = letterbox(image_rgb, self.input_size)
        raw = self._fn(img[None])
        return self._postprocess(raw[0], ratio, nms_thr, score_thr, final_thr, max_det)

    def detect_batch(self, frames_rgb, nms_thr=0.45, score_thr=0.1, final_thr=0.3,
                     max_det: int | None = None):
        """All frames of a clip through batched network calls (chunks of at
        most MAX_FRAME_BATCH; no power-of-two padding: it only served XLA's
        compile cache, and the results do not depend on it). Letterbox + NMS
        stay host-side; returns a list of [N_i, 4] person boxes per frame."""
        out = []
        for start in range(0, len(frames_rgb), self.MAX_FRAME_BATCH):
            chunk = frames_rgb[start:start + self.MAX_FRAME_BATCH]
            prepped = [letterbox(f, self.input_size) for f in chunk]
            raw = self._fn(np.stack([p[0] for p in prepped]))
            out.extend(self._postprocess(raw[i], prepped[i][1], nms_thr, score_thr, final_thr,
                                         max_det)
                       for i in range(len(chunk)))
        return out
