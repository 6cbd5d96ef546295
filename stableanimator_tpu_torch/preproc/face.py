"""Face analysis: SCRFD detection, ArcFace identity embedding, face masks
(port of the JAX package's `preproc/face.py`).

Replaces the reference's insightface/facexlib dependency (reference
animation/modules/face_model.py:8-27, face_mask_extraction.py:10-38) with
the same ONNX models (antelopev2: scrfd_10g_bnkps + glintr100) run by the
port's ONNX -> torch executor on `device` (the card by default; every
class takes device="cpu" too), plus numpy pre- and post-processing, as in
the JAX package:

  * SCRFD anchor-free decode (strides 8/16/32, 2 anchors/cell,
    distance2bbox) + NMS — the standard insightface formulation,
  * 5-point similarity alignment (Umeyama) to the ArcFace 112x112 template,
  * face-mask extraction with the reference's fallback chain: detector
    boxes -> all-white mask.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stableanimator_tpu_torch.preproc.detection import nms_single_class
from stableanimator_tpu_torch.preproc.geometry import (
    fill_rect,
    invert_affine,
    resize_bilinear,
    warp_affine,
)
from stableanimator_tpu_torch.preproc.onnx_to_torch import load_onnx_function

# the canonical ArcFace 112x112 5-point template (insightface arcface_dst)
ARCFACE_DST = np.array(
    [[38.2946, 51.6963], [73.5318, 51.5014], [56.0252, 71.7366],
     [41.5493, 92.3655], [70.7299, 92.2041]], dtype=np.float32)


def umeyama_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity transform (rotation+scale+translation)
    mapping src -> dst; returns a 2x3 matrix. Umeyama (1991)."""
    src_mean = src.mean(0)
    dst_mean = dst.mean(0)
    src_c = src - src_mean
    dst_c = dst - dst_mean
    cov = dst_c.T @ src_c / src.shape[0]
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u) * np.linalg.det(vt))
    diag = np.diag([1.0, d])
    var_src = (src_c**2).sum() / src.shape[0]
    scale = np.trace(np.diag(s) @ diag) / var_src
    rot = u @ diag @ vt
    t = dst_mean - scale * rot @ src_mean
    m = np.zeros((2, 3), np.float64)
    m[:, :2] = scale * rot
    m[:, 2] = t
    return m


def norm_crop(img: np.ndarray, landmarks5: np.ndarray, size: int = 112) -> np.ndarray:
    """Align a face to the ArcFace template."""
    m = umeyama_similarity(landmarks5.astype(np.float64),
                           ARCFACE_DST * (size / 112.0))
    return warp_affine(img, m, (size, size), border_value=0.0)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _distance2bbox(points, distance):
    return np.stack([points[:, 0] - distance[:, 0],
                     points[:, 1] - distance[:, 1],
                     points[:, 0] + distance[:, 2],
                     points[:, 1] + distance[:, 3]], axis=-1)


def _distance2kps(points, distance):
    out = []
    for i in range(0, distance.shape[1], 2):
        out.append(points[:, 0] + distance[:, i])
        out.append(points[:, 1] + distance[:, i + 1])
    return np.stack(out, axis=-1).reshape(len(points), -1, 2)


class FaceDetector:
    """SCRFD with keypoints (e.g. antelopev2/scrfd_10g_bnkps.onnx)."""

    def __init__(self, onnx_path: str, input_size=(640, 640),
                 det_thresh: float = 0.5, nms_thresh: float = 0.4,
                 device: torch.device | str = "cuda"):
        self.input_size = input_size
        self.det_thresh = det_thresh
        self.nms_thresh = nms_thresh
        self._graph = load_onnx_function(onnx_path, device=device)
        self.strides = (8, 16, 32)
        self.num_anchors = 2

    @torch.no_grad()
    def _fn(self, blob_u8: np.ndarray):
        # uint8 in, (x-127.5)/128 normalised on the device (1/4 the transfer;
        # the face-mask CLI runs this per frame over whole datasets)
        x = torch.from_numpy(np.ascontiguousarray(blob_u8)).to(self._graph.device)
        return self._graph((x.float() - 127.5) / 128.0)

    def __call__(self, image_rgb: np.ndarray):
        """-> (boxes [N,5] xyxy+score, kps [N,5,2]) in image coordinates."""
        h0, w0 = image_rgb.shape[:2]
        in_h, in_w = self.input_size
        ratio = min(in_h / h0, in_w / w0)
        nh, nw = int(h0 * ratio), int(w0 * ratio)
        resized = resize_bilinear(image_rgb, (nw, nh))
        det_img = np.zeros((in_h, in_w, 3), np.uint8)
        det_img[:nh, :nw] = resized
        blob = det_img.transpose(2, 0, 1)  # CHW uint8; normalise on device

        outputs = [_numpy(o) for o in self._fn(blob[None])]
        fmc = len(self.strides)
        scores_list, bboxes_list, kps_list = [], [], []
        for idx, stride in enumerate(self.strides):
            scores = outputs[idx].reshape(-1)
            bbox_preds = outputs[idx + fmc].reshape(-1, 4) * stride
            kps_preds = outputs[idx + 2 * fmc].reshape(-1, 10) * stride
            hgt, wdt = in_h // stride, in_w // stride
            xv, yv = np.meshgrid(np.arange(wdt), np.arange(hgt))
            centers = np.stack([xv, yv], axis=-1).reshape(-1, 2).astype(np.float32) * stride
            centers = np.repeat(centers, self.num_anchors, axis=0)
            keep = scores >= self.det_thresh
            scores_list.append(scores[keep])
            bboxes_list.append(_distance2bbox(centers, bbox_preds)[keep])
            kps_list.append(_distance2kps(centers, kps_preds)[keep])

        scores = np.concatenate(scores_list)
        if scores.size == 0:
            return np.zeros((0, 5), np.float32), np.zeros((0, 5, 2), np.float32)
        boxes = np.concatenate(bboxes_list) / ratio
        kps = np.concatenate(kps_list) / ratio
        order = scores.argsort()[::-1]
        boxes, kps, scores = boxes[order], kps[order], scores[order]

        keep = nms_single_class(boxes, scores, self.nms_thresh)
        dets = np.concatenate([boxes[keep], scores[keep, None]], axis=1)
        return dets.astype(np.float32), kps[keep].astype(np.float32)


class ArcFaceEncoder:
    """glintr100 ArcFace recogniser -> 512-d identity embedding."""

    def __init__(self, onnx_path: str, size: int = 112, device: torch.device | str = "cuda"):
        self.size = size
        self._fn = torch.no_grad()(load_onnx_function(onnx_path, device=device))

    def __call__(self, image_rgb: np.ndarray, landmarks5: np.ndarray) -> np.ndarray:
        aligned = norm_crop(image_rgb, landmarks5, self.size)
        blob = ((aligned.astype(np.float32) - 127.5) / 127.5).transpose(2, 0, 1)
        return _numpy(self._fn(blob[None])[0])[0]


class FaceModel:
    """Detection + recognition bundle (reference face_model.py:8-27);
    largest-box selection as in reference inference_basic.py:530-535."""

    def __init__(self, det_onnx_path: str, rec_onnx_path: str,
                 device: torch.device | str = "cuda"):
        self.detector = FaceDetector(det_onnx_path, device=device)
        self.encoder = ArcFaceEncoder(rec_onnx_path, device=device)

    def get_id_embedding(self, image_rgb: np.ndarray) -> Optional[np.ndarray]:
        dets, kps = self.detector(image_rgb)
        if len(dets) == 0:
            return None
        areas = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])
        i = int(np.argmax(areas))
        return self.encoder(image_rgb, kps[i])


class FaceParser:
    """BiSeNet face parsing (the reference loads facexlib's bisenet model
    into FaceModel: reference face_model.py:19-26). Runs any bisenet.onnx
    through the ONNX -> torch executor; returns the per-pixel class map at 512x512.
    Classes follow the CelebAMask-HQ convention (0=bg, 1=skin, ...)."""

    def __init__(self, onnx_path: str, size: int = 512, device: torch.device | str = "cuda"):
        self.size = size
        self._fn = torch.no_grad()(load_onnx_function(onnx_path, device=device))

    def __call__(self, image_rgb: np.ndarray) -> np.ndarray:
        img = resize_bilinear(image_rgb, (self.size, self.size)).astype(np.float32)
        img = img / 255.0
        mean = np.array([0.485, 0.456, 0.406], np.float32)
        std = np.array([0.229, 0.224, 0.225], np.float32)
        blob = ((img - mean) / std).transpose(2, 0, 1)
        out = _numpy(self._fn(blob[None])[0])
        return out[0].argmax(0).astype(np.uint8)


class RetinaFaceDetector:
    """RetinaFace detector (the reference's facexlib middle tier:
    FaceRestoreHelper(det_model='retinaface_resnet50'),
    face_mask_extraction.py:27-31) through the ONNX -> torch executor.

    Standard RetinaFace decode (biubug6 formulation, which facexlib uses):
    priors over steps 8/16/32 with min_sizes [[16,32],[64,128],[256,512]],
    variances (0.1, 0.2); preprocess = BGR float minus (104,117,123).
    Runs letterboxed at a fixed input size instead of
    facexlib's native-resolution path; boxes are mapped back through the
    letterbox ratio.
    """

    STEPS = (8, 16, 32)
    MIN_SIZES = ((16, 32), (64, 128), (256, 512))
    VARIANCES = (0.1, 0.2)

    def __init__(self, onnx_path: str, input_size=(640, 640),
                 nms_thresh: float = 0.4, device: torch.device | str = "cuda"):
        self.input_size = input_size
        self.nms_thresh = nms_thresh
        self._fn = torch.no_grad()(load_onnx_function(onnx_path, device=device))
        self._priors = self._make_priors(*input_size)

    @classmethod
    def _make_priors(cls, in_h: int, in_w: int) -> np.ndarray:
        """[N, 4] normalised (cx, cy, w, h) anchors."""
        priors = []
        for step, sizes in zip(cls.STEPS, cls.MIN_SIZES):
            fh = -(-in_h // step)  # ceil
            fw = -(-in_w // step)
            for i in range(fh):
                for j in range(fw):
                    for m in sizes:
                        priors.append([(j + 0.5) * step / in_w,
                                       (i + 0.5) * step / in_h,
                                       m / in_w, m / in_h])
        return np.asarray(priors, np.float32)

    @classmethod
    def decode_boxes(cls, loc: np.ndarray, priors: np.ndarray) -> np.ndarray:
        """loc [N,4] regression -> [N,4] normalised xyxy."""
        v0, v1 = cls.VARIANCES
        cxy = priors[:, :2] + loc[:, :2] * v0 * priors[:, 2:]
        wh = priors[:, 2:] * np.exp(loc[:, 2:] * v1)
        return np.concatenate([cxy - wh / 2.0, cxy + wh / 2.0], axis=1)

    def __call__(self, image_rgb: np.ndarray, det_thresh: float = 0.97):
        """-> boxes [N, 5] (xyxy + score) in image coordinates."""
        h0, w0 = image_rgb.shape[:2]
        in_h, in_w = self.input_size
        ratio = min(in_h / h0, in_w / w0)
        nh, nw = int(h0 * ratio), int(w0 * ratio)
        resized = resize_bilinear(image_rgb, (nw, nh))
        canvas = np.zeros((in_h, in_w, 3), np.float32)
        canvas[:nh, :nw] = resized[..., ::-1]  # RGB -> BGR
        blob = (canvas - np.array([104.0, 117.0, 123.0], np.float32))
        blob = blob.transpose(2, 0, 1)

        outs = [_numpy(o) for o in self._fn(blob[None])]
        # outputs (biubug6 export order): loc [1,N,4], conf [1,N,2],
        # landms [1,N,10] — identify loc/conf by trailing dim for robustness
        by_dim = {o.shape[-1]: o[0] for o in outs}
        loc, conf = by_dim[4], by_dim[2]
        scores = conf[:, 1]
        keep = scores > det_thresh
        if not keep.any():
            return np.zeros((0, 5), np.float32)
        boxes = self.decode_boxes(loc[keep], self._priors[keep])
        boxes *= np.array([in_w, in_h, in_w, in_h], np.float32)
        boxes /= ratio
        scores = scores[keep]
        order = scores.argsort()[::-1]
        boxes, scores = boxes[order], scores[order]

        kept = nms_single_class(boxes, scores, self.nms_thresh)
        return np.concatenate([boxes[kept], scores[kept, None]],
                              axis=1).astype(np.float32)


def face_mask(image_rgb: np.ndarray, detector: Optional[FaceDetector],
              fallback_detector=None,
              fallback_thresh: float = 0.97) -> np.ndarray:
    """Binary face mask with the reference's full three-tier chain
    (face_mask_extraction.py:10-38): primary detector boxes -> RetinaFace
    fallback at threshold 0.97 -> all-255."""
    h, w = image_rgb.shape[:2]
    mask = np.zeros((h, w), np.uint8)
    dets = (detector(image_rgb)[0] if detector is not None
            else np.zeros((0, 5), np.float32))
    if len(dets) == 0 and fallback_detector is not None:
        dets = fallback_detector(image_rgb, fallback_thresh)
    if len(dets) == 0:
        mask[:] = 255
        return mask
    for box in dets:
        fill_rect(mask, (int(box[0]), int(box[1])),
                  (int(box[2]), int(box[3])), 255)
    return mask


def _bbox_aligned_crop(image_rgb: np.ndarray, bbox, input_size: int):
    """insightface-style bbox-centered similarity crop (model_zoo
    landmark/attribute preprocessing): scale = input_size / (1.5 * max side),
    rotation 0, face center mapped to the crop center. Returns the crop and
    the 2x3 forward transform (for mapping predictions back)."""
    w, h = bbox[2] - bbox[0], bbox[3] - bbox[1]
    center = ((bbox[0] + bbox[2]) / 2.0, (bbox[1] + bbox[3]) / 2.0)
    scale = input_size / (max(w, h) * 1.5)
    mat = np.array([[scale, 0.0, input_size / 2.0 - center[0] * scale],
                    [0.0, scale, input_size / 2.0 - center[1] * scale]],
                   np.float64)
    crop = warp_affine(image_rgb, mat, (input_size, input_size))
    return crop, mat


def _invert_affine(mat: np.ndarray) -> np.ndarray:
    return invert_affine(mat)


class LandmarkModel:
    """antelopev2 landmark heads (2d106det: 106 2-d points; 1k3d68: 68 3-d
    points) through the ONNX -> torch executor — the reference loads these via
    insightface FaceAnalysis('antelopev2') (reference face_model.py:12-16).
    Decode follows insightface model_zoo/landmark.py: predictions in
    [-1, 1] crop space -> pixel coords via the inverse crop transform."""

    def __init__(self, onnx_path: str, lmk_dim: int = 2, lmk_num: int = 106,
                 input_size: int = 192, device: torch.device | str = "cuda"):
        self.lmk_dim = lmk_dim
        self.lmk_num = lmk_num
        self.input_size = input_size
        self._fn = torch.no_grad()(load_onnx_function(onnx_path, device=device))

    def __call__(self, image_rgb: np.ndarray, bbox) -> np.ndarray:
        size = self.input_size
        crop, mat = _bbox_aligned_crop(image_rgb, bbox, size)
        blob = crop.astype(np.float32).transpose(2, 0, 1)
        pred = np.array(_numpy(self._fn(blob[None])[0]))[0].reshape(-1, self.lmk_dim)
        if pred.shape[0] > self.lmk_num:
            pred = pred[-self.lmk_num:]
        pred[:, :2] = (pred[:, :2] + 1.0) * (size // 2)
        if self.lmk_dim == 3:
            pred[:, 2] *= size // 2
        inv = _invert_affine(mat)
        pts = np.concatenate([pred[:, :2], np.ones((pred.shape[0], 1))], 1)
        pred[:, :2] = pts @ inv.T
        if self.lmk_dim == 3:
            # insightface trans_points3d also scales z back to image space
            # by the inverse transform's scale factor
            pred[:, 2] *= float(np.sqrt(inv[0, 0] ** 2 + inv[0, 1] ** 2))
        return pred


class GenderAgeModel:
    """antelopev2 genderage head: [1, 3] = (female, male, age/100)
    (insightface model_zoo/attribute.py decode)."""

    def __init__(self, onnx_path: str, input_size: int = 96, device: torch.device | str = "cuda"):
        self.input_size = input_size
        self._fn = torch.no_grad()(load_onnx_function(onnx_path, device=device))

    def __call__(self, image_rgb: np.ndarray, bbox):
        crop, _ = _bbox_aligned_crop(image_rgb, bbox, self.input_size)
        blob = crop.astype(np.float32).transpose(2, 0, 1)
        pred = _numpy(self._fn(blob[None])[0])[0]
        return int(np.argmax(pred[:2])), int(round(float(pred[2]) * 100))


class FaceAnalyzer:
    """Full FaceAnalysis('antelopev2') equivalent (reference
    face_model.py:12-16): detection + every auxiliary model found in the
    antelopev2 directory. Returns per-face dicts with bbox/kps/embedding
    and, when the onnx files exist, landmark_2d_106 / landmark_3d_68 /
    (gender, age)."""

    def __init__(self, antelopev2_dir: str, device: torch.device | str = "cuda"):
        import os

        p = lambda n: os.path.join(antelopev2_dir, n)
        self.detector = FaceDetector(p("scrfd_10g_bnkps.onnx"), device=device)
        self.encoder = (ArcFaceEncoder(p("glintr100.onnx"), device=device)
                        if os.path.exists(p("glintr100.onnx")) else None)
        self.lmk2d = (LandmarkModel(p("2d106det.onnx"), lmk_dim=2, lmk_num=106, device=device)
                      if os.path.exists(p("2d106det.onnx")) else None)
        self.lmk3d = (LandmarkModel(p("1k3d68.onnx"), lmk_dim=3, lmk_num=68, device=device)
                      if os.path.exists(p("1k3d68.onnx")) else None)
        self.genderage = (GenderAgeModel(p("genderage.onnx"), device=device)
                          if os.path.exists(p("genderage.onnx")) else None)

    def __call__(self, image_rgb: np.ndarray):
        dets, kps = self.detector(image_rgb)
        faces = []
        for i in range(len(dets)):
            face = {"bbox": dets[i, :4], "det_score": float(dets[i, 4]),
                    "kps": kps[i]}
            if self.encoder is not None:
                face["embedding"] = self.encoder(image_rgb, kps[i])
            if self.lmk2d is not None:
                face["landmark_2d_106"] = self.lmk2d(image_rgb, dets[i, :4])
            if self.lmk3d is not None:
                face["landmark_3d_68"] = self.lmk3d(image_rgb, dets[i, :4])
            if self.genderage is not None:
                face["gender"], face["age"] = self.genderage(image_rgb,
                                                             dets[i, :4])
            faces.append(face)
        return faces
