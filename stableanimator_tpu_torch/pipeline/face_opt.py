"""HJB face optimisation: inference-time identity refinement (port of the
JAX package's `pipeline/face_opt.py`).

The StableAnimator paper (arXiv:2411.17697) describes a
Hamilton-Jacobi-Bellman-based face optimisation that the reference repo
never shipped (reference README.md:59). Treat denoising as an
optimal-control problem: the state is the predicted clean latent x0_hat,
the running cost is face-identity dissimilarity
c(x0) = 1 - cos(ArcFace(decode(x0)_face), e_ref), and the HJB-optimal
control for a quadratic control penalty is the negative value-function
gradient. Along the EDM probability-flow ODE this reduces to gradient
steps on x0_hat before the Euler update uses it:

    x0* = x0_hat - lr * d c(x0_hat) / d x0_hat        (n_steps times)
    x_{t-1} = x_t + (x_t - x0*) / sigma * (sigma_next - sigma)

The gradient is exact: the VAE temporal decoder and the recogniser (an
ONNX graph through the port's executor) are both torch, so autograd takes
d(similarity)/d(latents) through the real recogniser. Only a per-frame face
crop of the latent is decoded (the decoder is convolutional), which keeps
the inner loop cheap: at the default 16-latent crop the decoder's mid
attention sees 256 keys, below the flash kernel's cut-over, so autograd
differentiates the plain attention and no kernel launches.

`generate` runs under `torch.inference_mode()`; `refine` leaves it, enables
grad and clones x0_hat (an inference tensor) before differentiating, so
nothing on the plain path changes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from stableanimator_tpu_torch.ops.resize import resize_bicubic_align_corners


@dataclass(frozen=True)
class FaceOptConfig:
    """Inner-solver configuration."""

    steps: int = 0            # gradient steps per denoise step; 0 disables
    lr: float = 0.1
    start_step: int = 8       # first denoise step to optimise (face must
    end_step: int = 10_000    # have formed enough to carry identity)
    latent_crop: int = 16     # latent-space crop size (x8 pixels)
    arcface_size: int = 112


class FaceOptimizer:
    """Bundles the differentiable pieces the inner solver needs.

    arcface_fn: callable [N, 3, S, S] (pixels in [-1, 1]) -> [N, D]
                embeddings; typically an OnnxFunction of glintr100.
    decode_fn:  callable (latents [F, h, w, 4], num_frames) -> frames
                [F, H, W, 3] in [-1, 1]; the VAE decoder.
    target_embedding: [D] reference identity embedding (l2-normalised here).
    face_boxes: [F, 2] top-left (y, x) of each frame's face crop in latent
                coordinates, host-side ints.
    """

    def __init__(self, cfg: FaceOptConfig, arcface_fn: Callable, decode_fn: Callable,
                 target_embedding, face_boxes):
        self.cfg = cfg
        self.arcface_fn = arcface_fn
        self.decode_fn = decode_fn
        t = torch.as_tensor(target_embedding, dtype=torch.float32).reshape(-1)
        self.target = t / (torch.linalg.vector_norm(t) + 1e-8)
        self.face_boxes = np.asarray(face_boxes, np.int32)

    def with_boxes(self, face_boxes) -> "FaceOptimizer":
        """Copy with new per-frame face boxes, sharing cfg, callables and
        target (the boxes only exist after the poses are read)."""
        new = object.__new__(FaceOptimizer)
        new.cfg = self.cfg
        new.arcface_fn = self.arcface_fn
        new.decode_fn = self.decode_fn
        new.target = self.target
        new.face_boxes = np.asarray(face_boxes, np.int32)
        return new

    def identity_cost(self, x0_latents: torch.Tensor) -> torch.Tensor:
        """1 - mean cosine similarity over frames. x0_latents [1, F, h, w, 4]
        in the *scaled* latent space (x 0.18215)."""
        cfg = self.cfg
        lat = x0_latents[0]
        f, h, w, _ = lat.shape
        crop = cfg.latent_crop
        crops = []
        for frame, (y, x) in zip(lat, self.face_boxes):
            y = min(max(int(y), 0), h - crop)
            x = min(max(int(x), 0), w - crop)
            crops.append(frame[y:y + crop, x:x + crop])
        faces = self.decode_fn(torch.stack(crops), f)         # [F, 8c, 8c, 3]
        faces = faces.float().clamp(-1.0, 1.0)
        faces = resize_bicubic_align_corners(faces, cfg.arcface_size, cfg.arcface_size)
        emb = self.arcface_fn(faces.permute(0, 3, 1, 2))
        if isinstance(emb, (tuple, list)):
            emb = emb[0]
        emb = emb.float()
        emb = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-8)
        sim = (emb @ self.target.to(emb.device)).mean()
        return 1.0 - sim

    def refine(self, x0_latents: torch.Tensor, step_index: int) -> torch.Tensor:
        """HJB inner solver: `cfg.steps` gradient steps on x0_hat, at denoise
        steps in [start_step, end_step); other steps return x0_latents."""
        cfg = self.cfg
        if cfg.steps <= 0 or not cfg.start_step <= int(step_index) < cfg.end_step:
            return x0_latents
        with torch.inference_mode(False), torch.enable_grad():
            x = x0_latents.clone()
            for _ in range(cfg.steps):
                x = x.detach().requires_grad_(True)
                (grad,) = torch.autograd.grad(self.identity_cost(x), x)
                x = x - cfg.lr * grad
            return x.detach()


def face_boxes_from_pose_renders(pose_pixels, latent_h: int, latent_w: int,
                                 crop: int = 16) -> np.ndarray:
    """Per-frame latent face-crop top-lefts from *rendered* pose images
    [F, H, W, 3] in [-1, 1]. The face is the only element drawn pure white
    (the skeleton renderer draws (255,255,255) face dots; body limbs are
    hue-coded and dimmed x0.6, hands are HSV-coloured), so the white-pixel
    centroid locates the face. Host-side numpy."""
    arr = (pose_pixels.detach().cpu().numpy() if isinstance(pose_pixels, torch.Tensor)
           else np.asarray(pose_pixels))
    f, hh, ww, _ = arr.shape
    boxes = []
    for i in range(f):
        ys, xs = np.nonzero((arr[i] > 0.85).all(axis=-1))
        if len(ys) == 0:
            cy, cx = latent_h / 2.0, latent_w / 2.0
        else:
            cy = ys.mean() / hh * latent_h
            cx = xs.mean() / ww * latent_w
        y = int(np.clip(round(cy - crop / 2), 0, max(latent_h - crop, 0)))
        x = int(np.clip(round(cx - crop / 2), 0, max(latent_w - crop, 0)))
        boxes.append((y, x))
    return np.asarray(boxes, np.int32)


def make_face_optimizer(models, cfg: FaceOptConfig, arcface_fn, target_embedding,
                        pose_pixels, latent_h: int, latent_w: int,
                        channel_order: str = "reference",
                        num_frames: int | None = None) -> FaceOptimizer:
    """A FaceOptimizer from the real pipeline pieces.

    decode_fn wraps the models' temporal-VAE decoder and owns the latent
    scaling (x0 latents live in the x0.18215 space; the decoder expects the
    unscaled space, reference inference_pipeline_animation.py:326).
    arcface_fn is typically `load_onnx_function("glintr100.onnx")`, whose
    weights are on the device from its load on; with
    channel_order="reference" the decoded RGB faces are channel-flipped, so
    the embeddings live in the space of the reference identity embedding
    (cli/animate.py --face_channel_order). pose_pixels None gives centred
    placeholder boxes for `num_frames` frames (swap the real ones in with
    `with_boxes` once the poses are read)."""
    # the crop cannot exceed the latent plane (smoke runs at tiny resolutions)
    crop = min(cfg.latent_crop, latent_h, latent_w)
    if crop != cfg.latent_crop:
        cfg = dataclasses.replace(cfg, latent_crop=crop)
    scaling = models.vae.config.scaling_factor

    def decode_fn(crops, num_frames):
        return models.vae.decode(crops / scaling, num_frames=num_frames)

    def embed_fn(faces_nchw):
        if channel_order == "reference":
            faces_nchw = faces_nchw.flip(1)
        out = arcface_fn(faces_nchw)
        return out[0] if isinstance(out, (tuple, list)) else out

    if pose_pixels is None:
        y = max((latent_h - cfg.latent_crop) // 2, 0)
        x = max((latent_w - cfg.latent_crop) // 2, 0)
        boxes = np.broadcast_to(np.asarray((y, x), np.int32), (num_frames, 2)).copy()
    else:
        boxes = face_boxes_from_pose_renders(pose_pixels, latent_h, latent_w, cfg.latent_crop)
    return FaceOptimizer(cfg, embed_fn, decode_fn, target_embedding, boxes)


def face_boxes_from_pose(faces_keypoints, latent_h: int, latent_w: int,
                         crop: int = 16) -> np.ndarray:
    """Per-frame latent-space face-crop top-lefts from normalised DWPose
    face landmarks [F, 68, 2] (x, y in [0, 1]); host-side numpy."""
    boxes = []
    for lmks in np.asarray(faces_keypoints):
        valid = lmks[(lmks[:, 0] > 0.01) & (lmks[:, 1] > 0.01)]
        if len(valid) == 0:
            cy, cx = latent_h // 2, latent_w // 2
        else:
            cx = float(valid[:, 0].mean()) * latent_w
            cy = float(valid[:, 1].mean()) * latent_h
        y = int(np.clip(round(cy - crop / 2), 0, max(latent_h - crop, 0)))
        x = int(np.clip(round(cx - crop / 2), 0, max(latent_w - crop, 0)))
        boxes.append((y, x))
    return np.asarray(boxes, np.int32)
