"""Host-side image/video IO (reference inference_basic.py:36-79): a copy of
the JAX package's `utils/image.py`, which uses no JAX."""

from __future__ import annotations

import os
import re
from typing import List

import numpy as np
from PIL import Image


def _frame_sort_key(name: str):
    """Sort frame_0.png, frame_10.png ... numerically; robust to other
    naming by falling back to the first integer in the name."""
    m = re.findall(r"\d+", name)
    return int(m[-1]) if m else name


def load_images_from_folder(folder: str, width: int, height: int) -> List[Image.Image]:
    files = sorted((f for f in os.listdir(folder) if f.endswith(".png")),
                   key=_frame_sort_key)
    return [Image.open(os.path.join(folder, f)).convert("RGB").resize((width, height))
            for f in files]


def pil_to_unit_array(img: Image.Image) -> np.ndarray:
    """PIL -> [1, H, W, 3] float32 in [0, 1]."""
    return np.asarray(img, np.float32)[None] / 255.0


def poses_to_array(images: List[Image.Image]) -> np.ndarray:
    """PIL pose frames -> [F, H, W, 3] float32 in [-1, 1]
    (reference inference_pipeline_animation.py:618-624)."""
    arr = np.stack([np.asarray(im, np.float32) for im in images])
    return arr / 127.5 - 1.0


def pil_to_u8_array(img: Image.Image) -> np.ndarray:
    """PIL -> [1, H, W, 3] uint8. pipeline.generate converts on device —
    ship this across the host->device boundary instead of
    pil_to_unit_array's fp32 (4x the bytes, same values)."""
    return np.asarray(img, np.uint8)[None]


def poses_to_u8_array(images: List[Image.Image]) -> np.ndarray:
    """PIL pose frames -> [F, H, W, 3] uint8 (device-side [-1,1] mapping
    in pipeline.generate; same values as poses_to_array)."""
    return np.stack([np.asarray(im, np.uint8) for im in images])


def frames_to_uint8(frames: np.ndarray) -> List[np.ndarray]:
    """[F, H, W, 3] float in [0,1] -> list of uint8 HWC arrays. uint8 input
    (from PipelineConfig.output_uint8 device-side conversion) passes
    through."""
    frames = np.asarray(frames)
    if frames.dtype == np.uint8:
        return list(frames)
    return [np.clip(f * 255.0 + 0.5, 0, 255).astype(np.uint8) for f in frames]


def export_to_gif(frames: List[np.ndarray], output_path: str, duration_ms: int = 125):
    pil = [Image.fromarray(f) for f in frames]
    if output_path.endswith(".mp4"):
        output_path = output_path.replace(".mp4", ".gif")
    pil[0].save(output_path, format="GIF", append_images=pil[1:],
                save_all=True, duration=duration_ms, loop=0)


def save_frames_as_png(frames: List[np.ndarray], output_dir: str):
    os.makedirs(output_dir, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(output_dir, f"frame_{i}.png"))


def export_to_mp4(frames: List[np.ndarray], output_path: str, fps: int = 8):
    """mp4 artifact (reference inference_basic.py:56-64 writes via OpenCV).
    cv2's mp4v encoder (inter-frame compression) when importable; otherwise
    the first-party MJPEG muxer (utils/mp4.py) — no hard cv2 dependency."""
    try:
        import cv2
    except ImportError:
        from stableanimator_tpu_torch.utils.mp4 import write_mp4_mjpeg

        write_mp4_mjpeg(frames, output_path, fps=fps)
        return
    h, w = frames[0].shape[:2]
    out = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        out.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    out.release()

def read_image_rgb(path: str) -> np.ndarray:
    """Image file -> HWC uint8 RGB (PIL; replaces cv2.imread + BGR2RGB)."""
    return np.asarray(Image.open(path).convert("RGB"), np.uint8)


def write_image_bgr_convention(path: str, hwc: np.ndarray) -> None:
    """Write pixels exactly as `cv2.imwrite(path, hwc)` would: cv2 treats
    the array as BGR, so the file stores the channel-reversed image. The
    skeleton extractors rely on this quirk as a data contract (reference
    training_skeleton_extraction.py:165-167); PIL writes RGB, hence the
    flip. Decoded pixels are byte-identical to the cv2 write."""
    Image.fromarray(np.ascontiguousarray(hwc[..., ::-1])).save(path)


def write_image_gray(path: str, gray: np.ndarray) -> None:
    """Write a single-channel uint8 image (replaces cv2.imwrite on 2-D)."""
    Image.fromarray(np.asarray(gray, np.uint8), mode="L").save(path)
