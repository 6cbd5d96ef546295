"""Skeleton-extraction CLI (port of the JAX package's `cli/extract_skeleton.py`;
reference DWPose/skeleton_extraction.py:189-205).

Detects DWPose skeletons on a reference image and every target frame,
aligns the target skeletons to the reference body shape, and writes
OpenPose-style renderings as frame_{i}.png. The networks run on --device
(cuda by default).

    python -m stableanimator_tpu_torch.cli.extract_skeleton \\
        --target_image_folder_path frames --ref_image_path ref.png \\
        --poses_folder_path poses --dwpose_dir checkpoints/DWPose
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Skeleton extraction from images.")
    p.add_argument("--target_image_folder_path", type=str, required=True)
    p.add_argument("--ref_image_path", type=str, required=True)
    p.add_argument("--poses_folder_path", type=str, required=True)
    p.add_argument("--dwpose_dir", type=str, default="checkpoints/DWPose",
                   help="directory with yolox_l.onnx and dw-ll_ucoco_384.onnx")
    p.add_argument("--max_persons", type=int, default=None,
                   help="per-frame person cap (default 10; the reference "
                        "keeps every box — raise for crowd frames)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    """Run the CLI; returns the number of poses written."""
    args = parse_args(argv)
    from stableanimator_tpu_torch.pipeline.animation import resolve_device
    from stableanimator_tpu_torch.preproc.skeleton_extraction import get_video_pose
    from stableanimator_tpu_torch.preproc.wholebody import WholebodyDetector
    from stableanimator_tpu_torch.utils.image import (
        _frame_sort_key,
        read_image_rgb,
        write_image_bgr_convention,
    )

    detector = WholebodyDetector(os.path.join(args.dwpose_dir, "yolox_l.onnx"),
                                 os.path.join(args.dwpose_dir, "dw-ll_ucoco_384.onnx"),
                                 max_det=args.max_persons, device=resolve_device(args.device))
    ref = read_image_rgb(args.ref_image_path)
    files = sorted((f for f in os.listdir(args.target_image_folder_path) if f.endswith(".png")),
                   key=_frame_sort_key)
    frames = [read_image_rgb(os.path.join(args.target_image_folder_path, f)) for f in files]

    maps = get_video_pose(detector, frames, ref)  # [F, 3, H, W]
    os.makedirs(args.poses_folder_path, exist_ok=True)
    for i in range(maps.shape[0]):
        path = os.path.join(args.poses_folder_path, f"frame_{i}.png")
        write_image_bgr_convention(path, np.transpose(maps[i], (1, 2, 0)))
        print(f"save the pose image in {path}")
    return int(maps.shape[0])


if __name__ == "__main__":
    main()
