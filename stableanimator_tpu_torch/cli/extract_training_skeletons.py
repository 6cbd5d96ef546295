"""Training-path skeleton extraction (port of the JAX package's
`cli/extract_training_skeletons.py`; reference
DWPose/training_skeleton_extraction.py:126-167): walk dataset folders
`{root}/{name}/images` and write unaligned pose renderings to a sibling
`poses/` folder, skipping frames that already exist (idempotent). The
networks run on --device (cuda by default).

    python -m stableanimator_tpu_torch.cli.extract_training_skeletons \\
        --video_folder data --dwpose_dir checkpoints/DWPose
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Batch skeleton extraction for training data.")
    p.add_argument("--video_folder", type=str, required=True,
                   help="root containing {name}/images subfolders")
    p.add_argument("--dwpose_dir", type=str, default="checkpoints/DWPose")
    p.add_argument("--max_persons", type=int, default=None,
                   help="per-frame person cap (default 10; the reference "
                        "keeps every box — raise for crowd frames)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    """Run the CLI; returns the number of poses written (0 on a rerun)."""
    args = parse_args(argv)
    from stableanimator_tpu_torch.pipeline.animation import resolve_device
    from stableanimator_tpu_torch.preproc.skeleton_extraction import render_training_pose
    from stableanimator_tpu_torch.preproc.wholebody import WholebodyDetector
    from stableanimator_tpu_torch.utils.image import read_image_rgb, write_image_bgr_convention

    detector = WholebodyDetector(os.path.join(args.dwpose_dir, "yolox_l.onnx"),
                                 os.path.join(args.dwpose_dir, "dw-ll_ucoco_384.onnx"),
                                 max_det=args.max_persons, device=resolve_device(args.device))
    written = 0
    for name in sorted(os.listdir(args.video_folder)):
        images_dir = os.path.join(args.video_folder, name, "images")
        if not os.path.isdir(images_dir):
            continue
        poses_dir = os.path.join(args.video_folder, name, "poses")
        os.makedirs(poses_dir, exist_ok=True)
        for fname in sorted(os.listdir(images_dir)):
            if not fname.endswith(".png"):
                continue
            out_path = os.path.join(poses_dir, fname)
            if os.path.exists(out_path):
                continue
            pose_img = render_training_pose(detector,
                                            read_image_rgb(os.path.join(images_dir, fname)))
            # channel-swap write convention: the data contract the released
            # checkpoints were trained on (reference
            # training_skeleton_extraction.py:165-167); matches the
            # inference-path extractor (extract_skeleton.py)
            write_image_bgr_convention(out_path, np.transpose(pose_img, (1, 2, 0)))
            written += 1
            print(f"wrote {out_path}")
    return written


if __name__ == "__main__":
    main()
