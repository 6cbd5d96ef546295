"""Face-mask extraction CLI (port of the JAX package's
`cli/extract_face_masks.py`; reference face_mask_extraction.py:41-85).

Walks an image folder and writes binary face masks to a sibling `faces/`
folder (idempotent: existing masks are skipped). Masks weight the facial
region in the training loss (reference README.md:259). The detectors run on
--device (cuda by default).

    python -m stableanimator_tpu_torch.cli.extract_face_masks --image_folder data/00001/images
"""

from __future__ import annotations

import argparse
import os

from stableanimator_tpu_torch.utils.image import read_image_rgb, write_image_gray


def parse_args(argv=None):
    p = argparse.ArgumentParser("Human Face Mask Extraction", add_help=True)
    p.add_argument("--image_folder", type=str, required=True)
    p.add_argument("--scrfd_onnx", type=str,
                   default="checkpoints/antelopev2/scrfd_10g_bnkps.onnx")
    p.add_argument("--retinaface_onnx", type=str,
                   default="checkpoints/retinaface_resnet50.onnx",
                   help="middle-tier fallback detector (reference "
                        "face_mask_extraction.py:27-31, thr 0.97)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from stableanimator_tpu_torch.pipeline.animation import resolve_device
    from stableanimator_tpu_torch.preproc.face import FaceDetector, RetinaFaceDetector, face_mask

    device = resolve_device(args.device)
    detector = (FaceDetector(args.scrfd_onnx, device=device)
                if os.path.exists(args.scrfd_onnx) else None)
    if detector is None:
        print(f"WARNING: {args.scrfd_onnx} missing; masks fall back to all-white")
    fallback = (RetinaFaceDetector(args.retinaface_onnx, device=device)
                if os.path.exists(args.retinaface_onnx) else None)
    if fallback is None:
        print(f"note: {args.retinaface_onnx} missing; RetinaFace fallback "
              f"tier disabled (detector miss -> all-white directly)")

    out_dir = os.path.join(os.path.dirname(args.image_folder.rstrip("/")), "faces")
    os.makedirs(out_dir, exist_ok=True)
    for root, _, files in os.walk(args.image_folder):
        for file in sorted(files):
            if not file.endswith(".png"):
                continue
            save_path = os.path.join(out_dir, file)
            if os.path.exists(save_path):
                print(f"{save_path} already exists!")
                continue
            img = read_image_rgb(os.path.join(root, file))
            write_image_gray(save_path, face_mask(img, detector, fallback_detector=fallback))
            print(f"Finish face Extraction: {save_path}")


if __name__ == "__main__":
    main()
