"""Ingest the released StableAnimator checkpoint tree into a `--checkpoint_dir`
for the port (port of the root `tools/ingest_checkpoints.py`), with torch,
numpy and the standard library only: no JAX and no `safetensors` package.

    python -m stableanimator_tpu_torch.tools.ingest_checkpoints \\
        --source checkpoints/ --output ckpt/ [--validate_image face.png --device cuda]

Stages:
  1. dump     each file of PLAN to `.npz` (`tools/dump_torch_checkpoint.py`;
              the first match of its glob in sorted order, so the SVD
              folders' `.fp16.safetensors` variants come first);
  2. check    each `.npz` against its model on the meta device
              (`convert/checkpoints.py::check_state_dict`): a key that
              names no parameter, a parameter the file lacks or a shape
              that differs is an error, before any weight is loaded. A
              vanilla SVD UNet (none of the ID adapter's
              `processor.id_to_{k,v}` keys) is checked
              with the adapter its cross-attention gives at load time
              (`--init_id_adapter`); a UNet with only some of those keys is
              refused;
  3. copy     the antelopev2 and DWPose ONNX files verbatim (the port's ONNX
              executor runs them);
  4. validate (with --validate_image) the port's CLIs in subprocesses on
              --device: `cli.extract_skeleton` renders the image's skeleton
              (the image as both frames of a 2-frame clip) with the copied
              DWPose files, `cli.animate` renders those 2 frames at 512x512
              and 25 steps from the ingested files (with --init_id_adapter
              when the UNet is vanilla), and the CSIM of the
              frames against the image comes from
              `tools/evaluate.py::csim`. A failed CLI fails the tool.

The report, printed as JSON and returned by `main`, reads `ok:<n>` (n the
tensors the file holds; for a vanilla UNet followed by `VANILLA_NOTE`) or
`missing` for each `.npz`, and the CSIM under "csim".

The root tool's validation calls `extract_skeleton` with a flag that CLI
does not take (`--ref_video_path`), ignores the exit, and copies the photo
as both pose frames; here the CLI is called with the flags it takes and a
failure is an error. The root tool's render never passes
`--init_id_adapter`, so its validation of a vanilla UNet fails in the JAX
UNet for want of the adapter's parameters (ROADMAP §3, "Standing
divergences").
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from stableanimator_tpu_torch import subprocess_env
from stableanimator_tpu_torch.convert.checkpoints import (
    CHECKPOINT_FILES,
    check_state_dict,
    npz_shapes,
)
from stableanimator_tpu_torch.tools import dump_torch_checkpoint

SVD_ROOT = "SVD/stable-video-diffusion-img2vid-xt"

# (source glob, output npz name, converter name)
PLAN = [
    ("Animation/unet.pth", "unet.npz", "convert_unet"),
    (f"{SVD_ROOT}/vae/diffusion_pytorch_model*.safetensors", "vae.npz",
     "convert_vae"),
    (f"{SVD_ROOT}/image_encoder/*.safetensors", "image_encoder.npz",
     "convert_clip_vision"),
    ("Animation/pose_net.pth", "pose_net.npz", "convert_pose_net"),
    ("Animation/face_encoder.pth", "face_encoder.npz",
     "convert_face_encoder"),
]

ONNX_COPY = [
    ("antelopev2/*.onnx", "antelopev2"),
    ("DWPose/*.onnx", "DWPose"),
]

# the port's model each output file loads into (the CLIs' loader's names)
MODEL_OF = {fname: name for name, fname in CHECKPOINT_FILES.items()}
# the validation render: the root tool's size, steps and frames
VALIDATE_HW, VALIDATE_STEPS, VALIDATE_FRAMES = 512, 25, 2
# the report's note on a UNet file without the ID adapter
VANILLA_NOTE = "vanilla SVD UNet: load with --init_id_adapter"


def main(argv=None, timings: dict | None = None) -> dict:
    """Run the tool; returns the report. `timings`, if given, receives the
    seconds of each stage (dump, check, copy, validate)."""
    ap = argparse.ArgumentParser(description="reference checkpoints -> the port's "
                                             "--checkpoint_dir")
    ap.add_argument("--source", required=True, help="reference checkpoints/ root")
    ap.add_argument("--output", required=True, help="output --checkpoint_dir for cli.animate")
    ap.add_argument("--validate_image", default=None,
                    help="a face image; renders a 2-frame clip from the ingested files and "
                         "reports its CSIM against the image")
    ap.add_argument("--device", default="cuda",
                    help="where the validation's CLIs and CSIM run (cuda unless cpu is asked for)")
    ap.add_argument("--model_scale", default="full", choices=["full", "micro"],
                    help="the models the files are checked against and the validation "
                         "renders with ('micro': the CLIs' depth-1 zoo, for tests)")
    args = ap.parse_args(argv)
    from stableanimator_tpu_torch.core.config import micro_model_kwargs
    from stableanimator_tpu_torch.pipeline.animation import meta_models

    os.makedirs(args.output, exist_ok=True)
    models = meta_models(**(micro_model_kwargs() if args.model_scale == "micro" else {}))
    seconds = dict.fromkeys(("dump", "check", "copy", "validate"), 0.0)
    report = {}
    vanilla = False
    for pattern, npz_name, _ in PLAN:
        matches = sorted(glob.glob(os.path.join(args.source, pattern)))
        out_path = os.path.join(args.output, npz_name)
        if not matches:
            print(f"MISSING {pattern} — skipped ({npz_name})")
            report[npz_name] = "missing"
            continue
        t0 = time.perf_counter()
        dump_torch_checkpoint.main(["--input", matches[0], "--output", out_path])
        t1 = time.perf_counter()
        name = MODEL_OF[npz_name]
        n, is_vanilla = check_state_dict(name, npz_shapes(out_path), getattr(models, name))
        vanilla |= is_vanilla
        seconds["check"] += time.perf_counter() - t1
        seconds["dump"] += t1 - t0
        print(f"  {name}: OK ({n} tensors, keys and shapes of the port's model"
              f"{'; ' + VANILLA_NOTE if is_vanilla else ''})")
        report[npz_name] = f"ok:{n}" + (f" ({VANILLA_NOTE})" if is_vanilla else "")

    t0 = time.perf_counter()
    for pattern, sub in ONNX_COPY:
        dst = os.path.join(args.output, sub)
        os.makedirs(dst, exist_ok=True)
        for f in sorted(glob.glob(os.path.join(args.source, pattern))):
            shutil.copy2(f, dst)
            print(f"  copied {f} -> {dst}/")
    seconds["copy"] = time.perf_counter() - t0

    if args.validate_image:
        t0 = time.perf_counter()
        report["csim"] = validate(args.output, args.validate_image, args.device,
                                  args.model_scale, init_id_adapter=vanilla)
        seconds["validate"] = time.perf_counter() - t0
    if timings is not None:
        timings.update(seconds)
    print(json.dumps(report, indent=2))
    return report


def _cli(module: str, *flags: str) -> list[str]:
    return [sys.executable, "-m", f"stableanimator_tpu_torch.cli.{module}", *flags]


def validate(ckpt_dir: str, image_path: str, device: str, model_scale: str = "full",
             init_id_adapter: bool = False) -> dict:
    """A 2-frame render from the ingested files through the port's CLIs in
    subprocesses (`init_id_adapter`: the render loads a vanilla UNet with
    --init_id_adapter), and its CSIM against the image
    (`tools/evaluate.py::csim` with the copied antelopev2 files)."""
    from PIL import Image

    from stableanimator_tpu_torch.tools.evaluate import csim, load_frames

    env = subprocess_env()
    image = Image.open(image_path).convert("RGB")
    with tempfile.TemporaryDirectory() as td:
        frames_dir, poses, out_dir = (os.path.join(td, d) for d in ("frames", "poses", "out"))
        os.makedirs(frames_dir)
        for i in range(VALIDATE_FRAMES):
            image.save(os.path.join(frames_dir, f"frame_{i}.png"))
        subprocess.run(_cli("extract_skeleton", "--target_image_folder_path", frames_dir,
                            "--ref_image_path", image_path, "--poses_folder_path", poses,
                            "--dwpose_dir", os.path.join(ckpt_dir, "DWPose"),
                            "--device", device), check=True, env=env)
        subprocess.run(_cli("animate", "--checkpoint_dir", ckpt_dir,
                            "--reference_image", image_path, "--pose_control_folder", poses,
                            "--output_dir", out_dir, "--height", str(VALIDATE_HW),
                            "--width", str(VALIDATE_HW),
                            "--num_inference_steps", str(VALIDATE_STEPS),
                            "--device", device, "--model_scale", model_scale,
                            *(["--init_id_adapter"] if init_id_adapter else [])),
                       check=True, env=env)
        frames = load_frames(os.path.join(out_dir, "animated_images"))
    return csim(frames, np.asarray(image), os.path.join(ckpt_dir, "antelopev2"), device=device)


if __name__ == "__main__":
    main()
