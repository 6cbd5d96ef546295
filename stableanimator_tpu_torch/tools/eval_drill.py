"""Day-0 evaluation drill of the port (port of the root `tools/eval_drill.py`):
run the whole quality-evaluation path end to end on labelled stand-ins and
write the JSON it gives.

  1. two videos from the port's inference CLI (`cli.animate`,
     --allow_random_init: seeded weights) with different seeds, at the root
     drill's settings (64x64, 16 frames, tile 4 / overlap 1, 2 steps, decode
     chunk 2) on --device, at --model_scale (full width by default);
  2. stand-ins: antelopev2's pair (`preproc/standins.py::write_antelopev2`:
     the SCRFD-signature detector and a small seeded iresnet recogniser with
     glintr100's 112x112 -> 512 signature) and the I3D-shaped Conv3d network
     (`standins.I3DStandin`) at 224 x 224;
  3. the port's `tools/evaluate.py` on video A against video B on --device:
     CSIM through the face model, PSNR / L1, FVD through the ONNX executor
     over two clips a side (8 frames each at the default 16 frames; the
     root drill's one 16-frame clip a side has no covariance, and the
     port's FVD refuses it).

The JSON has the keys of the committed EVAL_r05.json, `standin_weights`
true. With the real files in place of the stand-ins, the same commands
give the real numbers.

    python -m stableanimator_tpu_torch.tools.eval_drill [--out eval.json] \\
        [--device cuda] [--model_scale full] [--work_dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from PIL import Image

from stableanimator_tpu_torch import subprocess_env

STEPS = 2
# FVD windows each video into FVD_CLIPS clips, the least a covariance takes
# (the root drill's one 16-frame clip a side has none), at 224 x 224
FVD_CLIPS, I3D_SIZE = 2, 224


def fvd_clip_len(frames: int) -> int:
    """The FVD window of a `frames`-frame video: FVD_CLIPS clips a side."""
    return max(1, frames // FVD_CLIPS)


def make_inputs(td, frames, h, w):
    """A seeded noise reference image and `frames` pose PNGs of a white box
    moving down (the root drill's inputs)."""
    rng = np.random.default_rng(0)
    ref = os.path.join(td, "reference.png")
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(ref)
    poses = os.path.join(td, "poses")
    os.makedirs(poses)
    for i in range(frames):
        img = np.zeros((h, w, 3), np.uint8)
        img[(10 + i * 3) % (h - 20):(30 + i * 3) % h, w // 3:2 * w // 3] = 255
        Image.fromarray(img).save(os.path.join(poses, f"frame_{i}.png"))
    return ref, poses


def make_standins(td, clip_len: int) -> tuple[str, str]:
    """(the antelopev2 directory, the I3D .onnx path) of seeded stand-ins;
    the I3D graph is exported at `clip_len` frames."""
    from stableanimator_tpu_torch.preproc.standins import (
        I3DStandin,
        export_onnx,
        seeded_iresnet,
        write_antelopev2,
    )

    recogniser = seeded_iresnet(2, layers=(1, 1, 1, 1), widths=(16, 32, 64, 128))
    av2 = write_antelopev2(os.path.join(td, "antelopev2"), recogniser=recogniser, seed=2)
    torch.manual_seed(2)
    i3d = export_onnx(I3DStandin(), (torch.zeros(1, 3, clip_len, I3D_SIZE, I3D_SIZE),),
                      os.path.join(td, "i3d.onnx"))
    return av2, i3d


def run_animate(td, tag, seed, ref, poses, h, w, frames, device, model_scale):
    """One request through the port's CLI in a subprocess -> (frames folder,
    frames written, seconds)."""
    out_dir = os.path.join(td, f"out_{tag}")
    cmd = [sys.executable, "-m", "stableanimator_tpu_torch.cli.animate",
           "--checkpoint_dir", os.path.join(td, "ckpt"),
           "--reference_image", ref, "--pose_control_folder", poses,
           "--output_dir", out_dir, "--height", str(h), "--width", str(w),
           "--tile_size", str(min(4, frames)), "--frames_overlap", "1",
           "--num_inference_steps", str(STEPS), "--decode_chunk_size", "2",
           "--allow_random_init", "--seed", str(seed),
           "--device", device, "--model_scale", model_scale]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1800,
                          env=subprocess_env())
    if proc.returncode != 0:
        raise RuntimeError(f"animate {tag} failed:\n{proc.stderr[-2000:]}")
    frames_dir = os.path.join(out_dir, "animated_images")
    n = len([f for f in os.listdir(frames_dir) if f.endswith(".png")])
    return frames_dir, n, round(time.time() - t0, 1)


def drill(td, height, width, frames, device, model_scale) -> dict:
    """The drill in the directory `td` (its inputs, stand-ins and videos stay
    there); returns the result."""
    from stableanimator_tpu_torch.pipeline.animation import resolve_device
    from stableanimator_tpu_torch.tools import evaluate

    dev = resolve_device(device)
    os.makedirs(os.path.join(td, "ckpt"), exist_ok=True)
    ref, poses = make_inputs(td, frames, height, width)
    av2, i3d = make_standins(td, fvd_clip_len(frames))

    gen_a, n_a, t_a = run_animate(td, "a", 1, ref, poses, height, width, frames, device,
                                  model_scale)
    gen_b, n_b, t_b = run_animate(td, "b", 2, ref, poses, height, width, frames, device,
                                  model_scale)
    metrics = evaluate.main(["--frames_dir", gen_a, "--reference", ref, "--antelopev2", av2,
                             "--gt_dir", gen_b, "--fvd_i3d", i3d,
                             "--fvd_clip_len", str(fvd_clip_len(frames)), "--device", device])
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU"
    return {
        "what": "day-0 evaluation drill of the PyTorch port: cli/animate (2 seeds) -> "
                "tools/evaluate.py CSIM+PSNR/L1+FVD on "
                f"{where}, {model_scale}-width models, ALL STAND-IN WEIGHTS (diffusion "
                "random-init, antelopev2/I3D synthesized) - proves the path executes, not "
                "quality parity",
        "standin_weights": True,
        "config": {"height": height, "width": width, "frames": frames, "steps": STEPS},
        "generate_seconds": [t_a, t_b],
        "frames_generated": [n_a, n_b],
        "metrics": metrics,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="the port's day-0 evaluation drill")
    ap.add_argument("--out", default=None, help="write the JSON here as well")
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--model_scale", default="full", choices=["full", "micro"],
                    help="the CLI's models: full width (default) or the depth-1 micro zoo")
    ap.add_argument("--work_dir", default=None,
                    help="keep the inputs, stand-ins and videos here (default: a temporary "
                         "directory, removed after)")
    args = ap.parse_args(argv)
    run = (args.height, args.width, args.frames, args.device, args.model_scale)
    if args.work_dir:
        os.makedirs(args.work_dir, exist_ok=True)
        result = drill(args.work_dir, *run)
    else:
        with tempfile.TemporaryDirectory(prefix="eval_drill_") as td:
            result = drill(td, *run)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
