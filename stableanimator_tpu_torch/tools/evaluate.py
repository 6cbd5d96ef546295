"""Quality evaluation (port of the JAX package's `tools/evaluate.py`): CSIM
(identity), FVD (video quality), PSNR / L1 (reconstruction).

CSIM is the paper's identity metric (arXiv:2411.17697): the mean cosine
similarity between the ArcFace embedding of the reference face and of each
generated frame's face, through the port's face model
(`preproc/face.py::FaceModel`, the antelopev2 pair run by the port's ONNX
executor on --device).

FVD is the Fréchet distance between I3D features of generated and real
clips, the I3D graph run by the port's ONNX executor
(`preproc/onnx_to_torch.py`) on --device. The I3D file is an external
artifact (--fvd_i3d: any I3D .onnx, e.g. the rgb Kinetics-400 export);
clips shorter than the window are rejected, longer ones are split into
non-overlapping windows, of which each side needs two (the JAX tool takes
one, whose covariance is undefined). The frames are resized to 224 x 224
by the port's copy of OpenCV's INTER_LINEAR resize
(`preproc/geometry.py::resize_bilinear`, byte-identical to cv2.resize,
which the JAX tool calls), so no OpenCV is needed.

    python -m stableanimator_tpu_torch.tools.evaluate --frames_dir out/animated_images \\
        --reference reference.png --antelopev2 checkpoints/antelopev2 [--device cuda]
    python -m stableanimator_tpu_torch.tools.evaluate --frames_dir out --gt_dir ground_truth
    python -m stableanimator_tpu_torch.tools.evaluate --frames_dir out --gt_dir gt \\
        --fvd_i3d i3d_rgb.onnx
"""

from __future__ import annotations

import argparse
import json
import os
import re

import numpy as np
import torch
from PIL import Image

from stableanimator_tpu_torch.preproc.geometry import resize_bilinear


def load_frames(folder: str) -> list:
    """The folder's PNGs as RGB uint8 arrays, in the order of the last
    number in each name."""
    def key(name):
        m = re.findall(r"\d+", name)
        return int(m[-1]) if m else 0

    files = sorted((f for f in os.listdir(folder) if f.endswith(".png")), key=key)
    return [np.asarray(Image.open(os.path.join(folder, f)).convert("RGB")) for f in files]


def csim(frames, reference, antelopev2_dir: str, device="cuda") -> dict:
    """Mean and least cosine similarity of each frame's face embedding with
    the reference's, and the frames with and without a detected face."""
    from stableanimator_tpu_torch.preproc.face import FaceModel

    model = FaceModel(os.path.join(antelopev2_dir, "scrfd_10g_bnkps.onnx"),
                      os.path.join(antelopev2_dir, "glintr100.onnx"), device=device)
    ref_emb = model.get_id_embedding(reference)
    if ref_emb is None:
        raise ValueError("no face found in the reference image")
    ref_emb = ref_emb / np.linalg.norm(ref_emb)
    sims, missing = [], 0
    for frame in frames:
        emb = model.get_id_embedding(frame)
        if emb is None:
            missing += 1
            continue
        emb = emb / np.linalg.norm(emb)
        sims.append(float(ref_emb @ emb))
    return {
        "csim_mean": float(np.mean(sims)) if sims else None,
        "csim_min": float(np.min(sims)) if sims else None,
        "frames_with_face": len(sims),
        "frames_without_face": missing,
    }


def _i3d_features(clips, i3d_fn, size: int = 224) -> np.ndarray:
    """I3D features of [T, H, W, 3] uint8 clips, the standard FVD recipe:
    resize to size x size (INTER_LINEAR), scale to [-1, 1], NCTHW; an
    output of any head shape is flattened to [D]."""
    feats = []
    for clip in clips:
        frames = np.stack([resize_bilinear(f, (size, size)) for f in clip])
        x = frames.astype(np.float32) / 127.5 - 1.0          # [T, H, W, 3]
        x = x.transpose(3, 0, 1, 2)[None]                     # [1, 3, T, H, W]
        with torch.no_grad():
            out = i3d_fn(x)
        out = out[0] if isinstance(out, (tuple, list)) else out
        out = out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
        feats.append(out.reshape(-1))
    return np.stack(feats)


def frechet_distance(feat_a: np.ndarray, feat_b: np.ndarray) -> float:
    """Fréchet distance between two Gaussian feature fits (the FVD / FID
    formula |mu_a - mu_b|^2 + Tr(Sa + Sb - 2 sqrtm(Sa Sb)))."""
    from scipy.linalg import sqrtm

    mu_a, mu_b = feat_a.mean(0), feat_b.mean(0)
    sa = np.atleast_2d(np.cov(feat_a, rowvar=False))
    sb = np.atleast_2d(np.cov(feat_b, rowvar=False))
    covmean = sqrtm(sa @ sb)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    diff = mu_a - mu_b
    return float(diff @ diff + np.trace(sa) + np.trace(sb) - 2.0 * np.trace(covmean))


def _windows(frames, clip_len: int) -> list:
    """Non-overlapping [clip_len, H, W, 3] windows of a frame list."""
    return [np.stack(frames[start:start + clip_len])
            for start in range(0, len(frames) - clip_len + 1, clip_len)]


def fvd(gen_frames, real_frames, i3d_onnx_path: str, clip_len: int = 16, device="cuda") -> dict:
    """FVD between generated and real frame sequences, the I3D graph run by
    the port's ONNX executor on `device` (the paper's metric,
    arXiv:2411.17697 Tab. 1)."""
    from stableanimator_tpu_torch.preproc.onnx_to_torch import load_onnx_function

    gen_clips = _windows(gen_frames, clip_len)
    real_clips = _windows(real_frames, clip_len)
    if not gen_clips or not real_clips:
        raise ValueError(f"need at least {clip_len} frames per side for FVD "
                         f"(got {len(gen_frames)} gen / {len(real_frames)} real)")
    if len(gen_clips) < 2 or len(real_clips) < 2:
        # one clip's features have no covariance: np.cov gives NaN (numpy >=
        # 2.2; older numpy took the row for one variable's observations)
        raise ValueError(f"FVD needs at least 2 clips of {clip_len} frames per side (got "
                         f"{len(gen_clips)} gen / {len(real_clips)} real): the covariance "
                         "of one clip is undefined")
    fn = load_onnx_function(i3d_onnx_path, device=device)
    return {
        "fvd": frechet_distance(_i3d_features(gen_clips, fn), _i3d_features(real_clips, fn)),
        "fvd_gen_clips": len(gen_clips),
        "fvd_real_clips": len(real_clips),
    }


def reconstruction(frames, gt_frames) -> dict:
    """Mean L1 and PSNR of the frames against the ground truth's, over the
    shorter of the two sequences, in [0, 1] pixels."""
    n = min(len(frames), len(gt_frames))
    l1s, psnrs = [], []
    for a, b in zip(frames[:n], gt_frames[:n]):
        a = a.astype(np.float32) / 255.0
        b = b.astype(np.float32) / 255.0
        l1s.append(float(np.abs(a - b).mean()))
        mse = float(np.square(a - b).mean())
        psnrs.append(10 * np.log10(1.0 / max(mse, 1e-10)))
    return {"l1_mean": float(np.mean(l1s)), "psnr_mean": float(np.mean(psnrs)), "num_frames": n}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="CSIM / FVD / PSNR-L1 of generated frames")
    ap.add_argument("--frames_dir", required=True)
    ap.add_argument("--reference", default=None)
    ap.add_argument("--antelopev2", default=None)
    ap.add_argument("--gt_dir", default=None)
    ap.add_argument("--fvd_i3d", default=None,
                    help="path to an I3D .onnx (external artifact); enables FVD against --gt_dir")
    ap.add_argument("--fvd_clip_len", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="where the face model and I3D run (cuda unless cpu is asked for)")
    args = ap.parse_args(argv)

    frames = load_frames(args.frames_dir)
    result = {"num_frames": len(frames)}
    if args.reference and args.antelopev2:
        ref = np.asarray(Image.open(args.reference).convert("RGB"))
        result.update(csim(frames, ref, args.antelopev2, device=args.device))
    if args.gt_dir:
        gt = load_frames(args.gt_dir)
        result.update(reconstruction(frames, gt))
        if args.fvd_i3d:
            result.update(fvd(frames, gt, args.fvd_i3d, clip_len=args.fvd_clip_len,
                              device=args.device))
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
