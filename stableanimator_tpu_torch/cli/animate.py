"""Inference CLI (port of the JAX package's `cli/animate.py`): the reference's
`inference_basic.py` surface (flags mirror inference_basic.py:81-213 /
command_basic_infer.sh), on one device.

    python -m stableanimator_tpu_torch.cli.animate --checkpoint_dir ckpt \\
        --reference_image ref.png --pose_control_folder poses \\
        --output_dir out [--device cuda]

Layout of --checkpoint_dir (the reference's state dicts as .npz, in the
reference's key space; `convert/checkpoints.py::load_state_dicts`):
  unet.npz            StableAnimator unet.pth (or SVD unet + --init_id_adapter)
  vae.npz             SVD vae
  image_encoder.npz   SVD image_encoder (CLIP ViT-H)
  pose_net.npz        StableAnimator pose_net.pth
  face_encoder.npz    StableAnimator face_encoder.pth
Missing files keep seeded random weights with --allow_random_init.
  antelopev2/scrfd_10g_bnkps.onnx + glintr100.onnx
                      the face model (`preproc/face.py::FaceModel`, run by the
                      port's ONNX executor on the device): the reference's
                      identity embedding, and the recogniser of the HJB face
                      optimisation (--face_optimize_steps). Without them the
                      embedding is zero and face optimisation is off, as in
                      the JAX package.

  DWPose/yolox_l.onnx + dw-ll_ucoco_384.onnx (or --dwpose_dir)
                      the skeleton extractor of --driving_video_folder: raw
                      frames in, DWPose run in a worker subprocess on the
                      same device (`preproc/pose_worker.py`) while the models
                      build and the kernels warm, its renders aligned to the
                      reference's body and channel-reversed as the
                      two-script flow stores them.

The noise is drawn from a torch.Generator on the device seeded --seed, so a
run does not reproduce the JAX package's jax.random noise for the same seed.
"""

from __future__ import annotations

import argparse
import os
import threading
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="StableAnimator inference (PyTorch port)")
    p.add_argument("--checkpoint_dir", type=str, required=True,
                   help="directory of .npz checkpoints (see module docstring)")
    p.add_argument("--reference_image", type=str, required=True)
    p.add_argument("--pose_control_folder", type=str, default=None,
                   help="folder of pre-rendered pose skeleton images (the "
                        "reference's two-script flow: run the skeleton "
                        "extraction CLI first)")
    p.add_argument("--driving_video_folder", type=str, default=None,
                   help="folder of RAW driving frames for inline DWPose "
                        "skeleton extraction")
    p.add_argument("--dwpose_dir", type=str, default=None,
                   help="dir with yolox_l.onnx + dw-ll_ucoco_384.onnx "
                        "(default: <checkpoint_dir>/DWPose)")
    p.add_argument("--max_persons", type=int, default=None,
                   help="per-frame person cap for inline DWPose extraction")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--guidance_scale", type=float, default=3.0)
    p.add_argument("--num_inference_steps", type=int, default=25)
    p.add_argument("--tile_size", type=int, default=16)
    p.add_argument("--frames_overlap", type=int, default=4)
    p.add_argument("--noise_aug_strength", type=float, default=0.02)
    p.add_argument("--decode_chunk_size", type=int, default=4)
    p.add_argument("--max_tile_batch", type=int, default=0,
                   help="max temporal tiles per UNet call; 0 = auto (all tiles "
                        "batched for short videos; past 4 tiles groups of 2, or "
                        "of 1 for an odd tile count)")
    p.add_argument("--steps_per_dispatch", type=int, default=0,
                   help="max Euler steps per segment; 0 = auto (one stretch for "
                        "short videos, segments of at most 5 steps past 4 "
                        "tiles, with progress lines), -1 = one stretch")
    p.add_argument("--fps", type=int, default=7)
    p.add_argument("--motion_bucket_id", type=int, default=127)
    p.add_argument("--seed", type=int, default=23123134)
    p.add_argument("--allow_random_init", action="store_true",
                   help="keep seeded random weights for any missing checkpoint (smoke runs)")
    p.add_argument("--model_scale", type=str, default="full", choices=["full", "micro"],
                   help="'micro' = depth-1 tiny model zoo (same topology, one "
                        "resnet/transformer layer per block, fp32) for smoke "
                        "runs; pairs with --allow_random_init")
    p.add_argument("--face_channel_order", type=str, default="reference",
                   choices=["reference", "standard"],
                   help="'reference' replicates the reference's channel-swap "
                        "quirk (cv2.imread BGR + RGB2BGR = RGB fed to "
                        "insightface; inference_basic.py:517-519), which the "
                        "released checkpoints were trained against; "
                        "'standard' feeds the recogniser RGB")
    p.add_argument("--face_optimize_steps", type=int, default=0,
                   help="HJB face-optimisation gradient steps per denoise step (the "
                        "paper's capability; 0 = off). Needs antelopev2/glintr100.onnx "
                        "in --checkpoint_dir.")
    p.add_argument("--face_opt_lr", type=float, default=0.1)
    p.add_argument("--face_opt_start_step", type=int, default=8,
                   help="first denoise step to apply face optimisation (the face "
                        "must have formed enough to carry identity)")
    p.add_argument("--init_id_adapter", action="store_true",
                   help="initialise id_to_k/id_to_v from SVD to_k/to_v when "
                        "loading a vanilla SVD unet (reference "
                        "inference_basic.py:372-377)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def _check_pose_source(args) -> None:
    if bool(args.pose_control_folder) == bool(args.driving_video_folder):
        raise SystemExit("pass exactly one of --pose_control_folder (pre-rendered "
                         "skeletons) or --driving_video_folder (raw frames)")


def _start_extraction(args, ref_u8: np.ndarray, device):
    """Start a PoseWorker on `device` on the driving frames (resized to the
    output size) and ship the extraction; returns (worker, join)."""
    from stableanimator_tpu_torch.preproc.pose_worker import PoseWorker
    from stableanimator_tpu_torch.utils.image import load_images_from_folder

    dwpose_dir = args.dwpose_dir or os.path.join(args.checkpoint_dir, "DWPose")
    det = os.path.join(dwpose_dir, "yolox_l.onnx")
    pose = os.path.join(dwpose_dir, "dw-ll_ucoco_384.onnx")
    if not (os.path.exists(det) and os.path.exists(pose)):
        raise SystemExit(f"--driving_video_folder needs yolox_l.onnx + dw-ll_ucoco_384.onnx "
                         f"in {dwpose_dir}")
    driving = np.stack([np.asarray(im) for im in load_images_from_folder(
        args.driving_video_folder, width=args.width, height=args.height)])
    worker = PoseWorker(det, pose, max_det=args.max_persons, device=str(device))
    try:
        return worker, worker.extract_async(driving, ref_u8, args.height, args.width)
    except BaseException:
        worker.close()
        raise


def _join_extraction(join, t_start: float):
    """Wait for the worker's renders -> (pose_u8 [F, H, W, 3], timings). The
    renders are channel-reversed: the two-script flow stores them with the
    BGR write convention and loads them back as RGB, so the checkpoints'
    conditioning saw the reversed render."""
    t_wait = time.time()
    maps, ack = join()
    waited = time.time() - t_wait
    ready = time.time() - t_start
    if not ack["aligned"]:
        print("WARNING: no 18-joint bodies detected; skeletons rendered without reference "
              "alignment")
    pose_u8 = np.ascontiguousarray(np.transpose(maps, (0, 2, 3, 1))[..., ::-1]).astype(np.uint8)
    print(f"DWPose extraction (worker subprocess): {pose_u8.shape[0]} frames, aligned "
          f"{ack['aligned']}, {ack['seconds']:.2f}s of extraction, ready {ready:.1f}s after "
          f"the worker started ({waited:.1f}s waited, the rest overlapped)")
    return pose_u8, {"extract_seconds": ack["seconds"], "ready_seconds": ready,
                     "waited_seconds": waited, "aligned": ack["aligned"]}


def reference_embedding(checkpoint_dir: str, ref_rgb: np.ndarray, channel_order: str,
                        device) -> np.ndarray | None:
    """The antelopev2 face model's identity embedding of the reference image
    (reference inference_basic.py:516-535), or None, with the JAX package's
    warnings, when its files are missing or no face is found.
    channel_order "reference" feeds it the reference's channel-swapped image."""
    from stableanimator_tpu_torch.preproc.face import FaceModel

    det_path = os.path.join(checkpoint_dir, "antelopev2", "scrfd_10g_bnkps.onnx")
    rec_path = os.path.join(checkpoint_dir, "antelopev2", "glintr100.onnx")
    if not (os.path.exists(det_path) and os.path.exists(rec_path)):
        print("WARNING: antelopev2 ONNX models missing; using zero identity embedding")
        return None
    face_input = ref_rgb[..., ::-1] if channel_order == "reference" else ref_rgb
    emb = FaceModel(det_path, rec_path, device=device).get_id_embedding(face_input)
    if emb is None:
        print("WARNING: no face detected in the reference image; using a zero identity "
              "embedding")
    return emb


def main(argv=None) -> dict:
    """Run the CLI; returns {"num_frames", "seconds", "phases", "warm",
    "face_opt" (whether the request ran the HJB face optimisation), "pose"
    (the inline extraction's timings and alignment, or None)}."""
    args = parse_args(argv)
    _check_pose_source(args)

    from PIL import Image

    from stableanimator_tpu_torch.pipeline.animation import generate, resolve_device
    from stableanimator_tpu_torch.utils.image import (
        export_to_gif,
        export_to_mp4,
        frames_to_uint8,
        load_images_from_folder,
        pil_to_u8_array,
        poses_to_u8_array,
        save_frames_as_png,
    )

    device = resolve_device(args.device)
    ref_pil = Image.open(args.reference_image).convert("RGB")
    ref_pil_sized = ref_pil.resize((args.width, args.height))
    # the frame count from the listing alone, so the warm starts before any
    # pose pixel is read
    src_folder = args.pose_control_folder or args.driving_video_folder
    num_frames = len([f for f in os.listdir(src_folder) if f.endswith(".png")])
    if num_frames == 0:
        raise SystemExit(f"no .png frames in {src_folder}")
    print(f"{num_frames} frames at {args.width}x{args.height}")

    # inline DWPose: the worker process extracts while this one builds the
    # models and warms the kernels
    worker = None
    if args.driving_video_folder:
        t_pose = time.time()
        worker, pose_join = _start_extraction(args, np.asarray(ref_pil_sized), device)

    def load_poses():
        """The pose frames [F, H, W, 3] uint8 and the extraction's timings
        (None for pre-rendered skeletons)."""
        if worker is None:
            return poses_to_u8_array(load_images_from_folder(
                args.pose_control_folder, width=args.width, height=args.height)), None
        return _join_extraction(pose_join, t_pose)

    try:
        models, cfg, emb, face_opt, warm_info, pose_u8, pose_info = _prepare(
            args, device, ref_pil, num_frames, load_poses)
    finally:
        if worker is not None:
            worker.close()

    timings: dict = {}
    t0 = time.time()
    frames = generate(
        models, torch.tensor(pil_to_u8_array(ref_pil_sized)), torch.from_numpy(pose_u8),
        torch.from_numpy(emb), cfg,
        # CLIP conditions on the original-resolution image (reference
        # inference_pipeline_animation.py:520)
        clip_image=torch.tensor(pil_to_u8_array(ref_pil)),
        generator=torch.Generator(device=device).manual_seed(args.seed),
        face_opt=face_opt, device=device, timings=timings,
        progress=lambda done, total: print(f"  denoise step {done}/{total} dispatched",
                                           flush=True))
    frames = frames.cpu().numpy()
    seconds = time.time() - t0
    print(f"generated {num_frames} frames in {seconds:.1f}s ("
          + ", ".join(f"{k} {v:.2f}s" for k, v in timings.items()) + ")")

    os.makedirs(args.output_dir, exist_ok=True)
    u8 = frames_to_uint8(frames)
    export_to_gif(u8, os.path.join(args.output_dir, "animation_video.gif"))
    # the reference names its artifact animation_video.mp4 and writes it at
    # 8 fps (inference_basic.py:560-562)
    export_to_mp4(u8, os.path.join(args.output_dir, "animation_video.mp4"), fps=8)
    save_frames_as_png(u8, os.path.join(args.output_dir, "animated_images"))
    print(f"wrote {args.output_dir}/animation_video.{{gif,mp4}}")
    return {"num_frames": num_frames, "seconds": seconds, "phases": timings,
            "warm": {k: v for k, v in warm_info.items() if k != "error"},
            "face_opt": face_opt is not None, "pose": pose_info}


def _prepare(args, device, ref_pil, num_frames: int, load_poses):
    """Models, config, identity embedding and face optimiser, then the warm
    (kernel builds) on a thread while `load_poses()` reads the skeleton PNGs
    or waits for the extraction worker. Returns (models, cfg, emb, face_opt,
    warm_info, pose_u8, pose_info)."""
    from stableanimator_tpu_torch.convert.checkpoints import load_state_dicts
    from stableanimator_tpu_torch.core.config import PipelineConfig, micro_model_kwargs
    from stableanimator_tpu_torch.pipeline.animation import build_models, warm_generate

    model_kwargs = dict(dtype=torch.bfloat16, device=device)
    if args.model_scale == "micro":
        # the .npz checkpoints are full-size; micro is for smoke runs
        model_kwargs.update(micro_model_kwargs(), dtype=torch.float32)
    t0 = time.time()
    models = build_models(**model_kwargs)
    loaded = load_state_dicts(args.checkpoint_dir, models, args.allow_random_init,
                              init_id_adapter=args.init_id_adapter)
    print(f"models built and {len(loaded)} checkpoint(s) loaded ({', '.join(loaded) or 'none'}) "
          f"in {time.time() - t0:.1f}s")

    # a clip shorter than a tile is one tile; its overlap stays below the
    # tile, as the server clamps it (else `tile_indices` gets no window)
    tile = min(args.tile_size, num_frames)
    cfg = PipelineConfig(
        height=args.height, width=args.width, num_frames=num_frames,
        tile_size=tile, tile_overlap=min(args.frames_overlap, max(tile - 1, 1)),
        num_inference_steps=args.num_inference_steps,
        min_guidance_scale=args.guidance_scale, max_guidance_scale=args.guidance_scale,
        fps=args.fps, motion_bucket_id=args.motion_bucket_id,
        noise_aug_strength=args.noise_aug_strength,
        decode_chunk_size=args.decode_chunk_size,
        max_tile_batch="auto" if args.max_tile_batch == 0 else args.max_tile_batch,
        steps_per_dispatch=("auto" if args.steps_per_dispatch == 0 else
                            None if args.steps_per_dispatch < 0 else args.steps_per_dispatch),
        output_uint8=True,
    )

    # face-ID embedding of the reference (reference inference_basic.py:516-535)
    id_dim = models.face_encoder.config.id_embeddings_dim  # 512 (ArcFace) at full scale
    face_emb = reference_embedding(args.checkpoint_dir, np.asarray(ref_pil),
                                   args.face_channel_order, device)
    emb = np.zeros((1, id_dim), np.float32)
    if face_emb is not None:
        if face_emb.shape[-1] != id_dim:  # micro scale + a full-width recogniser
            print(f"WARNING: identity embedding dim {face_emb.shape[-1]} != model id dim "
                  f"{id_dim}; truncating/padding (micro smoke)")
        emb[0] = np.resize(face_emb.astype(np.float32), (id_dim,))

    # HJB face optimiser: built before the warm with placeholder face boxes
    # (the real ones need the poses); with_boxes swaps them in below
    face_opt = None
    if args.face_optimize_steps > 0:
        rec_path = os.path.join(args.checkpoint_dir, "antelopev2", "glintr100.onnx")
        if not os.path.exists(rec_path):
            print("WARNING: --face_optimize_steps needs antelopev2/glintr100.onnx; face "
                  "optimization disabled")
        elif face_emb is None or not np.any(face_emb):
            print("WARNING: no reference identity embedding; face optimization disabled")
        else:
            from stableanimator_tpu_torch.pipeline.face_opt import (
                FaceOptConfig,
                make_face_optimizer,
            )
            from stableanimator_tpu_torch.preproc.onnx_to_torch import load_onnx_function

            focfg = FaceOptConfig(steps=args.face_optimize_steps, lr=args.face_opt_lr,
                                  start_step=args.face_opt_start_step)
            # the target is the recogniser's own embedding, not the one resized
            # to the model's id dim (they differ at the micro scale only)
            face_opt = make_face_optimizer(
                models, focfg, load_onnx_function(rec_path, device=device), face_emb, None,
                args.height // 8, args.width // 8, channel_order=args.face_channel_order,
                num_frames=num_frames)
            print(f"HJB face optimization: {focfg.steps} steps/denoise-step, lr={focfg.lr}, "
                  f"from denoise step {focfg.start_step}")

    # the warm (kernel builds) on a thread while the poses load or are
    # extracted; it executes nothing, so the request's kernel launches are
    # its own
    warm_info: dict = {}

    def _warm():
        try:
            t = time.time()
            warm_info.update(warm_generate(models, cfg, device=device,
                                           clip_shape=(ref_pil.height, ref_pil.width),
                                           execute=False, face_opt=face_opt))
            warm_info["seconds"] = round(time.time() - t, 1)
        except BaseException as e:  # re-raised on the main thread after the join
            warm_info["error"] = e

    warm_thread = threading.Thread(target=_warm, daemon=True)
    warm_thread.start()
    try:
        pose_u8, pose_info = load_poses()
    finally:
        warm_thread.join()
    if "error" in warm_info:
        raise warm_info["error"]
    print(f"graph warm: {warm_info['path']} path, {warm_info['programs']} program(s) in "
          f"{warm_info['seconds']}s (overlapped with preprocessing)")
    if face_opt is not None:
        # the real per-frame face boxes from the pose renders
        from stableanimator_tpu_torch.pipeline.face_opt import face_boxes_from_pose_renders

        face_opt = face_opt.with_boxes(face_boxes_from_pose_renders(
            pose_u8.astype(np.float32) / 127.5 - 1.0, args.height // 8, args.width // 8,
            face_opt.cfg.latent_crop))
    return models, cfg, emb, face_opt, warm_info, pose_u8, pose_info


if __name__ == "__main__":
    main()
