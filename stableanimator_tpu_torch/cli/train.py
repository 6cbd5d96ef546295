"""Training CLI (port of the JAX package's `cli/train.py`): the reference's
`train.py` contract (command_train.sh:1-21, command_finetune.sh,
README.md:285-363), torch.save checkpoints with `latest` resume, bf16
mixed precision, data-parallel over every rank.

    python -m stableanimator_tpu_torch.cli.train --checkpoint_dir ckpt \\
        --output_dir out --data_root_path data --rec_data_path rec.txt \\
        --gradient_checkpointing [--device cuda]
    torchrun --nproc_per_node N -m stableanimator_tpu_torch.cli.train ...

Without torchrun's environment it runs one process on one device. Under
torchrun every rank goes on the mesh's data axis (`parallel.make_mesh()`,
NCCL on CUDA, one card per process): the global batch is
`--per_device_batch_size` x ranks, every rank draws the same global batches
from the seeded sampler and loads its rows, the gradients are averaged over
the ranks and the AdamW moments are sharded ZeRO-1 style
(`train/train_step.py`). Rank 0 alone logs, validates and writes (and
prunes) checkpoints, which keep the one-device format.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="StableAnimator training (PyTorch port)")
    p.add_argument("--checkpoint_dir", type=str, required=True,
                   help="the reference's state dicts as .npz (unet.npz, vae.npz, "
                        "image_encoder.npz, pose_net.npz, face_encoder.npz)")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--data_root_path", type=str, required=True)
    p.add_argument("--rec_data_path", type=str, default=None)
    p.add_argument("--vec_data_path", type=str, default=None)
    p.add_argument("--data_path", type=str, default=None,
                   help="single path-list file at dataset_width/height (the "
                        "reference train_single.py flag; alias for "
                        "--rec_data_path)")
    p.add_argument("--validation_image_folder", type=str, default=None)
    p.add_argument("--validation_control_folder", type=str, default=None)
    p.add_argument("--validation_image", type=str, default=None)
    p.add_argument("--dataset_width", type=int, default=512)
    p.add_argument("--dataset_height", type=int, default=512)
    p.add_argument("--sample_n_frames", type=int, default=16)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--per_device_batch_size", type=int, default=1)
    p.add_argument("--num_train_epochs", type=int, default=6000)
    p.add_argument("--max_train_steps", type=int, default=0)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--checkpointing_steps", type=int, default=2000)
    p.add_argument("--checkpoints_total_limit", type=int, default=5000)
    p.add_argument("--validation_steps", type=int, default=500)
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.add_argument("--mixed_precision", type=str, default="bf16",
                   help='"bf16" (fp32 masters, bf16 compute) or "no" (fp32)')
    p.add_argument("--conditioning_dropout_prob", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=23123134)
    p.add_argument("--finetune_mode", type=bool, default=False)
    p.add_argument("--resume_from_checkpoint", type=str, default=None,
                   help='"latest" or a step number')
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--report_to", type=str, default="jsonl",
                   choices=["jsonl", "tensorboard", "none"],
                   help="persistent metrics stream: metrics.jsonl, + TensorBoard "
                        "mirror, or stdout only")
    p.add_argument("--allow_random_init", action="store_true")
    p.add_argument("--trainable_modules", type=str,
                   default="unet,pose_net,face_encoder",
                   help="what the optimizer updates (the reference trains all three)")
    p.add_argument("--model_scale", type=str, default="full",
                   choices=["full", "micro"],
                   help="'micro' = depth-1 tiny model zoo for smoke-testing the "
                        "whole training loop (data, step, metrics, checkpoint/"
                        "resume) in seconds")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def _load_rgb(path: str, width: int, height: int) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((width, height))
    return np.asarray(img, np.float32)


def main(argv=None):
    args = parse_args(argv)

    from stableanimator_tpu_torch.convert.checkpoints import load_state_dicts
    from stableanimator_tpu_torch.core.checkpoint import CheckpointManager
    from stableanimator_tpu_torch.core.config import (
        PipelineConfig,
        TrainConfig,
        micro_model_kwargs,
    )
    from stableanimator_tpu_torch.core.metrics import MetricsLogger
    from stableanimator_tpu_torch.parallel import make_mesh, shard_params
    from stableanimator_tpu_torch.parallel.mesh import DATA_AXIS
    from stableanimator_tpu_torch.pipeline.animation import build_models, resolve_device
    from stableanimator_tpu_torch.train.data import (
        AnimationDataset,
        MixedResolutionSampler,
        PrefetchLoader,
        read_path_list,
    )
    from stableanimator_tpu_torch.train.train_step import create_train_state, make_train_step

    device = resolve_device(args.device)
    mesh = make_mesh(device=device) if "WORLD_SIZE" in os.environ else None   # torchrun's
    if mesh is not None:
        device = mesh.device
    lead = mesh is None or mesh.axis_index(DATA_AXIS) == 0
    n_dev = 1 if mesh is None else mesh.size
    global_batch = args.per_device_batch_size * n_dev
    cfg = TrainConfig(
        sample_n_frames=args.sample_n_frames,
        per_device_batch_size=args.per_device_batch_size,
        learning_rate=args.learning_rate,
        lr_warmup_steps=args.lr_warmup_steps,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        num_train_epochs=args.num_train_epochs,
        max_train_steps=args.max_train_steps,
        checkpointing_steps=args.checkpointing_steps,
        checkpoints_total_limit=args.checkpoints_total_limit,
        validation_steps=args.validation_steps,
        gradient_checkpointing=args.gradient_checkpointing,
        mixed_precision=args.mixed_precision,
        seed=args.seed,
    )
    pipe = PipelineConfig(height=args.dataset_height, width=args.dataset_width,
                          num_frames=args.sample_n_frames)

    # fp32 first, so the optimizer's masters keep the checkpoint's precision;
    # create_train_state stores the models in the compute dtype
    model_kwargs = dict(dtype=torch.float32, device=device, seed=args.seed,
                        remat=args.gradient_checkpointing)
    if args.model_scale == "micro":
        model_kwargs.update(micro_model_kwargs())
        # real datasets carry 512-d ArcFace embeddings
        model_kwargs["face_cfg"] = dataclasses.replace(
            model_kwargs["face_cfg"], id_embeddings_dim=512)
    models = build_models(**model_kwargs)
    load_state_dicts(args.checkpoint_dir, models, args.allow_random_init,
                     init_id_adapter=not args.finetune_mode)
    if mesh is not None:
        shard_params(models, mesh)
    state = create_train_state(models, cfg,
                               trainable_keys=tuple(args.trainable_modules.split(",")),
                               mesh=mesh)
    if lead:
        print(f"mesh: {n_dev} devices, global batch {global_batch}")

    mgr = CheckpointManager(args.output_dir, total_limit=args.checkpoints_total_limit)
    if args.resume_from_checkpoint:
        step = (None if args.resume_from_checkpoint == "latest"
                else int(args.resume_from_checkpoint))
        state.load_state_dict(mgr.restore(step, map_location=device))
        if lead:
            print(f"resumed from step {state.step}")

    rec = vec = None
    rec_path = args.rec_data_path or args.data_path
    if rec_path:
        rec = AnimationDataset(read_path_list(rec_path), cfg.sample_n_frames,
                               args.dataset_width, args.dataset_height, seed=args.seed)
    if args.vec_data_path:
        vec = AnimationDataset(read_path_list(args.vec_data_path), cfg.sample_n_frames,
                               576, 1024, seed=args.seed)
    sampler = MixedResolutionSampler(rec, vec, seed=args.seed)
    rows = None
    if mesh is not None:                          # this rank's rows of every global batch
        first = mesh.axis_index(DATA_AXIS) * args.per_device_batch_size
        rows = range(first, first + args.per_device_batch_size)
    loader = PrefetchLoader(sampler, global_batch, num_workers=max(1, args.num_workers // 2),
                            rows=rows)
    step_fn = make_train_step(models, cfg, pipe,
                              conditioning_dropout_prob=args.conditioning_dropout_prob,
                              mesh=mesh)
    generator = torch.Generator(device=device)

    def run_validation(step: int):
        """A validation clip with the current weights (the reference's
        --validation_steps hook; command_train.sh:7-9,20)."""
        if not (args.validation_image and args.validation_control_folder):
            return
        from PIL import Image

        from stableanimator_tpu_torch.pipeline.animation import generate

        folder = args.validation_control_folder
        names = sorted(f for f in os.listdir(folder) if f.endswith(".png"))
        poses = np.stack([_load_rgb(os.path.join(folder, f), args.dataset_width,
                                    args.dataset_height) for f in names]) / 127.5 - 1.0
        ref = _load_rgb(args.validation_image, args.dataset_width, args.dataset_height) / 255.0
        val_cfg = PipelineConfig(height=args.dataset_height, width=args.dataset_width,
                                 num_frames=len(names), tile_size=min(16, len(names)),
                                 tile_overlap=4)
        frames = generate(models, torch.from_numpy(ref[None]), torch.from_numpy(poses),
                          torch.zeros((1, models.face_encoder.config.id_embeddings_dim)),
                          val_cfg, device=device, generator=torch.Generator(
                              device=device).manual_seed(cfg.seed))
        pixels = (frames.float().cpu().numpy() * 255.0 + 0.5).clip(0, 255).astype(np.uint8)
        out = os.path.join(args.output_dir, f"validation_step_{step}.gif")
        images = [Image.fromarray(f) for f in pixels]
        images[0].save(out, save_all=True, append_images=images[1:], duration=125, loop=0)
        print(f"validation clip -> {out}")

    metrics_log = MetricsLogger(args.output_dir, report_to=args.report_to if lead else "none")
    max_steps = args.max_train_steps or args.num_train_epochs * 1000
    t0 = time.time()
    start = state.step
    while state.step < max_steps:
        batch = {k: torch.from_numpy(v).to(device) for k, v in loader.next().items()}
        # one seed per step, so a resumed run draws what an unbroken one would
        generator.manual_seed(args.seed + state.step)
        state, metrics = step_fn(state, batch, generator=generator)
        step = state.step
        if lead and (step % 10 == 0 or step == max_steps):
            loss = float(metrics["loss"])
            gn = float(metrics["grad_norm"])
            sec = (time.time() - t0) / (step - start)
            print(f"step {step}: loss={loss:.4f} grad_norm={gn:.3f} ({sec:.2f}s/step)")
            metrics_log.log(step, {"loss": loss, "grad_norm": gn, "sec_per_step": sec})
        if lead and step % cfg.validation_steps == 0:
            run_validation(step)
        if step % cfg.checkpointing_steps == 0:
            sd = state.state_dict()               # every rank: it gathers the moments
            if lead:
                mgr.save(step, sd)
                print(f"checkpointed step {step}")
    sd = state.state_dict()
    if lead:
        mgr.save(state.step, sd)
    loader.close()
    metrics_log.close()
    if mesh is not None:
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
