"""Model export (port of the JAX package's `tools/export_model.py`): the UNet,
the temporal-VAE decoder, the VAE encoder's mode, or the whole flat
generate, each as a `torch.export` program (`.pt2`) that reloads and runs
without the model classes:

    python -m stableanimator_tpu_torch.tools.export_model --what unet \\
        --output unet_512x16.pt2 --height 512 --width 512 --frames 16 \\
        [--checkpoint_dir ckpt] [--device cuda]
    python -m stableanimator_tpu_torch.tools.export_model --what vae_decode --output vae_dec.pt2 ...
    python -m stableanimator_tpu_torch.tools.export_model --what generate --output generate.pt2 ...

    # reload:
    import torch
    import stableanimator_tpu_torch.ops.flash_attention  # registers the kernel's op
    program = torch.export.load("unet_512x16.pt2").module()
    out = program(sample, t, context, add_ids, pose)

The weights are the program's constants: seeded (the port's `build_models`,
seed 0) or loaded from `--checkpoint_dir` (the CLI's `.npz` files), in the
pipeline's dtypes (bf16 with the fp32 islands).

The graph depends on the device it is exported on. The attention dispatcher
picks its route from the tensors' device while the graph is traced: a
program exported on the CPU holds the plain attention, one exported on the
card holds the flash kernel's custom op
(`torch.ops.stableanimator.flash_attention_fwd`), which launches the kernel
when the program runs on CUDA tensors. Such a program needs that op
registered, which importing `stableanimator_tpu_torch.ops.flash_attention`
does.

`generate` is the flat path (one stretch of Euler steps, at most 4 tiles,
no face optimisation, one device), with its steps unrolled into the graph:
the port's Euler loop is a host loop, where the JAX package's export holds
a `lax.scan`. A `torch.Generator` cannot cross an export, so the program
takes the noises as inputs: (ref_image [1, H, W, 3], pose_pixels
[F, H, W, 3], face_embedding [1, id_dim], aug_noise [1, H, W, 3],
init_noise [1, tile, H/8, W/8, 4]), all fp32, and returns frames
[F, H, W, 3] in [0, 1]. The segmented, face-opt and mesh paths raise a
ValueError.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.nn as nn

from stableanimator_tpu_torch.core.config import PipelineConfig
from stableanimator_tpu_torch.diffusion.scheduler import SchedulerConfig, make_schedule
from stableanimator_tpu_torch.models.layers import module_dtype
from stableanimator_tpu_torch.pipeline.animation import (
    AnimationModels,
    _prepare_denoise_state,
    build_models,
    decode_frames,
    denoise,
    resolve_device,
    resolve_steps_per_dispatch,
)

WHATS = ("unet", "vae_decode", "vae_encode", "generate")


def _export(module: nn.Module, args: tuple):
    """`torch.export` (non-strict: traced as PyTorch runs it) of an
    inference call, outside autograd."""
    with torch.no_grad():
        return torch.export.export(module.eval(), args, strict=False)


class _VAEDecode(nn.Module):
    def __init__(self, vae, num_frames: int):
        super().__init__()
        self.vae = vae
        self.num_frames = num_frames

    def forward(self, z):
        return self.vae.decode(z, num_frames=self.num_frames)


class _VAEEncode(nn.Module):
    def __init__(self, vae):
        super().__init__()
        self.vae = vae

    def forward(self, x):
        return self.vae.encode(x)[0]


class _Generate(nn.Module):
    """The flat generate: conditioning, pose latents, the Euler steps
    (unrolled when traced) and the chunked decode."""

    def __init__(self, models: AnimationModels, cfg: PipelineConfig):
        super().__init__()
        self.unet, self.vae, self.clip, self.pose_net, self.face_encoder = models
        self.cfg = cfg

    def forward(self, ref_image, pose_pixels, face_embedding, aug_noise, init_noise):
        models = AnimationModels(self.unet, self.vae, self.clip, self.pose_net,
                                 self.face_encoder)
        device = ref_image.device
        state = _prepare_denoise_state(models, ref_image, pose_pixels, face_embedding, self.cfg,
                                       device, aug_noise=aug_noise, init_noise=init_noise)
        schedule = make_schedule(self.cfg.num_inference_steps, SchedulerConfig(), device=device)
        latents = denoise(models, *state, schedule, self.cfg)
        return decode_frames(models, latents, self.cfg)


def unet_inputs(unet, b: int, f: int, h8: int, w8: int, device, seed: int = 0) -> tuple:
    """Seeded example inputs of the UNet's call at these sizes (the JAX
    tool's shapes): sample [b, f, h8, w8, in], the timestep (fp32 scalar),
    context [b, 1 + num_id, cross], added_time_ids [b, 3] fp32, pose
    [b f, h8, w8, c0]."""
    cfg, dt = unet.config, module_dtype(unet)
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape, dtype=dt):
        return torch.randn(shape, generator=gen).to(device=device, dtype=dtype)

    return (randn(b, f, h8, w8, cfg.in_channels), torch.tensor(1.5, device=device),
            randn(b, 1 + cfg.num_id_tokens, cfg.cross_attention_dim),
            torch.tensor([[6.0, 127.0, 0.02]] * b, device=device),
            randn(b * f, h8, w8, cfg.block_out_channels[0]))


def export_unet(unet, b: int, f: int, h8: int, w8: int):
    """The UNet forward (the reference project/image_animate/unet_3d.py's
    counterpart), traced at these sizes on the UNet's device."""
    device = next(unet.parameters()).device
    return _export(unet, unet_inputs(unet, b, f, h8, w8, device))


def export_vae_decode(vae, f: int, h8: int, w8: int):
    """The temporal-VAE decoder: latents [F, h8, w8, 4] fp32 -> frames
    [F, H, W, 3] in [-1, 1] (in the decoder's dtype)."""
    device = next(vae.parameters()).device
    z = torch.zeros((f, h8, w8, vae.config.latent_channels), device=device)
    return _export(_VAEDecode(vae, f), (z,))


def export_vae_encode(vae, h: int, w: int):
    """The VAE encoder's mode: image [1, H, W, 3] in [-1, 1] -> latent mean
    [1, h8, w8, 4] fp32."""
    device = next(vae.parameters()).device
    return _export(_VAEEncode(vae), (torch.zeros((1, h, w, 3), device=device),))


def generate_inputs(models: AnimationModels, cfg: PipelineConfig, device, seed: int = 0) -> tuple:
    """Seeded inputs of the generate program: (ref_image, pose_pixels,
    face_embedding, aug_noise, init_noise), fp32."""
    gen = torch.Generator().manual_seed(seed)
    h, w, f = cfg.height, cfg.width, cfg.num_frames
    id_dim = models.face_encoder.config.id_embeddings_dim
    shapes = ((1, h, w, 3), (f, h, w, 3), (1, id_dim), (1, h, w, 3),
              (1, cfg.tile_size, h // 8, w // 8, 4))
    ref, pose, emb, aug, init = (torch.randn(s, generator=gen) for s in shapes)
    return tuple(x.to(device) for x in (ref.sigmoid(), pose.tanh(), emb, aug, init))


def export_generate(models: AnimationModels, h: int, w: int, f: int,
                    cfg: PipelineConfig | None = None, *, face_opt=None, mesh=None):
    """The whole flat generate (conditioning, the Euler steps unrolled, the
    decode) as one program taking the noises as inputs. The segmented path
    (past 4 tiles), face optimisation and a mesh are not exported: a
    ValueError says so."""
    if face_opt is not None:
        raise ValueError("generate with face optimisation is not exported: its refine "
                         "differentiates the decode inside the Euler loop")
    if mesh is not None:
        raise ValueError("generate on a mesh is not exported: its collectives run on "
                         "torch.distributed")
    cfg = cfg or PipelineConfig()
    cfg = dataclasses.replace(cfg, height=h, width=w, num_frames=f,
                              tile_size=min(cfg.tile_size, f))
    if resolve_steps_per_dispatch(cfg) is not None:
        raise ValueError(f"generate at {f} frames takes the segmented path, which is not "
                         "exported: only the flat path (at most 4 tiles) is")
    device = next(models.unet.parameters()).device
    return _export(_Generate(models, cfg), generate_inputs(models, cfg, device))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="torch.export of the port's models")
    ap.add_argument("--what", default="unet", choices=WHATS)
    ap.add_argument("--output", required=True)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2, help="2 = CFG pair")
    ap.add_argument("--checkpoint_dir", type=str, default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the program is traced; it decides the attention's route")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    models = build_models(dtype=torch.bfloat16, device=device)
    if args.checkpoint_dir:
        from stableanimator_tpu_torch.convert.checkpoints import load_state_dicts

        load_state_dicts(args.checkpoint_dir, models, allow_random_init=False,
                         init_id_adapter=False)
    b, f, h, w = args.batch, args.frames, args.height, args.width
    t0 = time.perf_counter()
    if args.what == "unet":
        program = export_unet(models.unet, b, f, h // 8, w // 8)
    elif args.what == "vae_decode":
        program = export_vae_decode(models.vae, f, h // 8, w // 8)
    elif args.what == "vae_encode":
        program = export_vae_encode(models.vae, h, w)
    else:
        program = export_generate(models, h, w, f)
    seconds = time.perf_counter() - t0
    torch.export.save(program, args.output)
    size = os.path.getsize(args.output)
    print(f"exported {args.what} on {device} in {seconds:.1f} s ({size / 1e6:.1f} MB) "
          f"-> {args.output}")
    return {"what": args.what, "device": str(device), "seconds": seconds, "bytes": size}


if __name__ == "__main__":
    main()
