"""The end-to-end animation pipeline, flat path (port of the JAX package's
`pipeline/animation.py`).

`generate` runs, in order:
  1. `encode_conditioning`: antialiased resize -> CLIP image tower,
     FusionFaceId face tokens, fp32 VAE encode of the noise-augmented
     reference image;
  2. PoseNet, once per video;
  3. `denoise`: one UNet call per Euler step carrying CFG x every tile,
     then the scatter-add tile blend and the guidance mix;
  4. `decode_frames`: chunked temporal-VAE decode, chunks batched when the
     video is small enough, else one chunk at a time.

Inputs and outputs keep the JAX package's channels-last layouts. This slice
covers videos of at most 4 tiles on one device; the grouped long-video
path, face optimisation and the mesh raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn

from stableanimator_tpu_torch.core.config import (
    CLIPVisionConfig,
    FaceEncoderConfig,
    PipelineConfig,
    PoseNetConfig,
    SchedulerConfig,
    UNetConfig,
    VAEConfig,
)
from stableanimator_tpu_torch.diffusion.scheduler import (
    make_schedule,
    scale_model_input,
    step_euler,
)
from stableanimator_tpu_torch.diffusion.tiling import (
    auto_tile_batch,
    tile_blend_weight,
    tile_indices,
)
from stableanimator_tpu_torch.models.clip import (
    CLIP_IMAGE_MEAN,
    CLIP_IMAGE_STD,
    CLIPVisionModelWithProjection,
)
from stableanimator_tpu_torch.models.id_encoder import FusionFaceId
from stableanimator_tpu_torch.models.layers import FP32_MODULES, cast_compute
from stableanimator_tpu_torch.models.pose_net import PoseNet
from stableanimator_tpu_torch.models.unet import UNetSpatioTemporal
from stableanimator_tpu_torch.models.vae import AutoencoderKLTemporalDecoder
from stableanimator_tpu_torch.ops.resize import resize_antialias

DEFAULT_SEED = 23123134  # the reference's seed_everything default


class AnimationModels(NamedTuple):
    unet: UNetSpatioTemporal
    vae: AutoencoderKLTemporalDecoder
    clip: CLIPVisionModelWithProjection
    pose_net: PoseNet
    face_encoder: FusionFaceId


def resolve_device(device: torch.device | str) -> torch.device:
    """The device an entry point runs on. CUDA is the default everywhere;
    without it the caller must ask for the CPU explicitly."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the "
                           "port on the CPU")
    return device


@torch.no_grad()
def fill_parameters(module: nn.Module, seed: int) -> None:
    """Seeded parameter fill with the rules of the JAX package's
    `fast_init_params`: norm scales and PoseNet's scale 1, biases 0, every
    other leaf uniform(+-sqrt(3)*std), std = 1/sqrt(fan_in) for matrices
    and 0.05 for vectors. Drawn on the parameters' device from one
    generator, leaf by leaf."""
    gen = None
    for mod_name, mod in module.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            if gen is None:
                gen = torch.Generator(device=p.device).manual_seed(seed)
            if isinstance(mod, FP32_MODULES) and name == "weight" or name == "scale":
                p.fill_(1.0)
            elif name == "bias":
                p.zero_()
            else:
                if p.dim() >= 2:
                    # Flax kernels are [..., in, out]; torch weights [out, in, ...]
                    # (the position embedding keeps Flax's [num_pos, dim])
                    fan_in = (p.shape[0] if isinstance(mod, nn.Embedding)
                              else int(np.prod(p.shape[1:])))
                    std = 1.0 / np.sqrt(max(fan_in, 1))
                else:
                    std = 0.05
                lim = float(np.sqrt(3.0) * std)
                p.uniform_(-lim, lim, generator=gen)


def build_models(unet_cfg: UNetConfig | None = None, vae_cfg: VAEConfig | None = None,
                 clip_cfg: CLIPVisionConfig | None = None,
                 pose_cfg: PoseNetConfig | None = None,
                 face_cfg: FaceEncoderConfig | None = None,
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cuda",
                 seed: int | None = 0, remat: bool = False) -> AnimationModels:
    """Build the five models on `device`, parameters filled from `seed`
    (`fill_parameters`) or left uninitialised for a checkpoint load when
    seed is None. Parameters are stored in `dtype` except the fp32 islands
    (`cast_models`). `remat` turns on the UNet's gradient checkpointing."""
    device = resolve_device(device)
    with torch.device("meta"):
        models = AnimationModels(
            unet=UNetSpatioTemporal(unet_cfg or UNetConfig(), remat=remat),
            vae=AutoencoderKLTemporalDecoder(vae_cfg or VAEConfig()),
            clip=CLIPVisionModelWithProjection(clip_cfg or CLIPVisionConfig()),
            pose_net=PoseNet(pose_cfg or PoseNetConfig()),
            face_encoder=FusionFaceId(face_cfg or FaceEncoderConfig()),
        )
    for i, m in enumerate(models):
        m.to_empty(device=device)
        if seed is not None:
            fill_parameters(m, seed + i)
        m.eval().requires_grad_(False)
    return cast_models(models, dtype)


def cast_models(models: AnimationModels, dtype: torch.dtype) -> AnimationModels:
    """Store the parameters in `dtype`, except the fp32 islands: norm
    affines, AlphaBlender mixes, and the VAE encoder + quant_conv."""
    for m in (models.unet, models.vae.decoder, models.clip, models.pose_net,
              models.face_encoder):
        cast_compute(m, dtype)
    return models


# ---------------------------------------------------------------------------
# conditioning
# ---------------------------------------------------------------------------

def encode_conditioning(models: AnimationModels, ref_image, face_embedding,
                        cfg: PipelineConfig, clip_image=None, aug_noise=None):
    """CLIP + face-ID + VAE reference conditioning.

    ref_image [1, H, W, 3] fp32 in [0, 1]; clip_image optional
    [1, H0, W0, 3] for the CLIP branch; face_embedding [1, id_dim];
    aug_noise [1, H, W, 3] standard normal (the noise augmentation).
    Returns (context [2, 1+num_id, cross_dim], image_latents [2, h, w, 4],
    add_time_ids [2, 3]); index 0 is the uncond stream."""
    size = models.clip.config.image_size
    x = (clip_image if clip_image is not None else ref_image) * 2.0 - 1.0
    x = (resize_antialias(x, size, size) + 1.0) / 2.0
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=x.dtype, device=x.device)
    clip_embed = models.clip((x - mean) / std)[:, None, :].float()   # [1, 1, D]
    faceid = models.face_encoder(face_embedding.float(), clip_embed).float()
    cond_ctx = torch.cat([clip_embed, faceid], dim=1)
    context = torch.cat([torch.zeros_like(cond_ctx), cond_ctx], dim=0)

    vae_in = ref_image * 2.0 - 1.0 + cfg.noise_aug_strength * aug_noise
    lat, _ = models.vae.encode(vae_in)                               # mode, fp32
    image_latents = torch.cat([torch.zeros_like(lat), lat], dim=0)

    ids = torch.tensor([[cfg.fps - 1, cfg.motion_bucket_id, cfg.noise_aug_strength]],
                       dtype=torch.float32, device=ref_image.device)
    return context, image_latents, torch.cat([ids, ids], dim=0)


# ---------------------------------------------------------------------------
# denoising
# ---------------------------------------------------------------------------

def denoise(models: AnimationModels, latents, context, image_latents, add_time_ids,
            pose_latents, schedule, cfg: PipelineConfig):
    """Euler steps with CFG and every tile batched into one UNet call.

    latents [1, F, h, w, 4] fp32 (already scaled by the init sigma);
    context [2, 1+num_id, D]; image_latents [2, h, w, 4]; pose_latents
    [F, h, w, c0]. Index 0 of the conditioning is the uncond stream."""
    f = latents.shape[1]
    device = latents.device
    tiles_np = tile_indices(f, cfg.tile_size, cfg.tile_overlap)
    n_tiles = tiles_np.shape[0]
    tiles = torch.from_numpy(tiles_np.astype(np.int64)).to(device)
    flat_idx = tiles.reshape(-1)
    weights_np = tile_blend_weight(cfg.tile_size)
    counts = np.zeros((f,), np.float32)
    np.add.at(counts, tiles_np.reshape(-1), np.tile(weights_np, n_tiles))
    counts_t = torch.from_numpy(counts).to(device)[:, None, None, None]
    weights = torch.from_numpy(weights_np).to(device)[None, :, None, None, None]
    guidance = torch.linspace(cfg.min_guidance_scale, cfg.max_guidance_scale, f,
                              dtype=torch.float32, device=device)[:, None, None, None]

    pose_tiles = pose_latents[flat_idx]
    pose_batch = torch.cat([torch.zeros_like(pose_tiles), pose_tiles], dim=0)
    ctx_batch = torch.cat([context[:1].expand(n_tiles, -1, -1),
                           context[1:].expand(n_tiles, -1, -1)], dim=0)
    ids_batch = torch.cat([add_time_ids[:1].expand(n_tiles, -1),
                           add_time_ids[1:].expand(n_tiles, -1)], dim=0)
    img_cond = image_latents[1]

    def blend(tile_out):                                   # [n, T, h, w, 4]
        acc = torch.zeros((f,) + tile_out.shape[2:], dtype=torch.float32, device=device)
        acc.index_add_(0, flat_idx, tile_out.reshape((-1,) + tile_out.shape[2:]))
        return acc / counts_t

    for i in range(schedule.timesteps.shape[0]):
        sigma, sigma_next = schedule.sigmas[i], schedule.sigmas[i + 1]
        lat_in = scale_model_input(latents, sigma)
        x_tiles = lat_in[0][tiles]                         # [n, T, h, w, 4]
        img_c = img_cond.expand(x_tiles.shape[:-1] + img_cond.shape[-1:])
        x_u = torch.cat([x_tiles, torch.zeros_like(img_c)], dim=-1)
        x_c = torch.cat([x_tiles, img_c], dim=-1)
        batch = torch.cat([x_u, x_c], dim=0)               # [2n, T, h, w, 8]
        out = models.unet(batch, schedule.timesteps[i], ctx_batch, ids_batch,
                          pose_batch).float()
        out = out * weights
        noise_uncond = blend(out[:n_tiles])
        noise_cond = blend(out[n_tiles:])
        noise_pred = noise_uncond + guidance * (noise_cond - noise_uncond)
        latents = step_euler(noise_pred[None], latents, sigma, sigma_next)
    return latents


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_frames(models: AnimationModels, latents, cfg: PipelineConfig):
    """Chunked temporal-VAE decode. latents [1, F, h, w, 4] -> frames
    [F, H, W, 3] fp32 in [0, 1] (uint8 when cfg.output_uint8)."""
    f = latents.shape[1]
    chunk = min(cfg.decode_chunk_size, f)
    rem = f % chunk
    full = f - rem
    z = latents[0] / models.vae.config.scaling_factor
    vae = models.vae
    if f * latents.shape[2] * latents.shape[3] <= cfg.batched_decode_max_latent_volume:
        # every chunk in one batched call; the remainder chunk as its own
        parts = [vae.decode(z[:full], num_frames=chunk)] if full else []
        if rem:
            parts.append(vae.decode(z[full:], num_frames=rem))
    else:
        parts = [vae.decode(z[s:s + chunk], num_frames=chunk) for s in range(0, full, chunk)]
        if rem:
            parts.append(vae.decode(z[full:], num_frames=rem))
    frames = (torch.cat(parts).float() / 2.0 + 0.5).clamp(0.0, 1.0)
    return output_uint8(frames) if cfg.output_uint8 else frames


# ---------------------------------------------------------------------------
# full generation
# ---------------------------------------------------------------------------

def _to_unit(x):
    """uint8 pixels -> [0, 1] fp32; fp32 passes through."""
    if x is not None and x.dtype == torch.uint8:
        return x.float() / 255.0
    return x


def _to_sym(x):
    """uint8 pixels -> [-1, 1] fp32; fp32 passes through."""
    if x.dtype == torch.uint8:
        return x.float() / 127.5 - 1.0
    return x


def _check_slice(cfg: PipelineConfig, face_opt, mesh) -> None:
    """Raise for what this slice of the port does not cover yet, naming the
    ROADMAP item that brings it."""
    if face_opt is not None:
        raise NotImplementedError("face optimisation (face_opt) is not ported yet: "
                                  "ROADMAP queue 1 item 9")
    if mesh is not None:
        raise NotImplementedError("multi-device generate (mesh) is not ported yet: "
                                  "ROADMAP queue 1 item 11")
    n_tiles = tile_indices(cfg.num_frames, cfg.tile_size, cfg.tile_overlap).shape[0]
    mtb = (auto_tile_batch(cfg.num_frames, cfg.tile_size, cfg.tile_overlap)
           if cfg.max_tile_batch == "auto" else cfg.max_tile_batch)
    spd = None if cfg.steps_per_dispatch == "auto" else cfg.steps_per_dispatch
    if n_tiles > 4 or (mtb is not None and mtb < n_tiles) or spd is not None:
        raise NotImplementedError(
            f"{n_tiles} tiles (max_tile_batch={cfg.max_tile_batch}, steps_per_dispatch="
            f"{cfg.steps_per_dispatch}): the grouped / segmented long-video path is not "
            "ported yet: ROADMAP queue 1 item 8")


def _mark(timings: dict | None, name: str | None, t0: float,
          device: torch.device) -> float:
    """When the caller asked for timings, synchronise the device at the
    phase boundary and record the phase's seconds under `name`."""
    if timings is None:
        return t0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    if name is not None:
        timings[name] = t - t0
    return t


@torch.inference_mode()
def generate(models: AnimationModels, ref_image, pose_pixels, face_embedding,
             cfg: PipelineConfig | None = None, *, clip_image=None, aug_noise=None,
             init_noise=None, generator: torch.Generator | None = None,
             face_opt=None, mesh=None, device: torch.device | str = "cuda",
             timings: dict | None = None):
    """Generate an animation (flat path: at most 4 tiles, one device).

    ref_image:      [1, H, W, 3] fp32 in [0, 1], or uint8
    pose_pixels:    [F, H, W, 3] fp32 in [-1, 1], or uint8
    face_embedding: [1, id_dim] ArcFace embedding
    clip_image:     optional [1, H0, W0, 3] for the CLIP branch
    aug_noise:      optional [1, H, W, 3] standard-normal noise augmentation
    init_noise:     optional [1, tile, H/8, W/8, 4] standard-normal initial
                    tile noise (scaled by the init sigma here)
    generator:      draws the noises not given; default a generator on the
                    device seeded 23123134
    timings:        optional dict that receives seconds per phase
                    (conditioning, pose, denoise, decode)
    returns frames  [F, H, W, 3] fp32 in [0, 1] (uint8 with cfg.output_uint8)
    """
    device = resolve_device(device)
    models_device = next(models.unet.parameters()).device
    if models_device.type != device.type:
        raise ValueError(f"models are on {models_device}, generate asked for {device}")
    cfg = cfg or PipelineConfig()
    f = pose_pixels.shape[0]
    cfg = dataclasses.replace(cfg, height=ref_image.shape[1], width=ref_image.shape[2],
                              num_frames=f, tile_size=min(cfg.tile_size, f))
    _check_slice(cfg, face_opt, mesh)

    def dev(x):
        return None if x is None else torch.as_tensor(x).to(device)

    t0 = _mark(timings, None, 0.0, device)
    ref_image = _to_unit(dev(ref_image))
    clip_image = _to_unit(dev(clip_image))
    pose_pixels = _to_sym(dev(pose_pixels))
    face_embedding = dev(face_embedding)
    if generator is None and (aug_noise is None or init_noise is None):
        generator = torch.Generator(device=device).manual_seed(DEFAULT_SEED)
    if aug_noise is None:
        aug_noise = torch.randn(ref_image.shape, generator=generator, device=device)
    h8, w8 = cfg.height // 8, cfg.width // 8
    if init_noise is None:
        init_noise = torch.randn((1, cfg.tile_size, h8, w8, 4), generator=generator,
                                 device=device)

    context, image_latents, add_time_ids = encode_conditioning(
        models, ref_image, face_embedding, cfg, clip_image=clip_image,
        aug_noise=dev(aug_noise).float())
    t0 = _mark(timings, "conditioning", t0, device)
    pose_latents = models.pose_net(pose_pixels).float()
    t0 = _mark(timings, "pose", t0, device)

    schedule = make_schedule(cfg.num_inference_steps, SchedulerConfig(), device=device)
    noise = dev(init_noise).float() * schedule.init_noise_sigma
    latents = noise.repeat(1, f // cfg.tile_size + 1, 1, 1, 1)[:, :f]
    latents = denoise(models, latents, context, image_latents, add_time_ids,
                      pose_latents, schedule, cfg)
    t0 = _mark(timings, "denoise", t0, device)
    frames = decode_frames(models, latents, cfg)
    _mark(timings, "decode", t0, device)
    return frames


def output_uint8(frames: torch.Tensor) -> torch.Tensor:
    """[0, 1] fp32 frames -> uint8 with round-half-up (the on-device form of
    the JAX package's utils/image.py::frames_to_uint8)."""
    return (frames.float() * 255.0 + 0.5).clamp(0.0, 255.0).to(torch.uint8)
