"""The end-to-end animation pipeline (port of the JAX package's
`pipeline/animation.py`), on one device or a (data, frame) mesh.

`generate` runs, in order:
  1. `_prepare_denoise_state`: `encode_conditioning` (antialiased resize ->
     CLIP image tower, FusionFaceId face tokens, fp32 VAE encode of the
     noise-augmented reference image), PoseNet once per video, and the
     initial noise;
  2. `denoise`: Euler steps with CFG. Short videos (<= 4 tiles) carry every
     tile in one UNet call per step; longer ones (`max_tile_batch`, "auto"
     past 4 tiles) call the UNet once per group of tiles
     (`_denoise_grouped`), so the UNet batch does not grow with the video;
     then the scatter-add tile blend and the guidance mix;
  3. `decode_frames`: chunked temporal-VAE decode, chunks batched when the
     video is small enough, else one chunk at a time.

Past 4 tiles (`resolve_steps_per_dispatch`) `generate` takes the segmented
path (`_generate_segmented`): the Euler loop in segments of a few steps,
with `progress(done, total)` after each, and the decode in groups of frames
(`_decode_dispatched`). PyTorch runs eagerly, so a segment is a stretch of
the same loop, not a program of its own; the segments and groups keep the
JAX package's plan, and its numbers, all the same.

With a `face_opt` (pipeline/face_opt.py::FaceOptimizer) every Euler update
of both denoise loops goes through the HJB identity refinement of x0_hat
(`_advance_latents`), and the segmented path's step budget halves, as in
the JAX package.

With a `mesh` (parallel/mesh.py::make_mesh; one process per rank, each
calling `generate` with the same inputs) every UNet call splits its CFG x
tiles rows over "data" and each tile's frames over "frame", as the JAX
package shards them; the UNet's output is gathered on every rank, so the
blend, guidance and Euler update run replicated and every rank holds the
same latents. Grouped denoising takes groups of one tile (the JAX
package's rule), and the decode gives each rank whole chunks, then gathers
the frames. The mesh is the active mesh (`ops/gate.py`) during the call.

Inputs and outputs keep the JAX package's channels-last layouts.
"""

from __future__ import annotations

import concurrent.futures
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
    pred_original_sample,
    scale_model_input,
    step_euler,
    step_euler_from_x0,
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
from stableanimator_tpu_torch.models.layers import FP32_MODULES, cast_compute, module_dtype
from stableanimator_tpu_torch.models.pose_net import PoseNet
from stableanimator_tpu_torch.models.unet import UNetSpatioTemporal
from stableanimator_tpu_torch.models.vae import AutoencoderKLTemporalDecoder
from stableanimator_tpu_torch.ops import build
from stableanimator_tpu_torch.ops import flash_attention as fa
from stableanimator_tpu_torch.ops.gate import use_mesh
from stableanimator_tpu_torch.ops.resize import resize_antialias
from stableanimator_tpu_torch.parallel.mesh import AXES, DATA_AXIS, FRAME_AXIS, Sharding

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


def meta_models(unet_cfg: UNetConfig | None = None, vae_cfg: VAEConfig | None = None,
                clip_cfg: CLIPVisionConfig | None = None,
                pose_cfg: PoseNetConfig | None = None,
                face_cfg: FaceEncoderConfig | None = None,
                remat: bool = False, quant: bool = False) -> AnimationModels:
    """The five models on the meta device: every parameter's name and
    shape, and no storage (`build_models` gives them a device; a checkpoint
    check reads their state dicts)."""
    with torch.device("meta"):
        return AnimationModels(
            unet=UNetSpatioTemporal(unet_cfg or UNetConfig(), remat=remat, quant=quant),
            vae=AutoencoderKLTemporalDecoder(vae_cfg or VAEConfig()),
            clip=CLIPVisionModelWithProjection(clip_cfg or CLIPVisionConfig()),
            pose_net=PoseNet(pose_cfg or PoseNetConfig()),
            face_encoder=FusionFaceId(face_cfg or FaceEncoderConfig()),
        )


def build_models(unet_cfg: UNetConfig | None = None, vae_cfg: VAEConfig | None = None,
                 clip_cfg: CLIPVisionConfig | None = None,
                 pose_cfg: PoseNetConfig | None = None,
                 face_cfg: FaceEncoderConfig | None = None,
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cuda",
                 seed: int | None = 0, remat: bool = False,
                 quant: bool = False) -> AnimationModels:
    """Build the five models on `device`, parameters filled from `seed`
    (`fill_parameters`) or left uninitialised for a checkpoint load when
    seed is None. Parameters are stored in `dtype` except the fp32 islands
    (`cast_models`). `remat` turns on the UNet's gradient checkpointing,
    `quant` its int8 path (same parameters)."""
    device = resolve_device(device)
    models = meta_models(unet_cfg, vae_cfg, clip_cfg, pose_cfg, face_cfg, remat=remat,
                         quant=quant)
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

def _unet(models: AnimationModels, batch, t, ctx, ids, pose, mesh):
    """The UNet on batch [R, T, h, w, 8] (ctx [R, ...], ids [R, 3], pose
    [R*T, ...]), fp32 out. Under a mesh each rank runs its rows ("data") and
    its block of frames ("frame"), and the output is gathered on every
    rank. An axis that does not divide its dim (2 rows over 4 data ranks)
    holds that dim whole on each of its ranks, which compute it alike (the
    JAX package's GSPMD shards unevenly instead; the results are the
    same)."""
    if mesh is None:
        return models.unet(batch, t, ctx, ids, pose).float()
    r, f = batch.shape[:2]
    data = DATA_AXIS if r % mesh.shape[DATA_AXIS] == 0 else None
    frame = FRAME_AXIS if f % mesh.shape[FRAME_AXIS] == 0 else None
    video = Sharding(mesh, (data, frame, None, None, None))
    rows = Sharding(mesh, (data, None))
    pose = video.local(pose.reshape(batch.shape[:2] + pose.shape[1:]))
    with use_mesh(mesh if frame is not None else None):    # no frame collectives
        out = models.unet(video.local(batch), t, rows.local(ctx), rows.local(ids),
                          pose.reshape((-1,) + pose.shape[2:]))
    return video.gather(out).float()


def denoise(models: AnimationModels, latents, context, image_latents, add_time_ids,
            pose_latents, schedule, cfg: PipelineConfig, step_start: int = 0,
            num_steps: int | None = None, face_opt=None, mesh=None):
    """Euler steps with CFG: steps [step_start, step_start + num_steps) of
    `schedule` (all of them by default), each through `face_opt`'s
    refinement when one is given.

    latents [1, F, h, w, 4] fp32 (already scaled by the init sigma);
    context [2, 1+num_id, D]; image_latents [2, h, w, 4]; pose_latents
    [F, h, w, c0]. Index 0 of the conditioning is the uncond stream. Every
    tile goes into one UNet call per step, unless `max_tile_batch` (or its
    "auto" policy) asks for groups of fewer tiles: `_denoise_grouped`.
    mesh: the UNet batch's rows go over "data", its frames over "frame"
    (`_unet`); groups are of one tile, so that the CFG pair is the data
    axis's batch (the JAX package's rule)."""
    f = latents.shape[1]
    device = latents.device
    tiles_np = tile_indices(f, cfg.tile_size, cfg.tile_overlap)
    n_tiles = tiles_np.shape[0]
    weights_np = tile_blend_weight(cfg.tile_size)
    counts = np.zeros((f,), np.float32)
    np.add.at(counts, tiles_np.reshape(-1), np.tile(weights_np, n_tiles))
    counts_t = torch.from_numpy(counts).to(device)[:, None, None, None]
    guidance = torch.linspace(cfg.min_guidance_scale, cfg.max_guidance_scale, f,
                              dtype=torch.float32, device=device)[:, None, None, None]
    n_scan = schedule.timesteps.shape[0] if num_steps is None else num_steps
    steps = range(step_start, step_start + n_scan)

    mtb = (auto_tile_batch(f, cfg.tile_size, cfg.tile_overlap)
           if cfg.max_tile_batch == "auto" else cfg.max_tile_batch)
    if mesh is not None and mtb is not None:
        mtb = 1
    if mtb is not None and mtb < n_tiles:
        return _denoise_grouped(models, latents, context, image_latents, add_time_ids,
                                pose_latents, schedule, mtb, tiles_np, weights_np, counts_t,
                                guidance, steps, face_opt, mesh)

    tiles = torch.from_numpy(tiles_np.astype(np.int64)).to(device)
    flat_idx = tiles.reshape(-1)
    weights = torch.from_numpy(weights_np).to(device)[None, :, None, None, None]
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

    for i in steps:
        sigma, sigma_next = schedule.sigmas[i], schedule.sigmas[i + 1]
        lat_in = scale_model_input(latents, sigma)
        x_tiles = lat_in[0][tiles]                         # [n, T, h, w, 4]
        img_c = img_cond.expand(x_tiles.shape[:-1] + img_cond.shape[-1:])
        x_u = torch.cat([x_tiles, torch.zeros_like(img_c)], dim=-1)
        x_c = torch.cat([x_tiles, img_c], dim=-1)
        batch = torch.cat([x_u, x_c], dim=0)               # [2n, T, h, w, 8]
        out = _unet(models, batch, schedule.timesteps[i], ctx_batch, ids_batch, pose_batch,
                    mesh)
        out = out * weights
        noise_uncond = blend(out[:n_tiles])
        noise_cond = blend(out[n_tiles:])
        noise_pred = noise_uncond + guidance * (noise_cond - noise_uncond)
        latents = _advance_latents(latents, noise_pred, sigma, sigma_next, i, face_opt)
    return latents


def _advance_latents(lat, noise_pred, sigma, sigma_next, i: int, face_opt):
    """One Euler update, through the HJB inner solver on x0_hat when
    `face_opt` has steps (`FaceOptimizer.refine` acts at its step window)."""
    if face_opt is not None and face_opt.cfg.steps > 0:
        x0 = pred_original_sample(noise_pred[None], lat, sigma)
        with use_mesh(None):          # replicated on every rank of a mesh
            x0 = face_opt.refine(x0, i)
        return step_euler_from_x0(x0, lat, sigma, sigma_next)
    return step_euler(noise_pred[None], lat, sigma, sigma_next)


def _denoise_grouped(models: AnimationModels, latents, context, image_latents, add_time_ids,
                     pose_latents, schedule, group_size: int, tiles_np, weights_np, counts_t,
                     guidance, steps, face_opt=None, mesh=None):
    """Long-video denoise: one UNet call per group of `group_size` tiles.

    The math of the all-tiles path in `denoise` (each tile's UNet output is
    weighted, scatter-added and count-normalised), with the UNet batch
    bounded at 2 x group_size tiles, so device memory does not grow with
    the video: the reference's per-tile loop (inference_pipeline_animation.py:
    654-689), in groups. As in the JAX package, the tiles are padded to a
    whole number of groups with zero-weight duplicates of the last tile, the
    pose latents are gathered per group once, and each step gathers every
    tile's input once and blends the stacked outputs with one scatter-add
    per CFG stream."""
    f = latents.shape[1]
    device = latents.device
    n_tiles, tile = tiles_np.shape
    g = group_size
    n_groups = -(-n_tiles // g)
    pad = n_groups * g - n_tiles
    tiles_p = np.concatenate([tiles_np, np.repeat(tiles_np[-1:], pad, axis=0)], axis=0)
    mask = np.concatenate([np.ones((n_tiles,), np.float32), np.zeros((pad,), np.float32)])
    mask = mask.reshape(n_groups, g)
    flat_idx = torch.from_numpy(tiles_p.reshape(-1).astype(np.int64)).to(device)
    # triangular blend weight x padding mask, [G, 2g, T, 1, 1, 1]
    wm = np.concatenate([mask, mask], axis=1)[:, :, None] * weights_np[None, None, :]
    wm = torch.from_numpy(wm).to(device)[..., None, None, None]

    pose_groups = pose_latents[flat_idx].reshape((n_groups, g * tile) + pose_latents.shape[1:])
    pose_uncond = torch.zeros_like(pose_groups[0])         # uncond drops the pose
    ctx_pair = torch.cat([context[:1].expand(g, -1, -1), context[1:].expand(g, -1, -1)], dim=0)
    ids_pair = torch.cat([add_time_ids[:1].expand(g, -1), add_time_ids[1:].expand(g, -1)], dim=0)
    img_cond = image_latents[1]

    for i in steps:
        sigma, sigma_next = schedule.sigmas[i], schedule.sigmas[i + 1]
        lat_in = scale_model_input(latents, sigma)[0]      # [F, h, w, 4]
        x_groups = lat_in[flat_idx].reshape((n_groups, g, tile) + lat_in.shape[1:])
        outs = []
        for gi in range(n_groups):
            x_t = x_groups[gi]                             # [g, T, h, w, 4]
            img_c = img_cond.expand(x_t.shape[:-1] + img_cond.shape[-1:])
            batch = torch.cat([torch.cat([x_t, torch.zeros_like(img_c)], dim=-1),
                               torch.cat([x_t, img_c], dim=-1)], dim=0)   # [2g, T, h, w, 8]
            pose_b = torch.cat([pose_uncond, pose_groups[gi]], dim=0)
            out = _unet(models, batch, schedule.timesteps[i], ctx_pair, ids_pair, pose_b, mesh)
            outs.append(out * wm[gi])
        outs = torch.stack(outs)                           # [G, 2g, T, h, w, 4]
        frame_shape = (-1,) + outs.shape[3:]
        acc_u = torch.zeros((f,) + outs.shape[3:], dtype=torch.float32, device=device)
        acc_c = torch.zeros_like(acc_u)
        acc_u.index_add_(0, flat_idx, outs[:, :g].reshape(frame_shape))
        acc_c.index_add_(0, flat_idx, outs[:, g:].reshape(frame_shape))
        noise_uncond = acc_u / counts_t
        noise_cond = acc_c / counts_t
        noise_pred = noise_uncond + guidance * (noise_cond - noise_uncond)
        latents = _advance_latents(latents, noise_pred, sigma, sigma_next, i, face_opt)
    return latents


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_frames(models: AnimationModels, latents, cfg: PipelineConfig, mesh=None):
    """Chunked temporal-VAE decode. latents [1, F, h, w, 4] -> frames
    [F, H, W, 3] fp32 in [0, 1] (uint8 when cfg.output_uint8). mesh: each
    rank decodes whole chunks (`_decode_sharded`)."""
    if mesh is not None and mesh.size > 1:
        return _decode_sharded(models, latents, cfg, mesh)
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
    return _to_frames(torch.cat(parts), cfg)


def _to_frames(decoded, cfg: PipelineConfig):
    """The VAE's [-1, 1] output -> frames in [0, 1] (uint8 when asked)."""
    frames = (decoded.float() / 2.0 + 0.5).clamp(0.0, 1.0)
    return output_uint8(frames) if cfg.output_uint8 else frames


def _decode_sharded(models: AnimationModels, latents, cfg: PipelineConfig, mesh):
    """The decode over a mesh: chunk k (of decode_chunk_size frames, the
    last one shorter as in `decode_frames`) on the rank at flat index
    k mod size, each chunk its own VAE call, so every chunk's temporal
    context is local; then every rank's chunks are gathered on every rank
    (padded to whole chunks for the all-gather)."""
    f = latents.shape[1]
    chunk = min(cfg.decode_chunk_size, f)
    starts = list(range(0, f, chunk))
    n, me = mesh.size, mesh.axis_index(AXES)
    z = latents[0] / models.vae.config.scaling_factor
    scale = 2 ** (len(models.vae.config.block_out_channels) - 1)
    per = -(-len(starts) // n)
    buf = torch.zeros((per, chunk, z.shape[1] * scale, z.shape[2] * scale, 3),
                      dtype=module_dtype(models.vae.decoder), device=z.device)
    with use_mesh(None):
        for j, s in enumerate(starts[me::n]):
            k = min(chunk, f - s)
            buf[j, :k] = models.vae.decode(z[s:s + k], num_frames=k)
    parts = Sharding(mesh, (AXES,)).gather(buf[None])          # [size, per, chunk, ...]
    frames = [parts[k % n, k // n, :min(chunk, f - s)] for k, s in enumerate(starts)]
    return _to_frames(torch.cat(frames), cfg)


def _decode_group_size(cfg: PipelineConfig, f: int, h8: int, w8: int) -> int:
    """Frames per dispatched decode group: a multiple of the decode chunk
    sized by `batched_decode_max_latent_volume`."""
    chunk = min(cfg.decode_chunk_size, f)
    return chunk * max(1, cfg.batched_decode_max_latent_volume // max(chunk * h8 * w8, 1))


def _decode_group(models: AnimationModels, latents, start: int, cfg: PipelineConfig,
                  group: int):
    """Decode `group` frames from frame `start`; returns (frames, start +
    group). `group` is a multiple of decode_chunk_size, so the chunk
    boundaries, and with them each chunk's temporal context, are those of
    the one-call decode."""
    return decode_frames(models, latents[:, start:start + group], cfg), start + group


def _decode_dispatched(models: AnimationModels, latents, cfg: PipelineConfig, mesh=None):
    """Decode a long video in groups of `_decode_group_size` frames, each one
    batched VAE call; a short one, or any under a mesh, in one
    `decode_frames`. The frames stay on the device."""
    f = latents.shape[1]
    per = _decode_group_size(cfg, f, latents.shape[2], latents.shape[3])
    if mesh is not None or f <= per:
        return decode_frames(models, latents, cfg, mesh)
    outs, start = [], 0
    while start < f:
        out, start = _decode_group(models, latents, start, cfg, min(per, f - start))
        outs.append(out)
    return torch.cat(outs)


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


def _check_mesh(mesh, device: torch.device) -> None:
    if mesh is not None and mesh.device.type != device.type:
        raise ValueError(f"the mesh runs on {mesh.device}, generate asked for {device}")


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


def _prepare_denoise_state(models: AnimationModels, ref_image, pose_pixels, face_embedding,
                           cfg: PipelineConfig, device: torch.device, *, clip_image=None,
                           aug_noise=None, init_noise=None,
                           generator: torch.Generator | None = None,
                           timings: dict | None = None):
    """Everything before the Euler loop: conditioning, pose latents and the
    initial noise (one tile of noise, repeated over the video; reference
    :586-597). Noises not given are drawn from `generator`, the augmentation
    first. Returns (latents, context, image_latents, add_time_ids,
    pose_latents), the state the denoise loop carries."""
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
    _mark(timings, "pose", t0, device)

    f = pose_pixels.shape[0]
    noise = dev(init_noise).float() * make_schedule(cfg.num_inference_steps).init_noise_sigma
    latents = noise.repeat(1, f // cfg.tile_size + 1, 1, 1, 1)[:, :f]
    return latents, context, image_latents, add_time_ids, pose_latents


def _denoise_segment(models: AnimationModels, latents, context, image_latents, add_time_ids,
                     pose_latents, cfg: PipelineConfig, step_start: int, num_steps: int,
                     face_opt=None, mesh=None):
    """`num_steps` Euler steps from schedule index `step_start`; returns
    (latents, step_start + num_steps)."""
    schedule = make_schedule(cfg.num_inference_steps, SchedulerConfig(), device=latents.device)
    latents = denoise(models, latents, context, image_latents, add_time_ids, pose_latents,
                      schedule, cfg, step_start=step_start, num_steps=num_steps,
                      face_opt=face_opt, mesh=mesh)
    return latents, step_start + num_steps


def _generate_segmented(models: AnimationModels, state, cfg: PipelineConfig, spd: int,
                        device: torch.device, progress=None, timings: dict | None = None,
                        face_opt=None, mesh=None):
    """The Euler loop of `state` (from `_prepare_denoise_state`) in segments
    of `spd` steps, then `_decode_dispatched`. progress: optional
    callable(done_steps, total_steps), called after each segment is
    dispatched (the card may still be running it)."""
    latents, context, image_latents, add_time_ids, pose_latents = state
    t0 = _mark(timings, None, 0.0, device)
    n = cfg.num_inference_steps
    done = 0
    while done < n:
        latents, done = _denoise_segment(models, latents, context, image_latents, add_time_ids,
                                         pose_latents, cfg, done, min(spd, n - done), face_opt,
                                         mesh)
        if progress is not None:
            progress(done, n)
    t0 = _mark(timings, "denoise", t0, device)
    frames = _decode_dispatched(models, latents, cfg, mesh)
    _mark(timings, "decode", t0, device)
    return frames


def resolve_steps_per_dispatch(cfg: PipelineConfig, face_opt_active: bool = False) -> int | None:
    """The `PipelineConfig.steps_per_dispatch` "auto" policy (the JAX
    package's): None (one stretch, the flat path) for videos of at most 4
    tiles; past that, segments of max(1, min(5, budget // slots)) steps,
    where slots is the tile slots per step (tiles padded to whole groups)
    and the budget is 30 slots, 15 with face optimisation. An explicit
    value wins."""
    spd = cfg.steps_per_dispatch
    if spd != "auto":
        return spd
    if cfg.num_frames <= cfg.tile_size:
        return None
    n_tiles = tile_indices(cfg.num_frames, cfg.tile_size, cfg.tile_overlap).shape[0]
    if n_tiles <= 4:
        return None
    mtb = (auto_tile_batch(cfg.num_frames, cfg.tile_size, cfg.tile_overlap)
           if cfg.max_tile_batch == "auto" else cfg.max_tile_batch)
    slots_per_step = (-(-n_tiles // mtb) * mtb) if mtb else n_tiles
    budget = 15 if face_opt_active else 30
    return max(1, min(5, budget // slots_per_step))


@torch.inference_mode()
def generate(models: AnimationModels, ref_image, pose_pixels, face_embedding,
             cfg: PipelineConfig | None = None, *, clip_image=None, aug_noise=None,
             init_noise=None, generator: torch.Generator | None = None,
             face_opt=None, mesh=None, device: torch.device | str = "cuda",
             timings: dict | None = None, progress=None):
    """Generate an animation on one device, or on this rank of `mesh`.

    ref_image:      [1, H, W, 3] fp32 in [0, 1], or uint8
    pose_pixels:    [F, H, W, 3] fp32 in [-1, 1], or uint8
    face_embedding: [1, id_dim] ArcFace embedding
    clip_image:     optional [1, H0, W0, 3] for the CLIP branch
    aug_noise:      optional [1, H, W, 3] standard-normal noise augmentation
    init_noise:     optional [1, tile, H/8, W/8, 4] standard-normal initial
                    tile noise (scaled by the init sigma here)
    generator:      draws the noises not given; default a generator on the
                    device seeded 23123134
    face_opt:       optional pipeline.face_opt.FaceOptimizer: the HJB identity
                    refinement of x0_hat at every Euler update (it also
                    halves the segmented path's step budget)
    mesh:           optional parallel.mesh.Mesh: every rank of it calls
                    generate with the same inputs and models
                    (parallel.shard_params makes the weights equal) and
                    gets the same frames
    timings:        optional dict that receives seconds per phase
                    (conditioning, pose, denoise, decode)
    progress:       optional callable(done_steps, total_steps), called after
                    each segment when `resolve_steps_per_dispatch` sends the
                    request to the segmented path (past 4 tiles by default)
    returns frames  [F, H, W, 3] fp32 in [0, 1] (uint8 with cfg.output_uint8),
                    on the device
    """
    device = resolve_device(device)
    models_device = next(models.unet.parameters()).device
    if models_device.type != device.type:
        raise ValueError(f"models are on {models_device}, generate asked for {device}")
    cfg = cfg or PipelineConfig()
    f = pose_pixels.shape[0]
    cfg = dataclasses.replace(cfg, height=ref_image.shape[1], width=ref_image.shape[2],
                              num_frames=f, tile_size=min(cfg.tile_size, f))
    _check_mesh(mesh, device)
    spd = resolve_steps_per_dispatch(cfg, face_opt is not None)
    with use_mesh(mesh):
        state = _prepare_denoise_state(models, ref_image, pose_pixels, face_embedding, cfg,
                                       device, clip_image=clip_image, aug_noise=aug_noise,
                                       init_noise=init_noise, generator=generator,
                                       timings=timings)
        if spd is not None:
            return _generate_segmented(models, state, cfg, spd, device, progress, timings,
                                       face_opt, mesh)
        t0 = _mark(timings, None, 0.0, device)
        schedule = make_schedule(cfg.num_inference_steps, SchedulerConfig(), device=device)
        latents = denoise(models, *state, schedule, cfg, face_opt=face_opt, mesh=mesh)
        t0 = _mark(timings, "denoise", t0, device)
        frames = decode_frames(models, latents, cfg, mesh)
        _mark(timings, "decode", t0, device)
        return frames


def _build_forward_kernels() -> list[str]:
    """Build the flash-attention forward kernels a request may launch: the
    streamed one, and the resident one when its budget is set. Returns
    their names."""
    names = [fa.KERNEL_NAME] + ([fa.RESIDENT_KERNEL] if fa.resident_kv_budget() > 0 else [])
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:   # one nvcc each
        list(pool.map(build.build_kernel, names))
    return names


@torch.inference_mode()
def warm_generate(models: AnimationModels, cfg: PipelineConfig, *,
                  device: torch.device | str = "cuda", uint8_inputs: bool = True,
                  clip_shape=None, execute: bool | str = "auto", face_opt=None, mesh=None):
    """Prepare everything `generate` will need for `cfg` before the real
    inputs exist, so that the caller's preprocessing overlaps it (run it on
    a thread). cfg must carry the real height, width and num_frames.

    On the card it builds the forward kernels the request may launch
    (`_build_forward_kernels`, nvcc on first use). PyTorch compiles no
    programs, so the JAX package's compile step has nothing to do here; what
    remains is its plan: `programs` counts the JAX package's programs for
    this request (prep, each distinct segment length, each distinct decode
    group size; 1 for the flat path).

    execute: "auto" or True run that plan once on zero inputs on the
      segmented path (prep, one segment of each distinct length, one decode
      group of each distinct size), which warms the allocator and the
      libraries' kernel choices; False does not. The flat path never
      executes.

    face_opt: optional FaceOptimizer (built with placeholder boxes before
      the poses exist; `with_boxes` swaps the real ones in): the plan of a
      face-opt request, whose segments are half as long, executed through
      its refinement.

    mesh: the mesh `generate` will run on; the execution runs on it (every
      rank calls warm_generate), and the decode is then one sharded call.

    Returns {"path", "programs", "executed", "face_opt"}, as the JAX
    package's does."""
    device = resolve_device(device)
    _check_mesh(mesh, device)
    if device.type == "cuda":
        _build_forward_kernels()
    cfg = dataclasses.replace(cfg, tile_size=min(cfg.tile_size, cfg.num_frames))
    spd = resolve_steps_per_dispatch(cfg, face_opt is not None)
    if spd is None:
        return {"path": "flat", "programs": 1, "executed": False,
                "face_opt": face_opt is not None}

    h, w, f = cfg.height, cfg.width, cfg.num_frames
    n = cfg.num_inference_steps
    seg_lengths = sorted({min(spd, n)} | ({n % spd} if n % spd else set()), reverse=True)
    per = _decode_group_size(cfg, f, h // 8, w // 8)
    group_sizes = ([f] if f <= per or mesh is not None else
                   sorted({per} | ({f % per} if f % per else set()), reverse=True))
    programs = 1 + len(seg_lengths) + len(group_sizes)
    do_exec = execute in ("auto", True)
    if do_exec:
        dt = torch.uint8 if uint8_inputs else torch.float32
        emb_dim = models.face_encoder.config.id_embeddings_dim
        clip = None if clip_shape is None else torch.zeros((1, *clip_shape, 3), dtype=dt,
                                                           device=device)
        state = _prepare_denoise_state(
            models, torch.zeros((1, h, w, 3), dtype=dt, device=device),
            torch.zeros((f, h, w, 3), dtype=dt, device=device),
            torch.zeros((1, emb_dim), device=device), cfg, device, clip_image=clip,
            aug_noise=torch.zeros((1, h, w, 3), device=device),
            init_noise=torch.zeros((1, cfg.tile_size, h // 8, w // 8, 4), device=device))
        latents = state[0]
        with use_mesh(mesh):
            for k in seg_lengths:
                latents, _ = _denoise_segment(models, latents, *state[1:], cfg, 0, k, face_opt,
                                              mesh)
            for g in group_sizes:
                decode_frames(models, latents[:, :g], cfg, mesh)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return {"path": "segmented", "programs": programs, "executed": bool(do_exec),
            "face_opt": face_opt is not None}


def output_uint8(frames: torch.Tensor) -> torch.Tensor:
    """[0, 1] fp32 frames -> uint8 with round-half-up (the on-device form of
    the JAX package's utils/image.py::frames_to_uint8)."""
    return (frames.float() * 255.0 + 0.5).clamp(0.0, 255.0).to(torch.uint8)
