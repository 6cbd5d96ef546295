"""Plain PyTorch reference of a StableAnimator request and training step.

Written from the published method (SVD-XT's EDM Euler sampler with
classifier-free guidance, the reference's `command_basic_infer.sh` and
`command_train.sh` settings), in float32, against `models.py`. It takes
the benchmark's inputs and weights and recomputes everything else itself:
the CLIP resize, the conditioning, the sigma schedule, the temporal tiles,
the pose latents, the decode, the loss, the gradient and the AdamW update.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def strict_float32() -> None:
    """float32 products and convolutions in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------------------
# conditioning
# --------------------------------------------------------------------------

def _gaussian(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float64) - size // 2
    if size % 2 == 0:
        x = x + 0.5
    g = torch.exp(-x ** 2 / (2.0 * sigma ** 2))
    return (g / g.sum()).float().to(device)


def clip_resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """[N, H, W, 3] in [-1, 1] -> [N, size, size, 3]: a gaussian blur of
    sigma (factor - 1) / 2 (reflect padding), then a bicubic (a = -0.75)
    resize with aligned corners."""
    n, h, w, c = x.shape
    y = x.permute(0, 3, 1, 2)
    for axis, factor in ((3, w / size), (2, h / size)):
        sigma = max((factor - 1.0) / 2.0, 0.001)
        k = int(max(4.0 * sigma, 3))
        k += 1 - k % 2
        g = _gaussian(k, sigma, x.device)
        pad = ((k - 1) // 2, k - 1 - (k - 1) // 2)
        if axis == 3:
            y = F.conv2d(F.pad(y, (*pad, 0, 0), mode="reflect"), g.view(1, 1, 1, k).expand(c, 1, 1, k),
                         groups=c)
        else:
            y = F.conv2d(F.pad(y, (0, 0, *pad), mode="reflect"), g.view(1, 1, k, 1).expand(c, 1, k, 1),
                         groups=c)
    y = F.interpolate(y, size=(size, size), mode="bicubic", align_corners=True)
    return y.permute(0, 2, 3, 1)


def clip_embed(models: dict, ref01: torch.Tensor) -> torch.Tensor:
    """The CLIP image embedding [N, 1, D] of [N, H, W, 3] images in [0, 1]."""
    size = models["clip"].cfg["image_size"]
    x = (clip_resize(ref01 * 2.0 - 1.0, size) + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return models["clip"]((x - mean) / std)[:, None]


def conditioning(models: dict, ref01, face_embed, aug_noise, noise_aug: float):
    """(context [1, 1 + num_id, D], reference latent [1, h, w, 4]) of the
    conditioned stream: CLIP token + face tokens, and the posterior mode of
    the noise-augmented reference image."""
    emb = clip_embed(models, ref01)
    context = torch.cat([emb, models["face_encoder"](face_embed, emb)], dim=1)
    latent, _ = models["vae"].encode(ref01 * 2.0 - 1.0 + noise_aug * aug_noise)
    return context, latent


# --------------------------------------------------------------------------
# sampling
# --------------------------------------------------------------------------

def karras_sigmas(steps: int, sched: dict) -> list[float]:
    """EDM's rho-spaced sigmas from sigma_max to sigma_min, then 0."""
    lo, hi, rho = sched["sigma_min"] ** (1 / sched["rho"]), sched["sigma_max"] ** (1 / sched["rho"]), \
        sched["rho"]
    s = [(hi + i / (steps - 1) * (lo - hi)) ** rho for i in range(steps)]
    return [float(np.float32(v)) for v in s] + [0.0]


def temporal_tiles(frames: int, tile: int, overlap: int) -> list[list[int]]:
    """Windows of `tile` frames at stride tile - overlap whose first frame
    is frame 0 (the anchor), and a last window ending at the last frame."""
    tiles = [[0, *range(i + 1, min(i + tile, frames))]
             for i in range(0, frames - tile + 1, tile - overlap)]
    if tiles[-1][-1] < frames - 1:
        tiles.append([0, *range(frames - tile + 1, frames)])
    return tiles


def triangle(tile: int) -> torch.Tensor:
    w = (torch.arange(tile, dtype=torch.float32) + 0.5) * 2.0 / tile
    return torch.minimum(w, 2.0 - w)


def generate(models: dict, ref01, pose_sym, face_embed, aug_noise, init_noise, traffic: dict,
             sched: dict) -> torch.Tensor:
    """One request: frames [F, H, W, 3] in [0, 1], float32.

    ref01 [1, H, W, 3] in [0, 1]; pose_sym [F, H, W, 3] in [-1, 1];
    face_embed [1, id_dim]; aug_noise [1, H, W, 3]; init_noise
    [1, tile, H/8, W/8, 4] standard normal."""
    dev = ref01.device
    f = pose_sym.shape[0]
    tile = min(traffic["tile_size"], f)
    steps = traffic["num_inference_steps"]
    scale = traffic["min_guidance_scale"], traffic["max_guidance_scale"]
    context, ref_lat = conditioning(models, ref01, face_embed, aug_noise, traffic["noise_aug_strength"])
    pose = models["pose_net"](pose_sym)
    ids = torch.tensor([[traffic["fps"] - 1, traffic["motion_bucket_id"],
                         traffic["noise_aug_strength"]]], device=dev)
    sigmas = karras_sigmas(steps, sched)
    latents = init_noise.repeat(1, f // tile + 1, 1, 1, 1)[:, :f] * math.sqrt(sched["sigma_max"] ** 2 + 1)
    tiles = temporal_tiles(f, tile, traffic["tile_overlap"])
    w = triangle(tile).to(dev)
    counts = torch.zeros(f, device=dev)
    for t in tiles:
        counts[t] += w
    guidance = torch.linspace(scale[0], scale[1], f, device=dev)[:, None, None, None]
    for i in range(steps):
        sigma, nxt = sigmas[i], sigmas[i + 1]
        x = latents[0] / math.sqrt(sigma ** 2 + 1.0)
        timestep = torch.tensor(0.25 * math.log(sigma), device=dev)
        pred = {}
        for stream in ("uncond", "cond"):
            acc = torch.zeros_like(latents[0])
            for t in tiles:
                xt = x[t]
                if stream == "cond":
                    inp = torch.cat([xt, ref_lat.expand(len(t), -1, -1, -1)], dim=-1)
                    out = models["unet"](inp[None], timestep, context, ids, pose[t])[0]
                else:
                    inp = torch.cat([xt, torch.zeros_like(xt)], dim=-1)
                    out = models["unet"](inp[None], timestep, torch.zeros_like(context), ids,
                                         torch.zeros_like(pose[t]))[0]
                acc.index_add_(0, torch.tensor(t, device=dev), out * w[:, None, None, None])
            pred[stream] = acc / counts[:, None, None, None]
        v = pred["uncond"] + guidance * (pred["cond"] - pred["uncond"])
        x0 = -sigma / math.sqrt(sigma ** 2 + 1.0) * v[None] + latents / (sigma ** 2 + 1.0)
        latents = latents + (latents - x0) / sigma * (nxt - sigma)
    return decode(models, latents[0], traffic["decode_chunk_size"])


def decode(models: dict, latents, chunk: int) -> torch.Tensor:
    """latents [F, h, w, 4] -> frames [F, H, W, 3] in [0, 1]: the temporal
    decoder over consecutive chunks of `chunk` frames, each a video of its
    own."""
    z = latents / models["vae"].scaling_factor
    f = z.shape[0]
    chunk = min(chunk, f)
    outs = [models["vae"].decode(z[s:s + chunk], num_frames=min(chunk, f - s))
            for s in range(0, f, chunk)]
    return (torch.cat(outs) / 2.0 + 0.5).clamp(0.0, 1.0)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def train_loss(models: dict, batch: dict, noises: dict, traffic: dict, train: dict,
               encode_chunk: int = 4) -> torch.Tensor:
    """The EDM face-weighted reconstruction loss of one batch (v-prediction,
    sigma_data 1), with conditioning dropout by `noises["keep"]`.

    batch: frames [B, F, H, W, 3] in [-1, 1], ref_image [B, H, W, 3] in
    [0, 1], pose_pixels [B, F, H, W, 3] in [-1, 1], face_embed [B, id],
    face_mask [B, F, H, W, 1]; noises: eps0 [B*F, h, w, 4], ref_aug
    [B, H, W, 3], keep [B], sigmas [B], noise [B, F, h, w, 4]."""
    vae, scale = models["vae"], models["vae"].scaling_factor
    frames = batch["frames"]
    b, f, hh, ww, _ = frames.shape
    h8, w8 = hh // 8, ww // 8
    with torch.no_grad():
        flat = frames.reshape(b * f, hh, ww, 3)
        moments = [vae.encode(flat[i:i + encode_chunk]) for i in range(0, b * f, encode_chunk)]
        mean = torch.cat([m for m, _ in moments])
        logvar = torch.cat([lv for _, lv in moments])
        x0 = ((mean + torch.exp(0.5 * logvar) * noises["eps0"]) * scale).reshape(b, f, h8, w8, -1)
        ref_lat, _ = vae.encode(batch["ref_image"] * 2.0 - 1.0
                                + traffic["noise_aug_strength"] * noises["ref_aug"])
        emb = clip_embed(models, batch["ref_image"])
    context = torch.cat([emb, models["face_encoder"](batch["face_embed"], emb)], dim=1)
    pose = models["pose_net"](batch["pose_pixels"].reshape(b * f, hh, ww, 3))
    keep = noises["keep"]
    context = context * keep[:, None, None]
    ref_lat = ref_lat * keep[:, None, None, None]
    pose = pose * keep.repeat_interleave(f)[:, None, None, None]
    sig = noises["sigmas"][:, None, None, None, None]
    x_t = x0 + sig * noises["noise"]
    inp = torch.cat([x_t / torch.sqrt(sig ** 2 + 1.0),
                     ref_lat[:, None].expand(b, f, h8, w8, ref_lat.shape[-1])], dim=-1)
    ids = torch.tensor([[traffic["fps"] - 1, traffic["motion_bucket_id"],
                         traffic["noise_aug_strength"]]], device=frames.device).expand(b, 3)
    v = models["unet"](inp, 0.25 * torch.log(noises["sigmas"]), context, ids, pose)
    x0_hat = -sig / torch.sqrt(sig ** 2 + 1.0) * v + x_t / (sig ** 2 + 1.0)
    lam = (1.0 + sig ** 2) / sig ** 2
    # the face mask at latent resolution: pixel (8i + 4, 8j + 4)
    mask = batch["face_mask"][:, :, 4::8, 4::8]
    return torch.mean(lam * (1.0 + train["face_loss_weight"] * mask) * (x0_hat - x0) ** 2)


class AdamW:
    """Global-norm clipping (scale max_norm / norm when norm >= max_norm),
    then AdamW with decoupled weight decay at the warm-up learning rate
    lr * update / warmup, over float32 parameters."""

    def __init__(self, params: list[torch.Tensor], train: dict):
        self.params, self.t = params, train
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.updates = 0

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """Apply one update; returns the clipped gradients."""
        t = self.t
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        clip = torch.where(norm < t["max_grad_norm"], torch.ones_like(norm), t["max_grad_norm"] / norm)
        lr = t["learning_rate"] * min(1.0, self.updates / t["lr_warmup_steps"])
        b1, b2 = t["adam_beta1"], t["adam_beta2"]
        n = self.updates + 1
        clipped = []
        for p, m, v, g in zip(self.params, self.m, self.v, grads):
            g = g * clip
            clipped.append(g)
            p.mul_(1.0 - lr * t["adam_weight_decay"])
            m.mul_(b1).add_((1.0 - b1) * g)
            v.mul_(b2).add_((1.0 - b2) * g * g)
            denom = torch.sqrt(v / (1.0 - b2 ** n)) + t["adam_epsilon"]
            p.sub_(lr * (m / (1.0 - b1 ** n)) / denom)
        self.updates += 1
        return clipped
