"""The inputs of a run, made on the device from (--seed, stream, index):
the same seed gives the same inputs, request by request and step by step.

A request is what the CLI and the server hand to `generate`: a reference
image and pose frames as uint8 pixels, an ArcFace embedding, and the two
noises (the reference's augmentation and the initial tile noise). A
training step takes a clip in `train/data.py`'s layout (frames and poses in
[-1, 1], the reference frame in [0, 1], a face mask) and the step's five
random draws. The clip is a shot in which the subject walks up to the
camera: frame by frame the person and the face grow, from a wide shot (the
face box 0.3 % of the frame) to a close-up (about 75 %), as the face masks
of a dolly-in shot do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.common import stream_seed


def _gen(seed: int, stream: str, index: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream, index))


def request(seed: int, index: int, height: int, width: int, frames: int, tile: int,
            id_dim: int, device) -> dict:
    """Request `index` of a run: ref [1, H, W, 3] uint8, pose [F, H, W, 3]
    uint8, face [1, id_dim], aug [1, H, W, 3], init [1, tile, H/8, W/8, 4]."""
    g = _gen(seed, "request", index, device)
    u8 = dict(dtype=torch.uint8, device=device, generator=g)
    return {
        "ref": torch.randint(0, 256, (1, height, width, 3), **u8),
        "pose": torch.randint(0, 256, (frames, height, width, 3), **u8),
        "face": torch.randn((1, id_dim), generator=g, device=device),
        "aug": torch.randn((1, height, width, 3), generator=g, device=device),
        "init": torch.randn((1, tile, height // 8, width // 8, 4), generator=g, device=device),
    }


def _field(g, height: int, width: int, octaves, device) -> torch.Tensor:
    """A smooth random colour field [1, 3, H, W] of unit rms: for each
    (cells, amplitude) of `octaves`, Gaussian noise on a grid of that many
    cells a side, upsampled bicubically."""
    out = torch.zeros((1, 3, height, width), device=device)
    for cells, amp in octaves:
        coarse = torch.randn((1, 3, cells, max(1, cells * width // height)), generator=g,
                             device=device)
        out += amp * F.interpolate(coarse, size=(height, width), mode="bicubic",
                                   align_corners=False)
    return out / out.std()


def clip(seed: int, index: int, height: int, width: int, frames: int,
         device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(frames [1, F, H, W, 3] in [-1, 1], pose renderings [1, F, H, W, 3]
    in [-1, 1], face mask [1, F, H, W, 1]) of clip `index`: the subject
    walks up to the camera. Frame f at t = f / (F - 1): the face box at a
    centre drawn within 0.15 of the frame's, half-width 0.05 + 0.75 t and
    half-height 1.2 times that (in units of half the frame); the person an
    ellipse under it, 1.6 by 3.4 half-widths; a fine texture on the
    person over a smooth background; the skeleton thin lines of the person
    on black."""
    g = _gen(seed, "clip", index, device)
    t = torch.linspace(0.0, 1.0, frames, device=device).view(frames, 1, 1, 1)
    ys = torch.linspace(-1.0, 1.0, height, device=device).view(1, 1, height, 1)
    xs = torch.linspace(-1.0, 1.0, width, device=device).view(1, 1, 1, width)
    cx, cy = ((torch.rand(2, generator=g, device=device) - 0.5) * 0.3).tolist()
    half = 0.05 + 0.75 * t
    face = ((xs - cx).abs() < half) & ((ys - cy).abs() < 1.2 * half)
    person = ((xs - cx) / (1.6 * half)) ** 2 + ((ys - cy - 2.2 * half) / (3.4 * half)) ** 2 < 1.0
    person = (person | face).float()
    scale = min(height, width)
    background = _field(g, height, width, ((4, 1.0), (16, 0.5)), device)
    texture = _field(g, height, width, ((scale // 8, 1.0), (scale // 2, 0.7)), device)
    limbs = _field(g, height, width, ((scale // 16, 1.0), (scale // 4, 0.5)), device)
    video = torch.tanh(background * (1.0 - person) + 1.5 * texture * person)
    line = (limbs.abs() < 0.15) & (person > 0)
    pose = torch.where(line, torch.tanh(2.0 * limbs.sign() + limbs), -1.0)

    def layout(x):
        return x.permute(0, 2, 3, 1).unsqueeze(0).contiguous()
    return layout(video), layout(pose), layout(face.float())


def train_step(seed: int, index: int, height: int, width: int, frames: int, id_dim: int,
               latent_channels: int, dropout: float, sched: dict, device) -> tuple[dict, dict]:
    """(batch, draws) of training step `index`: its clip (`clip`), the
    clip's first frame as the reference image, and the step's draws (eps0,
    ref_aug, keep, sigmas, noise)."""
    video, pose, mask = clip(seed, index, height, width, frames, device)
    g = _gen(seed, "step", index, device)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)

    batch = {"frames": video, "ref_image": video[:, 0] * 0.5 + 0.5, "pose_pixels": pose,
             "face_embed": normal(1, id_dim), "face_mask": mask}
    h8, w8 = height // 8, width // 8
    draws = {"eps0": normal(frames, h8, w8, latent_channels),
             "ref_aug": normal(1, height, width, 3),
             "keep": (torch.rand((1,), generator=g, device=device) < 1.0 - dropout).float(),
             "sigmas": torch.exp(sched["p_mean"] + sched["p_std"] * normal(1)),
             "noise": normal(1, frames, h8, w8, latent_channels)}
    return batch, draws
