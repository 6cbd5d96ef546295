"""Pose-conditioned SVD finetuning: the EDM loss and the training step (port
of the JAX package's `train/train_step.py`).

The training contract (command_train.sh:1-21, README.md:285-363): 16-frame
clips, EDM noising, a face-masked reconstruction loss, trainable
{unet, pose_net, face_encoder} over frozen {vae, clip}, AdamW at lr 1e-5
with a 500-step linear warm-up, global-norm clipping at 1.0, gradient
accumulation, bf16 mixed precision.

Loss (EDM, sigma_data = 1):
  sigma ~ exp(N(p_mean, p_std)); x_t = x0 + sigma eps
  x0_hat = c_skip x_t + c_out F(c_in x_t, c_noise)   (v-prediction)
  L = mean(lambda(sigma) * w_face * (x0_hat - x0)^2), lambda = (1 + sigma^2) / sigma^2
  w_face = 1 + face_loss_weight * mask (the face mask at latent resolution).
Conditioning dropout zeroes the CLIP/face context, the reference latent and
the pose latents per sample, so classifier-free guidance works at inference.

Mixed precision as Flax runs it (bf16 compute over fp32 parameters): the
optimizer holds fp32 master copies of the trainable parameters; the models
hold them in the compute dtype (`cast_models`), copied from the masters
after every update. Gradients arrive in the compute dtype and are upcast to
fp32 before anything else.

The optimizer is optax's chain, written out: `clip_by_global_norm`
(scale by max_norm / norm only when norm >= max_norm, no epsilon), then
AdamW (`torch.optim.AdamW`, whose weight decay is multiplied by the
scheduled lr as optax's is), with lr from the warm-up schedule at the count
of updates so far (0 at update 0). `gradient_accumulation_steps` k > 1 is
`optax.MultiSteps`: the raw gradients' running mean over k calls, one update
and one schedule tick on every k-th call, `step` counting every call.

Random draws: the JAX step takes five from one key (the VAE posterior
sample eps0, the reference image's noise augmentation, the dropout keep
mask, the sigmas' normal draw, the latent noise). `noises` hands them over
(the tests pass JAX's own); otherwise they come from `generator`.

The (data, frame) mesh (`mesh`, parallel/mesh.py; the JAX package's step
takes any mesh, its CLI trains over data only, and so does the port's): every
rank runs its rows of the global batch ("data") and its block of each
clip's frames ("frame"; `shard_batch`), with its part of the global batch's
draws: eps0 and the latent noise by rows and frames, the reference's noise,
the dropout mask and the sigmas by rows. The per-clip conditioning (CLIP,
the face tokens, the reference latent) is computed alike on every frame
rank; the UNet's frame collectives (`parallel/sequence.py`) carry their
cross-rank terms in the forward and, as their transposes, in the backward.
Each rank's loss is the mean over its block; since the blocks are equal,
the global loss is their mean over the mesh, and so is the gradient: the
gradients and the loss are mean-reduced over (data, frame) before anything
else, and every rank then holds the same gradients, masters and models, so
the step is the one-device step on the global batch. ZeRO-1
(`create_train_state(mesh=)`): AdamW keeps moments for, and updates, this
rank's block of each master only, split over (data, frame)
(`parallel.shard_optimizer_state`); the blocks are then all-gathered into
the full masters.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from stableanimator_tpu_torch.core import trace
from stableanimator_tpu_torch.core.config import PipelineConfig, SchedulerConfig, TrainConfig
from stableanimator_tpu_torch.diffusion.scheduler import (
    edm_loss_weight,
    sample_sigmas_lognormal,
    timestep_of_sigma,
)
from stableanimator_tpu_torch.models.clip import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
from stableanimator_tpu_torch.ops.gate import use_mesh
from stableanimator_tpu_torch.ops.resize import resize_antialias
from stableanimator_tpu_torch.parallel.mesh import (
    AXES,
    DATA_AXIS,
    FRAME_AXIS,
    all_reduce_mean,
    batch_sharding,
    gather_masters,
    shard_optimizer_state,
    video_sharding,
    zero_sharding_for,
)
from stableanimator_tpu_torch.pipeline.animation import AnimationModels, cast_models

DEFAULT_TRAINABLE = ("unet", "pose_net", "face_encoder")
NOISE_KEYS = ("eps0", "ref_aug", "keep", "sigmas", "noise")
# the batch's [B, F, ...] leaves, split over (data, frame) under a mesh; the
# others are per clip, split over data
VIDEO_KEYS = ("frames", "pose_pixels", "face_mask")


def lr_at(cfg: TrainConfig, update: int) -> float:
    """The learning rate of update number `update` (counting from 0):
    optax.join_schedules([linear_schedule(0, lr, W), constant(lr)], [W])."""
    w = cfg.lr_warmup_steps
    return cfg.learning_rate if update >= w else cfg.learning_rate * update / w


def make_optimizer(masters: list[torch.Tensor], cfg: TrainConfig) -> torch.optim.AdamW:
    """AdamW over the fp32 master parameters (or this rank's blocks of
    them); the lr is set per update."""
    return torch.optim.AdamW(masters, lr=lr_at(cfg, 0), betas=(cfg.adam_beta1, cfg.adam_beta2),
                             eps=cfg.adam_epsilon, weight_decay=cfg.adam_weight_decay)


@dataclasses.dataclass
class TrainState:
    """What the training step carries from call to call."""

    step: int                        # train-step calls so far
    trainable: tuple[str, ...]       # which of the five models are trained
    names: list[str]                 # "unet.conv_in.weight", ... in optimizer order
    params: list[nn.Parameter]       # the models' trainable parameters (compute dtype)
    masters: list[torch.Tensor]      # their fp32 masters, which the optimizer updates
    optimizer: torch.optim.AdamW
    updates: int = 0                 # optimizer updates applied (the schedule's count)
    mini_step: int = 0               # calls into the current accumulation window
    grad_acc: list[torch.Tensor] | None = None   # the window's running mean gradient
    mesh: object = None              # ZeRO-1 over (data, frame) (the optimizer holds blocks)

    def _zero(self):
        """Each master's ZeRO-1 sharding, or None without a mesh."""
        if self.mesh is None:
            return None
        return [zero_sharding_for(m, self.mesh, AXES) for m in self.masters]

    def master_state_dicts(self) -> dict[str, dict[str, torch.Tensor]]:
        """The fp32 masters as one state dict per trained model."""
        out: dict[str, dict[str, torch.Tensor]] = {k: {} for k in self.trainable}
        for name, m in zip(self.names, self.masters):
            model, key = name.split(".", 1)
            out[model][key] = m
        return out

    def state_dict(self) -> dict:
        """The one-device format under any mesh: ZeRO-1's moment blocks are
        gathered into whole moments (a collective: every rank calls it and
        gets the same dict), so a checkpoint resumes under any world size."""
        opt = self.optimizer.state_dict()
        zero = self._zero()
        if zero is not None:
            opt["state"] = {i: {k: (zero[i].gather(v) if k in ("exp_avg", "exp_avg_sq") else v)
                                for k, v in st.items()} for i, st in opt["state"].items()}
        return {"step": self.step, "updates": self.updates, "mini_step": self.mini_step,
                "trainable": list(self.trainable),
                "masters": dict(zip(self.names, self.masters)),
                "optimizer": opt,
                "grad_acc": (dict(zip(self.names, self.grad_acc))
                             if self.grad_acc is not None else None)}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        if tuple(sd["trainable"]) != self.trainable:
            raise ValueError(f"checkpoint trains {sd['trainable']}, this run {self.trainable}")
        for name, m in zip(self.names, self.masters):
            m.copy_(sd["masters"][name])
        opt = sd["optimizer"]
        zero = self._zero()
        if zero is not None:          # this rank's blocks of the whole moments
            opt = dict(opt, state={
                int(i): {k: (zero[int(i)].local(v.to(self.masters[int(i)].device)).clone()
                             if k in ("exp_avg", "exp_avg_sq") else v) for k, v in st.items()}
                for i, st in opt["state"].items()})
        self.optimizer.load_state_dict(opt)
        self.step, self.updates, self.mini_step = sd["step"], sd["updates"], sd["mini_step"]
        self.grad_acc = ([sd["grad_acc"][n].to(m.device) for n, m in zip(self.names, self.masters)]
                         if sd["grad_acc"] is not None else None)
        _copy_masters(self)


def create_train_state(models: AnimationModels, cfg: TrainConfig,
                       trainable_keys=DEFAULT_TRAINABLE, mesh=None) -> TrainState:
    """Keep fp32 masters of the trainable models' parameters (build the
    models in fp32 to keep a checkpoint's full precision), store the models
    in the compute dtype (bf16 for mixed_precision "bf16", else fp32), and
    set requires_grad on the trainable parameters only. mesh: ZeRO-1 over
    its (data, frame) ranks (the optimizer over this rank's blocks of the
    masters; with frame 1, the data axis's split)."""
    trainable = tuple(trainable_keys)
    unknown = set(trainable) - set(AnimationModels._fields)
    if unknown:
        raise ValueError(f"unknown trainable modules {sorted(unknown)}")
    names, masters = [], []
    for key in trainable:
        for n, p in getattr(models, key).named_parameters():
            names.append(f"{key}.{n}")
            masters.append(p.detach().float().clone())
    cast_models(models, torch.bfloat16 if cfg.mixed_precision == "bf16" else torch.float32)
    for key in AnimationModels._fields:
        getattr(models, key).requires_grad_(key in trainable)
    params = [p for key in trainable for p in getattr(models, key).parameters()]
    held = masters if mesh is None else shard_optimizer_state(masters, mesh, AXES)
    return TrainState(0, trainable, names, params, masters, make_optimizer(held, cfg), mesh=mesh)


def _autograd_for(module: nn.Module):
    """no_grad for a frozen module, a no-op for a trained one."""
    if any(p.requires_grad for p in module.parameters()):
        return contextlib.nullcontext()
    return torch.no_grad()


def _encode_context(models: AnimationModels, ref_image, face_embedding):
    """CLIP + face tokens for the conditioned stream: [B, 1 + num_id, D]."""
    size = models.clip.config.image_size
    x = (resize_antialias(ref_image * 2.0 - 1.0, size, size) + 1.0) / 2.0
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=x.dtype, device=x.device)
    with _autograd_for(models.clip):
        clip_embed = models.clip((x - mean) / std)[:, None, :].float()
    faceid = models.face_encoder(face_embedding.float(), clip_embed).float()
    return torch.cat([clip_embed, faceid], dim=1)


def draw_noises(batch: dict, latent_channels: int, conditioning_dropout_prob: float,
                sched: SchedulerConfig, generator: torch.Generator | None,
                batch_size: int | None = None, num_frames: int | None = None) -> dict:
    """The step's five random draws (see the module docstring), for
    `batch_size` clips of `num_frames` frames (default the batch's)."""
    b, f, hh, ww, _ = batch["frames"].shape
    b, f = batch_size or b, num_frames or f
    dev = batch["frames"].device

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    return {
        "eps0": randn(b * f, hh // 8, ww // 8, latent_channels),
        "ref_aug": randn(b, hh, ww, 3),
        "keep": (torch.rand((b,), generator=generator, device=dev)
                 < 1.0 - conditioning_dropout_prob).float(),
        "sigmas": sample_sigmas_lognormal((b,), sched, generator=generator, device=dev),
        "noise": randn(b, f, hh // 8, ww // 8, latent_channels),
    }


def train_loss(models: AnimationModels, batch: dict, cfg: TrainConfig, pipe: PipelineConfig,
               sched: SchedulerConfig | None = None, conditioning_dropout_prob: float = 0.1,
               encode_chunk: int = 4, noises: dict | None = None,
               generator: torch.Generator | None = None, timings: dict | None = None):
    """EDM face-masked reconstruction loss (a scalar fp32 tensor).

    batch (fp32 tensors on the models' device, channels-last):
      frames      [B, F, H, W, 3] in [-1, 1]   target clip
      ref_image   [B, H, W, 3]    in [0, 1]    reference frame
      pose_pixels [B, F, H, W, 3] in [-1, 1]   skeleton renderings
      face_embed  [B, id_dim]                  ArcFace embedding
      face_mask   [B, F, H, W, 1] in {0, 1}    facial-region mask
    noises: the five draws {eps0 [B*F, h, w, C], ref_aug [B, H, W, 3],
    keep [B] (0/1), sigmas [B], noise [B, F, h, w, C]}, or None to draw
    them from `generator`. encode_chunk frames go through the fp32 VAE
    encoder at a time (per-frame, so exact). The spans "encode" (the draws
    and the frozen VAE encodes) and "forward" (the rest); timings, when
    given, receives their host seconds under "encode" and
    "forward_backward"."""
    sched = sched or SchedulerConfig()
    frames = batch["frames"]
    b, f, hh, ww, _ = frames.shape
    h8, w8 = hh // 8, ww // 8
    device = frames.device
    with trace.span("encode", timings):
        if noises is None:
            noises = draw_noises(batch, models.vae.config.latent_channels,
                                 conditioning_dropout_prob, sched, generator)
        nz = {k: noises[k].to(device=device, dtype=torch.float32) for k in NOISE_KEYS}

        # --- targets and the reference latent: the frozen fp32 VAE encoder
        with _autograd_for(models.vae):
            frames_flat = frames.reshape(b * f, hh, ww, 3)
            chunk = encode_chunk if (b * f) % encode_chunk == 0 else b * f
            moments = [models.vae.encode(frames_flat[i:i + chunk])
                       for i in range(0, b * f, chunk)]
            mean = torch.cat([m for m, _ in moments])
            logvar = torch.cat([lv for _, lv in moments])
            x0 = (mean + torch.exp(0.5 * logvar) * nz["eps0"]) * models.vae.config.scaling_factor
            x0 = x0.reshape(b, f, h8, w8, -1)
            ref_in = batch["ref_image"] * 2.0 - 1.0 + pipe.noise_aug_strength * nz["ref_aug"]
            # the conditioning latent is the posterior mode, not scaled
            ref_lat, _ = models.vae.encode(ref_in)
    with trace.span("forward", timings, key="forward_backward"):
        # --- conditioning
        context = _encode_context(models, batch["ref_image"], batch["face_embed"])
        pose_latents = models.pose_net(batch["pose_pixels"].reshape(b * f, hh, ww, 3)).float()
        if conditioning_dropout_prob > 0:
            keep = nz["keep"]
            context = context * keep[:, None, None]
            ref_lat = ref_lat * keep[:, None, None, None]
            pose_latents = pose_latents * keep.repeat_interleave(f)[:, None, None, None]

        # --- EDM noising (fp32)
        sigmas = nz["sigmas"]
        sig5 = sigmas[:, None, None, None, None]
        x_t = x0 + sig5 * nz["noise"]
        model_in = x_t / torch.sqrt(sig5**2 + 1.0)
        ref_bcast = ref_lat[:, None].expand(b, f, h8, w8, ref_lat.shape[-1])
        model_in = torch.cat([model_in, ref_bcast], dim=-1)
        add_ids = torch.tensor([[pipe.fps - 1, pipe.motion_bucket_id, pipe.noise_aug_strength]],
                               dtype=torch.float32, device=device).expand(b, 3)
        v = models.unet(model_in, timestep_of_sigma(sigmas), context, add_ids,
                        pose_latents).float()

        # x0_hat from the v-prediction; EDM-weighted loss on x0
        x0_hat = v * (-sig5 / torch.sqrt(sig5**2 + 1.0)) + x_t / (sig5**2 + 1.0)
        lam = edm_loss_weight(sigmas)[:, None, None, None, None]
        # face weighting at latent resolution; "nearest-exact" samples pixel
        # 8i + 4 as jax.image.resize's "nearest" does ("nearest" would take 8i)
        mask = batch["face_mask"].reshape(b * f, hh, ww, 1).permute(0, 3, 1, 2)
        mask = F.interpolate(mask, size=(h8, w8), mode="nearest-exact")
        mask = mask.permute(0, 2, 3, 1).reshape(b, f, h8, w8, 1)
        w_face = 1.0 + cfg.face_loss_weight * mask
        return torch.mean(lam * w_face * torch.square(x0_hat - x0))


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's block of a global batch (or of its draws): the
    `VIDEO_KEYS` leaves and the draws eps0 and noise by rows and frames
    (eps0's [B*F, ...] as [B, F, ...]), the rest by rows."""
    out = {}
    for key, v in batch.items():
        if key == "eps0":
            n = batch["noise"].shape[1]
            v = video_sharding(mesh, v.ndim + 1).local(v.reshape((-1, n) + v.shape[1:]))
            out[key] = v.reshape((-1,) + v.shape[2:])
        elif key in VIDEO_KEYS or key == "noise":
            out[key] = video_sharding(mesh, v.ndim).local(v)
        else:
            out[key] = batch_sharding(mesh, v.ndim).local(v)
    return out


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all elements of all tensors (fp32)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


@torch.no_grad()
def _copy_masters(state: TrainState) -> None:
    for p, m in zip(state.params, state.masters):
        p.copy_(m)


@torch.no_grad()
def _apply_update(state: TrainState, grads: list[torch.Tensor], cfg: TrainConfig) -> None:
    """optax.clip_by_global_norm, then AdamW at the scheduled lr, on the fp32
    masters (under ZeRO-1 on this rank's blocks, then gathered); then the
    models' copies."""
    norm = global_norm(grads)
    clip = torch.where(norm < cfg.max_grad_norm, torch.ones_like(norm), cfg.max_grad_norm / norm)
    held = state.optimizer.param_groups[0]["params"]
    zero = state._zero()
    for i, (p, g) in enumerate(zip(held, grads)):
        p.grad = (g if zero is None else zero[i].local(g)) * clip
    state.optimizer.param_groups[0]["lr"] = lr_at(cfg, state.updates)
    state.optimizer.step()
    for p in held:
        p.grad = None
    if state.mesh is not None:
        gather_masters(state.masters, state.mesh, AXES)
    state.updates += 1
    _copy_masters(state)


def make_train_step(models: AnimationModels, cfg: TrainConfig, pipe: PipelineConfig,
                    conditioning_dropout_prob: float = 0.1, encode_chunk: int = 4, mesh=None):
    """The training step: step_fn(state, batch, *, noises=None,
    generator=None, timings=None) -> (state, metrics). It updates `state`
    in place and returns it with {"loss", "grad_norm"} (fp32 scalars on
    the device; grad_norm is the raw gradients' global norm, before
    accumulation and clipping). The step is the unit span "train_step"
    (core/trace.py) over the spans "encode" (frozen VAE), "forward" (the
    rest of the loss), "backward" and "optimizer" (upcast, the gradients'
    all-reduce under a mesh, accumulation, clipping, AdamW, the copy to the
    models). timings, when given, receives the host seconds of "encode",
    "forward_backward" (forward + backward) and "optimizer"; the device is
    synchronised at each of their boundaries.

    mesh: the (data, frame) mesh (module docstring). `batch` is then this
    rank's block of the global batch (`shard_batch(batch, mesh)`: its rows,
    and its block of each clip's frames), `noises` the global batch's draws
    (this rank's part is taken here) and the generator draws the global
    batch's; the metrics are the global batch's. The state must come from
    `create_train_state(..., mesh=mesh)`."""
    k = cfg.gradient_accumulation_steps

    def step_fn(state: TrainState, batch: dict, *, noises: dict | None = None,
                generator: torch.Generator | None = None, timings: dict | None = None):
        with trace.span("train_step", unit=True):
            for p in state.params:
                p.grad = None
            if mesh is not None:
                if noises is None:
                    b, f = batch["frames"].shape[:2]
                    noises = draw_noises(batch, models.vae.config.latent_channels,
                                         conditioning_dropout_prob, SchedulerConfig(), generator,
                                         batch_size=b * mesh.shape[DATA_AXIS],
                                         num_frames=f * mesh.shape[FRAME_AXIS])
                noises = shard_batch(noises, mesh)
            with use_mesh(mesh):                       # the UNet's frame collectives
                loss = train_loss(models, batch, cfg, pipe,
                                  conditioning_dropout_prob=conditioning_dropout_prob,
                                  encode_chunk=encode_chunk, noises=noises, generator=generator,
                                  timings=timings)
            with trace.span("backward", timings, key="forward_backward"):
                loss.backward()
            with trace.span("optimizer", timings):
                grads = []
                for p, m in zip(state.params, state.masters):
                    grads.append(p.grad.float() if p.grad is not None else torch.zeros_like(m))
                    p.grad = None
                loss = loss.detach()
                if mesh is not None:
                    all_reduce_mean(grads + [loss.reshape(1)], mesh, AXES)
                grad_norm = global_norm(grads)
                if k > 1:
                    if state.grad_acc is None:
                        state.grad_acc = [torch.zeros_like(m) for m in state.masters]
                    n = state.mini_step
                    for acc, g in zip(state.grad_acc, grads):      # optax's running mean
                        acc.add_((g - acc) / (n + 1))
                    state.mini_step = (n + 1) % k
                    if state.mini_step == 0:
                        _apply_update(state, state.grad_acc, cfg)
                        for acc in state.grad_acc:
                            acc.zero_()
                else:
                    _apply_update(state, grads, cfg)
                del grads
                state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm}

    return step_fn
