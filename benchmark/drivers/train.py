"""Training traffic: fine-tuning steps back to back, each on a fresh clip
and fresh draws, through the program's `make_train_step` as the training
CLI calls it.

Set-up builds the train state once and drives it through its first three
steps with the window's own call, on clips that all differ; the window
continues with the same state from step 3. `correct` is decided on those
three steps: the plain reference (`benchmark/reference`) takes the same
weights, clips and draws in float32 and follows them with its own loss,
gradient and AdamW. Compared: each step's loss, the first clipped
gradient's norm by leaf (the program's read from AdamW's first moment
after step 1) and its direction (1 - cosine) by leaf of more than one
element, and the norm of each leaf's change after the three updates, the
leaves by their median. A leaf whose reference gradient is under a
thousandth of the median leaf's moves by round-off alone and is left out of
the change and the direction. The control is the reference with the models
the configuration serves in bf16 computed in fp8.
"""

from __future__ import annotations

import gc
import statistics

import torch

from benchmark import common, inputs, weights
from benchmark.reference import models as ref_models
from benchmark.reference import pipeline as ref_pipeline

CHECKED_STEPS = 3
NOUGHT = 1e-3      # a leaf's reference gradient under this share of the median leaf's
CONTROL = "fp8"    # the precision below the configuration's bf16


def leaf_gaps(got: dict[str, float], want: dict[str, float], keep=None) -> tuple[float, float, str]:
    """Each leaf's gap between two norms, over the larger of the reference's
    norm of that leaf and the median leaf's: (the median leaf's gap, the
    worst leaf's gap, the worst leaf)."""
    names = [n for n in want if keep is None or n in keep]
    med = statistics.median(want[n] for n in names)
    gaps = {n: abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in names}
    worst = max(gaps, key=gaps.get)
    return statistics.median(gaps.values()), gaps[worst], worst


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    """The cosine of the angle between two tensors (0 where one is zero)."""
    a, b = a.double().flatten(), b.double().flatten()
    den = float(a.norm() * b.norm())
    return float(a @ b) / den if den > 0 else 0.0


class Cell:
    """One configuration under one training mix, on one device."""

    RATE_METRIC, RATE_SCALE, UNIT = "train_clips_per_h", 3600.0, "clips"
    FIRST_UNIT = CHECKED_STEPS  # the window's first step: set-up ran the ones before it

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.weight_seed = common.stream_seed(seed, "weights")
        self.train = cfg["training"]
        self.trainable = tuple(self.train["trainable"])
        self.losses: list[float] = []
        self.first: dict = {}
        self._wanted = None          # the reference's reading of the first steps

    def work(self) -> dict:
        t = self.traffic
        return {"kind": "step", "height": t["height"], "width": t["width"],
                "frames": self.train["sample_n_frames"], "clips": self.train["per_device_batch_size"],
                "checkpointing": self.train["gradient_checkpointing"]}

    def _batch(self, index: int):
        t, tr = self.traffic, self.train
        return inputs.train_step(self.seed, index, t["height"], t["width"], tr["sample_n_frames"],
                                 self.cfg["models"]["face_encoder"]["id_embeddings_dim"],
                                 self.cfg["models"]["vae"]["latent_channels"],
                                 tr["conditioning_dropout_prob"], self.cfg["scheduler"],
                                 self.device)

    def setup(self) -> None:
        """The train state from this seed's float32 weights, driven through
        its first CHECKED_STEPS steps (which also build the kernels and warm
        every shape); records what `check` compares."""
        from stableanimator_tpu_torch.core.config import PipelineConfig, TrainConfig
        from stableanimator_tpu_torch.pipeline import animation
        from stableanimator_tpu_torch.train import train_step

        tr = self.train
        models = animation.build_models(**common.port_model_kwargs(self.cfg), dtype=torch.float32,
                                        device=self.device, seed=None,
                                        remat=tr["gradient_checkpointing"])
        sds = weights.make(self.cfg, self.weight_seed, self.device, torch.float32)
        for name in weights.ORDER:
            getattr(models, name).load_state_dict(sds.pop(name), strict=True)
        tc = TrainConfig(**{k: tr[k] for k in (
            "sample_n_frames", "per_device_batch_size", "learning_rate", "lr_warmup_steps",
            "gradient_accumulation_steps", "gradient_checkpointing", "mixed_precision",
            "adam_beta1", "adam_beta2", "adam_weight_decay", "adam_epsilon", "max_grad_norm",
            "face_loss_weight")})
        s = self.cfg["sampling"]
        pipe = PipelineConfig(fps=s["fps"], motion_bucket_id=s["motion_bucket_id"],
                              noise_aug_strength=s["noise_aug_strength"])
        self.state = train_step.create_train_state(models, tc, self.trainable)
        self.step_fn = train_step.make_train_step(
            models, tc, pipe, conditioning_dropout_prob=tr["conditioning_dropout_prob"])
        self.models = models
        for i in range(CHECKED_STEPS):
            self.unit(i)
            if i == 0:
                # the clipped gradient AdamW took: its first moment / (1 - beta1)
                # (none where it took no step)
                moments = [self.state.optimizer.state.get(m, {}).get("exp_avg")
                           for m in self.state.masters]
                self.first["grad_vec"] = {
                    n: (torch.zeros_like(m) if v is None else v / (1.0 - tr["adam_beta1"])).cpu()
                    for n, v, m in zip(self.state.names, moments, self.state.masters)}
                self.first["grad"] = {n: float(v.norm())
                                      for n, v in self.first["grad_vec"].items()}
        start = weights.make(self.cfg, self.weight_seed, self.device, torch.float32,
                             models=self.trainable)
        self.first["change"] = {}
        for n, m in zip(self.state.names, self.state.masters):
            model, key = n.split(".", 1)
            self.first["change"][n] = float((m - start[model][key]).norm())
        self.first["loss"] = self.losses[:CHECKED_STEPS]
        del start

    def unit(self, index: int, timings: dict | None = None) -> int:
        """Training step `index` on its own clip; returns the clips it
        completed."""
        batch, draws = self._batch(index)
        self.state, metrics = self.step_fn(self.state, batch, noises=draws, timings=timings)
        self.losses.append(float(metrics["loss"]))
        return self.train["per_device_batch_size"]

    def valid(self, index: int) -> bool:
        return bool(torch.isfinite(torch.tensor(self.losses[index])))

    def free_program(self) -> None:
        self.state = self.step_fn = self.models = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_steps(self, lowp: str | None = None) -> dict:
        """The reference's loss by step, first clipped gradient norm by leaf
        and change norm by leaf after CHECKED_STEPS updates, from the same
        weights, clips and draws; with `lowp`, the control: the models the
        configuration serves in bf16 computed in that format
        (`lower_precision`)."""
        ref_pipeline.strict_float32()
        ref = ref_models.build(self.cfg, self.device,
                               checkpoint=self.train["gradient_checkpointing"])
        sds = weights.make(self.cfg, self.weight_seed, self.device, torch.float32)
        for name in weights.ORDER:
            ref[name].load_state_dict(sds.pop(name), strict=True)
            ref[name].requires_grad_(name in self.trainable)
            if lowp and name != "vae":
                ref_models.lower_precision(ref[name], lowp)
        names = [f"{m}.{k}" for m in self.trainable for k, _ in ref[m].named_parameters()]
        params = [p for m in self.trainable for p in ref[m].parameters()]
        opt = ref_pipeline.AdamW(params, self.train)
        out = {"loss": []}
        for i in range(CHECKED_STEPS):
            batch, draws = self._batch(i)
            loss = ref_pipeline.train_loss(ref, batch, draws, self.cfg["sampling"], self.train)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            clipped = opt.step([torch.zeros_like(p) if g is None else g
                                for p, g in zip(params, grads)])
            out["loss"].append(float(loss.detach()))
            if i == 0:
                out["grad"] = {n: float(g.norm()) for n, g in zip(names, clipped)}
                out["grad_vec"] = {n: g.cpu() for n, g in zip(names, clipped)}
            del loss, grads, clipped
        start = weights.make(self.cfg, self.weight_seed, self.device, torch.float32,
                             models=self.trainable)
        out["change"] = {n: float((p.detach() - start[n.split(".", 1)[0]][n.split(".", 1)[1]])
                                  .norm()) for n, p in zip(names, params)}
        return out

    def compare(self, got: dict, want: dict) -> dict[str, float]:
        """The compared numbers of `got` (the program's first steps, or the
        control's) against `want` (the reference's): the largest relative
        gap of a step's loss, the median leaf's gaps of the first gradient's
        and of the change's norms, and the median leaf's 1 - cosine between
        the first gradients. Half of the clip left out moves the loss: the
        clip's face box grows frame by frame (`inputs.clip`), so its first
        half weighs the face-weighted loss otherwise. A leaf of one element has a sign, not
        a direction (its 1 - cosine is 0, 1 or 2), and is left out of the
        direction: a spatio-temporal mix's gradient is a sum that all but
        cancels, and bf16 rounding flips or zeroes it. The worst leaf of
        each number swings with rounding from seed to seed: it is printed,
        not compared (PERF.md)."""
        steps = [abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"])]
        loss = max(steps)
        grad, grad_worst, grad_leaf = leaf_gaps(got["grad"], want["grad"])
        med = statistics.median(want["grad"].values())
        moved = {n for n, g in want["grad"].items() if g >= NOUGHT * med}
        change, change_worst, change_leaf = leaf_gaps(got["change"], want["change"], moved)
        dirs = {n: 1.0 - cosine(got["grad_vec"][n], want["grad_vec"][n]) for n in moved
                if want["grad_vec"][n].numel() > 1}
        dir_leaf = max(dirs, key=dirs.get)
        return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
                "grad_dir_gap": statistics.median(dirs.values()),
                "grad_dir_worst": dirs[dir_leaf], "grad_dir_worst_leaf": dir_leaf,
                "step_loss_gaps": steps,
                "reference_losses": want["loss"], "grad_worst": grad_worst, "grad_worst_leaf": grad_leaf,
                "change_worst": change_worst, "change_worst_leaf": change_leaf,
                "left_out": len(want["grad"]) - len(moved)}

    def _want(self) -> dict:
        if self._wanted is None:
            self._wanted = self.reference_steps()
        return self._wanted

    def check(self, done: list[int]) -> dict[str, float]:
        """The program's first steps against the reference's. Runs after
        `free_program`."""
        return self.compare(self.first, self._want())

    def control(self) -> dict[str, float]:
        """The control's numbers: the reference computed in CONTROL (the
        program has no lower-precision training path) against the
        reference."""
        return self.compare(self.reference_steps(CONTROL), self._want())
