"""Request traffic: one client in a closed loop, each request a fresh
reference image, pose clip, face embedding and noises, through the
program's `generate` as the CLI and the server call it (uint8 frames back
on the host).

`correct` is decided on one finished request of the window, drawn from the
seed: the plain reference (`benchmark/reference`) generates the same
request in float32 from the same inputs and weights, and the frames the
program returned are compared with its frames. The control is the same
reference computed in fp8 in the program's place.
"""

from __future__ import annotations

import dataclasses
import gc

import torch

from benchmark import common, inputs, weights
from benchmark.reference import models as ref_models
from benchmark.reference import pipeline as ref_pipeline

# the precision below the configuration's bf16 (the program's own int8 path
# is no control: its frames lie as close to the reference's as the bf16
# path's; PERF.md)
CONTROL = "fp8"
SAMPLING_KEYS = ("num_inference_steps", "min_guidance_scale", "max_guidance_scale", "tile_size",
                 "tile_overlap", "decode_chunk_size", "noise_aug_strength", "motion_bucket_id",
                 "fps")


def frame_gaps(got_u8: torch.Tensor, want01: torch.Tensor) -> dict[str, float]:
    """The served uint8 frames against the reference's [0, 1] frames, in
    units of one uint8 level: the root mean square of the gap, and its
    99.9th percentile."""
    gap = (got_u8.float().cpu() - want01.float().cpu() * 255.0).abs().flatten()
    k = max(1, int(round(0.999 * gap.numel())))
    return {"frame_rms": float(gap.square().mean().sqrt()),
            "frame_p999": float(gap.kthvalue(k).values)}


class Cell:
    """One configuration under one request mix, on one device."""

    RATE_METRIC, RATE_SCALE, UNIT = "frames_per_s", 1.0, "frames"
    FIRST_UNIT = 0              # the window's first request

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self._wanted = None          # (request, the reference's frames)
        self.dtype = getattr(torch, cfg["dtype"])
        self.weight_seed = common.stream_seed(seed, "weights")
        self.sampling = {**cfg["sampling"], **traffic.get("sampling", {})}
        self.outputs: dict[int, torch.Tensor] = {}

    def work(self) -> dict:
        """What one unit of this traffic is, for the counts."""
        return {"kind": "request", "height": self.traffic["height"],
                "width": self.traffic["width"], "frames": self.traffic["frames"],
                "steps": self.sampling["num_inference_steps"],
                "decode_chunk": self.sampling["decode_chunk_size"],
                "batched_decode_max_latent_volume": self.traffic["batched_decode_max_latent_volume"]}

    def setup(self) -> None:
        """The program's models with this seed's weights, and one short
        request of the traffic's shapes, which builds and loads the kernels
        and warms every shape a request uses."""
        from stableanimator_tpu_torch.core.config import PipelineConfig
        from stableanimator_tpu_torch.pipeline import animation

        self.models = animation.build_models(**common.port_model_kwargs(self.cfg), dtype=self.dtype,
                                             device=self.device, seed=None)
        sds = weights.make(self.cfg, self.weight_seed, self.device, self.dtype)
        for name in weights.ORDER:
            getattr(self.models, name).load_state_dict(sds.pop(name), strict=True)
        t = self.traffic
        self.pipe = PipelineConfig(height=t["height"], width=t["width"], num_frames=t["frames"],
                                   batched_decode_max_latent_volume=t[
                                       "batched_decode_max_latent_volume"],
                                   output_uint8=True,
                                   **{k: self.sampling[k] for k in SAMPLING_KEYS})
        warm = dataclasses.replace(self.pipe, num_inference_steps=t["warmup_steps"])
        self._request(-1, warm, None)

    def _inputs(self, index: int) -> dict:
        t = self.traffic
        return inputs.request(self.seed, index, t["height"], t["width"], t["frames"],
                              min(self.sampling["tile_size"], t["frames"]),
                              self.cfg["models"]["face_encoder"]["id_embeddings_dim"], self.device)

    def _request(self, index: int, pipe, timings) -> torch.Tensor:
        from stableanimator_tpu_torch.pipeline import animation

        x = self._inputs(index)
        frames = animation.generate(self.models, x["ref"], x["pose"], x["face"], pipe,
                                    aug_noise=x["aug"], init_noise=x["init"], device=self.device,
                                    timings=timings)
        return frames.cpu()

    def unit(self, index: int, timings: dict | None = None) -> int:
        """Request `index`, returned to the host; returns its frames."""
        out = self._request(index, self.pipe, timings)
        self.outputs[index] = out
        return out.shape[0]

    def valid(self, index: int) -> bool:
        """The request returned whole: F frames of H x W x 3 uint8."""
        t = self.traffic
        out = self.outputs[index]
        return out.dtype == torch.uint8 and tuple(out.shape) == (t["frames"], t["height"],
                                                                 t["width"], 3)

    def free_program(self) -> None:
        self.models = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, index: int, lowp: str | None = None) -> torch.Tensor:
        """Request `index` through the float32 reference, or with `lowp`
        through the control: the models the configuration serves in bf16
        computed in that format (`lower_precision`)."""
        ref_pipeline.strict_float32()
        ref = ref_models.build(self.cfg, self.device)
        sds = weights.make(self.cfg, self.weight_seed, self.device, self.dtype)
        for name in weights.ORDER:
            ref[name].load_state_dict({k: v.float() for k, v in sds.pop(name).items()},
                                      strict=True)
            ref[name].eval()
        if lowp:
            for name in ("unet", "clip", "pose_net", "face_encoder"):
                ref_models.lower_precision(ref[name], lowp)
            ref_models.lower_precision(ref["vae"].decoder, lowp)
        x = self._inputs(index)
        with torch.no_grad():
            return ref_pipeline.generate(ref, x["ref"].float() / 255.0,
                                         x["pose"].float() / 127.5 - 1.0, x["face"], x["aug"],
                                         x["init"], self.sampling, self.cfg["scheduler"])

    def _want(self, index: int) -> torch.Tensor:
        if self._wanted is None or self._wanted[0] != index:
            self._wanted = (index, self._reference(index))
        return self._wanted[1]

    def check(self, done: list[int]) -> dict[str, float]:
        """The compared numbers (`frame_gaps`) of one finished request drawn
        from the seed, against the float32 reference. Runs after
        `free_program`."""
        index = done[common.stream_seed(self.seed, "check") % len(done)]
        return {"request": index, **frame_gaps(self.outputs[index], self._want(index))}

    def control(self) -> dict[str, float]:
        """The control's numbers on the request `check` judged (else the
        first): the reference in CONTROL in the program's place, serving
        uint8 frames as the program does."""
        index = self._wanted[0] if self._wanted is not None else self.FIRST_UNIT
        got = self._reference(index, CONTROL)
        u8 = (got.float() * 255.0 + 0.5).clamp(0.0, 255.0).to(torch.uint8)
        return {"request": index, **frame_gaps(u8, self._want(index))}
