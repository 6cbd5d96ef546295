"""Model and pipeline configuration dataclasses of the PyTorch port.

The port's own copy of the JAX package's `core/config.py` (same fields,
same defaults), so that the port imports nothing of the JAX package.
Default values reproduce the SVD-XT + StableAnimator configuration;
`tiny()` variants and `micro_model_kwargs` are the scaled-down configs
the tests use.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


def _freeze(x):
    if isinstance(x, list):
        return tuple(_freeze(v) for v in x)
    return x


@dataclass(frozen=True)
class UNetConfig:
    """UNetSpatioTemporalConditionModel config (reference unet.py:38-63)."""

    sample_size: int = 96
    in_channels: int = 8          # 4 noise + 4 reference-image latent channels
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlockSpatioTemporal",
        "CrossAttnDownBlockSpatioTemporal",
        "CrossAttnDownBlockSpatioTemporal",
        "DownBlockSpatioTemporal",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal",
    )
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 768
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    transformer_layers_per_block: int = 1
    num_attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    num_frames: int = 25
    # StableAnimator ID-adapter: number of face-identity tokens appended to
    # the CLIP image token (reference inference_pipeline_animation.py:190).
    num_id_tokens: int = 4

    def __post_init__(self):
        object.__setattr__(self, "down_block_types", _freeze(self.down_block_types))
        object.__setattr__(self, "up_block_types", _freeze(self.up_block_types))
        object.__setattr__(self, "block_out_channels", _freeze(self.block_out_channels))
        object.__setattr__(self, "num_attention_heads", _freeze(self.num_attention_heads))

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @staticmethod
    def tiny() -> "UNetConfig":
        """A miniature UNet for unit tests (same topology, small dims)."""
        return UNetConfig(
            sample_size=8,
            block_out_channels=(32, 64, 64, 64),
            num_attention_heads=(2, 4, 4, 4),
            cross_attention_dim=48,
            addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=24,
        )


@dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKLTemporalDecoder config (reference vae.py:221-231)."""

    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    sample_size: int = 768
    scaling_factor: float = 0.18215
    force_upcast: bool = True

    def __post_init__(self):
        object.__setattr__(self, "block_out_channels", _freeze(self.block_out_channels))

    @property
    def downscale_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(block_out_channels=(32, 32, 64, 64), sample_size=32)


@dataclass(frozen=True)
class PoseNetConfig:
    """PoseNet config (reference pose_net.py:11-38)."""

    noise_latent_channels: int = 320
    conv_channels: Tuple[int, ...] = (3, 16, 32, 64, 128)
    scale_init: float = 2.0

    def __post_init__(self):
        object.__setattr__(self, "conv_channels", _freeze(self.conv_channels))

    @staticmethod
    def tiny() -> "PoseNetConfig":
        return PoseNetConfig(noise_latent_channels=32, conv_channels=(3, 4, 4, 8, 8))


@dataclass(frozen=True)
class FaceEncoderConfig:
    """FusionFaceId config (reference id_encoder.py:104-130)."""

    cross_attention_dim: int = 1024
    id_embeddings_dim: int = 512
    clip_embeddings_dim: int = 1024
    num_tokens: int = 4
    depth: int = 4
    dim_head: int = 64
    ff_mult: int = 4

    @property
    def heads(self) -> int:
        return self.cross_attention_dim // self.dim_head

    @staticmethod
    def tiny() -> "FaceEncoderConfig":
        return FaceEncoderConfig(
            cross_attention_dim=64, id_embeddings_dim=32, clip_embeddings_dim=64,
            depth=2, dim_head=16,
        )


@dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP ViT-H/14 vision tower with projection (the SVD image encoder:
    `CLIPVisionModelWithProjection`, reference inference_basic.py:241-248).
    laion2B ViT-H geometry: 32 layers, width 1280, 16 heads, patch 14,
    projection to 1024."""

    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    intermediate_size: int = 5120
    projection_dim: int = 1024
    layer_norm_eps: float = 1e-5

    @staticmethod
    def tiny() -> "CLIPVisionConfig":
        return CLIPVisionConfig(
            image_size=32, patch_size=8, hidden_size=32, num_layers=2,
            num_heads=2, intermediate_size=64, projection_dim=48,
        )


@dataclass(frozen=True)
class SchedulerConfig:
    """EulerDiscrete/EDM scheduler config for SVD (continuous timesteps,
    Karras sigmas; semantics verified against the traced timestep values at
    reference inference_pipeline_animation.py:634-639 and
    init_noise_sigma=700.000732 at :405)."""

    sigma_min: float = 0.002
    sigma_max: float = 700.0
    rho: float = 7.0
    # training-time sigma sampling (EDM lognormal), SVD finetune values
    p_mean: float = 0.7
    p_std: float = 1.6


@dataclass(frozen=True)
class PipelineConfig:
    """Generation-time parameters (reference command_basic_infer.sh:22-39,
    inference_pipeline_animation.py:443-468)."""

    height: int = 512
    width: int = 512
    num_frames: int = 16
    tile_size: int = 16
    tile_overlap: int = 4
    num_inference_steps: int = 25
    min_guidance_scale: float = 3.0
    max_guidance_scale: float = 3.0
    fps: int = 7
    motion_bucket_id: int = 127
    noise_aug_strength: float = 0.02
    decode_chunk_size: int = 4
    # Decode all chunks in one batched VAE call when the video's latent
    # volume (frames x latent pixels) is at most this; above it, chunks run
    # sequentially — at 576x1024 the batched decoder's level-0 activations
    # alone exceed one chip's HBM.
    batched_decode_max_latent_volume: int = 16 * 64 * 64
    # Max temporal tiles per UNet invocation. None = every tile in one
    # batched call (fastest; fine up to a few tiles). Long videos (the
    # reference's headline 15 s / ~450-frame demo, README.md:367) have
    # dozens of tiles, so the denoise step scans over groups of this many
    # tiles instead — bounded HBM at any video length, like the
    # reference's per-tile Python loop (inference_pipeline_animation.py:
    # 654-689) but still fully inside one compiled program. "auto" (the
    # default) picks None for <= 4 tiles and groups of 2 past that
    # (diffusion/tiling.py::auto_tile_batch), so every caller — CLI,
    # server, benches — is long-video-safe without opting in.
    max_tile_batch: int | str | None = "auto"
    # Max Euler steps per device dispatch. None = the whole denoise loop is
    # one lax.scan inside one executable (fastest; the headline-bench path).
    # An int k splits the loop into host-dispatched segments of k steps that
    # all reuse ONE compiled program (the step offset is a traced scalar), so
    # no single device execution runs unboundedly long — long videos execute
    # for minutes in one program otherwise, which trips execution watchdogs
    # on remote-attached TPUs (measured: 512^2 x 64f x 25-step single-program
    # generate reproducibly kills the worker; 12 steps survive). Segment
    # dispatch costs ~40 ms each — noise next to multi-second segments — and
    # gives the CLI/server real progress reporting. "auto" (the default)
    # picks None for <= 4 tiles, then sizes segments inversely with the
    # per-step tile-slot count so one execution stays ~bounded (5
    # steps/dispatch at 5 tiles, 1 at the 450-frame demo scale; see
    # pipeline.resolve_steps_per_dispatch).
    steps_per_dispatch: int | str | None = "auto"
    # Emit uint8 frames (0-255) from the decode program instead of fp32
    # [0,1]: same round-half-up mapping as utils/image.py::frames_to_uint8,
    # but on device — 1/4 the device->host transfer for consumers that want
    # pixels anyway (CLI, server, benches). A 450-frame 512^2 video is
    # 354 MB as uint8 vs 1.4 GB as fp32 across a remote-TPU tunnel.
    output_uint8: bool = False


def micro_model_kwargs() -> dict:
    """Depth-1 micro model-zoo kwargs for `pipeline.build_models`: same
    topology as the full stack (4-level UNet with CrossAttn/Down/Up blocks,
    temporal mixing, all five conditioning models) but one resnet /
    transformer layer per block. Used by smoke tests, the driver dryrun and
    `cli.train --model_scale micro` — any place that exercises graph
    structure rather than capacity."""
    return dict(
        unet_cfg=dataclasses.replace(UNetConfig.tiny(), layers_per_block=1),
        vae_cfg=dataclasses.replace(VAEConfig.tiny(), layers_per_block=1),
        clip_cfg=dataclasses.replace(
            CLIPVisionConfig.tiny(), image_size=64, num_layers=1),
        pose_cfg=dataclasses.replace(
            PoseNetConfig.tiny(), noise_latent_channels=32),
        face_cfg=dataclasses.replace(
            FaceEncoderConfig.tiny(), cross_attention_dim=48,
            clip_embeddings_dim=48, depth=1),
    )
