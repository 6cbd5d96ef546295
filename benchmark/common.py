"""What the harness's parts share: its files, found by name (drivers,
metric readers, model families), the seeds of its inputs, and the program's
model configurations built from a configuration file."""

from __future__ import annotations

import hashlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FAMILIES = HERE / "families"     # a model family's counts and weights (family())


def load_json(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def load_module(path: Path, name: str):
    """A module of the harness's data (a driver, a metric reader), by file."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return load_module(HERE / "drivers" / f"{name}.py", f"benchmark_driver_{name}")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py", "benchmark_metric_" + name.replace(".", "_"))


def family(cfg: dict):
    """The module of a configuration's model family, `FAMILIES/<name>.py`
    for `"family": "<name>"`, or None for a configuration without the key:
    the SVD family, whose counts and weights `counts.py` and `weights.py`
    hold. A family module holds `model_flops(cfg, work)`,
    `attention_calls(cfg, work)`, `build(cfg, device, *, meta)`, `ORDER`,
    `NORMS` and `served_dtype(model, module, key, name, dtype)`."""
    name = cfg.get("family")
    if name is None:
        return None
    path = FAMILIES / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"model family {name!r}: no file {path}")
    return load_module(path, "benchmark_family_" + name.replace(".", "_"))


def stream_seed(seed: int, *parts) -> int:
    """A generator seed for one stream of draws of a run: a hash of the run's
    seed and the stream's name and index, under 2**63."""
    text = ":".join(str(p) for p in (seed, *parts)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def port_model_kwargs(cfg: dict) -> dict:
    """The program's configuration objects of a configuration file's models,
    as `build_models` takes them."""
    from stableanimator_tpu_torch.core import config as pc

    m = cfg["models"]
    u = m["unet"]
    unet_keys = ("in_channels", "out_channels", "down_block_types", "up_block_types",
                 "block_out_channels", "addition_time_embed_dim",
                 "projection_class_embeddings_input_dim", "layers_per_block",
                 "cross_attention_dim", "transformer_layers_per_block", "num_attention_heads",
                 "num_id_tokens")
    c = m["clip"]
    return dict(
        unet_cfg=pc.UNetConfig(**{k: u[k] for k in unet_keys}),
        vae_cfg=pc.VAEConfig(**{k: m["vae"][k] for k in (
            "in_channels", "out_channels", "block_out_channels", "layers_per_block",
            "latent_channels", "scaling_factor")}),
        clip_cfg=pc.CLIPVisionConfig(
            image_size=c["image_size"], patch_size=c["patch_size"], hidden_size=c["hidden_size"],
            num_layers=c["num_hidden_layers"], num_heads=c["num_attention_heads"],
            intermediate_size=c["intermediate_size"], projection_dim=c["projection_dim"],
            layer_norm_eps=c["layer_norm_eps"]),
        pose_cfg=pc.PoseNetConfig(noise_latent_channels=m["pose_net"]["noise_latent_channels"],
                                  conv_channels=tuple(m["pose_net"]["conv_channels"])),
        face_cfg=pc.FaceEncoderConfig(**m["face_encoder"]),
    )
