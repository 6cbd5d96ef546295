"""Flax parameter trees -> the port's state dicts.

The inverse of the key and layout rules of the JAX package's
`convert/torch_to_jax.py` (written out here; the port imports nothing of
that package). Input: the JAX package's params as nested dicts of numpy
arrays, `{"unet": ..., "vae": ..., "clip": ..., "pose_net": ...,
"face_encoder": ...}`, each optionally wrapped in `{"params": ...}`.
Output: one state dict per model, loadable with `load_state_dict(strict=True)`.

Layout rules (Flax -> torch):
  Dense kernel   [in, out]              -> weight [out, in]
  Conv2d kernel  [kh, kw, I, O]         -> weight [O, I, kh, kw]
  Conv3d kernel  [kt, kh, kw, I, O]     -> weight [O, I, kt, kh, kw]
  norm scale                            -> weight
"""

from __future__ import annotations

import re
from typing import Callable, Iterator, Mapping

import numpy as np
import torch

_UNET_LISTS = ("down_blocks", "up_blocks", "resnets", "attentions",
               "transformer_blocks", "temporal_transformer_blocks",
               "downsamplers", "upsamplers")
_UNET_LIST_RE = re.compile(rf"({'|'.join(_UNET_LISTS)})_(\d+)")
_VAE_LIST_RE = re.compile(r"(down_blocks|up_blocks|resnets|attentions|downsamplers|upsamplers)_(\d+)")


def _flatten(tree: Mapping, prefix: tuple = ()) -> Iterator[tuple[tuple, np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _leaf(path: tuple, arr) -> tuple[tuple, np.ndarray]:
    """Map the leaf name and the array layout."""
    arr = np.asarray(arr)
    name = path[-1]
    if name == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 5:
            arr = arr.transpose(4, 3, 0, 1, 2)
        return path[:-1] + ("weight",), arr
    if name == "scale" and len(path) > 1:      # norm scale; PoseNet's root scale stays
        return path[:-1] + ("weight",), arr
    return path, arr


def _unet_names(path: tuple) -> list[str]:
    out: list[str] = []
    for i, p in enumerate(path):
        parent = path[i - 1] if i else ""
        m = _UNET_LIST_RE.fullmatch(p)
        if m:
            out += [m.group(1), m.group(2)]
        elif p == "to_out":
            out += ["to_out", "0"]
        elif p in ("id_to_k", "id_to_v"):
            out += ["processor", p]
        elif p == "act" and parent in ("ff", "ff_in"):
            out += ["net", "0"]
        elif p == "proj_out" and parent in ("ff", "ff_in"):
            out += ["net", "2"]
        else:
            out.append(p)
    return out


def _vae_names(path: tuple) -> list[str]:
    out: list[str] = []
    for p in path:
        if p == "to_out":
            out += ["to_out", "0"]
            continue
        flat = _VAE_LIST_RE.sub(r"\1.\2", p)
        flat = re.sub(r"(\d)_", r"\1.", flat).replace("mid_block_", "mid_block.")
        out += flat.split(".")
    return out


def _pose_net_names(path: tuple) -> list[str]:
    return [q for p in path for q in re.sub(r"^conv_layers_(\d+)$", r"conv_layers.\1", p).split(".")]


_FF_CHILD = {"norm": "0", "fc1": "1", "fc2": "3"}


def _face_encoder_names(path: tuple) -> list[str]:
    out: list[str] = []
    for i, p in enumerate(path):
        parent = path[i - 1] if i else ""
        m = re.fullmatch(r"layers_(\d+)_(attn|ff)", p)
        if m:
            out += ["layers", m.group(1), "0" if m.group(2) == "attn" else "1"]
        elif re.fullmatch(r"proj_\d+", p) and i == 0:
            out += p.split("_")
        elif parent.endswith("_ff") and p in _FF_CHILD:
            out.append(_FF_CHILD[p])
        else:
            out.append(p)
    return out


_CLIP_EMBED = ("patch_embedding", "class_embedding")
_CLIP_ATTN = ("q_proj", "k_proj", "v_proj", "out_proj")


def _clip_names(path: tuple) -> list[str]:
    top = path[0]
    if top == "visual_projection":
        return list(path)
    if top in _CLIP_EMBED:
        return ["vision_model", "embeddings", *path]
    if top == "position_embedding":
        return ["vision_model", "embeddings", "position_embedding", "weight"]
    m = re.fullmatch(r"layers_(\d+)", top)
    if m:
        rest = list(path[1:])
        if rest[0] in _CLIP_ATTN:
            rest = ["self_attn", *rest]
        elif rest[0] in ("fc1", "fc2"):
            rest = ["mlp", *rest]
        return ["vision_model", "encoder", "layers", m.group(1), *rest]
    return ["vision_model", *path]


_RULES: dict[str, Callable[[tuple], list[str]]] = {
    "unet": _unet_names,
    "vae": _vae_names,
    "pose_net": _pose_net_names,
    "face_encoder": _face_encoder_names,
    "clip": _clip_names,
}


def state_dict_from_jax(model: str, tree: Mapping) -> dict[str, torch.Tensor]:
    """One model's Flax params -> the port module's state dict."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    rule = _RULES[model]
    sd: dict[str, torch.Tensor] = {}
    for path, arr in _flatten(tree):
        if model == "clip" and path == ("position_embedding",):
            key_path, arr = path, np.asarray(arr)     # [num_pos, dim], used as is
        else:
            key_path, arr = _leaf(path, arr)
        key = ".".join(rule(key_path))
        if key in sd:
            raise ValueError(f"{model}: two Flax leaves map to {key}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def state_dicts_from_jax(params: Mapping) -> dict[str, dict[str, torch.Tensor]]:
    """All five models' Flax params -> the port's state dicts."""
    return {name: state_dict_from_jax(name, params[name]) for name in _RULES if name in params}
