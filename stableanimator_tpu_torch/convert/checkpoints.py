"""Reference checkpoints -> the port's models.

The checkpoint directory holds the reference's (diffusers / HF) state dicts
as `.npz` files, in the reference's key space, which the port's modules
share: the files the JAX package's `cli/animate.py::load_params` reads and
converts. Here they load straight into the modules with
`load_state_dict(strict=True)`. `check_state_dict` checks one file's keys
and shapes against a model on the meta device before anything is loaded
(`tools/ingest_checkpoints.py`), reading only the `.npz` members' headers
(`npz_shapes`). A vanilla SVD UNet (`is_vanilla_unet`: none of the ID
adapter's keys) is checked and loaded with the adapter that
`init_id_adapter_from_svd` adds, the CLIs' `--init_id_adapter`.
"""

from __future__ import annotations

import os
import re
import zipfile

import numpy as np
import torch
from torch import nn

CHECKPOINT_FILES = {"unet": "unet.npz", "vae": "vae.npz", "clip": "image_encoder.npz",
                    "pose_net": "pose_net.npz", "face_encoder": "face_encoder.npz"}
# the cross-attention projections of the spatial transformer blocks only
# ("temporal_transformer_blocks" do not match: the segment must start here)
_SPATIAL_ATTN2 = re.compile(r"((?:.*\.)?transformer_blocks\.\d+\.attn2)\.to_([kv])\.weight")


def id_adapter_sources(keys) -> dict[str, str]:
    """{ID adapter key: the cross-attention key it starts from} for a UNet
    state dict's keys: each spatial block's `attn2.to_{k,v}.weight` gives
    its `attn2.processor.id_to_{k,v}.weight`."""
    out = {}
    for key in keys:
        m = _SPATIAL_ATTN2.fullmatch(key)
        if m:
            out[f"{m.group(1)}.processor.id_to_{m.group(2)}.weight"] = key
    return out


def is_vanilla_unet(keys) -> bool:
    """Whether a UNet state dict's keys hold none of the ID adapter's: a
    vanilla SVD UNet, which loads with `init_id_adapter`. A file that holds
    some of them is not vanilla, and neither the check nor the load takes it
    without them all."""
    keys = set(keys)
    return not keys & set(id_adapter_sources(keys))


def init_id_adapter_from_svd(unet_sd: dict) -> dict:
    """For a vanilla SVD UNet state dict (`is_vanilla_unet`), initialise the
    ID adapter from the spatial blocks' cross-attention to_k / to_v, as the
    reference does at load time (inference_basic.py:372-377). Returns a new
    dict. One that holds the whole adapter already comes back as it is (the
    training CLI loads a StableAnimator UNet so); one that holds only some
    of it raises ValueError. The values may be tensors (copied) or, for the
    check, shapes."""
    sources = id_adapter_sources(unet_sd)
    held = sorted(set(sources) & set(unet_sd))
    if held and len(held) < len(sources):
        lacks = sorted(set(sources) - set(held))
        raise ValueError(f"unet: holds {len(held)} of the {len(sources)} ID adapter keys, "
                         f"lacks {lacks[:10]} ...")
    out = dict(unet_sd)
    if not held:
        for id_key, key in sources.items():
            value = unet_sd[key]
            out[id_key] = value.clone() if isinstance(value, torch.Tensor) else value
    return out


def _keep(model: str, key: str) -> bool:
    """The keys a model's file carries beyond the module: the CLIP file may
    hold the text tower, which the image encoder does not have."""
    return model != "clip" or key.startswith(("vision_model.", "visual_projection."))


def npz_shapes(path: str) -> dict[str, tuple]:
    """{key: shape} of an `.npz` file's arrays, from each member's `.npy`
    header only (no array is read)."""
    readers = {(1, 0): np.lib.format.read_array_header_1_0,
               (2, 0): np.lib.format.read_array_header_2_0}
    shapes = {}
    with zipfile.ZipFile(path) as z:
        for info in z.infolist():
            if not info.filename.endswith(".npy"):
                continue
            with z.open(info) as f:
                version = np.lib.format.read_magic(f)
                if version not in readers:
                    raise ValueError(f"{path}: {info.filename} is .npy format {version}")
                shapes[info.filename[:-len(".npy")]] = tuple(readers[version](f)[0])
    return shapes


def check_state_dict(name: str, shapes: dict, module: nn.Module) -> tuple[int, bool]:
    """Check a checkpoint file's {key: shape} against `module` (best on the
    meta device: `pipeline/animation.py::meta_models`) as the strict load
    will take it: after `_keep` (and, for a vanilla UNet, with the keys
    `init_id_adapter_from_svd` adds, shaped as the projections they start
    from), every key must name a parameter, every parameter must be in the
    file, and the shapes must match. The JAX package's converters raise on
    keys they cannot map (`stableanimator_tpu/convert/torch_to_jax.py::_convert`);
    this raises ValueError on all three, naming up to ten keys, so a UNet
    with only some of the adapter's keys is refused for those it lacks.
    Returns the number of tensors the file holds, and whether it is a
    vanilla UNet (to be loaded with `init_id_adapter`)."""
    kept = {k: tuple(v) for k, v in shapes.items() if _keep(name, k)}
    n_file = len(kept)
    vanilla = name == "unet" and is_vanilla_unet(kept)
    if vanilla:
        kept = init_id_adapter_from_svd(kept)
    params = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    unmapped = sorted(set(kept) - set(params))
    if unmapped:
        raise ValueError(f"{name}: unmapped torch keys ({len(unmapped)}): {unmapped[:10]} ...")
    missing = sorted(set(params) - set(kept))
    if missing:
        raise ValueError(f"{name}: parameters the file lacks ({len(missing)}): "
                         f"{missing[:10]} ...")
    wrong = [(k, kept[k], params[k]) for k in sorted(kept) if kept[k] != params[k]]
    if wrong:
        raise ValueError(f"{name}: shapes that differ from the model's, (key, file, model) "
                         f"({len(wrong)}): {wrong[:10]} ...")
    return n_file, vanilla


def load_state_dicts(checkpoint_dir: str, models, allow_random_init: bool,
                     init_id_adapter: bool) -> list[str]:
    """Load each model's `.npz` from `checkpoint_dir` into `models` (an
    AnimationModels) with strict key matching; values are cast to each
    parameter's dtype. A missing file raises, unless `allow_random_init`,
    which keeps the module's current (seeded) weights. `init_id_adapter`
    fills a vanilla UNet's ID adapter from SVD's cross-attention
    (`init_id_adapter_from_svd`; a UNet with part of the adapter raises).
    Returns the names of the models loaded."""
    loaded = []
    for name, fname in CHECKPOINT_FILES.items():
        path = os.path.join(checkpoint_dir, fname)
        if not os.path.exists(path):
            if not allow_random_init:
                raise FileNotFoundError(f"{path} not found (or pass allow_random_init for a "
                                        "smoke run on seeded weights)")
            print(f"WARNING: {path} missing; {name} keeps its seeded random weights")
            continue
        with np.load(path) as z:
            sd = {k: torch.from_numpy(z[k]) for k in z.files if _keep(name, k)}
        if name == "unet" and init_id_adapter:
            sd = init_id_adapter_from_svd(sd)
        getattr(models, name).load_state_dict(sd, strict=True)
        loaded.append(name)
    return loaded
