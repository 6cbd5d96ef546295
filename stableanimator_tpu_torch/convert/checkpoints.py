"""Reference checkpoints -> the port's models.

The checkpoint directory holds the reference's (diffusers / HF) state dicts
as `.npz` files, in the reference's key space, which the port's modules
share: the files the JAX package's `cli/animate.py::load_params` reads and
converts. Here they load straight into the modules with
`load_state_dict(strict=True)`. `check_state_dict` checks one file's keys
and shapes against a model on the meta device before anything is loaded
(`tools/ingest_checkpoints.py`), reading only the `.npz` members' headers
(`npz_shapes`).
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


def init_id_adapter_from_svd(unet_sd: dict) -> dict:
    """For a vanilla SVD UNet state dict (no `processor.id_to_k/v`),
    initialise the ID adapter from the spatial blocks' cross-attention
    to_k / to_v, as the reference does at load time
    (inference_basic.py:372-377). Returns a new dict; keys already present
    are kept."""
    out = dict(unet_sd)
    for key, value in unet_sd.items():
        m = _SPATIAL_ATTN2.fullmatch(key)
        if m:
            id_key = f"{m.group(1)}.processor.id_to_{m.group(2)}.weight"
            if id_key not in out:
                out[id_key] = value.clone()
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


def check_state_dict(name: str, shapes: dict, module: nn.Module) -> int:
    """Check a checkpoint file's {key: shape} against `module` (best on the
    meta device: `pipeline/animation.py::meta_models`) as the strict load
    will take it: after `_keep`, every key must name a parameter, every
    parameter must be in the file, and the shapes must match. The JAX
    package's converters raise on keys they cannot map
    (`stableanimator_tpu/convert/torch_to_jax.py::_convert`); this raises
    ValueError on all three, naming up to ten keys. Returns the number of
    tensors checked."""
    kept = {k: tuple(v) for k, v in shapes.items() if _keep(name, k)}
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
    return len(kept)


def load_state_dicts(checkpoint_dir: str, models, allow_random_init: bool,
                     init_id_adapter: bool) -> list[str]:
    """Load each model's `.npz` from `checkpoint_dir` into `models` (an
    AnimationModels) with strict key matching; values are cast to each
    parameter's dtype. A missing file raises, unless `allow_random_init`,
    which keeps the module's current (seeded) weights. `init_id_adapter`
    fills the UNet's ID adapter from SVD's cross-attention
    (`init_id_adapter_from_svd`). Returns the names of the models loaded."""
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
