"""Reference checkpoints -> the port's models.

The checkpoint directory holds the reference's (diffusers / HF) state dicts
as `.npz` files, in the reference's key space, which the port's modules
share: the files the JAX package's `cli/animate.py::load_params` reads and
converts. Here they load straight into the modules with
`load_state_dict(strict=True)`.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

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
