"""Seeded weights for a configuration: the same tensors for the program and
for the plain reference.

Rules (frozen here, whatever the program's own initialiser does): norm
scales and PoseNet's scale 1, biases 0, every other leaf uniform in
+-sqrt(3) * std, std = 1 / sqrt(fan_in) for matrices and kernels (a
position embedding's fan-in is its number of positions) and 0.05 for
vectors. Each model's leaves are drawn in one call from a generator of its
own on the device, in the order of the reference's state dict, so a seed
gives the same weights whatever the dtypes they are served in, and one
model's weights can be made again without the others.

The rules hold for every model family. What names the models, builds them
and says which leaves are norm scales and float32 islands is the family's:
here the SVD family's (`ORDER`, `reference/models.py`, `_served_dtype`), for
a configuration file without a `"family"` key; with `"family": "<name>"`,
`benchmark/families/<name>.py`'s `ORDER`, `build`, `NORMS` and
`served_dtype` (`common.family`).
"""

from __future__ import annotations

import math
import types

import torch
import torch.nn as nn

from benchmark import common
from benchmark.reference import models as ref_models

ORDER = ("unet", "vae", "clip", "pose_net", "face_encoder")


def _rule(module: nn.Module, name: str, shape, norms: tuple) -> tuple[str, float]:
    """("one" | "zero" | "uniform", limit) for one leaf; `norms`: the module
    classes whose `weight` is a scale."""
    if name == "scale" or (isinstance(module, norms) and name == "weight"):
        return "one", 0.0
    if name == "bias":
        return "zero", 0.0
    if len(shape) >= 2:
        fan_in = shape[0] if isinstance(module, nn.Embedding) else math.prod(shape[1:])
        return "uniform", math.sqrt(3.0) / math.sqrt(fan_in)
    return "uniform", math.sqrt(3.0) * 0.05


def _served_dtype(model: str, module: nn.Module, key: str, name: str, dtype: torch.dtype):
    """The dtype an SVD-family leaf is served in: `dtype`, except the float32
    islands (norm affines, AlphaBlender mixes, the VAE encoder and
    quant_conv)."""
    if (isinstance(module, ref_models.NORMS) or name == "mix_factor"
            or (model == "vae" and key.startswith(("encoder.", "quant_conv.")))):
        return torch.float32
    return dtype


SVD = types.SimpleNamespace(ORDER=ORDER, build=ref_models.build, NORMS=ref_models.NORMS,
                            served_dtype=_served_dtype)


def make(cfg: dict, seed: int, device, dtype: torch.dtype,
         models=None) -> dict[str, dict[str, torch.Tensor]]:
    """{model: state dict} of the configuration's `models` (default all of
    its family's `ORDER`), each leaf in its served dtype (`dtype` outside
    the family's float32 islands; float32 gives float32 everywhere), drawn
    on `device` from `seed`."""
    family = common.family(cfg) or SVD
    meta = family.build(cfg, None, meta=True)
    out = {}
    for model in family.ORDER if models is None else models:
        gen = torch.Generator(device=device).manual_seed(
            common.stream_seed(seed, "weights", model))
        mod = meta[model]
        leaves = []
        for mod_name, sub in mod.named_modules():
            for name, p in sub.named_parameters(recurse=False):
                key = f"{mod_name}.{name}" if mod_name else name
                leaves.append((key, p.shape, *_rule(sub, name, p.shape, family.NORMS),
                               family.served_dtype(model, sub, key, name, dtype)))
        total = sum(math.prod(s) for _, s, *_ in leaves)
        flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
        sd, at = {}, 0
        for key, shape, kind, lim, served in leaves:
            n = math.prod(shape)
            u = flat[at:at + n].view(shape)
            at += n
            if kind == "one":
                sd[key] = torch.ones(shape, device=device, dtype=served)
            elif kind == "zero":
                sd[key] = torch.zeros(shape, device=device, dtype=served)
            else:
                sd[key] = u.mul(2.0 * lim).sub_(lim).to(served)
        del flat
        out[model] = sd
    return out

