"""Dump a torch or safetensors checkpoint to a numpy `.npz` (port of the root
`tools/dump_torch_checkpoint.py`), with torch, numpy and the standard
library only: `.safetensors` files go through the port's own reader
(`convert/safetensors_io.py`), so the `safetensors` package is not needed.

    python -m stableanimator_tpu_torch.tools.dump_torch_checkpoint \\
        --input checkpoints/Animation/pose_net.pth --output pose_net.npz
    python -m stableanimator_tpu_torch.tools.dump_torch_checkpoint \\
        --input checkpoints/SVD/.../vae/diffusion_pytorch_model.fp16.safetensors \\
        --output vae.npz

The `.npz` is the one the root tool writes: the same keys, dtypes and
values (a `.pth`'s fp16 / bf16 tensors as fp32, a `.safetensors` file's as
stored).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from stableanimator_tpu_torch.convert.safetensors_io import read_safetensors


def load_state_dict(path: str) -> dict[str, np.ndarray]:
    """The checkpoint's tensors as numpy arrays, by name: a `.safetensors`
    file's as stored (views of a memmap), a `.pth`'s (its `state_dict`
    entry, if it has one) with fp16 / bf16 cast to fp32."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.float().numpy() if v.dtype in (torch.float16, torch.bfloat16)
            else v.numpy() for k, v in sd.items()}


def main(argv=None) -> int:
    """Run the CLI; returns the number of tensors written."""
    ap = argparse.ArgumentParser(description="torch / safetensors checkpoint -> .npz")
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    args = ap.parse_args(argv)
    sd = load_state_dict(args.input)
    np.savez(args.output, **sd)
    print(f"wrote {len(sd)} tensors to {args.output}")
    return len(sd)


if __name__ == "__main__":
    main()
