"""The frame axis's collectives: what GSPMD inserts in the JAX package's
frame-sharded UNet, written out once.

Under a mesh with frame > 1 (the active mesh, `ops/gate.py`) each rank
holds a contiguous block of every tile's frames. Three kinds of UNet op mix
frames:
  * the temporal convolutions (kernel 3 over frames): `halo_exchange` adds
    the neighbouring blocks' edge frames, zeros at the tile's true ends;
  * the temporal GroupNorms, whose statistics cover every frame:
    `ops/norms.py::group_norm(stats_group=frame_group())` all-reduces the
    two sums;
  * temporal self-attention over the frames: `frames_to_rows` moves from
    frame-sharded [R, F/n, ...] to row-sharded [R/n, F, ...] (one
    all-to-all), the attention runs locally, `rows_to_frames` moves back;
and the frame embedding reads the block's global frame indices
(`frame_offset`) and the first frame's context (`first_frame`).

Without such a mesh every function here is the identity and calls nothing.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from stableanimator_tpu_torch.ops.gate import active_mesh
from stableanimator_tpu_torch.parallel.mesh import FRAME_AXIS


def frame_mesh():
    """The active mesh when it splits frames, else None."""
    mesh = active_mesh()
    return mesh if mesh is not None and mesh.shape[FRAME_AXIS] > 1 else None


def frame_group():
    """The process group of this rank's frame blocks, or None."""
    mesh = frame_mesh()
    return None if mesh is None else mesh.group(FRAME_AXIS)


def frame_blocks() -> int:
    """How many blocks the frames are split into (1 without a frame mesh)."""
    mesh = frame_mesh()
    return 1 if mesh is None else mesh.shape[FRAME_AXIS]


def frame_offset(local_frames: int) -> int:
    """The global index of this rank's first frame (blocks of equal size)."""
    mesh = frame_mesh()
    return 0 if mesh is None else mesh.coordinate[FRAME_AXIS] * local_frames


def _all_gather(x: torch.Tensor, mesh) -> list[torch.Tensor]:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.shape[FRAME_AXIS])]
    dist.all_gather(parts, x, group=mesh.group(FRAME_AXIS))
    return parts


def halo_exchange(x: torch.Tensor, frame_axis: int, width: int = 1) -> torch.Tensor:
    """x with `width` frames added on each side of `frame_axis`: the last
    frames of the previous block and the first of the next, zeros before the
    first block and after the last. Without a frame mesh, x itself (no
    halo)."""
    mesh = frame_mesh()
    if mesh is None:
        return x
    n, r = mesh.shape[FRAME_AXIS], mesh.coordinate[FRAME_AXIS]
    length = x.shape[frame_axis]
    if length < width:
        raise ValueError(f"{length} frames per block, halo {width}")
    edges = torch.cat([x.narrow(frame_axis, 0, width),
                       x.narrow(frame_axis, length - width, width)], frame_axis)
    parts = _all_gather(edges, mesh)
    zeros = torch.zeros_like(x.narrow(frame_axis, 0, width))
    left = parts[r - 1].narrow(frame_axis, width, width) if r > 0 else zeros
    right = parts[r + 1].narrow(frame_axis, 0, width) if r < n - 1 else zeros
    return torch.cat([left, x, right], frame_axis)


def frames_to_rows(x: torch.Tensor) -> torch.Tensor:
    """[R, F/n, ...] (every row, this rank's frames) -> [R/n, F, ...] (this
    rank's rows, every frame): one all-to-all over the frame group. R must
    split n ways."""
    mesh = frame_mesh()
    if mesh is None:
        return x
    n = mesh.shape[FRAME_AXIS]
    r, f = x.shape[:2]
    if r % n:
        raise ValueError(f"{r} rows do not split {n} ways")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group(FRAME_AXIS))
    # out: [source rank i][my R/n rows][source i's frames]
    out = out.reshape((n, r // n, f) + x.shape[2:]).transpose(0, 1)
    return out.reshape((r // n, n * f) + x.shape[2:])


def rows_to_frames(x: torch.Tensor) -> torch.Tensor:
    """The inverse of `frames_to_rows`: [R/n, F, ...] -> [R, F/n, ...]."""
    mesh = frame_mesh()
    if mesh is None:
        return x
    n = mesh.shape[FRAME_AXIS]
    rn, f = x.shape[:2]
    x = x.reshape((rn, n, f // n) + x.shape[2:]).transpose(0, 1).contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group(FRAME_AXIS))
    return out.reshape((n * rn, f // n) + x.shape[3:])


def gather_frames(x: torch.Tensor, frame_axis: int) -> torch.Tensor:
    """Every block's frames along `frame_axis`, on every rank of the group."""
    mesh = frame_mesh()
    if mesh is None:
        return x
    return torch.cat(_all_gather(x, mesh), frame_axis)


def first_frame(x: torch.Tensor) -> torch.Tensor:
    """The first frame block's x (broadcast from frame index 0): what
    "frame 0" means when the frames are split."""
    mesh = frame_mesh()
    if mesh is None:
        return x
    x = x.contiguous().clone()
    dist.broadcast(x, src=mesh.src_rank(FRAME_AXIS), group=mesh.group(FRAME_AXIS))
    return x
