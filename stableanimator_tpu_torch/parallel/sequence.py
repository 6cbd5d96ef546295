"""The frame axis's collectives: what GSPMD inserts in the JAX package's
frame-sharded UNet, written out once, forward and backward.

Under a mesh with frame > 1 (the active mesh, `ops/gate.py`) each rank
holds a contiguous block of every tile's frames. Three kinds of UNet op mix
frames:
  * the temporal convolutions (kernel 3 over frames): `halo_exchange` adds
    the neighbouring blocks' edge frames, zeros at the tile's true ends;
  * the temporal GroupNorms, whose statistics cover every frame:
    `ops/norms.py::group_norm(stats_group=frame_group())` sums the two
    sums over the group (`all_reduce_sum`);
  * temporal self-attention over the frames: `frames_to_rows` moves from
    frame-sharded [R, F/n, ...] to row-sharded [R/n, F, ...] (one
    all-to-all), the attention runs locally, `rows_to_frames` moves back;
    or, where the rows do not split, `gather_frames` hands every rank every
    block;
and the frame embedding reads the block's global frame indices
(`frame_offset`) and the first frame's context (`first_frame`).

Each collective is a `torch.autograd.Function` whose backward is its
transpose, so that a training step's backward carries every cross-rank
term. Every rank seeds its backward with the gradient of its own loss; a
transpose sums what the ranks send and never averages (the step's mean over
the mesh is the one normalisation):
  * `halo_exchange`: the halo's gradient goes back to the block that owns
    those frames and is added to its edge frames; the zero padding's is
    dropped;
  * `frames_to_rows` and `rows_to_frames`: each is the other's backward;
  * `gather_frames`: the gradient summed over the group (an all-reduce),
    this rank's block of it;
  * `first_frame`: every rank's gradient summed on the group's first rank
    (an all-reduce), zero on the others;
  * `all_reduce_sum`: an all-reduce of the gradient;
  * `frame_offset` is an integer and carries none.

The mesh may run gloo with every rank on one card (`parallel/mesh.py`):
gloo takes each collective used here on CUDA tensors, so the tensors stay
on the card.

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


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: x summed over the group's ranks."""
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, frame_axis: int, width: int, mesh):
        ctx.frame_axis, ctx.width, ctx.mesh = frame_axis, width, mesh
        n, r = mesh.shape[FRAME_AXIS], mesh.coordinate[FRAME_AXIS]
        length = x.shape[frame_axis]
        edges = torch.cat([x.narrow(frame_axis, 0, width),
                           x.narrow(frame_axis, length - width, width)], frame_axis)
        parts = _all_gather(edges, mesh)
        zeros = torch.zeros_like(x.narrow(frame_axis, 0, width))
        left = parts[r - 1].narrow(frame_axis, width, width) if r > 0 else zeros
        right = parts[r + 1].narrow(frame_axis, 0, width) if r < n - 1 else zeros
        return torch.cat([left, x, right], frame_axis)

    @staticmethod
    def backward(ctx, g):
        axis, width, mesh = ctx.frame_axis, ctx.width, ctx.mesh
        n, r = mesh.shape[FRAME_AXIS], mesh.coordinate[FRAME_AXIS]
        length = g.shape[axis] - 2 * width
        # every rank's halo gradients: block i's left halo is block i-1's
        # last frames, its right halo block i+1's first frames
        parts = _all_gather(torch.cat([g.narrow(axis, 0, width),
                                       g.narrow(axis, width + length, width)], axis), mesh)
        dx = g.narrow(axis, width, length).clone()
        if r > 0:
            dx.narrow(axis, 0, width).add_(parts[r - 1].narrow(axis, width, width))
        if r < n - 1:
            dx.narrow(axis, length - width, width).add_(parts[r + 1].narrow(axis, 0, width))
        return dx, None, None, None


def halo_exchange(x: torch.Tensor, frame_axis: int, width: int = 1) -> torch.Tensor:
    """x with `width` frames added on each side of `frame_axis`: the last
    frames of the previous block and the first of the next, zeros before the
    first block and after the last. Without a frame mesh, x itself (no
    halo)."""
    mesh = frame_mesh()
    if mesh is None:
        return x
    if x.shape[frame_axis] < width:
        raise ValueError(f"{x.shape[frame_axis]} frames per block, halo {width}")
    return _HaloExchange.apply(x, frame_axis, width, mesh)


def _frames_to_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    n = mesh.shape[FRAME_AXIS]
    r, f = x.shape[:2]
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group(FRAME_AXIS))
    # out: [source rank i][my R/n rows][source i's frames]
    out = out.reshape((n, r // n, f) + x.shape[2:]).transpose(0, 1)
    return out.reshape((r // n, n * f) + x.shape[2:])


def _rows_to_frames(x: torch.Tensor, mesh) -> torch.Tensor:
    n = mesh.shape[FRAME_AXIS]
    rn, f = x.shape[:2]
    x = x.reshape((rn, n, f // n) + x.shape[2:]).transpose(0, 1).contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group(FRAME_AXIS))
    return out.reshape((n * rn, f // n) + x.shape[3:])


class _FramesToRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _frames_to_rows(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _rows_to_frames(g, ctx.mesh), None


class _RowsToFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _rows_to_frames(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _frames_to_rows(g, ctx.mesh), None


def frames_to_rows(x: torch.Tensor) -> torch.Tensor:
    """[R, F/n, ...] (every row, this rank's frames) -> [R/n, F, ...] (this
    rank's rows, every frame): one all-to-all over the frame group. R must
    split n ways."""
    mesh = frame_mesh()
    if mesh is None:
        return x
    if x.shape[0] % mesh.shape[FRAME_AXIS]:
        raise ValueError(f"{x.shape[0]} rows do not split {mesh.shape[FRAME_AXIS]} ways")
    return _FramesToRows.apply(x, mesh)


def rows_to_frames(x: torch.Tensor) -> torch.Tensor:
    """The inverse of `frames_to_rows`: [R/n, F, ...] -> [R, F/n, ...]."""
    mesh = frame_mesh()
    if mesh is None:
        return x
    return _RowsToFrames.apply(x, mesh)


class _GatherFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, frame_axis: int, mesh):
        ctx.frame_axis, ctx.mesh = frame_axis, mesh
        return torch.cat(_all_gather(x, mesh), frame_axis)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        block = g.shape[ctx.frame_axis] // mesh.shape[FRAME_AXIS]
        g = _summed(g, mesh.group(FRAME_AXIS))
        return g.narrow(ctx.frame_axis, mesh.coordinate[FRAME_AXIS] * block, block), None, None


def gather_frames(x: torch.Tensor, frame_axis: int) -> torch.Tensor:
    """Every block's frames along `frame_axis`, on every rank of the group."""
    mesh = frame_mesh()
    if mesh is None:
        return x
    return _GatherFrames.apply(x, frame_axis, mesh)


class _FirstFrame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        x = x.contiguous().clone()
        dist.broadcast(x, src=mesh.src_rank(FRAME_AXIS), group=mesh.group(FRAME_AXIS))
        return x

    @staticmethod
    def backward(ctx, g):
        g = _summed(g, ctx.mesh.group(FRAME_AXIS))
        return (g if ctx.mesh.coordinate[FRAME_AXIS] == 0 else torch.zeros_like(g)), None


def first_frame(x: torch.Tensor) -> torch.Tensor:
    """The first frame block's x (broadcast from frame index 0): what
    "frame 0" means when the frames are split."""
    mesh = frame_mesh()
    if mesh is None:
        return x
    return _FirstFrame.apply(x, mesh)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the ranks of `group` (a new tensor on every rank); its
    gradient is the gradients' sum over the group."""
    return _AllReduceSum.apply(x, group)
