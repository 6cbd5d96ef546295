"""The (data, frame) mesh over a torch.distributed world (port of the JAX
package's `parallel/mesh.py`).

Two mesh axes, as in the JAX package:
  * "data":  data parallelism: the training batch, and at inference the
    CFG x temporal-tile batch of the UNet call;
  * "frame": sequence parallelism over the video frame axis: the UNet's
    frames within a tile, and the VAE's decode chunks.

GSPMD partitions the JAX package's programs and inserts the collectives.
PyTorch does not: here every process is one rank of the mesh, holds its own
slice of a sharded tensor, and the code calls the collectives itself (the
frame axis's in `parallel/sequence.py`). A `Sharding` says which slice a
rank holds (`local`) and puts the full tensor back on every rank
(`gather`). An axis of size 1 calls no collective.

On CUDA the mesh runs over NCCL, one card per process, unless the caller
set the world up with gloo: gloo lets several ranks share one card, which
NCCL refuses. On the CPU it runs over gloo.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
FRAME_AXIS = "frame"
AXES = (DATA_AXIS, FRAME_AXIS)
# elements of fp32 per collective when many tensors are reduced or gathered
# together (ZeRO's gather, the gradients' all-reduce): 256 MB
BUCKET_ELEMENTS = 64 * 2**20


def _axes(axes) -> tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if not axes or any(a not in AXES for a in axes) or list(axes) != sorted(axes, key=AXES.index):
        raise ValueError(f"mesh axes {axes}: expected some of {AXES}, in that order")
    return axes


class Mesh:
    """This rank's view of a (data, frame) mesh: the DeviceMesh, the
    sub-group of each axis, this rank's coordinates and its device. `shape`,
    `size` and `axis_names` read as the JAX Mesh's do."""

    axis_names = AXES

    def __init__(self, device_mesh: DeviceMesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        data, frame = device_mesh.shape
        self.shape = {DATA_AXIS: data, FRAME_AXIS: frame}
        self.size = data * frame
        coord = device_mesh.get_coordinate()
        self.coordinate = {DATA_AXIS: coord[0], FRAME_AXIS: coord[1]}
        self.groups = {a: device_mesh.get_group(a) for a in AXES}

    def __repr__(self):
        return (f"Mesh(data={self.shape[DATA_AXIS]}, frame={self.shape[FRAME_AXIS]}, "
                f"coordinate={self.coordinate}, device={self.device})")

    def axis_size(self, axes) -> int:
        n = 1
        for a in _axes(axes):
            n *= self.shape[a]
        return n

    def axis_index(self, axes) -> int:
        """This rank's index along `axes` (row-major over several)."""
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + self.coordinate[a]
        return i

    def group(self, axes):
        """The process group over `axes`: an axis's sub-group, or the whole
        mesh (the world) for both."""
        axes = _axes(axes)
        return self.groups[axes[0]] if len(axes) == 1 else dist.group.WORLD

    def src_rank(self, axes) -> int:
        """The global rank at index 0 of this rank's group over `axes`."""
        return dist.get_global_rank(self.group(axes), 0) if len(_axes(axes)) == 1 else 0


def _init_world(backend: str) -> None:
    """Join the torch.distributed world: torchrun's (its environment), a
    world the caller set up (it must run `backend`), or else a world of one
    process, in memory."""
    if dist.is_initialized():
        have = dist.get_backend()
        if backend not in str(have):
            raise ValueError(f"the process group runs {have}; a {backend} mesh needs a "
                             f"{backend} process group")
        return
    if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def _backend(device: torch.device) -> str:
    """The collectives' backend for a mesh on `device`: gloo on the CPU; on
    the card NCCL, or gloo in a world the caller set up with gloo (never
    because NCCL failed)."""
    if device.type == "cpu":
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"no mesh on {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the port on the CPU")
    return "gloo" if dist.is_initialized() and dist.get_backend() == "gloo" else "nccl"


def make_mesh(data: int = 1, frame: int = 1, devices=None, *,
              device: torch.device | str = "cuda") -> Mesh:
    """Build a (data, frame) mesh over the world's ranks, rank r at
    (r // frame, r % frame). `devices`, as the JAX function's, lists what to
    lay out: here the world's ranks, in order (the default), since every
    rank of the world joins the mesh. With the defaults (1, 1) and several
    ranks, every rank goes on the data axis. device="cuda" runs on the card
    LOCAL_RANK, else the rank modulo the cards: over NCCL, one card per
    process, or over gloo in a world the caller set up with gloo, which lets
    several ranks share one card. device="cpu" runs over gloo."""
    device = torch.device(device)
    _init_world(_backend(device))
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    n = len(ranks)
    if data * frame == 1 and n > 1:
        data = n
    if data * frame > n:
        raise ValueError(f"mesh {data}x{frame} needs {data * frame} devices, have {n}")
    if data * frame != world or ranks[:world] != list(range(world)):
        raise ValueError(f"mesh {data}x{frame} must hold the ranks of the world of {world} "
                         "in order")
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    dm = DeviceMesh(device.type, torch.arange(world).reshape(data, frame), mesh_dim_names=AXES)
    return Mesh(dm, device)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor lies on the mesh: `spec` names, for each leading dim, the
    axis (or axes) it is split over, or None (replicated). The split is into
    equal contiguous blocks, block i on the rank at index i along the axes."""

    mesh: Mesh
    spec: tuple = ()

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the full tensor x (a view)."""
        for dim, axes in enumerate(self.spec):
            if axes is None:
                continue
            n = self.mesh.axis_size(axes)
            if n == 1:
                continue
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways")
            c = x.shape[dim] // n
            x = x.narrow(dim, self.mesh.axis_index(axes) * c, c)
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The full tensor, on every rank, from each rank's block x."""
        for dim in reversed(range(len(self.spec))):
            axes = self.spec[dim]
            if axes is None or self.mesh.axis_size(axes) == 1:
                continue
            x = x.contiguous()
            parts = [torch.empty_like(x) for _ in range(self.mesh.axis_size(axes))]
            dist.all_gather(parts, x, group=self.mesh.group(axes))
            x = torch.cat(parts, dim)
        return x


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh: Mesh, ndim: int = 2) -> Sharding:
    """Leading axis over the data axis; rest replicated."""
    return Sharding(mesh, (DATA_AXIS,) + (None,) * (ndim - 1))


def video_sharding(mesh: Mesh, ndim: int = 5) -> Sharding:
    """[B, F, ...] tensors: batch over data, frames over the frame axis."""
    return Sharding(mesh, (DATA_AXIS, FRAME_AXIS) + (None,) * (ndim - 2))


@torch.no_grad()
def shard_params(modules, mesh: Mesh):
    """Replicate parameters across the mesh: every parameter and buffer of
    `modules` (a module or a tuple of them) broadcast from the mesh's first
    rank, so that every rank computes with rank 0's weights. Returns
    `modules`."""
    if mesh.size > 1:
        for m in (modules if isinstance(modules, tuple) else (modules,)):
            for t in m.state_dict().values():
                dist.broadcast(t, src=mesh.src_rank(AXES), group=mesh.group(AXES))
    return modules


def zero_sharding_for(x, mesh: Mesh, axis=DATA_AXIS) -> Sharding:
    """ZeRO-1 sharding of one optimizer-state leaf: split the first dim that
    the size of `axis` divides (one axis name, or a tuple: their combined
    size); replicate scalars and odd shapes."""
    n = 1
    for a in ((axis,) if isinstance(axis, str) else tuple(axis)):
        n *= mesh.shape[a]
    spec = [None] * len(getattr(x, "shape", ()))
    for i, dim in enumerate(getattr(x, "shape", ())):
        if dim % n == 0 and dim >= n:
            spec[i] = axis
            break
    return Sharding(mesh, tuple(spec))


def shard_optimizer_state(masters: list[torch.Tensor], mesh: Mesh,
                          axis=DATA_AXIS) -> list[torch.Tensor]:
    """ZeRO-1 over the fp32 masters: this rank's block of each master
    (`zero_sharding_for`), as a view. An optimizer built over these views
    keeps its moments for this rank's blocks only, so optimizer memory
    scales as 1 / the axis size; `gather_masters` refreshes the other
    ranks' blocks after each update."""
    return [zero_sharding_for(m, mesh, axis).local(m) for m in masters]


def _buckets(tensors: list[torch.Tensor]):
    bucket, size = [], 0
    for t in tensors:
        if bucket and size + t.numel() > BUCKET_ELEMENTS:
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += t.numel()
    if bucket:
        yield bucket


@torch.no_grad()
def gather_masters(masters: list[torch.Tensor], mesh: Mesh, axis=DATA_AXIS) -> None:
    """After an update of each rank's blocks (`shard_optimizer_state`), put
    every rank's block into the full masters on every rank, in buckets of
    `BUCKET_ELEMENTS`. Replicated masters were updated whole everywhere."""
    n = mesh.axis_size(axis)
    if n == 1:
        return
    split = [(m, zero_sharding_for(m, mesh, axis)) for m in masters]
    split = [(m, s) for m, s in split if any(a is not None for a in s.spec)]
    for bucket in _buckets([m for m, _ in split]):
        specs = [zero_sharding_for(m, mesh, axis) for m in bucket]
        mine = torch.cat([s.local(m).reshape(-1) for m, s in zip(bucket, specs)])
        parts = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(parts, mine, group=mesh.group(axis))
        for r, part in enumerate(parts):
            off = 0
            for m, s in zip(bucket, specs):
                dim = next(i for i, a in enumerate(s.spec) if a is not None)
                c = m.shape[dim] // n
                block = m.narrow(dim, r * c, c)
                block.copy_(part[off:off + block.numel()].view(block.shape))
                off += block.numel()


@torch.no_grad()
def all_reduce_mean(tensors: list[torch.Tensor], mesh: Mesh, axis=DATA_AXIS) -> None:
    """Replace each tensor, in place, by its mean over `axis` (flattened in
    buckets of `BUCKET_ELEMENTS`, one all-reduce each)."""
    n = mesh.axis_size(axis)
    if n == 1:
        return
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=mesh.group(axis))
        flat /= n
        off = 0
        for t in bucket:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
