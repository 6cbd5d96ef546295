"""Ranks of a torch.distributed world on the CPU (gloo) for the port's mesh
and data-parallel tests. JAX-free: the children import torch and the port
only, run one thread each, and meet through a FileStore.

    python -m tests.torch_mesh_worker TASK RANK WORLD STORE INPUTS OUTPUT

runs `TASK(rank, world, inputs)` (inputs: a torch.save'd object) and
torch.saves its result to OUTPUT. `run_ranks` starts WORLD of them and
returns their results in rank order.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys

import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(task: str, world: int, tmp_path, inputs, timeout: float = 300.0) -> list:
    """Run `task` in `world` processes; their results in rank order."""
    return collect_ranks(start_ranks(task, world, tmp_path, inputs), timeout)


def start_ranks(task: str, world: int, tmp_path, inputs):
    """Start `task` in `world` processes; `collect_ranks` waits for them."""
    tmp = str(tmp_path)
    inp = os.path.join(tmp, f"{task}_inputs.pt")
    torch.save(inputs, inp)
    store = os.path.join(tmp, f"{task}_store")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_mesh_worker", task, str(r), str(world), store, inp,
         os.path.join(tmp, f"{task}_out{r}.pt")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    return task, tmp, procs


def collect_ranks(started, timeout: float = 300.0) -> list:
    """The results, in rank order, of the processes `start_ranks` began."""
    task, tmp, procs = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    assert not bad, bad
    return [torch.load(os.path.join(tmp, f"{task}_out{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def micro_models(state_dicts, quant: bool = False, remat: bool = False):
    """The micro model zoo, fp32 on the CPU, with the given weights."""
    from stableanimator_tpu_torch.core.config import micro_model_kwargs
    from stableanimator_tpu_torch.pipeline.animation import build_models

    models = build_models(**micro_model_kwargs(), dtype=torch.float32, device="cpu", seed=None,
                          quant=quant, remat=remat)
    for name, sd in state_dicts.items():
        getattr(models, name).load_state_dict(sd, strict=True)
    return models


def generate_on(models, case: dict, mesh=None):
    from stableanimator_tpu_torch.core.config import PipelineConfig
    from stableanimator_tpu_torch.pipeline.animation import generate

    return generate(models, case["ref"], case["pose"], case["face"],
                    PipelineConfig(**case["cfg"]), aug_noise=case["aug"],
                    init_noise=case["init"], device="cpu", mesh=mesh)


def _collectives(mesh) -> dict:
    """Each frame-axis collective against its unsharded result on the 2 x 2
    mesh: (max abs difference, ...) per check."""
    import torch.nn.functional as F

    from stableanimator_tpu_torch.ops.gate import use_mesh
    from stableanimator_tpu_torch.ops.norms import group_norm
    from stableanimator_tpu_torch.parallel import sequence
    from stableanimator_tpu_torch.parallel.mesh import FRAME_AXIS

    gen = torch.Generator().manual_seed(5)
    n, r = mesh.shape[FRAME_AXIS], mesh.coordinate[FRAME_AXIS]
    out = {}
    x = torch.randn((2, 6, 3, 3, 4), generator=gen)
    blk = 6 // n
    with use_mesh(mesh):
        got = sequence.halo_exchange(x[:, r * blk:(r + 1) * blk], 1, 1)
        want = F.pad(x, (0, 0, 0, 0, 0, 0, 1, 1))[:, r * blk:r * blk + blk + 2]
        out["halo"] = (got - want).abs().max().item()
        y = torch.randn((2, 6, 4, 4, 64), generator=gen) * 3 + 1
        w, b = torch.randn(64, generator=gen), torch.randn(64, generator=gen)
        got = group_norm(y[:, r * blk:(r + 1) * blk], w, b, 32, 1e-6,
                         stats_group=sequence.frame_group())
        out["group_norm"] = (got - group_norm(y, w, b, 32, 1e-6)[:, r * blk:(r + 1) * blk]
                             ).abs().max().item()
        z = torch.randn((6, 4, 2, 3), generator=gen)
        rows = sequence.frames_to_rows(z[:, r * 2:(r + 1) * 2])
        out["frames_to_rows"] = (rows - z[r * 3:(r + 1) * 3]).abs().max().item()
        out["rows_to_frames"] = (sequence.rows_to_frames(rows) - z[:, r * 2:(r + 1) * 2]
                                 ).abs().max().item()
    return out


def _temporal_transformer(mesh) -> dict:
    """A transformer whose context differs by frame, sharded over frames
    against the same one unsharded; and the same with the block's local
    frame indices or local first frame, which must differ."""
    from unittest import mock

    from stableanimator_tpu_torch.models.transformer import TransformerSpatioTemporalModel
    from stableanimator_tpu_torch.ops.gate import use_mesh
    from stableanimator_tpu_torch.parallel import sequence
    from stableanimator_tpu_torch.parallel.mesh import FRAME_AXIS
    from stableanimator_tpu_torch.pipeline.animation import fill_parameters

    b, f = 2, 4
    model = TransformerSpatioTemporalModel(2, 16, 32, 48)
    fill_parameters(model, 7)
    gen = torch.Generator().manual_seed(8)
    x = torch.randn((b * f, 4, 4, 32), generator=gen)
    ctx = torch.randn((b * f, 5, 48), generator=gen)
    n, r = mesh.shape[FRAME_AXIS], mesh.coordinate[FRAME_AXIS]
    fl = f // n

    def mine(t):
        return t.reshape((b, f) + t.shape[1:])[:, r * fl:(r + 1) * fl].reshape((-1,) + t.shape[1:])

    with torch.no_grad():
        want = mine(model(x, ctx, num_frames=f))
        out = {}
        with use_mesh(mesh):
            out["sharded"] = (model(mine(x), mine(ctx), num_frames=fl) - want).abs().max().item()
            with mock.patch.object(sequence, "frame_offset", lambda frames: 0):
                out["local_frame_ids"] = (model(mine(x), mine(ctx), num_frames=fl) - want
                                          ).abs().max().item()
            with mock.patch.object(sequence, "first_frame", lambda t: t):
                out["local_first_frame"] = (model(mine(x), mine(ctx), num_frames=fl) - want
                                            ).abs().max().item()
    return out


def _unet_call(models, mesh) -> dict:
    """One micro UNet call on a CFG pair of 4-frame tiles, sharded over the
    mesh (`pipeline.animation._unet`) against the same call on one rank:
    the largest difference and the output's largest magnitude."""
    from stableanimator_tpu_torch.ops.gate import use_mesh
    from stableanimator_tpu_torch.pipeline.animation import _unet

    gen = torch.Generator().manual_seed(6)
    batch = torch.randn((2, 4, 8, 8, 8), generator=gen)
    ctx = torch.randn((2, 5, 48), generator=gen)
    ids = torch.tensor([[6.0, 127.0, 0.02]] * 2)
    pose = torch.randn((8, 8, 8, 32), generator=gen)
    t = torch.tensor(0.25 * 3.0)
    with torch.no_grad():
        want = _unet(models, batch, t, ctx, ids, pose, None)
        with use_mesh(mesh):
            got = _unet(models, batch, t, ctx, ids, pose, mesh)
    return {"max_diff": (got - want).abs().max().item(), "scale": want.abs().max().item()}


def mesh_suite(rank: int, world: int, inputs: dict) -> dict:
    """make_mesh's rules, the frame collectives, the temporal transformer,
    one UNet call, and the flat and grouped micro generates on a 2 x 2 mesh;
    the flat one also on a 1 x 4 mesh (one frame per block); and the UNet
    call and both generates on a 4 x 1 mesh, whose data axis outnumbers the
    CFG pair's 2 rows."""
    from stableanimator_tpu_torch.parallel import make_mesh, shard_params

    out = {}
    whole = make_mesh(device="cpu")
    out["default_shape"] = dict(whole.shape)
    with contextlib.suppress(ValueError):
        make_mesh(4, 2, device="cpu")
        out["oversize"] = "no error"
    out.setdefault("oversize", "ValueError")
    mesh = make_mesh(2, 2, device="cpu")
    out["coordinate"] = dict(mesh.coordinate)
    out["collectives"] = _collectives(mesh)
    out["transformer"] = _temporal_transformer(mesh)
    models = shard_params(micro_models(inputs["state_dicts"]), mesh)
    out["unet"] = _unet_call(models, mesh)
    with torch.no_grad():
        for name in ("flat", "grouped"):
            out[name] = generate_on(models, inputs[name], mesh)
        out["flat_frame4"] = generate_on(models, inputs["flat"], make_mesh(1, 4, device="cpu"))
        data4 = make_mesh(4, 1, device="cpu")
        out["unet_data4"] = _unet_call(models, data4)
        for name in ("flat", "grouped"):
            out[f"{name}_data4"] = generate_on(models, inputs[name], data4)
    return out


def train_steps(models, inputs: dict, n_steps: int, mesh=None, state_dict=None):
    """`n_steps` fp32 training steps on the global batch (this rank's block
    under a mesh) with the given global draws, from `state_dict` when given.
    Returns (state, [(loss, grad_norm)] per step)."""
    from stableanimator_tpu_torch.core.config import PipelineConfig, TrainConfig
    from stableanimator_tpu_torch.train.train_step import (
        create_train_state,
        make_train_step,
        shard_batch,
    )

    cfg = TrainConfig(**inputs["cfg"])
    state = create_train_state(models, cfg, mesh=mesh)
    if state_dict is not None:
        state.load_state_dict(state_dict)
    step_fn = make_train_step(models, cfg, PipelineConfig(), conditioning_dropout_prob=0.1,
                              mesh=mesh)
    batch = inputs["batch"]
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    metrics = []
    for noises in inputs["noises"][state.step:state.step + n_steps]:
        state, m = step_fn(state, batch, noises=noises)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return state, metrics


def _held(state) -> int:
    """How many moment elements this rank's optimizer holds."""
    return sum(v.numel() for st in state.optimizer.state.values()
               for k, v in st.items() if k in ("exp_avg", "exp_avg_sq"))


def dp_step(rank: int, world: int, inputs: dict) -> dict:
    """Two data-parallel ZeRO-1 steps over the world; the consolidated
    state dict, and how many moment elements this rank holds."""
    from stableanimator_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device="cpu")
    state, metrics = train_steps(micro_models(inputs["state_dicts"]), inputs, 2, mesh)
    return {"metrics": metrics, "state_dict": state.state_dict(), "held": _held(state)}


def _grads_against_unsharded(mesh, sharded, unsharded, inputs, cotangents, params=()):
    """Autograd through `sharded` (this rank's block of each input -> this
    rank's output) against autograd through `unsharded` (the whole inputs
    -> every rank's output, a list) on this process, each output seeded with
    its cotangent. Returns [(got, want)] for this rank's block of each
    input's gradient (`inputs`: (whole tensor, this rank's block of it as a
    function)), and for each of `params` the gradient summed over the
    ranks against the unsharded one."""
    from stableanimator_tpu_torch.ops.gate import use_mesh
    from stableanimator_tpu_torch.parallel.mesh import FRAME_AXIS

    r = mesh.coordinate[FRAME_AXIS]
    blocks = [mine(x).detach().clone().requires_grad_() for x, mine in inputs]
    with use_mesh(mesh):
        out = sharded(*blocks)
    (out * cotangents[r]).sum().backward()
    got = [b.grad for b in blocks]

    def param_grads():           # (a parameter the function does not use has none)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad.clone() for p in params]
        for p in params:
            p.grad = None
        return grads

    got_params = param_grads()
    for g in got_params:
        dist.all_reduce(g, group=mesh.group(FRAME_AXIS))
    whole = [x.detach().clone().requires_grad_() for x, _ in inputs]
    outs = unsharded(*whole)
    sum((o * c).sum() for o, c in zip(outs, cotangents)).backward()
    want = [mine(w.grad) for w, (_, mine) in zip(whole, inputs)]
    return list(zip(got, want)) + list(zip(got_params, param_grads()))


def _collective_grads(mesh) -> dict:
    """Each frame collective's backward, and group_norm's over the frame
    group, against autograd of the unsharded function; and a temporal
    transformer's at 4x4 tokens (the all-to-all branch) and at 1x1 with one
    clip (the gather_frames branch, the rows do not split)."""
    import torch.nn.functional as F

    from stableanimator_tpu_torch.models.transformer import TransformerSpatioTemporalModel
    from stableanimator_tpu_torch.ops.norms import group_norm
    from stableanimator_tpu_torch.parallel import sequence
    from stableanimator_tpu_torch.parallel.mesh import FRAME_AXIS
    from stableanimator_tpu_torch.pipeline.animation import fill_parameters

    gen = torch.Generator().manual_seed(9)
    n, r = mesh.shape[FRAME_AXIS], mesh.coordinate[FRAME_AXIS]

    def randn(*shape):
        return torch.randn(shape, generator=gen)

    def block(axis, size):
        return lambda t: t.narrow(axis, r * size, size)

    out = {}
    x = randn(2, 6, 3, 3, 4)
    out["halo_exchange"] = _grads_against_unsharded(
        mesh, lambda xb: sequence.halo_exchange(xb, 1, 1),
        lambda xw: [F.pad(xw, (0, 0, 0, 0, 0, 0, 1, 1))[:, i * 3:i * 3 + 5] for i in range(n)],
        [(x, block(1, 3))], randn(n, 2, 5, 3, 3, 4))
    z = randn(6, 4, 2, 3)
    out["frames_to_rows"] = _grads_against_unsharded(
        mesh, sequence.frames_to_rows, lambda zw: [zw[i * 3:(i + 1) * 3] for i in range(n)],
        [(z, block(1, 2))], randn(n, 3, 4, 2, 3))
    out["rows_to_frames"] = _grads_against_unsharded(
        mesh, sequence.rows_to_frames, lambda zw: [zw[:, i * 2:(i + 1) * 2] for i in range(n)],
        [(z, block(0, 3))], randn(n, 6, 2, 2, 3))
    out["gather_frames"] = _grads_against_unsharded(
        mesh, lambda xb: sequence.gather_frames(xb, 1), lambda xw: [xw] * n,
        [(x, block(1, 3))], randn(n, 2, 6, 3, 3, 4))
    per_rank = randn(n, 2, 5, 8)
    out["first_frame"] = _grads_against_unsharded(
        mesh, sequence.first_frame, lambda pw: [pw[0]] * n,
        [(per_rank, lambda t: t[r])], randn(n, 2, 5, 8))
    y = randn(2, 6, 4, 4, 64) * 3 + 1
    w = randn(64).requires_grad_()
    b = randn(64).requires_grad_()
    out["group_norm"] = _grads_against_unsharded(
        mesh, lambda yb: group_norm(yb, w, b, 32, 1e-6, stats_group=sequence.frame_group()),
        lambda yw: [group_norm(yw, w, b, 32, 1e-6)[:, i * 3:(i + 1) * 3] for i in range(n)],
        [(y, block(1, 3))], randn(n, 2, 3, 4, 4, 64), params=(w, b))

    model = TransformerSpatioTemporalModel(2, 16, 32, 48)
    fill_parameters(model, 7)
    f = 4
    fl = f // n
    for name, clips, side in (("transformer_all_to_all", 2, 4), ("transformer_gather", 1, 1)):
        def mine(t, clips=clips):
            t = t.reshape((clips, f) + t.shape[1:])[:, r * fl:(r + 1) * fl]
            return t.reshape((-1,) + t.shape[2:])

        def theirs(t, i, clips=clips):
            t = t.reshape((clips, f) + t.shape[1:])[:, i * fl:(i + 1) * fl]
            return t.reshape((-1,) + t.shape[2:])

        x = randn(clips * f, side, side, 32)
        ctx = randn(clips * f, 5, 48)
        cot = randn(clips * f, side, side, 32)
        out[name] = _grads_against_unsharded(
            mesh, lambda xb, cb: model(xb, cb, num_frames=fl),
            lambda xw, cw: [theirs(o, i) for o in [model(xw, cw, num_frames=f)]
                            for i in range(n)],
            [(x, mine), (ctx, mine)], torch.stack([theirs(cot, i) for i in range(n)]),
            params=tuple(model.parameters()))
    return out


def frame_train(rank: int, world: int, inputs: dict) -> dict:
    """Two ZeRO-1 steps of the remat micro models on a (world / 2) x 2
    mesh, frames split in two (the backward's recomputation sees the
    forward's mesh only through the checkpoint, since the step runs the
    backward outside its `use_mesh`); on a 1 x 2 mesh first the
    collectives' gradients (`_collective_grads`)."""
    from stableanimator_tpu_torch.parallel import make_mesh

    mesh = make_mesh(world // 2, 2, device="cpu")
    out = {"grads": _collective_grads(mesh)} if world == 2 else {}
    state, metrics = train_steps(micro_models(inputs["state_dicts"], remat=True), inputs, 2,
                                 mesh)
    out.update(metrics=metrics, state_dict=state.state_dict(), held=_held(state))
    return out


def main(argv) -> int:
    task, rank, world, store, inp, outp = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        result = globals()[task](rank, world, torch.load(inp, weights_only=False))
        torch.save(result, outp)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
