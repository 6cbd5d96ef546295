"""The port's (data, frame) mesh on torch.distributed, on the CPU: four gloo
processes (tests/torch_mesh_worker.py, JAX-free, one thread each) on a
2 x 2 mesh against one process, and the micro `generate` on the mesh
against the port's one-process `generate` and the JAX package's
one-device one (tests/test_multichip.py's configurations); also on a
1 x 4 mesh (one frame per block) and a 4 x 1 one (make_mesh()'s layout of
4 ranks, more data ranks than the CFG pair's 2 rows).

Tolerances. The frame collectives move data exactly (halo, all-to-alls:
0) or change a summation order (the sharded GroupNorm statistics, the
sharded transformer: fp32 rounding, 1e-5 on unit-scale data). One UNet
call on the mesh against the same call on one process: 1e-5 of the
output's largest magnitude (fp32 rounding: the ranks' GEMMs and
convolutions see half the rows and frames, the norms sum in parts).
Whole generates: the micro model with these weights amplifies rounding
through the Euler steps (init sigma 700). On the flat case the same
one-process generate at 4 and at 1 CPU threads differs by 2.0e-4 on a
[0, 1] pixel (mean 1.7e-5), so no fp32 reordering, the mesh's included,
stays within 1e-4 of another. The flat generates are held to the JAX
package's bound between its mesh and one device (tests/test_multichip.py:
1e-3) and to 1e-4 on the mean absolute difference.

The grouped case (23 frames) is more sensitive still, and how far rounding
moves it depends on the host's and torch's own rounding: on one host
scaling the initial noise by 1 + 1e-7 moved pixels by 2.4e-3, on another
by 3.2e-4, while a scale of 1 - 3e-7 there moved one pixel by 6.5e-3 (mean
1.1e-4), as far as the mesh's run lies from the one-process run. So its
bounds are measured in the same run (`_rounding`): the one-process
generate in groups of one tile under other roundings (the initial noise
scaled by each of NOISE_NUDGES, and at 4 threads: the same code path,
rounded otherwise), and the largest change any of them makes, per pixel
and on the mean, times ROUNDING_FACTOR, never below GROUPED_ATOL /
MEAN_ATOL (`_grouped_bounds`). The mesh's grouped run is held to those
against the same grouping, and to twice them against the default grouping
(groups of two), one more evaluation order away; that grouping is a code
path of its own, so it is checked against the bounds and never sets them. A wrong halo, offset or missing collective moves
pixels by 1e-2 and more on much of the frame (the 1 x 4 mesh before the
single-key repair: 0.12, mean 1.1e-2; ROADMAP §3; on the grouped case a
block's frame offset one frame off: 0.22, mean 2.1e-2; a zero halo: 0.64,
mean 7.1e-2), so `test_rounding_sets_the_generate_bounds` fails when the
measured bounds reach GROUPED_CEILING / MEAN_CEILING, where a fault could
hide under them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stableanimator_tpu.core.config import PipelineConfig as JPipelineConfig
from stableanimator_tpu.core.config import micro_model_kwargs as jax_micro_kwargs
from stableanimator_tpu.parallel import make_mesh as jax_make_mesh
from stableanimator_tpu.parallel.mesh import zero_sharding_for as jax_zero_sharding_for
from stableanimator_tpu.pipeline import build_models as jax_build_models
from stableanimator_tpu.pipeline import fast_init_params
from stableanimator_tpu.pipeline import generate as jax_generate
from stableanimator_tpu_torch.convert.from_jax import state_dicts_from_jax
from stableanimator_tpu_torch.parallel.mesh import zero_sharding_for
from tests.torch_mesh_worker import generate_on, micro_models, run_ranks
from tests.torch_threads import share_cores

THREADS = share_cores()

CFG = dict(tile_size=4, tile_overlap=1, num_inference_steps=2, decode_chunk_size=2)
ATOL, MEAN_ATOL, UNET_REL = 1e-3, 1e-4, 1e-5
# the grouped case's bounds (module docstring): the rounding probes' largest
# change times ROUNDING_FACTOR, at least GROUPED_ATOL (per pixel) and
# MEAN_ATOL (mean); past GROUPED_CEILING / MEAN_CEILING they could hide a fault
GROUPED_ATOL, ROUNDING_FACTOR = 5e-3, 2.0
GROUPED_CEILING, MEAN_CEILING = 3e-2, 1e-3
NOISE_NUDGES = (1 + 1e-7, 1 - 1e-7, 1 + 3e-7, 1 - 3e-7)


def _case(frames: int, seed: int, key=None) -> dict:
    """tests/test_multichip.py's inputs; the noises JAX's generate draws
    from `key` (split(key, 3)[0] augmentation, [1] initial tile), or numpy's."""
    rng = np.random.default_rng(seed)
    ref = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    pose = rng.uniform(-1, 1, size=(frames, 64, 64, 3)).astype(np.float32)
    face = rng.normal(size=(1, 32)).astype(np.float32)
    if key is not None:
        keys = jax.random.split(key, 3)
        aug = np.array(jax.random.normal(keys[0], ref.shape, jnp.float32))
        init = np.array(jax.random.normal(keys[1], (1, 4, 8, 8, 4), jnp.float32))
    else:
        aug = rng.normal(size=ref.shape).astype(np.float32)
        init = rng.normal(size=(1, 4, 8, 8, 4)).astype(np.float32)
    t = torch.from_numpy
    return dict(ref=t(ref), pose=t(pose), face=t(face), aug=t(aug), init=t(init),
                cfg=dict(num_frames=frames, **CFG))


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    jm = jax_build_models(**jax_micro_kwargs(), dtype=None, use_flash=False)
    params = fast_init_params(jm, height=64, width=64)
    key = jax.random.PRNGKey(11)
    inputs = dict(state_dicts=state_dicts_from_jax(params), flat=_case(4, 9, key),
                  grouped=_case(23, 13))
    ranks = run_ranks("mesh_suite", 4, tmp_path_factory.mktemp("mesh"), inputs)
    flat = inputs["flat"]
    want_jax = np.asarray(jax_generate(
        jm, params, jnp.asarray(flat["ref"].numpy()), jnp.asarray(flat["pose"].numpy()),
        jnp.asarray(flat["face"].numpy()), JPipelineConfig(**flat["cfg"]), rng=key))
    models = micro_models(inputs["state_dicts"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)                # the ranks' evaluation order
    try:
        with torch.no_grad():
            one = {name: generate_on(models, inputs[name]) for name in ("flat", "grouped")}
            tiles1 = dict(inputs["grouped"], cfg=dict(inputs["grouped"]["cfg"], max_tile_batch=1))
            one["grouped_tiles1"] = generate_on(models, tiles1)
            # the same computations under other roundings: the initial noise
            # scaled by NOISE_NUDGES, and at 4 threads
            probes = {f"noise x {s:.7f}": generate_on(models, dict(tiles1, init=tiles1["init"] * s))
                      for s in NOISE_NUDGES}
            torch.set_num_threads(4)
            one["flat_4threads"] = generate_on(models, inputs["flat"])
            probes["4 threads"] = generate_on(models, tiles1)
    finally:
        torch.set_num_threads(threads)
    one["rounding"] = _rounding(one["grouped_tiles1"], probes)
    return ranks, one, want_jax


def _rounding(base, probes: dict) -> dict:
    """{probe: (max, mean) of |probe - base|}."""
    return {name: ((p - base).abs().max().item(), (p - base).abs().mean().item())
            for name, p in probes.items()}


def _grouped_bounds(one) -> tuple[float, float]:
    """The grouped case's per-pixel and mean bounds against the same
    grouping, from the rounding measured in this run."""
    rounding = one["rounding"].values()
    return (max(GROUPED_ATOL, ROUNDING_FACTOR * max(m for m, _ in rounding)),
            max(MEAN_ATOL, ROUNDING_FACTOR * max(a for _, a in rounding)))


def test_rounding_sets_the_generate_bounds(suite):
    """What fp32 rounding alone does to the one-process generate (the
    module docstring's numbers): the flat bounds sit above it, and the
    grouped bounds measured from it stay below what a fault does."""
    _, one, _ = suite
    flat = (one["flat_4threads"] - one["flat"]).abs()
    atol, mean_atol = _grouped_bounds(one)
    print(f"flat, 4 vs 1 threads: max {flat.max().item():.3e} mean {flat.mean().item():.3e}; "
          "grouped against groups of one tile: " + "; ".join(
              f"{name} max {m:.3e} mean {a:.3e}" for name, (m, a) in one["rounding"].items())
          + f"; bounds {atol:.3e}, mean {mean_atol:.3e}")
    assert flat.max() < ATOL and flat.mean() < MEAN_ATOL
    assert atol < GROUPED_CEILING and mean_atol < MEAN_CEILING
    # no 1e-4 per-pixel bound can hold on the grouped case
    assert max(m for m, _ in one["rounding"].values()) > 1e-4


def test_make_mesh_rules(suite):
    ranks, _, _ = suite
    for r, out in enumerate(ranks):
        assert out["default_shape"] == {"data": 4, "frame": 1}     # (1, 1): all on data
        assert out["oversize"] == "ValueError"                      # 4 x 2 > 4 ranks
        assert out["coordinate"] == {"data": r // 2, "frame": r % 2}


@pytest.mark.parametrize("check", ["halo", "group_norm", "frames_to_rows", "rows_to_frames"])
def test_frame_collectives_match_unsharded(suite, check):
    ranks, _, _ = suite
    tol = 1e-5 if check == "group_norm" else 0.0
    for out in ranks:
        assert out["collectives"][check] <= tol, out["collectives"]


def test_temporal_transformer_with_per_frame_context(suite):
    """Sharded over frames it equals the unsharded module; with the block's
    local frame indices (every block embeds frames 0..f-1), or with each
    block's own first frame as the time context, the second block differs."""
    ranks, _, _ = suite
    for out in ranks:
        assert out["transformer"]["sharded"] <= 1e-5, out["transformer"]
    second = [out["transformer"] for out in ranks if out["coordinate"]["frame"] == 1]
    for t in second:
        assert t["local_frame_ids"] > 1e-2 and t["local_first_frame"] > 1e-2, t


def _close(got, want, atol=ATOL, mean_atol=MEAN_ATOL):
    np.testing.assert_allclose(got, want, rtol=atol, atol=atol)
    assert np.abs(got - want).mean() < mean_atol


def test_sharded_unet_call_matches_one_process(suite):
    ranks, _, _ = suite
    for out in ranks:
        assert out["unet"]["max_diff"] <= UNET_REL * out["unet"]["scale"], out["unet"]


def test_unet_call_on_more_data_ranks_than_rows(suite):
    """4 x 1: the CFG pair's 2 rows do not split 4 ways, so each data rank
    runs both rows (`_unet` replicates an axis that does not divide)."""
    ranks, _, _ = suite
    for out in ranks:
        assert out["unet_data4"]["max_diff"] <= UNET_REL * out["unet_data4"]["scale"], out


@pytest.mark.parametrize("mesh", ["flat", "flat_frame4", "flat_data4"])
def test_sharded_flat_generate_matches_one_process_and_jax(suite, mesh):
    """On the 2 x 2 mesh, on a 1 x 4 mesh (one frame per block, as the
    JAX test's 2 x 4 mesh holds them) and on a 4 x 1 mesh (every rank on
    data, as make_mesh() lays out 4 ranks)."""
    ranks, one, want_jax = suite
    got = ranks[0][mesh].numpy()
    for out in ranks[1:]:
        np.testing.assert_array_equal(out[mesh].numpy(), got)      # every rank the same
    assert got.shape == (4, 64, 64, 3) and got.std() > 0.05
    _close(got, one["flat"].numpy())
    _close(got, want_jax)


def test_sharded_grouped_generate_matches_one_process(suite):
    """23 frames, 8 tiles: grouped denoise and segmented dispatch; under
    the mesh in groups of one tile (the one-process run: groups of 2, and
    of 1 with max_tile_batch=1)."""
    ranks, one, _ = suite
    got = ranks[0]["grouped"].numpy()
    for out in ranks[1:]:
        np.testing.assert_array_equal(out["grouped"].numpy(), got)
    assert got.shape == (23, 64, 64, 3) and got.std() > 0.05
    atol, mean_atol = _grouped_bounds(one)
    _close(got, one["grouped_tiles1"].numpy(), atol=atol, mean_atol=mean_atol)
    _close(got, one["grouped"].numpy(), atol=2 * atol, mean_atol=2 * mean_atol)


def test_grouped_generate_on_more_data_ranks_than_rows(suite):
    """The grouped case on the 4 x 1 mesh: groups of one tile, 2 rows over
    4 data ranks, held as the 2 x 2 mesh's run is."""
    ranks, one, _ = suite
    got = ranks[0]["grouped_data4"].numpy()
    for out in ranks[1:]:
        np.testing.assert_array_equal(out["grouped_data4"].numpy(), got)
    assert got.shape == (23, 64, 64, 3) and got.std() > 0.05
    atol, mean_atol = _grouped_bounds(one)
    _close(got, one["grouped_tiles1"].numpy(), atol=atol, mean_atol=mean_atol)
    _close(got, one["grouped"].numpy(), atol=2 * atol, mean_atol=2 * mean_atol)


SHAPES = [(), (7,), (320,), (1280, 320), (320, 320, 3, 3), (4, 3, 3, 3), (3, 6), (5, 7, 8)]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_zero_sharding_for_matches_jax(n):
    """The split dim of every shape, for one axis and for the pair."""
    jmesh = jax_make_mesh(data=n, frame=1, devices=jax.devices()[:n])
    pair = jax_make_mesh(data=max(n // 2, 1), frame=2 if n > 1 else 1,
                         devices=jax.devices()[:n])
    for shape in SHAPES:
        x = np.zeros(shape, np.float32)
        for mesh, axis in ((jmesh, "data"), (pair, ("data", "frame"))):
            want = tuple(jax_zero_sharding_for(x, mesh, axis).spec)
            want = want + (None,) * (len(shape) - len(want))
            got = zero_sharding_for(torch.from_numpy(x), mesh, axis).spec
            assert got == want, (shape, n, axis, got, want)

