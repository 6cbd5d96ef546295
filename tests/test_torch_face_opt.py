"""The port's HJB face optimisation (`stableanimator_tpu_torch.pipeline.
face_opt`) against the JAX package's (`pipeline/face_opt.py`), on the CPU in
fp32.

The stand-ins of tests/test_face_opt.py (a pooled "recogniser" and an
upsampling "decoder") written in both frameworks, then the real pieces:
the micro VAE decoder (weights from `fast_init_params`, loaded into both
packages) and an exported ArcTiny recogniser run by both ONNX executors.
Costs and refined latents within 1e-5; a micro `generate` with face
optimisation within 2e-3 of the JAX package's (tests/test_torch_pipeline.py
says why that bound). The segmented and warm cases run the port alone:
each compares two of its own paths.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from stableanimator_tpu.core.config import PipelineConfig as JPipelineConfig
from stableanimator_tpu.core.config import micro_model_kwargs as jax_micro_kwargs
from stableanimator_tpu.pipeline import animation as jax_animation
from stableanimator_tpu.pipeline import build_models as jax_build_models
from stableanimator_tpu.pipeline import face_opt as jax_fo
from stableanimator_tpu.pipeline import fast_init_params
from stableanimator_tpu.preproc.onnx_to_jax import load_onnx_function as jax_load_onnx_function
from stableanimator_tpu_torch.convert.from_jax import state_dicts_from_jax
from stableanimator_tpu_torch.core.config import PipelineConfig, micro_model_kwargs
from stableanimator_tpu_torch.pipeline import animation
from stableanimator_tpu_torch.pipeline import face_opt as fo
from stableanimator_tpu_torch.preproc.onnx_to_torch import load_onnx_function
from stableanimator_tpu_torch.preproc.standins import export_onnx

TOL = 1e-5
GEN_ATOL = 2e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes at once, and torch's thread pools then spend their time
    waiting for each other on these small shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arc_jax(pixels):
    n = pixels.shape[0]
    return jnp.mean(pixels.reshape(n, 3, 4, 28, 4, 28), axis=(3, 5)).reshape(n, -1)[:, :8]


def _arc_torch(pixels):
    n = pixels.shape[0]
    return pixels.reshape(n, 3, 4, 28, 4, 28).mean(dim=(3, 5)).reshape(n, -1)[:, :8]


def _decode_jax(latents, num_frames):
    x = jnp.tanh(latents[..., :3])
    return jnp.repeat(jnp.repeat(x, 8, axis=1), 8, axis=2)


def _decode_torch(latents, num_frames):
    x = torch.tanh(latents[..., :3])
    return x.repeat_interleave(8, dim=1).repeat_interleave(8, dim=2)


def _pair(steps=2, lr=0.5, start=0, end=100, boxes=None):
    cfg = dict(steps=steps, lr=lr, start_step=start, end_step=end, latent_crop=4,
               arcface_size=112)
    target = np.ones((8,), np.float32)
    boxes = np.zeros((3, 2), np.int32) if boxes is None else boxes
    return (fo.FaceOptimizer(fo.FaceOptConfig(**cfg), _arc_torch, _decode_torch, target, boxes),
            jax_fo.FaceOptimizer(jax_fo.FaceOptConfig(**cfg), _arc_jax, _decode_jax, target,
                                 boxes))


def test_config_defaults_match_jax():
    assert dataclasses.asdict(fo.FaceOptConfig()) == dataclasses.asdict(jax_fo.FaceOptConfig())


def test_refine_reduces_identity_cost():
    opt, jopt = _pair(steps=3, lr=1.0, boxes=np.array([[0, 0], [4, 2], [9, -3]], np.int32))
    x0 = np.random.default_rng(0).normal(size=(1, 3, 8, 8, 4)).astype(np.float32)
    before = opt.identity_cost(torch.from_numpy(x0)).item()
    refined = opt.refine(torch.from_numpy(x0), 0)
    after = opt.identity_cost(refined).item()
    assert after < before, (before, after)
    assert abs(before - float(jopt.identity_cost(jnp.asarray(x0)))) <= TOL
    want = np.asarray(jopt.refine(jnp.asarray(x0), jnp.int32(0)))
    np.testing.assert_allclose(refined.numpy(), want, rtol=0, atol=TOL)


def test_refine_respects_step_window():
    opt, _ = _pair(steps=2, start=5, end=10)
    x0 = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 3, 8, 8, 4))
                          .astype(np.float32))
    assert opt.refine(x0, 2) is x0 and opt.refine(x0, 10) is x0
    assert (opt.refine(x0, 7) - x0).abs().max() > 0
    off, _ = _pair(steps=0)
    assert off.refine(x0, 7) is x0


def test_face_boxes_from_pose():
    faces = np.full((2, 68, 2), 0.5)
    boxes = fo.face_boxes_from_pose(faces, latent_h=64, latent_w=64, crop=16)
    np.testing.assert_array_equal(boxes, [[24, 24], [24, 24]])
    np.testing.assert_array_equal(fo.face_boxes_from_pose(np.zeros((1, 68, 2)), 64, 64, 16),
                                  [[24, 24]])
    pts = np.random.default_rng(2).uniform(0, 1, size=(5, 68, 2))
    pts[1] = 0.0
    np.testing.assert_array_equal(fo.face_boxes_from_pose(pts, 40, 24, 8),
                                  jax_fo.face_boxes_from_pose(pts, 40, 24, 8))
    renders = np.full((3, 64, 48, 3), -1.0, np.float32)
    renders[0, 8:12, 30:34] = 1.0
    renders[2, 50:60, 2:6] = 1.0
    for crop in (4, 16):
        got = fo.face_boxes_from_pose_renders(torch.from_numpy(renders), 8, 6, crop)
        np.testing.assert_array_equal(got, jax_fo.face_boxes_from_pose_renders(renders, 8, 6,
                                                                                crop))


def test_with_boxes_shares_cfg_callables_and_target():
    """The port's counterpart of the JAX package's pytree round trip: a copy
    with new boxes keeps cfg, both callables and the target."""
    opt, _ = _pair(steps=2)
    swapped = opt.with_boxes(np.ones((3, 2), np.int32))
    assert swapped.cfg == opt.cfg and swapped.target is opt.target
    assert swapped.arcface_fn is opt.arcface_fn and swapped.decode_fn is opt.decode_fn
    np.testing.assert_array_equal(swapped.face_boxes, 1)
    np.testing.assert_array_equal(opt.face_boxes, 0)


def test_refine_leaves_inference_mode_and_returns_a_plain_tensor():
    opt, _ = _pair(steps=1)
    with torch.inference_mode():
        x0 = torch.randn(1, 3, 8, 8, 4)
        out = opt.refine(x0, 0)
        assert (out - x0).abs().max() > 0 and not out.requires_grad


# ---------------------------------------------------------------------------
# the real pieces: micro VAE decoder + an exported recogniser
# ---------------------------------------------------------------------------

class ArcTiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, stride=2, padding=1)
        self.bn = nn.BatchNorm2d(8)
        self.prelu = nn.PReLU(8)
        self.fc = nn.Linear(8 * 8 * 8, 16)
        self.feat = nn.BatchNorm1d(16)

    def forward(self, x):
        return self.feat(self.fc(self.prelu(self.bn(self.conv(x))).flatten(1)))


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    jm = jax_build_models(**jax_micro_kwargs(), dtype=None, use_flash=False)
    params = fast_init_params(jm, height=64, width=64)
    pm = animation.build_models(**micro_model_kwargs(), dtype=torch.float32, device="cpu",
                                seed=None)
    for name, sd in state_dicts_from_jax(params).items():
        getattr(pm, name).load_state_dict(sd, strict=True)
    torch.manual_seed(0)
    path = export_onnx(ArcTiny(), (torch.zeros(1, 3, 16, 16),),
                       str(tmp_path_factory.mktemp("arc") / "arc.onnx"))
    return jm, params, pm, path


def _pose(frames):
    pose = np.full((frames, 64, 64, 3), -1.0, np.float32)
    pose[:, 8:12, 40:44, :] = 1.0          # the white face blob
    return pose


@pytest.mark.parametrize("order", ["reference", "standard"])
def test_make_face_optimizer_real_pieces_match_jax(micro, order):
    jm, params, pm, path = micro
    cfg = dict(steps=2, lr=0.5, start_step=0, latent_crop=4, arcface_size=16)
    target = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    opt = fo.make_face_optimizer(pm, fo.FaceOptConfig(**cfg), load_onnx_function(path, "cpu"),
                                 target, torch.from_numpy(_pose(2)), 8, 8, channel_order=order)
    jopt = jax_fo.make_face_optimizer(jm, params, jax_fo.FaceOptConfig(**cfg),
                                      jax_load_onnx_function(path), target, _pose(2), 8, 8,
                                      channel_order=order)
    np.testing.assert_array_equal(opt.face_boxes, np.asarray(jopt.face_boxes))
    assert abs(int(opt.face_boxes[0, 1]) - 3) <= 1
    x0 = np.random.default_rng(2).normal(size=(1, 2, 8, 8, 4)).astype(np.float32)
    before = opt.identity_cost(torch.from_numpy(x0)).item()
    assert abs(before - float(jopt.identity_cost(jnp.asarray(x0)))) <= TOL
    refined = opt.refine(torch.from_numpy(x0), 0)
    want = np.asarray(jopt.refine(jnp.asarray(x0), jnp.int32(0)))
    np.testing.assert_allclose(refined.numpy(), want, rtol=0, atol=TOL)
    after = opt.identity_cost(refined).item()
    assert np.isfinite(after) and after < before, (before, after)
    # placeholder boxes for F frames (before the poses exist)
    placeholder = fo.make_face_optimizer(pm, fo.FaceOptConfig(**cfg), opt.arcface_fn, target,
                                         None, 8, 8, num_frames=3)
    np.testing.assert_array_equal(placeholder.face_boxes, [[2, 2]] * 3)


def test_refine_and_its_gradient_at_a_24_latent_crop_match_jax(micro):
    # latent_crop >= 23 puts crop^2 >= 512 tokens into the decoder's mid
    # attention, where the card takes the flash kernel and its d = 512
    # backward (tests/test_torch_face_cuda.py); on the CPU both packages take
    # the plain attention. A 24 x 24 latent plane, so the crop is the plane.
    # fp32: the cost within 1e-5 (TOL), the gradient within 1e-4 of its
    # largest element (576-token attention and a 192-px decode: summation
    # order only), the refined latents within TOL
    jm, params, pm, path = micro
    cfg = dict(steps=1, lr=0.5, start_step=0, latent_crop=24, arcface_size=16)
    target = np.random.default_rng(5).normal(size=(16,)).astype(np.float32)
    opt = fo.make_face_optimizer(pm, fo.FaceOptConfig(**cfg), load_onnx_function(path, "cpu"),
                                 target, None, 24, 24, num_frames=2)
    jopt = jax_fo.make_face_optimizer(jm, params, jax_fo.FaceOptConfig(**cfg),
                                      jax_load_onnx_function(path), target, None, 24, 24,
                                      num_frames=2)
    assert opt.cfg.latent_crop == 24
    np.testing.assert_array_equal(opt.face_boxes, np.asarray(jopt.face_boxes))
    x0 = np.random.default_rng(6).normal(size=(1, 2, 24, 24, 4)).astype(np.float32)
    x = torch.from_numpy(x0).requires_grad_(True)
    cost = opt.identity_cost(x)
    (grad,) = torch.autograd.grad(cost, x)
    jcost, jgrad = jax.jit(jax.value_and_grad(jopt.identity_cost))(jnp.asarray(x0))
    assert abs(cost.item() - float(jcost)) <= TOL
    jgrad = np.asarray(jgrad)
    assert np.abs(jgrad).max() > 0
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=0, atol=1e-4 * np.abs(jgrad).max())
    # the JAX refine's one step is x0 - lr * its gradient (compiled once above)
    refined = opt.refine(torch.from_numpy(x0), 0)
    np.testing.assert_allclose(refined.numpy(), x0 - cfg["lr"] * jgrad, rtol=0, atol=TOL)


def _micro_inputs(frames, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(1, 64, 64, 3)).astype(np.float32),
            rng.uniform(-1, 1, size=(frames, 64, 64, 3)).astype(np.float32),
            rng.normal(size=(1, 32)).astype(np.float32))


def test_generate_with_face_opt_matches_jax(micro):
    jm, params, pm, _ = micro
    ref, pose, face = _micro_inputs(2, seed=5)
    kw = dict(num_frames=2, tile_size=2, tile_overlap=1, num_inference_steps=2,
              decode_chunk_size=2)
    cfg = dict(steps=1, lr=0.5, start_step=0, latent_crop=4)
    target = np.ones((8,), np.float32)
    jopt = jax_fo.make_face_optimizer(jm, params, jax_fo.FaceOptConfig(**cfg), _arc_jax, target,
                                      None, 8, 8, channel_order="standard", num_frames=2)
    opt = fo.make_face_optimizer(pm, fo.FaceOptConfig(**cfg), _arc_torch, target, None, 8, 8,
                                 channel_order="standard", num_frames=2)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_animation.generate(jm, params, jnp.asarray(ref), jnp.asarray(pose),
                                             jnp.asarray(face), JPipelineConfig(**kw), rng=key,
                                             face_opt=jopt))
    keys = jax.random.split(key, 3)
    noises = dict(aug_noise=torch.from_numpy(np.array(jax.random.normal(keys[0], ref.shape))),
                  init_noise=torch.from_numpy(np.array(jax.random.normal(keys[1],
                                                                         (1, 2, 8, 8, 4)))))
    args = (pm, torch.from_numpy(ref), torch.from_numpy(pose), torch.from_numpy(face),
            PipelineConfig(**kw))
    got = animation.generate(*args, face_opt=opt, device="cpu", **noises).numpy()
    base = animation.generate(*args, device="cpu", **noises).numpy()
    assert got.shape == (2, 64, 64, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=GEN_ATOL)
    assert np.abs(got - base).max() > 1e-3      # the refinement moved the frames


def test_face_opt_composes_with_segmented_long_video(micro):
    """tests/test_face_opt.py's long-video case on the port: 14 frames at
    tile 4 take the grouped denoise and the segmented dispatch; with
    face_opt the 2-step segments match the one-stretch path and differ from
    the plain output."""
    _, _, pm, _ = micro
    ref, pose, face = (torch.from_numpy(x) for x in _micro_inputs(14, seed=7))
    cfg = PipelineConfig(num_frames=14, tile_size=4, tile_overlap=1, num_inference_steps=3,
                         decode_chunk_size=2, steps_per_dispatch=2)
    opt = fo.make_face_optimizer(pm, fo.FaceOptConfig(steps=1, lr=0.5, start_step=0,
                                                      latent_crop=4),
                                 _arc_torch, np.ones((8,), np.float32), None, 8, 8,
                                 channel_order="standard", num_frames=14)
    progress = []

    def run(c, face_opt):
        gen = torch.Generator().manual_seed(9)
        return animation.generate(pm, ref, pose, face, c, face_opt=face_opt, device="cpu",
                                  generator=gen,
                                  progress=lambda d, t: progress.append((d, t))).numpy()

    segmented = run(cfg, opt)
    assert progress == [(2, 3), (3, 3)]
    single = run(dataclasses.replace(cfg, steps_per_dispatch=None), opt)
    assert segmented.shape == (14, 64, 64, 3)
    rel = np.linalg.norm(segmented - single) / max(np.linalg.norm(single), 1e-12)
    assert rel < 4e-3, f"rel L2 {rel:.2e}"
    assert np.abs(segmented - run(cfg, None)).max() > 1e-6


def test_warm_generate_covers_face_opt_dispatch(micro):
    """warm_generate(face_opt=...) with placeholder boxes reports the JAX
    package's plan for a face-opt request (its segments half as long) and
    executes it; generate then runs with the real boxes swapped in."""
    _, _, pm, _ = micro
    kw = dict(height=64, width=64, num_frames=14, tile_size=4, tile_overlap=1,
              num_inference_steps=5, decode_chunk_size=2)
    opt = fo.make_face_optimizer(pm, fo.FaceOptConfig(steps=1, lr=0.5, start_step=0,
                                                      latent_crop=4),
                                 _arc_torch, np.ones((8,), np.float32), None, 8, 8,
                                 channel_order="standard", num_frames=14)
    info = animation.warm_generate(pm, PipelineConfig(**kw), device="cpu", uint8_inputs=False,
                                   face_opt=opt)
    # the JAX plan: prep, each distinct segment length (5 steps in segments
    # of 3 with face-opt: 3 and 2; of 5 without), one decode
    assert jax_animation.resolve_steps_per_dispatch(JPipelineConfig(**kw), True) == 3
    assert animation.resolve_steps_per_dispatch(PipelineConfig(**kw), True) == 3
    assert animation.resolve_steps_per_dispatch(PipelineConfig(**kw), False) == 5
    assert info == {"path": "segmented", "programs": 4, "executed": True, "face_opt": True}
    assert animation.warm_generate(pm, PipelineConfig(**kw), device="cpu", execute=False) == {
        "path": "segmented", "programs": 3, "executed": False, "face_opt": False}
    ref, pose, face = (torch.from_numpy(x) for x in _micro_inputs(14, seed=11))
    out = animation.generate(pm, ref, pose, face, PipelineConfig(**kw), device="cpu",
                             face_opt=opt.with_boxes(np.full((14, 2), 2, np.int32)))
    assert torch.isfinite(out).all()
