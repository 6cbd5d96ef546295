"""The port's ONNX -> torch executor and the HJB face optimisation's
`refine` on the card against the same on the CPU, with a small iresnet
recogniser (the stand-in of glintr100's architecture) and the micro VAE
decoder; fp32 with TF32 off, so summation order only.

Imports neither JAX nor the test configuration, so it runs on a machine
with the GPU and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_face_cuda.py -q
"""

import numpy as np
import pytest
import torch

from stableanimator_tpu_torch.core.config import micro_model_kwargs
from stableanimator_tpu_torch.pipeline.animation import build_models
from stableanimator_tpu_torch.pipeline.face_opt import FaceOptConfig, make_face_optimizer
from stableanimator_tpu_torch.preproc.onnx_to_torch import load_onnx_function
from stableanimator_tpu_torch.preproc.standins import export_onnx, seeded_iresnet

pytestmark = pytest.mark.cuda
# fp32 on both sides: outputs and gradients within 1e-4 of their largest
# element
REL = 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def recogniser(tmp_path_factory):
    model = seeded_iresnet(0, layers=(2, 2, 2, 2), widths=(16, 32, 32, 64), num_features=64)
    path = export_onnx(model, (torch.zeros(1, 3, 112, 112),),
                       str(tmp_path_factory.mktemp("rec") / "glintr100.onnx"),
                       constant_folding=False)
    return model, path


def _close(a, b):
    return (a.cpu() - b.cpu()).abs().max().item() <= REL * b.abs().max().item()


def test_executor_on_the_card_matches_the_cpu_and_the_module(recogniser):
    _card()
    model, path = recogniser
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (4, 3, 112, 112))
                         .astype(np.float32))
    t = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 64)).astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        fn = load_onnx_function(path, device=dev)
        assert all(w.device.type == dev for w in fn.weights.values())
        xd = x.to(dev).requires_grad_(True)
        emb = fn(xd)[0]
        (grad,) = torch.autograd.grad((emb * t.to(dev)).sum(), xd)
        out[dev] = (emb.detach(), grad)
    with torch.no_grad():
        ref = model(x)
    assert _close(out["cuda"][0], out["cpu"][0]) and _close(out["cpu"][0], ref)
    assert _close(out["cuda"][1], out["cpu"][1])


def test_refine_on_the_card_matches_the_cpu(recogniser):
    _card()
    _, path = recogniser
    seeded = build_models(**micro_model_kwargs(), dtype=torch.float32, device="cpu", seed=0)
    x0 = torch.from_numpy(np.random.default_rng(2).normal(size=(1, 2, 8, 8, 4))
                          .astype(np.float32))
    pose = np.full((2, 64, 64, 3), -1.0, np.float32)
    pose[:, 8:12, 40:44] = 1.0
    target = np.random.default_rng(3).normal(size=(64,)).astype(np.float32)
    cfg = FaceOptConfig(steps=2, lr=0.5, start_step=0, latent_crop=4)
    out = {}
    for dev in ("cpu", "cuda"):
        models = build_models(**micro_model_kwargs(), dtype=torch.float32, device=dev, seed=None)
        for a, b in zip(seeded, models):
            b.load_state_dict(a.state_dict())
        opt = make_face_optimizer(models, cfg, load_onnx_function(path, device=dev), target,
                                  pose, 8, 8, channel_order="reference")
        with torch.inference_mode():          # as inside generate
            xd = x0.to(dev)
            before = opt.identity_cost(xd).item()
            refined = opt.refine(xd, 0)
            out[dev] = (before, refined, opt.identity_cost(refined).item())
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4
    assert _close(out["cuda"][1] - x0.cuda(), out["cpu"][1] - x0)      # the update itself
    assert out["cuda"][2] < out["cuda"][0]


def test_full_width_refine_at_crop_24_runs_the_d512_backward(recogniser):
    # the full-width bf16 VAE decoder on a 24-latent crop: its mid attention
    # has 576 tokens at d = 512, so the forward is the flash kernel and the
    # refine's gradient goes through the d = 512 backward pair, once each
    _card()
    from stableanimator_tpu_torch.ops import flash_attention as fa

    _, path = recogniser
    models = build_models(dtype=torch.bfloat16, device="cuda", seed=0)
    pose = np.full((2, 256, 256, 3), -1.0, np.float32)
    pose[:, 60:70, 120:130] = 1.0
    target = np.random.default_rng(3).normal(size=(64,)).astype(np.float32)
    opt = make_face_optimizer(models, FaceOptConfig(steps=1, lr=0.1, start_step=0,
                                                    latent_crop=24),
                              load_onnx_function(path, device="cuda"), target, pose, 32, 32)
    x0 = torch.from_numpy(np.random.default_rng(4).normal(size=(1, 2, 32, 32, 4))
                          .astype(np.float32)).cuda()
    fa.reset_launch_counts()
    with torch.inference_mode():
        refined = opt.refine(x0, 0)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_by_shape == {(2, 576, 576, 1, 512): 1}
    assert dict(fa.flash_attention_bwd.launches) == {fa.DKV_D512_KERNEL: 1, fa.DQ_D512_KERNEL: 1}
    step = refined - x0
    assert bool(torch.isfinite(step).all()) and step.abs().max().item() > 0
    # outside the 24 x 24 crops of each frame the gradient is zero
    y, x = (int(v) for v in opt.face_boxes[0])
    outside = step[0, 0].clone()
    outside[y:y + 24, x:x + 24] = 0
    assert outside.abs().max().item() == 0
