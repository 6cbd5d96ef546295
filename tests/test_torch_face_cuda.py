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
