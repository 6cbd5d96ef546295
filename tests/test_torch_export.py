"""The port's export tool (`stableanimator_tpu_torch/tools/export_model.py`)
on the CPU: each module exported with `torch.export`, saved, loaded back and
run without the model classes equals the port's eager module (fp32, micro
zoo, 64x64, atol 1e-5; the eager modules are held against the JAX package by
tests/test_torch_models.py and test_torch_pipeline.py). The generate round
trip is tests/test_torch_export_generate.py.

The flash kernel's custom op: a module whose attention takes the flash route
exports to a graph that holds the op, and the reloaded program runs it (on
the CPU the op runs the plain version; tests/test_torch_export_cuda.py
launches the kernel from a program exported on the card).
"""

import io

import pytest
import torch
import torch.nn as nn

from stableanimator_tpu_torch.core.config import PipelineConfig, micro_model_kwargs
from stableanimator_tpu_torch.ops import attention
from stableanimator_tpu_torch.ops import flash_attention as fa
from stableanimator_tpu_torch.pipeline.animation import build_models
from stableanimator_tpu_torch.tools import export_model as em

ATOL = 1e-5
FLASH_OPS = ("stableanimator.flash_attention_fwd", "stableanimator.flash_attention_fwd_lse")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes at once, and torch's thread pools then spend their time
    waiting for each other; tracing and (de)serialising are host Python."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return build_models(**micro_model_kwargs(), dtype=torch.float32, device="cpu", seed=0)


def _reload(program):
    """The program through save and load, as a callable module."""
    buf = io.BytesIO()
    torch.export.save(program, buf)
    buf.seek(0)
    return torch.export.load(buf).module()


def _ops(program) -> set:
    return {str(n.target).rsplit(".", 1)[0] for n in program.graph.nodes
            if n.op == "call_function"}


def test_unet_export_roundtrip(models):
    b, f, h8, w8 = 2, 2, 8, 8
    reloaded = _reload(em.export_unet(models.unet, b, f, h8, w8))
    args = em.unet_inputs(models.unet, b, f, h8, w8, "cpu", seed=1)
    with torch.no_grad():
        want = models.unet(*args)
    torch.testing.assert_close(reloaded(*args), want, rtol=0, atol=ATOL)


def test_vae_export_roundtrips(models):
    gen = torch.Generator().manual_seed(2)
    program = em.export_vae_decode(models.vae, 2, 8, 8)
    # the dispatcher routes CPU tensors to the plain attention while the graph
    # is traced, so a program exported on the CPU holds no kernel op
    assert not _ops(program) & set(FLASH_OPS)
    dec = _reload(program)
    z = torch.randn((2, 8, 8, 4), generator=gen)
    with torch.no_grad():
        want = models.vae.decode(z, num_frames=2)
    torch.testing.assert_close(dec(z), want, rtol=0, atol=ATOL)

    enc = _reload(em.export_vae_encode(models.vae, 64, 64))
    x = torch.rand((1, 64, 64, 3), generator=gen) * 2.0 - 1.0
    with torch.no_grad():
        want = models.vae.encode(x)[0]
    torch.testing.assert_close(enc(x), want, rtol=0, atol=ATOL)


class _Attend(nn.Module):
    def __init__(self):
        super().__init__()
        self.proj = nn.Linear(64, 64 * 3)

    def forward(self, x):
        q, k, v = self.proj(x).unflatten(-1, (3, 2, 32)).unbind(2)
        return attention.dot_product_attention(q, k, v, use_flash=True)


def test_flash_route_exports_as_the_custom_op():
    torch.manual_seed(0)
    module = _Attend().eval()
    x = torch.randn((2, 48, 64))
    program = em._export(module, (x,))
    assert "stableanimator.flash_attention_fwd" in _ops(program)
    reloaded = _reload(program)
    fa.reset_launch_counts()
    with torch.no_grad():
        want = module(x)
    torch.testing.assert_close(reloaded(x), want, rtol=0, atol=0)
    assert fa.flash_attention.launches == 0          # the CPU runs the plain version


def test_lse_op_fake_gives_the_kernels_shapes():
    q = torch.empty((2, 100, 3, 64), dtype=torch.bfloat16, device="meta")
    o, lse = fa._flash_forward_lse_op(q, q, q, 0.125)
    assert o.shape == q.shape and o.dtype == q.dtype and o.is_contiguous()
    assert lse.shape == (2, 100, 3) and lse.dtype == torch.float32


def test_generate_export_refuses_what_it_does_not_export(models):
    cfg = PipelineConfig(num_frames=2, tile_size=2, tile_overlap=1, num_inference_steps=2,
                         decode_chunk_size=2)
    with pytest.raises(ValueError, match="face optimisation is not exported"):
        em.export_generate(models, 64, 64, 2, cfg, face_opt=object())
    with pytest.raises(ValueError, match="mesh is not exported"):
        em.export_generate(models, 64, 64, 2, cfg, mesh=object())
    # 14 frames at tile 2 / overlap 1: 13 tiles, the segmented path
    with pytest.raises(ValueError, match="segmented path, which is not exported"):
        em.export_generate(models, 64, 64, 14, cfg)


def test_main_writes_a_program_that_loads(tmp_path, monkeypatch):
    # the CLI builds the full-size zoo; here the micro one stands in for it
    monkeypatch.setattr(em, "build_models", lambda **kw: build_models(
        **micro_model_kwargs(), dtype=torch.float32, device=kw["device"]))
    out = tmp_path / "vae_enc.pt2"
    info = em.main(["--what", "vae_encode", "--output", str(out), "--height", "64",
                    "--width", "64", "--device", "cpu"])
    assert info["bytes"] == out.stat().st_size > 0 and info["device"] == "cpu"
    program = torch.export.load(str(out)).module()
    assert program(torch.zeros((1, 64, 64, 3))).shape == (1, 8, 8, 4)
