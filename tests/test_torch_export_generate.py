"""The port's export tool on the whole flat generate, on the CPU: the program
(conditioning, 2 Euler steps unrolled, the decode; the noises as inputs),
saved, loaded back and run without the model classes, equals the port's
eager `generate` on the same inputs and noises (fp32, micro zoo, 64x64 x 2
frames, atol 1e-5). The eager `generate` is held against the JAX package's
by tests/test_torch_pipeline.py, so no JAX generate is compiled here. In a
file of its own, so that the test runners take it beside
tests/test_torch_export.py.
"""

import dataclasses
import io

import pytest
import torch

from stableanimator_tpu_torch.core.config import PipelineConfig, micro_model_kwargs
from stableanimator_tpu_torch.pipeline.animation import build_models, generate
from stableanimator_tpu_torch.tools import export_model as em

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes at once, and torch's thread pools then spend their time
    waiting for each other; tracing and (de)serialising are host Python."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_generate_export_roundtrip():
    models = build_models(**micro_model_kwargs(), dtype=torch.float32, device="cpu", seed=0)
    h = w = 64
    f = 2
    cfg = PipelineConfig(num_frames=f, tile_size=2, tile_overlap=1, num_inference_steps=2,
                         decode_chunk_size=2)
    buf = io.BytesIO()
    torch.export.save(em.export_generate(models, h, w, f, cfg), buf)
    buf.seek(0)
    program = torch.export.load(buf).module()

    full = dataclasses.replace(cfg, height=h, width=w)
    ref, pose, emb, aug, init = em.generate_inputs(models, full, "cpu", seed=5)
    got = program(ref, pose, emb, aug, init)
    want = generate(models, ref, pose, emb, cfg, aug_noise=aug, init_noise=init, device="cpu")
    assert got.shape == (f, h, w, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
