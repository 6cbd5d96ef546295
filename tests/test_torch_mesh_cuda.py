"""The mesh and the int8 path on the card: a world-of-one NCCL mesh
generate at the micro size against the plain one, and `int8_dense` on the
card against the CPU (the same int8 values; the int32 product is exact on
both).

Imports neither JAX nor the test configuration, so it runs on a machine
with the GPU and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_cuda.py -q
"""

import numpy as np
import pytest
import torch

from stableanimator_tpu_torch.core.config import PipelineConfig, micro_model_kwargs
from stableanimator_tpu_torch.ops import quant
from stableanimator_tpu_torch.pipeline.animation import build_models, generate
from tests.torch_threads import share_cores

THREADS = share_cores()

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def test_world_of_one_nccl_mesh_generate_equals_plain():
    _card()
    import torch.distributed as dist

    from stableanimator_tpu_torch.parallel import make_mesh

    models = build_models(**micro_model_kwargs(), dtype=torch.float32, device="cuda", seed=0)
    gen = torch.Generator().manual_seed(3)
    ref, pose = torch.rand((1, 64, 64, 3), generator=gen), torch.rand((4, 64, 64, 3), generator=gen)
    face = torch.randn((1, 32), generator=gen)
    cfg = PipelineConfig(num_frames=4, tile_size=4, tile_overlap=1, num_inference_steps=2,
                         decode_chunk_size=2)
    mesh = make_mesh()
    try:
        assert dist.get_backend() == "nccl" and mesh.device.type == "cuda"
        sharded = generate(models, ref, pose, face, cfg, mesh=mesh)
        plain = generate(models, ref, pose, face, cfg)
    finally:
        dist.destroy_process_group()
    torch.testing.assert_close(sharded, plain, rtol=0, atol=0)


@pytest.mark.parametrize("rows", [64, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_dense_on_the_card_equals_the_cpu(rows, dtype):
    _card()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(rows, 320)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.normal(size=(1280, 320)).astype(np.float32) * 0.05).to(dtype)
    b = torch.from_numpy(rng.normal(size=(1280,)).astype(np.float32) * 0.1).to(dtype)
    wq_cpu, ws_cpu = quant.quantize_weight(w)
    wq_gpu, ws_gpu = quant.quantize_weight(w.cuda())
    torch.testing.assert_close(wq_gpu.cpu(), wq_cpu, rtol=0, atol=0)
    torch.testing.assert_close(ws_gpu.cpu(), ws_cpu, rtol=0, atol=0)
    want = quant.int8_dense(x.float(), w.float(), b.float())
    got = quant.int8_dense(x.float().cuda(), w.float().cuda(), b.float().cuda()).cpu()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * want.abs().max().item())
    if dtype == torch.bfloat16:       # the generate path's dtype: one bf16 rounding apart
        got16 = quant.int8_dense(x.cuda(), w.cuda(), b.cuda()).cpu().float()
        want16 = quant.int8_dense(x, w, b).float()
        torch.testing.assert_close(got16, want16, rtol=2**-8, atol=2**-8 * want16.abs().max())
