"""The export tool on the card: the full-width bf16 UNet exported from CUDA
tensors holds the flash kernel's custom op, and the program saved and loaded
back launches the kernel and matches the eager module within
`kernel_tolerance` (the same kernels in the same order).

Imports neither JAX nor the test configuration, so it runs on a machine
with the GPU and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_export_cuda.py -q
"""

import io

import pytest
import torch

from stableanimator_tpu_torch.ops import flash_attention as fa
from stableanimator_tpu_torch.pipeline.animation import build_models
from stableanimator_tpu_torch.tools import export_model as em

pytestmark = pytest.mark.cuda


def test_exported_unet_launches_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    unet = build_models(dtype=torch.bfloat16, device="cuda", seed=0).unet
    # 256 x 256, 2 frames: level 0 has 1024 tokens at d = 64, the kernel's
    # route (5 spatial self-attentions: 2 down, 3 up); level 1's 256 take
    # the plain path
    b, f, h8, w8 = 2, 2, 32, 32
    program = em.export_unet(unet, b, f, h8, w8)
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert "stableanimator.flash_attention_fwd.default" in targets
    buf = io.BytesIO()
    torch.export.save(program, buf)
    buf.seek(0)
    reloaded = torch.export.load(buf).module()
    args = em.unet_inputs(unet, b, f, h8, w8, "cuda", seed=1)
    fa.reset_launch_counts()
    got = reloaded(*args)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_by_shape == {(b * f, h8 * w8, h8 * w8, 5, 64): 5}
    with torch.no_grad():
        want = unet(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(((got.float() - want.float()).abs() <= fa.kernel_tolerance(want)).all())
