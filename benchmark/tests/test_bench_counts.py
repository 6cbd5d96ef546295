"""counts.py against `FlopCounterMode` over the reference on meta tensors at
full width, at the cells' shapes, and the attention calls against the
program's routing."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import common, counts
from benchmark.reference import models as ref_models

CFG = common.config("stableanimator-svdxt-infer")
M = CFG["models"]


@pytest.fixture(scope="module")
def meta():
    return ref_models.build(CFG, None, meta=True)


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as c, torch.no_grad():
        fn()
    return c.get_total_flops()


def _e(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("height,width,b", [(512, 512, 2), (576, 1024, 2), (512, 512, 1),
                                            (1024, 576, 1)])
def test_unet_flops(meta, height, width, b):
    h, w = height // 8, width // 8
    got = _counted(lambda: meta["unet"](_e(b, 16, h, w, 8), _e(), _e(b, 5, 1024), _e(b, 3),
                                        _e(b * 16, h, w, 320)))
    assert counts.unet_flops(M["unet"], b, 16, h, w) == got


@pytest.mark.parametrize("height,width", [(512, 512), (576, 1024), (1024, 576)])
def test_vae_pose_flops(meta, height, width):
    h, w = height // 8, width // 8
    assert counts.vae_decode_flops(M["vae"], 16, h, w) == _counted(
        lambda: meta["vae"].decode(_e(16, h, w, 4), 4))
    assert counts.vae_encode_flops(M["vae"], 17, height, width) == _counted(
        lambda: meta["vae"].encode(_e(17, height, width, 3)))
    assert counts.pose_flops(M["pose_net"], 16, height, width) == _counted(
        lambda: meta["pose_net"](_e(16, height, width, 3)))


def test_clip_and_face_flops(meta):
    assert counts.clip_flops(M["clip"]) == _counted(lambda: meta["clip"](_e(1, 224, 224, 3)))
    assert counts.face_flops(M["face_encoder"]) == _counted(
        lambda: meta["face_encoder"](_e(1, 512), _e(1, 1, 1024)))


@pytest.mark.parametrize("fn,args,tflop", [
    # FlopCounterMode over the program's meta models at full width
    (counts.unet_flops, (2, 16, 64, 64), 39.71), (counts.unet_flops, (2, 16, 72, 128), 100.34),
    (counts.vae_decode_flops, (16, 64, 64), 48.69), (counts.vae_decode_flops, (16, 72, 128), 111.09),
    (counts.vae_encode_flops, (1, 512, 512), 1.117), (counts.vae_encode_flops, (1, 576, 1024), 2.609),
])
def test_the_programs_own_figures(fn, args, tflop):
    part = M["unet"] if fn is counts.unet_flops else M["vae"]
    assert fn(part, *args) / 1e12 == pytest.approx(tflop, abs=0.01)


def _request(h, w):
    return {"kind": "request", "height": h, "width": w, "frames": 16, "steps": 25,
            "decode_chunk": 4, "batched_decode_max_latent_volume": 16 * 64 * 64}


def _step(h, w):
    return {"kind": "step", "height": h, "width": w, "frames": 16, "clips": 1,
            "checkpointing": True}


@pytest.mark.parametrize("work,launches", [
    # the program's launch counts (chip_smoke): 10 a step + 1 decode, 125 a
    # level at 576x1024 + 4 decode chunks; training 20 / 10 (remat), 30 / 15
    (_request(512, 512), {"fwd": 251}), (_request(576, 1024), {"fwd": 379}),
    (_step(512, 512), {"fwd": 20, "bwd": 10}), (_step(1024, 576), {"fwd": 30, "bwd": 15}),
])
def test_attention_calls_follow_the_routing(work, launches):
    got = {}
    for c in counts.attention_calls(CFG, work):
        got[c["pass"]] = got.get(c["pass"], 0) + c["n"]
    assert got == launches


def test_bounds_of_the_programs_kernel_table():
    # PERF.md's kernel table: UNet L0 [32,4096,5,64] 0.695 ms, VAE mid
    # [16,4096,1,512] 0.556 ms, pro L2 [32,576,20,64] 0.056 ms (bytes)
    def fwd(b, s, h, d):
        return dict(**{"pass": "fwd"}, b=b, sq=s, sk=s, h=h, d=d, lse=False, n=1)

    assert counts.bound_seconds(fwd(32, 4096, 5, 64)) * 1e3 == pytest.approx(0.695, abs=1e-3)
    assert counts.bound_seconds(fwd(16, 4096, 1, 512)) * 1e3 == pytest.approx(0.556, abs=1e-3)
    assert counts.bound_seconds(fwd(32, 576, 20, 64)) * 1e3 == pytest.approx(0.056, abs=2e-3)


def test_model_flops_of_a_request_and_a_step():
    req = counts.model_flops(CFG, _request(512, 512))
    parts = (25 * counts.unet_flops(M["unet"], 2, 16, 64, 64)
             + counts.vae_decode_flops(M["vae"], 16, 64, 64)
             + counts.vae_encode_flops(M["vae"], 1, 512, 512) + counts.clip_flops(M["clip"])
             + counts.pose_flops(M["pose_net"], 16, 512, 512) + counts.face_flops(M["face_encoder"]))
    assert req == parts
    assert 1.0e15 < req < 1.1e15
    step = counts.model_flops(CFG, _step(512, 512))
    assert step == (3 * (counts.unet_flops(M["unet"], 1, 16, 64, 64)
                         + counts.pose_flops(M["pose_net"], 16, 512, 512)
                         + counts.face_flops(M["face_encoder"]))
                    + counts.vae_encode_flops(M["vae"], 17, 512, 512) + counts.clip_flops(M["clip"]))
