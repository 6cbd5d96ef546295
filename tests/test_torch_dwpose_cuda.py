"""The port's DWPose extraction on the card against the same on the CPU:
micro-width YOLOX and RTMPose stand-ins (`preproc/standins.py::write_dwpose`
at depth 0.33, width 0.125), fp32 with TF32 off, so summation order only;
and the C++ raster built with g++ on the card's machine.

Imports neither JAX nor the test configuration, so it runs on a machine
with the GPU and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_dwpose_cuda.py -q
"""

import os

import numpy as np
import pytest
import torch

from stableanimator_tpu_torch.preproc import skeleton_render
from stableanimator_tpu_torch.preproc.standins import write_dwpose
from stableanimator_tpu_torch.preproc.wholebody import WholebodyDetector
from tests.torch_threads import share_cores

THREADS = share_cores()

pytestmark = pytest.mark.cuda
TOL = 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def micro_dwpose(tmp_path_factory):
    _card()
    d = write_dwpose(str(tmp_path_factory.mktemp("dwpose")), depth=0.33, width=0.125)
    return os.path.join(d, "yolox_l.onnx"), os.path.join(d, "dw-ll_ucoco_384.onnx")


def test_video_poses_on_the_card_match_the_cpu(micro_dwpose):
    _card()
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, (256, 256, 3), dtype=np.uint8) for _ in range(4)]
    poses = {dev: WholebodyDetector(*micro_dwpose, device=dev).video_poses(frames)
             for dev in ("cpu", "cuda")}
    for got, want in zip(poses["cuda"], poses["cpu"]):
        np.testing.assert_array_equal(got["bodies"]["subset"], want["bodies"]["subset"])
        np.testing.assert_allclose(got["bodies"]["candidate"], want["bodies"]["candidate"],
                                   rtol=TOL, atol=TOL)
        for key in ("hands", "faces"):
            np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL)


def test_detector_boxes_on_the_card_match_the_cpu(micro_dwpose):
    _card()
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 255, (320, 240, 3), dtype=np.uint8) for _ in range(3)]
    boxes = {dev: WholebodyDetector(*micro_dwpose, device=dev).detector.detect_batch(frames)
             for dev in ("cpu", "cuda")}
    assert sum(len(b) for b in boxes["cpu"]) > 0
    for got, want in zip(boxes["cuda"], boxes["cpu"]):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_raster_builds_and_draws():
    _card()
    rng = np.random.default_rng(2)
    pose = dict(bodies=dict(candidate=rng.uniform(0.1, 0.9, (18, 2)),
                            subset=np.arange(18, dtype=float)[None], score=np.full((1, 18), 0.9)),
                hands=rng.uniform(0.1, 0.9, (2, 21, 2)), hands_score=np.full((2, 21), 0.8),
                faces=rng.uniform(0.1, 0.9, (1, 68, 2)), faces_score=np.full((1, 68), 0.7))
    img = skeleton_render.draw_pose(pose, 128, 96)
    assert img.shape == (3, 128, 96) and img.max() > 0
