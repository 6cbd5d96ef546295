"""The port's DWPose skeleton extraction (`stableanimator_tpu_torch.preproc.
{detection,pose_estimation,wholebody,native_raster,skeleton_render,
skeleton_extraction,legacy_detectors,pose_worker}` and the two extract CLIs)
against the JAX package's, on the CPU.

The networks are tests/test_preproc.py's stand-ins (a YOLOX-grid detector at
64x64, a 133-keypoint SimCC head at 64x48), exported once and run through
both packages' executors on the same frames: person boxes and keypoints
within 1e-4, subsets equal. The numpy helpers are copies (equal outputs);
renders on the same pose dicts are byte-equal to the JAX package's C++
raster and to its OpenCV oracle. Also the executor's release of values
after their last use, the pose model's input size read from the graph, the
worker's protocol, the CLIs, and the full-width stand-ins' shapes (on the
meta device).
"""

import copy
import filecmp
import io
import json
import os
import tomllib
import zlib

import numpy as np
import pytest
import torch
import torch.nn as nn

from stableanimator_tpu.preproc import detection as jax_det
from stableanimator_tpu.preproc import legacy_detectors as jax_legacy
from stableanimator_tpu.preproc import pose_estimation as jax_pose
from stableanimator_tpu.preproc import skeleton_extraction as jax_se
from stableanimator_tpu.preproc import skeleton_render as jax_render
from stableanimator_tpu.preproc import wholebody as jax_wb
from stableanimator_tpu_torch.ops import build
from stableanimator_tpu_torch.preproc import (
    detection,
    legacy_detectors,
    pose_estimation,
    pose_worker,
    skeleton_extraction,
    skeleton_render,
    standins,
    wholebody,
)
from chip_smoke import _keep_every_value
from stableanimator_tpu_torch.preproc.onnx_to_torch import load_onnx_function
from tests.test_preproc import _YoloxStandin
from tests.torch_threads import share_cores

THREADS = share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
# get_video_pose end to end: at most this many pixels of the [F, 3, H, W]
# renders differ from the JAX package's. The keypoints agree within ~1e-6 of
# the image size, but each one is truncated to an integer pixel of the
# 2160-px canvas, so a coordinate within ~1e-6 of a pixel boundary moves a
# joint by one canvas pixel; none did on these frames.
RENDER_PIXELS = 0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes at once, and torch's thread pools then spend their time
    waiting for each other on these small shapes."""
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(THREADS)


class _SimccStandin(nn.Module):
    """tests/test_preproc.py's RTMPose stand-in: 133 keypoints, SimCC x / y
    heads of 2 x 48 and 2 x 64 bins for a 64x48 crop."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 16, stride=16)
        self.fx = nn.Linear(8 * 4 * 3, 133 * 96)
        self.fy = nn.Linear(8 * 4 * 3, 133 * 128)

    def forward(self, x):
        y = self.conv(x).flatten(1)
        return self.fx(y).reshape(-1, 133, 96), self.fy(y).reshape(-1, 133, 128)


@pytest.fixture(scope="module")
def onnx_pair(tmp_path_factory):
    """(detector path, pose path): the stand-ins, exported once."""
    d = tmp_path_factory.mktemp("dwpose")
    torch.manual_seed(3)
    det = standins.export_onnx(_YoloxStandin(), (torch.randn(1, 3, 64, 64),), str(d / "det.onnx"))
    pose = standins.export_onnx(_SimccStandin(), (torch.randn(1, 3, 64, 48),),
                                str(d / "pose.onnx"))
    return det, pose


@pytest.fixture(scope="module")
def detectors(onnx_pair):
    """(port WholebodyDetector on the CPU, JAX WholebodyDetector) at the
    stand-ins' 64x64 / 64x48 sizes; the port reads the pose size from the
    graph, the JAX package is told it."""
    port = wholebody.WholebodyDetector(*onnx_pair, device="cpu")
    jax = jax_wb.WholebodyDetector(*onnx_pair)
    port.detector.input_size = jax.detector.input_size = (64, 64)
    jax.pose.input_size = (48, 64)
    return port, jax


def _frames(seed, n, shape=(96, 72, 3)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, shape, dtype=np.uint8) for _ in range(n)]


def _random_pose(rng, people=1):
    body = rng.uniform(0.05, 0.95, (18 * people, 2))
    score = rng.uniform(0.0, 1.0, (people, 18))
    subset = np.where(score > 0.3, np.arange(18 * people).reshape(people, 18), -1).astype(float)
    return dict(bodies=dict(candidate=body, subset=subset, score=score),
                hands=rng.uniform(0.05, 0.95, (2 * people, 21, 2)),
                hands_score=rng.uniform(0, 1, (2 * people, 21)),
                faces=rng.uniform(0.05, 0.95, (people, 68, 2)),
                faces_score=rng.uniform(0, 1, (people, 68)))


def _assert_poses_close(got, want):
    np.testing.assert_allclose(got["bodies"]["candidate"], want["bodies"]["candidate"],
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got["bodies"]["subset"], want["bodies"]["subset"])
    np.testing.assert_allclose(got["bodies"]["score"], want["bodies"]["score"],
                               rtol=TOL, atol=TOL)
    for key in ("hands", "faces", "hands_score", "faces_score"):
        np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL, err_msg=key)


class _QuietYolox(_YoloxStandin):
    """The YOLOX-grid stand-in with its outputs scaled down so that no box
    passes the score threshold (obj x cls < 1e-2 for 0-255 pixels): every
    frame takes the full-image box, one body, and the alignment has frames
    to fit on."""

    def forward(self, x):
        return super().forward(x) * 1e-4


def write_cli_standins(directory) -> str:
    """yolox_l.onnx (`_QuietYolox` at 640x640) and dw-ll_ucoco_384.onnx (the
    SimCC stand-in at 64x48), batch dynamic, under DWPose's file names."""
    os.makedirs(directory, exist_ok=True)
    torch.manual_seed(4)
    standins.export_onnx(_QuietYolox(), (torch.zeros(1, 3, 640, 640),),
                         os.path.join(directory, "yolox_l.onnx"), names=(["images"], ["output"]))
    standins.export_onnx(_SimccStandin(), (torch.zeros(1, 3, 64, 48),),
                         os.path.join(directory, "dw-ll_ucoco_384.onnx"),
                         names=(["input"], ["simcc_x", "simcc_y"]))
    return str(directory)


@pytest.fixture(scope="module")
def dwpose_dir(tmp_path_factory):
    """(directory of the CLI stand-ins, a port WholebodyDetector on them)."""
    d = write_cli_standins(tmp_path_factory.mktemp("DWPose"))
    return d, wholebody.WholebodyDetector(os.path.join(d, "yolox_l.onnx"),
                                          os.path.join(d, "dw-ll_ucoco_384.onnx"), device="cpu")


# ---------------------------------------------------------------------------
# numpy helpers: copies, equal outputs
# ---------------------------------------------------------------------------

def _boxes(rng, n):
    xy = rng.uniform(0, 50, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(5, 30, (n, 2))], axis=1).astype(np.float32)


def _helper_case(name, rng):
    """(port result, JAX result) of helper `name` on seeded inputs."""
    if name == "letterbox":
        img = rng.integers(0, 255, (70, 50, 3), dtype=np.uint8)
        return detection.letterbox(img, (64, 64)), jax_det.letterbox(img, (64, 64))
    if name == "decode_outputs":
        raw = rng.normal(size=(2, 84, 85)).astype(np.float32)
        return detection.decode_outputs(raw, (64, 64)), jax_det.decode_outputs(raw, (64, 64))
    if name == "nms_single_class":
        b, s = _boxes(rng, 40), rng.uniform(size=40).astype(np.float32)
        return detection.nms_single_class(b, s, 0.45), jax_det.nms_single_class(b, s, 0.45)
    if name == "multiclass_nms":
        b, s = _boxes(rng, 60), rng.uniform(size=(60, 3)).astype(np.float32)
        return (detection.multiclass_nms(b, s, 0.45, 0.3),
                jax_det.multiclass_nms(b, s, 0.45, 0.3))
    if name == "bbox_xyxy2cs+fix_aspect_ratio":
        box = _boxes(rng, 1)[0].astype(np.float64)
        c, s = pose_estimation.bbox_xyxy2cs(box)
        jc, js = jax_pose.bbox_xyxy2cs(box)
        return ((c, s, pose_estimation.fix_aspect_ratio(s, 0.75)),
                (jc, js, jax_pose.fix_aspect_ratio(js, 0.75)))
    if name == "get_warp_matrix+top_down_affine":
        img = rng.integers(0, 255, (80, 60, 3), dtype=np.uint8)
        c, s = np.array([30.0, 41.0]), np.array([37.0, 52.0])
        return ((pose_estimation.get_warp_matrix(c, s, 15.0, (48, 64)),
                 *pose_estimation.top_down_affine((48, 64), s, c, img)),
                (jax_pose.get_warp_matrix(c, s, 15.0, (48, 64)),
                 *jax_pose.top_down_affine((48, 64), s, c, img)))
    if name == "simcc_decode":
        sx, sy = rng.normal(size=(3, 133, 96)), rng.normal(size=(3, 133, 128))
        sx[0, :5] = -1.0                                # invisible keypoints -> -1
        return pose_estimation.simcc_decode(sx, sy), jax_pose.simcc_decode(sx, sy)
    if name == "_compose+_to_pose_dict":
        k, s = rng.uniform(0, 90, (2, 133, 2)), rng.uniform(0, 1, (2, 133))
        cand, score = wholebody.WholebodyDetector._compose(k, s)
        jcand, jscore = jax_wb.WholebodyDetector._compose(k, s)
        return ((cand, score, wholebody.WholebodyDetector._to_pose_dict(cand, score, 96, 72)),
                (jcand, jscore, jax_wb.WholebodyDetector._to_pose_dict(jcand, jscore, 96, 72)))
    raise KeyError(name)


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", ["letterbox", "decode_outputs", "nms_single_class",
                                  "multiclass_nms", "bbox_xyxy2cs+fix_aspect_ratio",
                                  "get_warp_matrix+top_down_affine", "simcc_decode",
                                  "_compose+_to_pose_dict"])
def test_numpy_helper_copies_equal_jax(name):
    got, want = _helper_case(name, np.random.default_rng(zlib.crc32(name.encode())))
    _assert_same(got, want)


def test_face_model_takes_nms_from_detection():
    from stableanimator_tpu_torch.preproc import face

    assert face.nms_single_class is detection.nms_single_class


# ---------------------------------------------------------------------------
# the networks through both executors
# ---------------------------------------------------------------------------

def test_person_detector_matches_jax(detectors):
    port, jax = detectors
    frames = _frames(8, 5, (80, 64, 3))
    kw = dict(score_thr=-10.0, final_thr=-10.0)
    got = port.detector.detect_batch(frames, **kw)
    want = jax.detector.detect_batch(frames, **kw)
    assert len(got) == len(want) == 5 and any(len(b) for b in got)
    for g, w, f in zip(got, want, frames):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(port.detector(f, **kw), g, rtol=TOL, atol=TOL)


def test_pose_estimator_reads_its_crop_size_and_matches_jax(onnx_pair):
    """The crop size comes from the graph's declared [1, 3, 64, 48] input (the
    JAX package fixes 192x256 and is told 48x64 here); same keypoints."""
    est = pose_estimation.PoseEstimator(onnx_pair[1], device="cpu")
    assert est.input_size == (48, 64)
    jest = jax_pose.PoseEstimator(onnx_pair[1], input_size=(48, 64))
    img = _frames(1, 1, (96, 72, 3))[0]
    boxes = np.array([[10, 10, 60, 90], [5, 20, 40, 70]], np.float32)
    (k, s), (jk, js) = est(img, boxes), jest(img, boxes)
    assert k.shape == (2, 133, 2) and s.shape == (2, 133)
    np.testing.assert_allclose(k, jk, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s, js, rtol=TOL, atol=TOL)
    assert pose_estimation.PoseEstimator(onnx_pair[1], input_size=(96, 128),
                                         device="cpu").input_size == (96, 128)


def test_pose_estimator_needs_a_static_crop_size():
    """A graph whose H x W is dynamic gives no crop size: the caller must."""
    from stableanimator_tpu_torch.preproc.onnx_reader import Graph

    assert pose_estimation.graph_input_size(Graph([], {}, [("x", [-1, 3, 384, 288])],
                                                  [])) == (288, 384)
    for shape in ([-1, 3, -1, -1], None, [3, 64]):
        with pytest.raises(ValueError, match="static"):
            pose_estimation.graph_input_size(Graph([], {}, [("x", shape)], []))


def test_wholebody_video_poses_and_call_match_jax(detectors):
    port, jax = detectors
    frames = _frames(7, 3)
    got, want = port.video_poses(frames), jax.video_poses(frames)
    assert len(got) == len(want) == 3
    for g, w, f in zip(got, want, frames):
        _assert_poses_close(g, w)
        _assert_poses_close(port(f), g)          # the serial call, same poses
        _assert_poses_close(port(f), jax(f))


# ---------------------------------------------------------------------------
# the raster and the renders
# ---------------------------------------------------------------------------

def test_raster_source_is_a_byte_equal_copy():
    assert filecmp.cmp(os.path.join(REPO, "native", "raster.cpp"),
                       build.CSRC / "raster.cpp", shallow=False)
    assert build.library_path("raster").name.startswith("libraster_")


@pytest.mark.parametrize("size", [(128, 96), (512, 512), (96, 160)])
def test_draw_pose_is_byte_equal_to_jax_native_and_cv2(size):
    h, w = size
    rng = np.random.default_rng(h * w)
    for pose in (_random_pose(rng), _random_pose(rng, people=2)):
        got = skeleton_render.draw_pose(copy.deepcopy(pose), h, w)
        assert got.shape == (3, h, w) and got.dtype == np.uint8 and got.max() > 0
        np.testing.assert_array_equal(got, jax_render.draw_pose(copy.deepcopy(pose), h, w,
                                                                backend="native"))
        np.testing.assert_array_equal(got, jax_render.draw_pose(copy.deepcopy(pose), h, w,
                                                                backend="cv2"))


def test_align_to_reference_matches_jax():
    rng = np.random.default_rng(4)
    ref = _random_pose(rng)
    ref["bodies"]["subset"][0, [3, 9]] = -1              # joints the reference lacks
    detected = [_random_pose(rng) for _ in range(3)] + [_random_pose(rng, people=2)]
    got = skeleton_render.align_to_reference(copy.deepcopy(detected), ref, 128, 96)
    want = jax_render.align_to_reference(copy.deepcopy(detected), ref, 128, 96)
    for g, w in zip(got, want):
        for key in ("faces", "hands"):
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-9)
        np.testing.assert_allclose(g["bodies"]["candidate"], w["bodies"]["candidate"],
                                   rtol=0, atol=1e-9)
    with pytest.raises(ValueError):
        skeleton_render.align_to_reference([_random_pose(rng, people=2)], ref, 128, 96)


def test_get_video_pose_renders_match_jax(dwpose_dir):
    """End to end on the quiet 640x640 detector (each frame one full-image
    body, so the alignment has bodies to fit)."""
    d, port = dwpose_dir
    jax = jax_wb.WholebodyDetector(os.path.join(d, "yolox_l.onnx"),
                                   os.path.join(d, "dw-ll_ucoco_384.onnx"))
    jax.pose.input_size = (48, 64)
    frames, ref = _frames(11, 3), _frames(12, 1)[0]
    got = skeleton_extraction.get_video_pose(port, frames, ref)
    want = jax_se.get_video_pose(jax, frames, ref)
    assert got.shape == want.shape == (3, 3, 96, 72) and got.std() > 0
    assert int((got != want).any(axis=1).sum()) <= RENDER_PIXELS
    np.testing.assert_array_equal(skeleton_extraction.render_training_pose(port, ref),
                                  jax_se.render_training_pose(jax, ref))


class _FakeWholebody:
    """tests/test_legacy_detectors.py's fixed keypoints for two people."""

    def __init__(self, n_people=2):
        rng = np.random.default_rng(0)
        self._kpts = rng.uniform(10, 60, (n_people, 134, 2))
        self._scores = rng.uniform(0.2, 1.0, (n_people, 134))

    def keypoints(self, image_rgb):
        return self._kpts.copy(), self._scores.copy()


@pytest.mark.parametrize("cls", ["DWposeDetector", "DWposeDetectorOnlyOnePerson"])
def test_legacy_detectors_are_byte_equal_to_jax(cls):
    det = getattr(legacy_detectors, cls)("x", "y", detector=_FakeWholebody())
    jdet = getattr(jax_legacy, cls)("x", "y", detector=_FakeWholebody())
    img = np.zeros((72, 80, 3), np.uint8)
    for remain_face in (True, False):
        got = det(img, remain_face=remain_face)
        assert got.max() > 0
        np.testing.assert_array_equal(got, jdet(img, remain_face=remain_face))


def test_legacy_hand_and_face_boxes_match_jax():
    rng = np.random.default_rng(5)
    cand = rng.uniform(0, 200, (36, 2))
    subset = np.where(rng.uniform(size=(2, 18)) > 0.2, np.arange(36).reshape(2, 18), -1)
    for fn in ("hand_detect", "face_detect"):
        assert (getattr(legacy_detectors, fn)(cand, subset, (220, 210))
                == getattr(jax_legacy, fn)(cand, subset, (220, 210)))


# ---------------------------------------------------------------------------
# faults: the executor's value lifetimes, the wheel's sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["iresnet", "scrfd"])
def test_executor_releases_values_and_computes_the_same(tmp_path, case):
    """The face models' stand-ins (iresnet, SCRFD): outputs and input
    gradients equal to chip_smoke's loop that keeps every value (the
    executor before it freed values), while the most values held at once
    falls below the count the graph computes."""
    if case == "iresnet":
        model = standins.seeded_iresnet(0, layers=(1, 1, 1, 1), widths=(8, 8, 16, 16),
                                        num_features=32)
        shape = (2, 3, 112, 112)
    else:
        torch.manual_seed(0)
        model = standins.ScrfdStandin(score_bias=1.0)
        shape = (1, 3, 64, 64)
    path = standins.export_onnx(model, (torch.zeros(shape),), str(tmp_path / "m.onnx"),
                                constant_folding=False)
    fn = load_onnx_function(path, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, shape).astype(np.float32))
    produced = len({o for n in fn.graph.nodes for o in n.outputs if o})
    grads = []
    for run in (fn, lambda v: _keep_every_value(fn, v)):
        xr = x.clone().requires_grad_(True)
        outs = run(xr)
        (g,) = torch.autograd.grad(sum(o.square().sum() for o in outs), xr)
        grads.append((outs, g))
    (outs, g), (want_outs, want_g) = grads
    for o, w in zip(outs, want_outs):
        assert torch.equal(o, w)
    assert torch.equal(g, want_g)
    assert 0 < fn.peak_values < produced // 4, (fn.peak_values, produced)


def test_the_wheel_ships_every_native_source():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]["stableanimator_tpu_torch"]
    assert {"csrc/*.cu", "csrc/*.cuh", "csrc/*.cpp"} <= set(data)
    suffixes = {p.suffix for p in build.CSRC.iterdir() if p.is_file()}
    assert suffixes <= {".cu", ".cuh", ".cpp"}, suffixes


# ---------------------------------------------------------------------------
# the full-width stand-ins: the published interfaces (meta device, no work)
# ---------------------------------------------------------------------------

def test_full_width_standins_have_the_published_shapes():
    with torch.device("meta"):
        yolox, rtm = standins.Yolox(), standins.RTMPose()
        out = yolox(torch.zeros(2, 3, 640, 640))
        sx, sy = rtm(torch.zeros(2, 3, 384, 288))
    assert tuple(out.shape) == (2, 8400, 85)
    assert tuple(sx.shape) == (2, 133, 576) and tuple(sy.shape) == (2, 133, 768)
    # YOLOX-L is 54.2 M parameters (Megvii's model zoo)
    assert 54.1e6 < sum(p.numel() for p in yolox.parameters()) < 54.3e6
    assert rtm.mlp[1].in_features == 108 and rtm.mlp[1].out_features == 256
    assert rtm.final_layer.kernel_size == (7, 7) and rtm.gau.s == 128 and rtm.gau.e == 512


# ---------------------------------------------------------------------------
# the worker and the CLIs
# ---------------------------------------------------------------------------

def test_pose_worker_protocol(dwpose_dir, tmp_path):
    """serve() in this process: init, a bad request answered ok: false with
    the worker still serving, extract, image_pose, exit."""
    frames = np.stack(_frames(2, 3))
    ref = _frames(3, 1)[0]
    np.save(tmp_path / "f.npy", frames)
    np.save(tmp_path / "r.npy", ref)
    requests = [
        {"op": "extract", "frames_npy": "x", "reference_npy": "y", "out_npy": "z",
         "height": 96, "width": 72},
        {"op": "init", "det": os.path.join(dwpose_dir[0], "yolox_l.onnx"),
         "pose": os.path.join(dwpose_dir[0], "dw-ll_ucoco_384.onnx"), "device": "cpu",
         "letterbox": [640, 640], "max_det": 10},
        {"op": "nonsense"},
        {"op": "extract", "frames_npy": str(tmp_path / "f.npy"),
         "reference_npy": str(tmp_path / "r.npy"), "out_npy": str(tmp_path / "o.npy"),
         "height": 96, "width": 72},
        {"op": "image_pose", "reference_npy": str(tmp_path / "r.npy"),
         "out_npy": str(tmp_path / "p.npy")},
        {"op": "exit"},
        {"op": "nonsense"},                                  # after exit: not read
    ]
    out = io.StringIO()
    pose_worker.serve(io.StringIO("\n".join(json.dumps(r) for r in requests) + "\n"), out)
    replies = [json.loads(line) for line in out.getvalue().splitlines()]
    assert len(replies) == 6
    assert not replies[0]["ok"] and "init first" in replies[0]["error"]
    assert replies[1] == {"ok": True}
    assert not replies[2]["ok"] and "unknown op" in replies[2]["error"]
    assert replies[3]["ok"] and replies[3]["frames"] == 3 and replies[3]["aligned"]
    assert replies[4]["ok"] and replies[5] == {"ok": True}
    wb = dwpose_dir[1]
    np.testing.assert_array_equal(np.load(tmp_path / "o.npy"),
                                  skeleton_extraction.get_video_pose(wb, list(frames), ref))
    np.testing.assert_array_equal(np.load(tmp_path / "p.npy"),
                                  skeleton_extraction.get_image_pose(wb, ref))


def test_pose_worker_subprocess(dwpose_dir):
    """PoseWorker: the subprocess on the CPU, extract_async + join, image_pose,
    a failed request raised on the caller's side with the worker serving on,
    close."""
    frames, ref = np.stack(_frames(2, 2)), _frames(3, 1)[0]
    worker = pose_worker.PoseWorker(os.path.join(dwpose_dir[0], "yolox_l.onnx"),
                                    os.path.join(dwpose_dir[0], "dw-ll_ucoco_384.onnx"),
                                    device="cpu")
    try:
        maps, ack = worker.extract_async(frames, ref, 96, 72)()
        assert maps.shape == (2, 3, 96, 72) and ack["frames"] == 2 and ack["aligned"]
        join = worker.extract_async(frames[:0], ref, 96, 72, tag="empty")
        with pytest.raises(RuntimeError, match="pose worker: ValueError"):
            join()
        assert worker.image_pose(ref).shape == (3, 96, 72)
    finally:
        worker.close()
    assert worker._proc.returncode == 0 and not os.path.exists(worker._dir)


def test_pose_worker_queues_the_extraction_behind_its_init(tmp_path):
    """extract_async does not wait for the init's ack (the caller's work
    overlaps the worker's start): a failed init surfaces at join()."""
    worker = pose_worker.PoseWorker(str(tmp_path / "none.onnx"), str(tmp_path / "none.onnx"),
                                    device="cpu")
    try:
        join = worker.extract_async(np.stack(_frames(2, 1)), _frames(3, 1)[0], 96, 72)
        with pytest.raises(RuntimeError, match="pose worker: FileNotFoundError"):
            join()
    finally:
        worker.close()
    assert worker._proc.returncode == 0


def _write_frames(folder, frames):
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(folder, f"frame_{i}.png"))


def test_extract_skeleton_cli_writes_the_aligned_renders(dwpose_dir, tmp_path):
    from PIL import Image

    from stableanimator_tpu_torch.cli import extract_skeleton

    frames, ref = _frames(21, 3, (96, 72, 3)), _frames(22, 1, (96, 72, 3))[0]
    _write_frames(tmp_path / "frames", frames)
    Image.fromarray(ref).save(tmp_path / "ref.png")
    n = extract_skeleton.main(["--target_image_folder_path", str(tmp_path / "frames"),
                               "--ref_image_path", str(tmp_path / "ref.png"),
                               "--poses_folder_path", str(tmp_path / "poses"),
                               "--dwpose_dir", dwpose_dir[0], "--device", "cpu"])
    want = skeleton_extraction.get_video_pose(dwpose_dir[1], frames, ref)
    assert n == 3
    for i in range(3):
        written = np.asarray(Image.open(tmp_path / "poses" / f"frame_{i}.png"))
        # the BGR write convention: the file holds the channel-reversed render
        np.testing.assert_array_equal(written[..., ::-1], want[i].transpose(1, 2, 0))


def test_extract_training_skeletons_cli_is_idempotent(dwpose_dir, tmp_path):
    from PIL import Image

    from stableanimator_tpu_torch.cli import extract_training_skeletons

    frames = _frames(31, 2, (80, 64, 3))
    for clip in ("clip0", "clip1"):
        _write_frames(tmp_path / "data" / clip / "images", frames)
    argv = ["--video_folder", str(tmp_path / "data"), "--dwpose_dir", dwpose_dir[0],
            "--device", "cpu"]
    assert extract_training_skeletons.main(argv) == 4
    path = tmp_path / "data" / "clip1" / "poses" / "frame_1.png"
    written = np.asarray(Image.open(path))
    np.testing.assert_array_equal(
        written[..., ::-1],
        skeleton_extraction.render_training_pose(dwpose_dir[1], frames[1]).transpose(1, 2, 0))
    mtime = path.stat().st_mtime_ns
    assert extract_training_skeletons.main(argv) == 0
    assert path.stat().st_mtime_ns == mtime
