"""The port's face models and geometry (`stableanimator_tpu_torch.preproc.
{face,geometry}`) against the JAX package's (`preproc/{face,geometry}.py`),
on the CPU.

The geometry is a copy: byte for byte the JAX package's outputs on the same
inputs (tests/test_preproc.py pins those to OpenCV). The face models run
exported stand-in networks (SCRFD's output signature, small recognisers,
landmark and gender/age heads) through both packages' executors on the
same images: boxes, keypoints, embeddings and landmarks within 1e-4.

An embedding is compared on the same five landmarks in both packages: the
alignment warp rounds to uint8, so keypoints that differ by ~4e-5 (fp32
summation order in the detector) can move a few crop pixels by one level,
which moves a stand-in's embedding by ~2e-4.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

from stableanimator_tpu.preproc import face as jax_face
from stableanimator_tpu.preproc import geometry as jax_geometry
from stableanimator_tpu_torch.preproc import face, geometry
from stableanimator_tpu_torch.preproc.standins import (
    IResNet,
    ScrfdStandin,
    export_onnx,
    seeded_iresnet,
    write_antelopev2,
)
from tests.torch_threads import share_cores

THREADS = share_cores()

TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes at once, and torch's thread pools then spend their time
    waiting for each other on these small shapes."""
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(THREADS)


def test_geometry_copy_is_byte_equal_to_jax():
    rng = np.random.default_rng(0)
    for shape, size in [((100, 80, 3), (64, 64)), ((33, 44, 3), (7, 5)), ((7, 5), (33, 44)),
                        ((64, 64, 3), (64, 64))]:
        img = rng.integers(0, 256, shape, np.uint8)
        np.testing.assert_array_equal(geometry.resize_bilinear(img, size),
                                      jax_geometry.resize_bilinear(img, size))
    for _ in range(5):
        img = rng.integers(0, 256, (40, 50, 3), np.uint8)
        src = rng.uniform(0, 40, (3, 2)).astype(np.float32)
        dst = rng.uniform(0, 40, (3, 2)).astype(np.float32)
        m = geometry.get_affine_transform(src, dst)
        np.testing.assert_array_equal(m, jax_geometry.get_affine_transform(src, dst))
        np.testing.assert_array_equal(geometry.invert_affine(m), jax_geometry.invert_affine(m))
        np.testing.assert_array_equal(geometry.warp_affine(img, m, (30, 20), border_value=7),
                                      jax_geometry.warp_affine(img, m, (30, 20), border_value=7))
    for box in [(2, 3, 10, 12), (-5, -5, 4, 4), (60, 60, 80, 80)]:
        a, b = np.zeros((64, 64), np.uint8), np.zeros((64, 64), np.uint8)
        geometry.fill_rect(a, box[:2], box[2:], 255)
        jax_geometry.fill_rect(b, box[:2], box[2:], 255)
        np.testing.assert_array_equal(a, b)


def test_umeyama_and_norm_crop_match_jax():
    rng = np.random.default_rng(1)
    src = face.ARCFACE_DST * 1.7 + rng.normal(size=(5, 2)).astype(np.float32) * 2 + 30
    m = face.umeyama_similarity(src.astype(np.float64), face.ARCFACE_DST)
    np.testing.assert_array_equal(m, jax_face.umeyama_similarity(src.astype(np.float64),
                                                                 jax_face.ARCFACE_DST))
    # a similarity: recovers the scale that made src
    assert abs(np.sqrt(np.linalg.det(m[:, :2])) - 1 / 1.7) < 0.05
    img = rng.integers(0, 256, (200, 180, 3), np.uint8)
    np.testing.assert_array_equal(face.norm_crop(img, src), jax_face.norm_crop(img, src))


def test_nms_copy_matches_jax():
    from stableanimator_tpu.preproc.detection import nms_single_class

    rng = np.random.default_rng(2)
    xy = rng.uniform(0, 50, (40, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (40, 2))], axis=1).astype(np.float32)
    scores = rng.uniform(size=40).astype(np.float32)
    assert face.nms_single_class(boxes, scores, 0.4) == nms_single_class(boxes, scores, 0.4)


class _ArcStandin(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 16, stride=16)
        self.fc = nn.Linear(4 * 7 * 7, 512)

    def forward(self, x):
        return self.fc(self.conv(x).flatten(1))


def test_scrfd_arcface_and_face_model_match_jax(tmp_path):
    """tests/test_preproc.py's SCRFD + ArcFace case, both packages."""
    torch.manual_seed(2)
    det_path = export_onnx(ScrfdStandin(score_bias=1.0), (torch.randn(1, 3, 64, 64),),
                           str(tmp_path / "scrfd.onnx"))
    rec_path = export_onnx(_ArcStandin(), (torch.randn(1, 3, 112, 112),),
                           str(tmp_path / "arc.onnx"))
    img = np.random.default_rng(2).integers(0, 255, (80, 80, 3), dtype=np.uint8)
    det = face.FaceDetector(det_path, input_size=(64, 64), det_thresh=0.4, device="cpu")
    jdet = jax_face.FaceDetector(det_path, input_size=(64, 64), det_thresh=0.4)
    (boxes, kps), (jboxes, jkps) = det(img), jdet(img)
    assert boxes.ndim == 2 and boxes.shape[1] == 5 and kps.shape[1:] == (5, 2)
    assert len(boxes) >= 1 and boxes.shape == jboxes.shape
    np.testing.assert_allclose(boxes, jboxes, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(kps, jkps, rtol=TOL, atol=TOL)
    model = face.FaceModel(det_path, rec_path, device="cpu")
    jmodel = jax_face.FaceModel(det_path, rec_path)
    model.detector, jmodel.detector = det, jdet       # the 64x64 stand-in geometry
    emb = model.get_id_embedding(img)
    assert emb.shape == (512,) and emb.dtype == np.float32 and np.abs(emb).max() > 0
    # the largest box's landmarks, as both packages pick them
    largest = int(np.argmax((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])))
    np.testing.assert_allclose(emb, jmodel.encoder(img, kps[largest]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(model.encoder(img, jkps[largest]),
                               jmodel.encoder(img, jkps[largest]), rtol=TOL, atol=TOL)
    # nothing detected -> None in both
    det.det_thresh = jdet.det_thresh = 1.1
    assert model.get_id_embedding(img) is None and jmodel.get_id_embedding(img) is None


def test_antelopev2_standins_give_an_embedding(tmp_path):
    """The stand-in pack (SCRFD signature at 640x640, an iresnet recogniser)
    detects a face in any image and embeds it, as the JAX package does."""
    small = seeded_iresnet(0, layers=(1, 1, 1, 1), widths=(8, 8, 16, 16), num_features=64)
    d = write_antelopev2(str(tmp_path / "antelopev2"), recogniser=small)
    img = np.random.default_rng(3).integers(0, 255, (96, 72, 3), dtype=np.uint8)
    paths = (f"{d}/scrfd_10g_bnkps.onnx", f"{d}/glintr100.onnx")
    model, jmodel = face.FaceModel(*paths, device="cpu"), jax_face.FaceModel(*paths)
    emb = model.get_id_embedding(img)
    assert jmodel.get_id_embedding(img) is not None
    assert emb is not None and emb.shape == (64,) and np.abs(emb).max() > 0
    boxes, kps = model.detector(img)
    largest = int(np.argmax((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])))
    np.testing.assert_allclose(emb, jmodel.encoder(img, kps[largest]), rtol=TOL, atol=TOL)


def test_iresnet_standin_has_glintr100_shape():
    model = IResNet()
    blocks = [len(layer) for layer in model.layers]
    assert blocks == [3, 13, 30, 3]
    assert model.fc.in_features == 512 * 7 * 7 and model.fc.out_features == 512
    assert 64e6 < sum(p.numel() for p in model.parameters()) < 66e6


def test_face_mask_fallback():
    img = np.zeros((32, 32, 3), np.uint8)
    assert (face.face_mask(img, None) == 255).all()
    np.testing.assert_array_equal(face.face_mask(img, None), jax_face.face_mask(img, None))


def test_face_mask_three_tiers():
    """The reference chain (face_mask_extraction.py:10-38): primary
    detector -> RetinaFace fallback at thr 0.97 -> all-white, both packages."""
    img = np.zeros((32, 32, 3), np.uint8)

    class NoFace:
        def __call__(self, image):
            return np.zeros((0, 5), np.float32), np.zeros((0, 5, 2), np.float32)

    class OneFace:
        def __call__(self, image):
            return (np.array([[1.0, 1.0, 5.0, 5.0, 0.9]], np.float32),
                    np.zeros((1, 5, 2), np.float32))

    calls = []

    def fallback(image, thr):
        calls.append(thr)
        return np.array([[4.0, 4.0, 12.0, 12.0, 0.99]], np.float32)

    def miss(image, thr):
        return np.zeros((0, 5), np.float32)

    for primary, fb in ((NoFace(), fallback), (NoFace(), miss), (OneFace(), fallback)):
        calls.clear()
        mask = face.face_mask(img, primary, fallback_detector=fb)
        port_calls = list(calls)
        np.testing.assert_array_equal(mask, jax_face.face_mask(img, primary,
                                                               fallback_detector=fb))
        if isinstance(primary, OneFace):
            assert port_calls == [] and mask[2, 2] == 255
        elif fb is fallback:
            assert port_calls == [0.97] and (mask == 255).sum() == 9 * 9
        else:
            assert (mask == 255).all()


def test_retinaface_priors_and_decode_match_jax():
    R, JR = face.RetinaFaceDetector, jax_face.RetinaFaceDetector
    priors = R._make_priors(64, 64)
    assert priors.shape == (128 + 32 + 8, 4)
    np.testing.assert_array_equal(priors, JR._make_priors(64, 64))
    np.testing.assert_array_equal(R._make_priors(72, 40), JR._make_priors(72, 40))
    loc = np.random.default_rng(4).normal(size=(len(priors), 4)).astype(np.float32)
    np.testing.assert_array_equal(R.decode_boxes(loc, priors), JR.decode_boxes(loc, priors))
    boxes = R.decode_boxes(np.zeros_like(loc), priors)
    np.testing.assert_allclose(boxes[0], [priors[0, 0] - priors[0, 2] / 2,
                                          priors[0, 1] - priors[0, 3] / 2,
                                          priors[0, 0] + priors[0, 2] / 2,
                                          priors[0, 1] + priors[0, 3] / 2], rtol=1e-6)


def test_retinaface_end_to_end_with_standin_network():
    out = {}
    for name, cls in (("port", face.RetinaFaceDetector), ("jax", jax_face.RetinaFaceDetector)):
        det = cls.__new__(cls)
        det.input_size = (64, 64)
        det.nms_thresh = 0.4
        det._priors = cls._make_priors(64, 64)
        n = len(det._priors)

        def fake_fn(blob, n=n):
            loc = np.zeros((1, n, 4), np.float32)
            conf = np.zeros((1, n, 2), np.float32)
            conf[:, :, 0] = 1.0
            conf[0, 5, 1] = 0.99
            conf[0, 100, 1] = 0.98
            return [loc, conf, np.zeros((1, n, 10), np.float32)]

        det._fn = fake_fn
        img = np.zeros((64, 64, 3), np.uint8)
        out[name] = (det(img, det_thresh=0.97), det(img, det_thresh=0.999))
    assert out["port"][0].shape == (2, 5) and out["port"][1].shape == (0, 5)
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])


class _Lmk(nn.Module):
    def __init__(self, n):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 32, stride=32)
        self.fc = nn.Linear(4 * 6 * 6, n)

    def forward(self, x):
        return torch.tanh(self.fc(self.conv(x).flatten(1)))


class _GenderAge(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 16, stride=16)
        self.fc = nn.Linear(4 * 6 * 6, 3)

    def forward(self, x):
        return torch.sigmoid(self.fc(self.conv(x).flatten(1)))


def _write_pack(d):
    torch.manual_seed(4)
    export_onnx(ScrfdStandin(score_bias=1.0, box_scale=4.0), (torch.zeros(1, 3, 64, 64),),
                str(d / "scrfd_10g_bnkps.onnx"))
    export_onnx(_Lmk(212), (torch.zeros(1, 3, 192, 192),), str(d / "2d106det.onnx"))
    export_onnx(_Lmk(204), (torch.zeros(1, 3, 192, 192),), str(d / "1k3d68.onnx"))
    export_onnx(_GenderAge(), (torch.zeros(1, 3, 96, 96),), str(d / "genderage.onnx"))
    export_onnx(_ArcStandin(), (torch.zeros(1, 3, 112, 112),), str(d / "glintr100.onnx"))


@pytest.mark.parametrize("aux", ["full_pack", "detector_only"])
def test_face_analyzer_matches_jax(tmp_path, aux):
    """tests/test_preproc.py's FaceAnalysis('antelopev2') cases: every model
    of the pack, or the detector alone when the others are missing."""
    _write_pack(tmp_path)
    if aux == "detector_only":
        for n in ("2d106det.onnx", "1k3d68.onnx", "genderage.onnx", "glintr100.onnx"):
            (tmp_path / n).unlink()
    an, jan = face.FaceAnalyzer(str(tmp_path), device="cpu"), jax_face.FaceAnalyzer(str(tmp_path))
    an.detector.input_size = jan.detector.input_size = (64, 64)
    img = np.random.default_rng(4).integers(0, 255, (128, 128, 3), dtype=np.uint8)
    faces, jfaces = an(img), jan(img)
    assert len(faces) == len(jfaces) >= 1
    for f, jf in zip(faces, jfaces):
        assert set(f) == set(jf)
        for key in ("bbox", "det_score", "kps"):
            np.testing.assert_allclose(f[key], jf[key], rtol=TOL, atol=TOL, err_msg=key)
        # each per-face model on the same detection (its crop warp rounds to uint8)
        if "embedding" in f:
            np.testing.assert_allclose(f["embedding"], jan.encoder(img, f["kps"]), rtol=TOL,
                                       atol=TOL)
        # landmarks in image pixels: within 1e-4 of the crop's side (the
        # heads' [-1, 1] outputs are scaled up to it)
        side = 1.5 * max(f["bbox"][2] - f["bbox"][0], f["bbox"][3] - f["bbox"][1])
        for key, model in (("landmark_2d_106", jan.lmk2d), ("landmark_3d_68", jan.lmk3d)):
            if key in f:
                np.testing.assert_allclose(f[key], model(img, f["bbox"]), rtol=TOL,
                                           atol=TOL * side, err_msg=key)
        if "gender" in f:
            assert (f["gender"], f["age"]) == jan.genderage(img, f["bbox"])
    f = faces[0]
    if aux == "full_pack":
        assert f["landmark_2d_106"].shape == (106, 2) and f["landmark_3d_68"].shape == (68, 3)
        assert f["gender"] in (0, 1) and 0 <= f["age"] <= 100 and f["embedding"].shape == (512,)
    else:
        assert "landmark_2d_106" not in f and "gender" not in f and "embedding" not in f


def test_face_parser_matches_jax(tmp_path):
    torch.manual_seed(6)
    net = nn.Sequential(nn.Conv2d(3, 19, 8, stride=8), nn.Upsample(scale_factor=8.0))
    path = export_onnx(net, (torch.zeros(1, 3, 64, 64),), str(tmp_path / "bisenet.onnx"))
    img = np.random.default_rng(6).integers(0, 255, (50, 70, 3), dtype=np.uint8)
    got = face.FaceParser(path, size=64, device="cpu")(img)
    want = jax_face.FaceParser(path, size=64)(img)
    assert got.shape == (64, 64) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
