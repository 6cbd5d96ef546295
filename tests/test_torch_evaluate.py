"""The port's evaluation tool (`stableanimator_tpu_torch/tools/evaluate.py`)
against the JAX package's (`tools/evaluate.py`) on the same inputs, on the
CPU: the Fréchet distance, the reconstruction metrics and the windows
(numpy in both: equal), the I3D features of a seeded I3D-shaped stand-in
(the repository holds no I3D file, as tests/test_misc.py::TestFVD) through
the two ONNX executors, and CSIM on two frames with the stand-in antelopev2
pair (a small iresnet recogniser, as tests/test_torch_face.py).
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from stableanimator_tpu_torch.preproc.geometry import resize_bilinear
from stableanimator_tpu_torch.preproc.onnx_to_torch import load_onnx_function
from stableanimator_tpu_torch.preproc.standins import (
    I3DStandin,
    export_onnx,
    seeded_iresnet,
    write_antelopev2,
)
from stableanimator_tpu_torch.tools import evaluate
from tools import evaluate as jax_evaluate
from tests.torch_threads import share_cores

THREADS = share_cores()

# I3D features: the two executors sum in other orders (fp32), 1e-5 of the
# largest feature. CSIM: both embed the same crops; keypoints that differ
# by ~4e-5 can move a crop pixel by one level, which moves a stand-in's
# embedding by ~2e-4 (tests/test_torch_face.py), so 1e-3 on a cosine.
I3D_REL, CSIM_ATOL = 1e-5, 1e-3


def _frames(n, hw, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (hw, hw, 3), dtype=np.uint8) for _ in range(n)]


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(64, 8))
    b = rng.normal(loc=3.0, size=(64, 8))
    for x, y in ((a, a), (a, b), (b, a[:40])):
        assert evaluate.frechet_distance(x, y) == jax_evaluate.frechet_distance(x, y)
    assert abs(evaluate.frechet_distance(a, a)) < 1e-6 and evaluate.frechet_distance(a, b) > 4.0



def test_reconstruction_and_windows_match_jax():
    gen, gt = _frames(7, 24, seed=1), _frames(5, 24, seed=2)
    assert evaluate.reconstruction(gen, gt) == jax_evaluate.reconstruction(gen, gt)
    for clip_len in (2, 3, 8):
        got, want = evaluate._windows(gen, clip_len), jax_evaluate._windows(gen, clip_len)
        assert len(got) == len(want) == len(gen) // clip_len
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_i3d_resize_is_opencv_inter_linear():
    # the JAX tool resizes with cv2.resize(INTER_LINEAR); the port with its
    # byte-identical copy: no uint8 step apart, up and down
    cv2 = pytest.importorskip("cv2")
    for hw in (48, 300):
        frame = _frames(1, hw, seed=hw)[0]
        np.testing.assert_array_equal(resize_bilinear(frame, (224, 224)),
                                      cv2.resize(frame, (224, 224), interpolation=cv2.INTER_LINEAR))


def test_i3d_features_and_fvd_match_jax(tmp_path):
    from stableanimator_tpu.preproc.onnx_to_jax import load_onnx_function as jax_load

    torch.manual_seed(0)
    # tests/test_misc.py::TestFVD's stand-in
    path = export_onnx(I3DStandin(stride=(2, 4, 4), pool=(2, 8, 8)).eval(),
                       (torch.zeros(1, 3, 4, 32, 32),),
                       str(tmp_path / "i3d.onnx"))
    gen, real = _frames(8, 32, seed=3), _frames(8, 32, seed=4)
    clips = evaluate._windows(gen, 4)
    got = evaluate._i3d_features(clips, load_onnx_function(path, device="cpu"), size=32)
    want = jax_evaluate._i3d_features(clips, jax_load(path).jitted(), size=32)
    assert got.shape == want.shape == (2, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=I3D_REL * np.abs(want).max())
    out = evaluate.fvd(gen, real, path, clip_len=4, device="cpu")
    assert np.isfinite(out["fvd"]) and out["fvd_gen_clips"] == out["fvd_real_clips"] == 2
    assert abs(evaluate.fvd(gen, gen, path, clip_len=4, device="cpu")["fvd"]) < 1e-4
    with pytest.raises(ValueError, match="need at least 16 frames"):
        evaluate.fvd(gen, real, path, device="cpu")


def test_csim_and_main_match_jax(tmp_path):
    small = seeded_iresnet(0, layers=(1, 1, 1, 1), widths=(8, 8, 16, 16), num_features=64)
    pack = write_antelopev2(str(tmp_path / "antelopev2"), recogniser=small)
    frames = _frames(2, 96, seed=5)
    reference = _frames(1, 96, seed=6)[0]
    got = evaluate.csim(frames, reference, pack, device="cpu")
    want = jax_evaluate.csim(frames, reference, pack)
    assert got["frames_with_face"] == want["frames_with_face"] == 2
    assert got["frames_without_face"] == want["frames_without_face"] == 0
    for key in ("csim_mean", "csim_min"):
        assert abs(got[key] - want[key]) <= CSIM_ATOL, (key, got[key], want[key])

    # the CLI on the same files: frames, reference, ground truth
    for name, seq in (("gen", frames), ("gt", frames[::-1])):
        os.makedirs(tmp_path / name)
        for i, f in enumerate(seq):
            Image.fromarray(f).save(tmp_path / name / f"frame_{i}.png")
    Image.fromarray(reference).save(tmp_path / "ref.png")
    result = evaluate.main(["--frames_dir", str(tmp_path / "gen"), "--reference",
                            str(tmp_path / "ref.png"), "--antelopev2", pack, "--gt_dir",
                            str(tmp_path / "gt"), "--device", "cpu"])
    assert result["num_frames"] == 2 and result["frames_with_face"] == 2
    assert abs(result["csim_mean"] - want["csim_mean"]) <= CSIM_ATOL
    assert result == {**result, **jax_evaluate.reconstruction(frames, frames[::-1])}


def test_fvd_refuses_one_clip_a_side(tmp_path):
    # the JAX tool takes one clip a side; the covariance of its one
    # observation is then numpy's to decide (the row's variance as one
    # variable before numpy 2.2, NaN since, on which scipy's sqrtm raises)
    torch.manual_seed(0)
    path = export_onnx(I3DStandin(stride=(2, 4, 4), pool=(2, 8, 8)).eval(),
                       (torch.zeros(1, 3, 4, 32, 32),), str(tmp_path / "i3d.onnx"))
    gen, real = _frames(4, 32, seed=3), _frames(7, 32, seed=4)
    with pytest.raises(ValueError, match=r"FVD needs at least 2 clips of 4 frames per side "
                                         r"\(got 1 gen / 1 real\)"):
        evaluate.fvd(gen, real, path, clip_len=4, device="cpu")
    assert evaluate.fvd(gen + gen, real + real, path, clip_len=4, device="cpu")["fvd_gen_clips"] == 2
