"""The port's inference CLI (`stableanimator_tpu_torch.cli.animate`) on the
CPU, at the micro scale and 64x64 with seeded random weights: the files it
writes, its frames against a direct `generate` with the same seed, the
driving-video path (DWPose stand-ins in the worker subprocess), the face
model and face optimisation with stand-in antelopev2 files, and the port's
`utils` against the JAX package's (byte for byte).
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from stableanimator_tpu.utils import image as jax_image
from stableanimator_tpu.utils import mp4 as jax_mp4
from stableanimator_tpu_torch.cli import animate
from stableanimator_tpu_torch.core.config import PipelineConfig, micro_model_kwargs
from stableanimator_tpu_torch.pipeline.animation import build_models, generate
from stableanimator_tpu_torch.utils import image, mp4
from tests.torch_threads import share_cores

THREADS = share_cores()

N_FRAMES = 6


@pytest.fixture()
def inputs(tmp_path):
    rng = np.random.default_rng(0)
    # the reference at another size than the frames: CLIP sees the original
    Image.fromarray(rng.integers(0, 255, (80, 72, 3), dtype=np.uint8)).save(tmp_path / "ref.png")
    poses = tmp_path / "poses"
    poses.mkdir()
    for i in range(N_FRAMES):
        img = np.zeros((64, 64, 3), np.uint8)
        img[10 + 3 * i:30 + 3 * i, 20:40] = 255
        Image.fromarray(img).save(poses / f"frame_{i}.png")
    return tmp_path


@pytest.fixture()
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's thread pools then wait for each other on these small
    shapes."""
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(THREADS)


def _argv(root, *extra):
    return ["--checkpoint_dir", str(root / "ckpt"), "--reference_image", str(root / "ref.png"),
            "--pose_control_folder", str(root / "poses"), "--output_dir", str(root / "out"),
            "--height", "64", "--width", "64", "--tile_size", "4", "--frames_overlap", "1",
            "--num_inference_steps", "2", "--decode_chunk_size", "2", "--seed", "5",
            "--device", "cpu", "--model_scale", "micro", "--allow_random_init", *extra]


def test_cli_writes_the_outputs_of_a_direct_generate(inputs, capsys):
    info = animate.main(_argv(inputs))
    out = capsys.readouterr().out
    assert info["num_frames"] == N_FRAMES and info["warm"]["path"] == "flat"
    assert "zero identity embedding" in out and f"generated {N_FRAMES} frames" in out
    pngs = sorted(os.listdir(inputs / "out" / "animated_images"))
    assert pngs == sorted(f"frame_{i}.png" for i in range(N_FRAMES))
    with Image.open(inputs / "out" / "animation_video.gif") as gif:
        assert gif.n_frames == N_FRAMES
    assert (inputs / "out" / "animation_video.mp4").stat().st_size > 0

    models = build_models(**micro_model_kwargs(), dtype=torch.float32, device="cpu")
    ref = Image.open(inputs / "ref.png").convert("RGB")
    poses = image.load_images_from_folder(str(inputs / "poses"), 64, 64)
    cfg = PipelineConfig(height=64, width=64, num_frames=N_FRAMES, tile_size=4, tile_overlap=1,
                         num_inference_steps=2, decode_chunk_size=2, output_uint8=True)
    want = generate(models, torch.tensor(image.pil_to_u8_array(ref.resize((64, 64)))),
                    torch.from_numpy(image.poses_to_u8_array(poses)),
                    torch.zeros((1, models.face_encoder.config.id_embeddings_dim)), cfg,
                    clip_image=torch.tensor(image.pil_to_u8_array(ref)),
                    generator=torch.Generator().manual_seed(5), device="cpu").numpy()
    got = np.stack([np.asarray(Image.open(inputs / "out" / "animated_images" / f"frame_{i}.png"))
                    for i in range(N_FRAMES)])
    assert want.std() > 1.0
    np.testing.assert_array_equal(got, want)


# face optimisation (ROADMAP item 9), the antelopev2 face model (11b) and
# --driving_video_folder (11c) are ported: each case now runs
@pytest.mark.parametrize("case,match", [("driving", None),
                                        pytest.param("face_opt", None, id="face_opt-item 9"),
                                        pytest.param("onnx", None, id="onnx-item 11")],
                         ids=["driving-item 11", None, None])
def test_cli_options_not_ported_raise(inputs, case, match, capsys, monkeypatch,
                                      one_torch_thread):
    extra = []
    if case == "driving":
        # the JAX package's test_animate_cli_driving_video_inline_dwpose: 4 raw
        # frames, DWPose stand-ins extracted in the worker subprocess on the CPU
        from tests.test_torch_dwpose import write_cli_standins

        write_cli_standins(inputs / "ckpt" / "DWPose")
        rng = np.random.default_rng(1)
        (inputs / "driving").mkdir()
        for i in range(4):
            Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(
                inputs / "driving" / f"frame_{i}.png")
        argv = [str(inputs / "driving") if a == str(inputs / "poses") else
                "--driving_video_folder" if a == "--pose_control_folder" else a
                for a in _argv(inputs)]
        info = animate.main(argv)
        out = capsys.readouterr().out
        assert info["num_frames"] == 4 and info["pose"]["aligned"]
        assert "DWPose extraction (worker subprocess): 4 frames, aligned True" in out
        assert "WARNING: no 18-joint bodies" not in out
        pngs = sorted(os.listdir(inputs / "out" / "animated_images"))
        assert pngs == [f"frame_{i}.png" for i in range(4)]
        assert (inputs / "out" / "animation_video.mp4").stat().st_size > 0
        frames = np.stack([np.asarray(Image.open(inputs / "out" / "animated_images" / n))
                           for n in pngs])
        assert frames.shape == (4, 64, 64, 3) and frames.std() > 0
        return
    argv = _argv(inputs)
    if case == "face_opt":
        # without glintr100.onnx: warned and disabled, as in the JAX CLI
        extra = ["--face_optimize_steps", "2"]
    if case == "onnx":
        from stableanimator_tpu_torch.preproc.standins import seeded_iresnet, write_antelopev2

        write_antelopev2(str(inputs / "ckpt" / "antelopev2"),
                         recogniser=seeded_iresnet(0, layers=(1, 1, 1, 1),
                                                   widths=(8, 8, 16, 16), num_features=32))
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            animate.main(argv + extra)
        assert not (inputs / "out").exists()
        return
    import stableanimator_tpu_torch.pipeline.animation as animation

    embeddings = []

    def spy(*args, **kw):                        # the identity embedding the CLI passes
        embeddings.append(args[3].numpy())
        return generate(*args, **kw)

    monkeypatch.setattr(animation, "generate", spy)
    info = animate.main(argv + extra)
    out = capsys.readouterr().out
    assert info["num_frames"] == N_FRAMES and not info["face_opt"]
    assert len(os.listdir(inputs / "out" / "animated_images")) == N_FRAMES
    if case == "face_opt":
        assert "face optimization disabled" in out and "glintr100.onnx" in out
        assert "zero identity embedding" in out and not np.any(embeddings[0])
    else:
        assert "zero identity embedding" not in out
        assert embeddings[0].shape == (1, 32) and np.abs(embeddings[0]).max() > 0


def test_cli_face_optimization_with_standin_antelopev2(inputs, capsys, one_torch_thread):
    """--face_optimize_steps with the stand-in antelopev2 files: the face
    model embeds the reference and every Euler step from
    --face_opt_start_step runs the HJB refinement."""
    from stableanimator_tpu_torch.preproc.standins import seeded_iresnet, write_antelopev2

    write_antelopev2(str(inputs / "ckpt" / "antelopev2"),
                     recogniser=seeded_iresnet(0, layers=(1, 1, 1, 1), widths=(8, 8, 16, 16),
                                               num_features=32))
    info = animate.main(_argv(inputs, "--face_optimize_steps", "1", "--face_opt_start_step",
                              "1"))
    out = capsys.readouterr().out
    assert info["face_opt"] and "HJB face optimization: 1 steps/denoise-step" in out
    assert "zero identity embedding" not in out and "disabled" not in out
    frames = np.stack([np.asarray(Image.open(inputs / "out" / "animated_images" /
                                             f"frame_{i}.png")) for i in range(N_FRAMES)])
    assert frames.shape == (N_FRAMES, 64, 64, 3) and frames.std() > 1.0


def test_utils_write_what_the_jax_package_writes(tmp_path, inputs):
    rng = np.random.default_rng(1)
    frames = rng.uniform(size=(5, 32, 48, 3)).astype(np.float32)
    u8, ju8 = image.frames_to_uint8(frames), jax_image.frames_to_uint8(frames)
    np.testing.assert_array_equal(np.stack(u8), np.stack(ju8))
    for name, ours, theirs in (
            ("a.gif", lambda p: image.export_to_gif(u8, p), lambda p: jax_image.export_to_gif(u8, p)),
            ("a.mp4", lambda p: image.export_to_mp4(u8, p), lambda p: jax_image.export_to_mp4(u8, p)),
            ("m.mp4", lambda p: mp4.write_mp4_mjpeg(u8, p, fps=8),
             lambda p: jax_mp4.write_mp4_mjpeg(u8, p, fps=8))):
        (tmp_path / "port").mkdir(exist_ok=True)
        (tmp_path / "jax").mkdir(exist_ok=True)
        ours(str(tmp_path / "port" / name))
        theirs(str(tmp_path / "jax" / name))
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    image.save_frames_as_png(u8, str(tmp_path / "port" / "png"))
    jax_image.save_frames_as_png(u8, str(tmp_path / "jax" / "png"))
    for i in range(5):
        assert (tmp_path / "port" / "png" / f"frame_{i}.png").read_bytes() == \
            (tmp_path / "jax" / "png" / f"frame_{i}.png").read_bytes()
    folder = str(inputs / "poses")
    ours = image.load_images_from_folder(folder, 48, 32)
    theirs = jax_image.load_images_from_folder(folder, 48, 32)
    np.testing.assert_array_equal(image.poses_to_u8_array(ours), jax_image.poses_to_u8_array(theirs))
    np.testing.assert_array_equal(image.poses_to_array(ours), jax_image.poses_to_array(theirs))
