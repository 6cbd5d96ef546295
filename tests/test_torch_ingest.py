"""The port's release-day tools against the root ones, on the CPU:

  (a) `convert/safetensors_io.py::read_safetensors` against
      `safetensors.safe_open(framework="np")` (F32, F16, I64, BOOL, a 0-size
      tensor, `__metadata__`; BF16 refused by both), and its refusal of a
      truncated file and of overlapping offsets;
  (b) `tools/dump_torch_checkpoint.py::load_state_dict` against the root
      tool's (`.pth` in fp32 / fp16 / bf16 and wrapped in `state_dict`,
      `.safetensors` in F32 / F16): equal keys, dtypes and values;
  (c) `tools/ingest_checkpoints.py` against the root tool on a micro release
      tree (the JAX package's `fast_init_params` carried into the reference
      key space): the same files, report keys and `.npz` contents; the
      directory then loads strictly into the port, and a micro generate on
      it equals one on the in-memory weights cast as the files store them;
  (d) both tools refuse a key no model has, naming it, and report a missing
      file as "missing"; the port's check refuses a missing parameter and a
      wrong shape too, and a UNet that holds only half of the ID adapter;
  (e) the port's validation renders skeletons through a correct
      `extract_skeleton` call (and fails if it cannot), where the root
      tool's call exits 2 and the photo stands in for the poses;
  (f) a vanilla SVD UNet (the micro tree's `unet.pth` without its ID adapter):
      both tools write the same `unet.npz`, the port's report names it
      vanilla, and the port's load with `init_id_adapter` equals the JAX
      CLI's `load_params` with it at 0 error; the port's validation renders
      it with --init_id_adapter, where the root tool's render lacks the flag
      and the JAX UNet cannot run the parameters that load gives.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from stableanimator_tpu import convert as jax_convert
from stableanimator_tpu.cli.animate import load_params as jax_load_params
from stableanimator_tpu.core.config import micro_model_kwargs as jax_micro_kwargs
from stableanimator_tpu.pipeline import build_models as jax_build_models
from stableanimator_tpu.pipeline import fast_init_params
from stableanimator_tpu_torch.convert.checkpoints import (
    check_state_dict,
    id_adapter_sources,
    init_id_adapter_from_svd,
    is_vanilla_unet,
    load_state_dicts,
    npz_shapes,
)
from stableanimator_tpu_torch.convert.from_jax import state_dicts_from_jax
from stableanimator_tpu_torch.convert.safetensors_io import (
    read_header,
    read_safetensors,
    write_safetensors,
)
from stableanimator_tpu_torch.core.config import PipelineConfig, micro_model_kwargs
from stableanimator_tpu_torch.pipeline import animation
from stableanimator_tpu_torch.tools import dump_torch_checkpoint, ingest_checkpoints
from tools import dump_torch_checkpoint as root_dump
from tools import ingest_checkpoints as root_ingest
from tests.test_torch_dwpose import write_cli_standins
from tests.torch_threads import share_cores

THREADS = share_cores()

SVD = ingest_checkpoints.SVD_ROOT
# how the micro release tree stores each model, as the release does (the
# Animation files as .pth, the SVD folders as safetensors with an fp16 and
# an fp32 variant) with a cast each: (path, dtype)
RELEASE = {"unet": ("Animation/unet.pth", torch.bfloat16),
           "pose_net": ("Animation/pose_net.pth", torch.float32),
           "face_encoder": ("Animation/face_encoder.pth", torch.float16),
           "vae": (f"{SVD}/vae/diffusion_pytorch_model.fp16.safetensors", torch.float16),
           "clip": (f"{SVD}/image_encoder/model.fp16.safetensors", torch.float16)}
# the keys of CLIPModel's text tower, which the image encoder's file may carry
TEXT_TOWER = {"text_model.embeddings.token_embedding.weight": (12, 8),
              "text_projection.weight": (8, 8), "logit_scale": ()}


def _tensors():
    rng = np.random.default_rng(0)
    return {"f32": rng.normal(size=(3, 5)).astype(np.float32),
            "f16": rng.normal(size=(7,)).astype(np.float16),
            "i64": rng.integers(-9, 9, (2, 2, 3)),
            "bool": rng.random(5) > 0.5,
            "empty": np.zeros((0, 4), np.float32),
            "scalar": np.array(2.5, np.float32)}


# ---------------------------------------------------------------------------
# (a) the safetensors reader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "safetensors"])
def test_reader_matches_safe_open(tmp_path, writer):
    from safetensors import safe_open
    from safetensors.numpy import save_file

    want, path = _tensors(), str(tmp_path / "t.safetensors")
    meta = {"format": "np", "note": "fixture"}
    if writer == "port":
        write_safetensors(path, want, meta)
    else:
        save_file(want, path, metadata=meta)
    got = read_safetensors(path)
    with safe_open(path, framework="np") as f:
        theirs = {k: f.get_tensor(k) for k in f.keys()}
        assert f.metadata() == meta == read_header(path)[1]
    assert set(got) == set(theirs) == set(want)
    for k in want:
        assert got[k].dtype == theirs[k].dtype == np.asarray(want[k]).dtype, k
        assert got[k].shape == theirs[k].shape == np.shape(want[k]), k
        np.testing.assert_array_equal(got[k], theirs[k])


def test_reader_refuses_bf16_as_safe_open_does(tmp_path):
    from safetensors.torch import save_file

    path = str(tmp_path / "bf16.safetensors")
    save_file({"w": torch.ones(3, dtype=torch.bfloat16), "b": torch.ones(2)}, path)
    # in a process of its own: this one has imported JAX, whose ml_dtypes
    # gives numpy a bfloat16 that safe_open would then use
    code = ("import sys; from safetensors import safe_open\n"
            "with safe_open(sys.argv[1], framework='np') as f:\n"
            "    f.get_tensor('b'); f.get_tensor('w')")
    proc = subprocess.run([sys.executable, "-c", code, path], capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode != 0 and "TypeError: data type 'bfloat16' not understood" in proc.stderr
    with pytest.raises(TypeError, match="'w' is BF16"):
        read_safetensors(path)
    with pytest.raises(TypeError, match="no safetensors dtype"):
        write_safetensors(str(tmp_path / "x.safetensors"), {"w": np.ones(2, dtype=object)})


def _raw(path, header: dict, data: bytes):
    raw = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw + data)


def test_reader_refuses_a_truncated_file_and_overlapping_offsets(tmp_path):
    path = str(tmp_path / "t.safetensors")
    size = write_safetensors(path, _tensors())
    with open(path, "r+b") as f:
        f.truncate(size - 4)
    # the widest types first, so the 5-byte bool tensor is last
    with pytest.raises(ValueError, match="'bool' ends at byte"):
        read_safetensors(path)
    f32 = np.arange(4, dtype=np.float32).tobytes()
    _raw(path, {"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
                "b": {"dtype": "F32", "shape": [2], "data_offsets": [4, 12]}}, f32[:12])
    with pytest.raises(ValueError, match=r"'b' begins at byte 4 .* \(an overlap\)"):
        read_safetensors(path)
    _raw(path, {"a": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}}, f32[:8])
    with pytest.raises(ValueError, match="'a' spans 8 bytes"):
        read_safetensors(path)
    _raw(path, {"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}}, f32)
    with pytest.raises(ValueError, match="end at byte 8 of data that holds 16"):
        read_safetensors(path)


# ---------------------------------------------------------------------------
# (b) the dump against the root tool's
# ---------------------------------------------------------------------------

def _write_case(tmp_path, case: str) -> str:
    gen = torch.Generator().manual_seed(1)
    sd = {"w": torch.randn((4, 3), generator=gen), "n": torch.arange(3),
          "norm.weight": torch.randn((5,), generator=gen)}
    kind, dtype = case.split("_")
    cast = {"fp32": torch.float32, "fp16": torch.float16, "bf16": torch.bfloat16,
            "wrapped": torch.float16}[dtype]
    sd = {k: v.to(cast) if v.is_floating_point() else v for k, v in sd.items()}
    if kind == "safetensors":
        path = str(tmp_path / "ckpt.safetensors")
        write_safetensors(path, {k: v.numpy() for k, v in sd.items()})
    else:
        path = str(tmp_path / "ckpt.pth")
        torch.save({"state_dict": sd, "epoch": 3} if dtype == "wrapped" else sd, path)
    return path


@pytest.mark.parametrize("case", ["pth_fp32", "pth_fp16", "pth_bf16", "pth_wrapped",
                                  "safetensors_fp32", "safetensors_fp16"])
def test_dump_matches_the_root_tool(tmp_path, monkeypatch, case):
    path = _write_case(tmp_path, case)
    got, want = dump_torch_checkpoint.load_state_dict(path), root_dump.load_state_dict(path)
    assert sorted(got) == sorted(want) == ["n", "norm.weight", "w"]
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        np.testing.assert_array_equal(got[k], want[k])
    # the CLIs write the same .npz
    assert dump_torch_checkpoint.main(["--input", path, "--output", str(tmp_path / "port.npz")]) == 3
    monkeypatch.setattr(sys, "argv", ["dump_torch_checkpoint.py", "--input", path,
                                      "--output", str(tmp_path / "root.npz")])
    root_dump.main()
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "root.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# (c), (d) ingestion against the root tool
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def release(tmp_path_factory):
    """(a micro release tree, the state dicts as written: numpy arrays of
    the dtype each file stores)."""
    jm = jax_build_models(**jax_micro_kwargs(), dtype=None, use_flash=False)
    sds = state_dicts_from_jax(fast_init_params(jm, height=64, width=64))
    root = tmp_path_factory.mktemp("release")
    written = {}
    for name, (rel, dtype) in RELEASE.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        sd = {k: v.to(dtype) for k, v in sds[name].items()}
        if rel.endswith(".pth"):
            torch.save({"state_dict": sd} if name == "pose_net" else sd, path)
        else:
            stored = {k: v.numpy() for k, v in sd.items()}
            if name == "clip":
                rng = np.random.default_rng(2)
                stored.update({k: rng.normal(size=s).astype(np.float16)
                               for k, s in TEXT_TOWER.items()})
            write_safetensors(str(path), stored, {"format": "pt"})
            # the fp32 variant beside it, which sorts after the fp16 one
            full = str(path).replace(".fp16.safetensors", ".safetensors")
            write_safetensors(full, {k: v.float().numpy() for k, v in sds[name].items()})
        written[name] = sd
    for sub, files in (("antelopev2", ("glintr100.onnx", "scrfd_10g_bnkps.onnx")),
                       ("DWPose", ("dw-ll_ucoco_384.onnx", "yolox_l.onnx"))):
        (root / sub).mkdir()
        for i, f in enumerate(files):
            (root / sub / f).write_bytes(bytes([i]) * 64)
    return root, written


def _root_report(capsys) -> dict:
    out = capsys.readouterr().out
    return json.loads(out[out.rindex("\n{") + 1:])


def _files(root) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_ingest_matches_the_root_tool_and_loads_strictly(release, tmp_path, monkeypatch,
                                                         capsys):
    src, written = release
    port_out, root_out = tmp_path / "port", tmp_path / "root"
    timings = {}
    report = ingest_checkpoints.main(["--source", str(src), "--output", str(port_out),
                                      "--model_scale", "micro"], timings=timings)
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["ingest_checkpoints.py", "--source", str(src),
                                      "--output", str(root_out)])
    root_ingest.main()
    root_report = _root_report(capsys)
    assert sorted(report) == sorted(root_report) == sorted(f for _, f, _ in ingest_checkpoints.PLAN)
    for npz, status in report.items():
        assert status.startswith("ok:") and root_report[npz].startswith("ok:"), (npz, status)
    assert report["image_encoder.npz"] == f"ok:{len(written['clip'])}"   # the text tower left out
    assert set(timings) == {"dump", "check", "copy", "validate"} and timings["validate"] == 0
    assert _files(port_out) == _files(root_out)
    for npz in report:
        with np.load(port_out / npz) as a, np.load(root_out / npz) as b:
            assert sorted(a.files) == sorted(b.files), npz
            for k in b.files:
                assert a[k].dtype == b[k].dtype, (npz, k)
                np.testing.assert_array_equal(a[k], b[k])
    for sub in ("antelopev2", "DWPose"):
        for f in os.listdir(src / sub):
            assert (port_out / sub / f).read_bytes() == (src / sub / f).read_bytes()

    # the directory loads strictly, each parameter the written tensor cast to
    # the model's fp32, and a micro generate on it equals one on the weights
    # loaded from memory
    kwargs = dict(**micro_model_kwargs(), dtype=torch.float32, device="cpu", seed=None)
    loaded, direct = animation.build_models(**kwargs), animation.build_models(**kwargs)
    assert load_state_dicts(str(port_out), loaded, allow_random_init=False,
                            init_id_adapter=False) == list(animation.AnimationModels._fields)
    for name, sd in written.items():
        getattr(direct, name).load_state_dict(sd, strict=True)
        got = getattr(loaded, name).state_dict()
        for k, v in getattr(direct, name).state_dict().items():
            assert torch.equal(got[k], v), (name, k)
    rng = np.random.default_rng(3)
    ref = torch.from_numpy(rng.uniform(size=(1, 64, 64, 3)).astype(np.float32))
    pose = torch.from_numpy(rng.uniform(-1, 1, size=(4, 64, 64, 3)).astype(np.float32))
    face = torch.from_numpy(rng.normal(size=(1, 32)).astype(np.float32))
    cfg = PipelineConfig(height=64, width=64, num_frames=4, tile_size=4, tile_overlap=1,
                         num_inference_steps=2, decode_chunk_size=2)
    frames = [animation.generate(m, ref, pose, face, cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
              for m in (loaded, direct)]
    assert frames[0].shape == (4, 64, 64, 3) and torch.isfinite(frames[0]).all()
    assert torch.equal(frames[0], frames[1])


def test_both_tools_refuse_an_unknown_key_and_report_missing_files(release, tmp_path,
                                                                  monkeypatch, capsys):
    src, written = release
    extra = tmp_path / "extra"
    (extra / "Animation").mkdir(parents=True)
    sd = dict(written["unet"], **{"extra_head.weight": torch.zeros(2, 2)})
    torch.save(sd, extra / "Animation" / "unet.pth")
    with pytest.raises(ValueError, match=r"unmapped torch keys \(1\): \['extra_head.weight'\]"):
        ingest_checkpoints.main(["--source", str(extra), "--output", str(tmp_path / "p1"),
                                 "--model_scale", "micro"])
    monkeypatch.setattr(sys, "argv", ["ingest_checkpoints.py", "--source", str(extra),
                                      "--output", str(tmp_path / "r1")])
    with pytest.raises(ValueError, match="unmapped torch keys .*extra_head.weight"):
        root_ingest.main()

    one = tmp_path / "one"
    (one / "Animation").mkdir(parents=True)
    torch.save(written["pose_net"], one / "Animation" / "pose_net.pth")
    capsys.readouterr()
    report = ingest_checkpoints.main(["--source", str(one), "--output", str(tmp_path / "p2"),
                                      "--model_scale", "micro"])
    monkeypatch.setattr(sys, "argv", ["ingest_checkpoints.py", "--source", str(one),
                                      "--output", str(tmp_path / "r2")])
    capsys.readouterr()
    root_ingest.main()
    root_report = _root_report(capsys)
    assert report == {**root_report, "pose_net.npz": report["pose_net.npz"]}
    assert [k for k, v in report.items() if v == "missing"] == [
        "unet.npz", "vae.npz", "image_encoder.npz", "face_encoder.npz"]
    assert report["pose_net.npz"] == f"ok:{len(written['pose_net'])}"
    assert root_report["pose_net.npz"].startswith("ok:")


@pytest.mark.parametrize("fault", ["unknown", "missing", "shape", "text_tower", "vanilla_unet",
                                   "half_adapter"])
def test_check_state_dict_takes_what_the_strict_load_takes(fault):
    models = animation.meta_models(**micro_model_kwargs())
    name = {"text_tower": "clip", "vanilla_unet": "unet", "half_adapter": "unet"}.get(
        fault, "face_encoder")
    module = getattr(models, name)
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    key = sorted(shapes)[0]
    adapter = sorted(k for k in shapes if ".processor.id_to_" in k)
    if fault == "unknown":
        shapes["head.extra.weight"] = (3,)
    elif fault == "missing":
        del shapes[key]
    elif fault == "shape":
        shapes[key] = shapes[key] + (1,)
    elif fault == "text_tower":
        shapes.update(TEXT_TOWER)
    else:
        # the micro UNet's 10 spatial blocks carry 20 adapter keys; a vanilla
        # file has none of them, the faulty one half
        assert len(adapter) == 20 and sorted(id_adapter_sources(shapes)) == adapter
        gone = adapter if fault == "vanilla_unet" else adapter[::2]
        for k in gone:
            del shapes[k]
        assert is_vanilla_unet(shapes) == (fault == "vanilla_unet")
    match = {"unknown": r"unmapped torch keys \(1\): \['head.extra.weight'\]",
             "missing": rf"parameters the file lacks \(1\): \['{key}'\]",
             "shape": rf"shapes that differ .*'{key}'",
             "half_adapter": r"parameters the file lacks \(10\): \[.*processor\.id_to_k"}.get(fault)
    if fault == "vanilla_unet":
        # checked with the keys init_id_adapter_from_svd adds; the count is
        # the file's
        assert check_state_dict(name, shapes, module) == (len(module.state_dict()) - 20, True)
    elif match is None:
        assert check_state_dict(name, shapes, module) == (len(module.state_dict()), False)
    else:
        with pytest.raises(ValueError, match=match):
            check_state_dict(name, shapes, module)
    if fault == "half_adapter":
        # the load's initialisation refuses it too: one definition of vanilla
        with pytest.raises(ValueError, match=r"holds 10 of the 20 ID adapter keys"):
            init_id_adapter_from_svd(shapes)
        with pytest.raises(ValueError, match=r"holds 10 of the 20 ID adapter keys"):
            init_id_adapter_from_svd({k: torch.zeros(v) for k, v in shapes.items()})


def test_npz_shapes_reads_the_headers(tmp_path):
    arrays = {"a.weight": np.zeros((3, 4), np.float32), "b": np.zeros((0,), np.float16),
              "c": np.float64(1.0), "d": np.zeros((2, 2, 2), np.int64)}
    np.savez(tmp_path / "x.npz", **arrays)
    assert npz_shapes(str(tmp_path / "x.npz")) == {k: np.shape(v) for k, v in arrays.items()}


# ---------------------------------------------------------------------------
# (e) the validation's skeleton call
# ---------------------------------------------------------------------------

class _Rendered(Exception):
    """Raised in place of the validation's render: what came before it is
    the test."""


def _intercept(monkeypatch, calls: list):
    """subprocess.run that runs the skeleton CLIs and, in place of
    cli.animate, records its pose folder and raises _Rendered."""
    real_run = subprocess.run

    def run(cmd, check=False, **kwargs):
        if cmd[2].endswith("cli.extract_skeleton"):
            proc = real_run(cmd, capture_output=True, text=True, **kwargs)
            calls.append((cmd, proc.returncode))
            if check:
                proc.check_returncode()
            return proc
        poses = cmd[cmd.index("--pose_control_folder") + 1]
        calls.append((cmd, sorted(os.listdir(poses))))
        raise _Rendered

    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setenv("OMP_NUM_THREADS", str(THREADS))


def test_validation_renders_skeletons_where_the_root_tool_cannot(tmp_path, monkeypatch):
    ckpt = tmp_path / "ckpt"
    write_cli_standins(ckpt / "DWPose")
    image = tmp_path / "face.png"
    Image.fromarray(np.random.default_rng(5).integers(0, 255, (96, 80, 3), dtype=np.uint8)
                    ).save(image)
    calls = []
    _intercept(monkeypatch, calls)
    with pytest.raises(_Rendered):
        ingest_checkpoints.validate(str(ckpt), str(image), "cpu", "micro")
    (skeleton, rc), (render, poses) = calls
    assert rc == 0, "the port's extract_skeleton call failed"
    assert "--target_image_folder_path" in skeleton and "--dwpose_dir" in skeleton
    assert skeleton[skeleton.index("--dwpose_dir") + 1] == str(ckpt / "DWPose")
    assert poses == ["frame_0.png", "frame_1.png"]
    assert render[render.index("--device") + 1] == "cpu"

    # the root tool's call takes a flag the CLI does not have, exits 2, and
    # the photo goes to the render as both "poses"
    calls.clear()
    with pytest.raises(_Rendered):
        root_ingest.validate(str(ckpt), str(image))
    (skeleton, rc), (_, poses) = calls
    assert "--ref_video_path" in skeleton and rc == 2
    assert poses == ["frame_0.png", "frame_1.png"]

    # without the DWPose files the port's validation fails, loudly
    calls.clear()
    with pytest.raises(subprocess.CalledProcessError):
        ingest_checkpoints.validate(str(tmp_path / "nockpt"), str(image), "cpu", "micro")
    assert len(calls) == 1 and calls[0][1] != 0


# ---------------------------------------------------------------------------
# (f) a vanilla SVD UNet
# ---------------------------------------------------------------------------

def _tree_with_unet(src, root, unet_sd: dict):
    """`root`: the release tree `src` (linked) with `unet_sd` as its
    Animation/unet.pth."""
    (root / "Animation").mkdir(parents=True)
    for entry in os.listdir(src):
        if entry != "Animation":
            os.symlink(src / entry, root / entry)
    for f in os.listdir(src / "Animation"):
        if f != "unet.pth":
            os.symlink(src / "Animation" / f, root / "Animation" / f)
    torch.save(unet_sd, root / "Animation" / "unet.pth")
    return root


def _root_main(argv) -> dict:
    """The root tool's main on `argv`, its printed report."""
    out = io.StringIO()
    with mock.patch.object(sys, "argv", ["ingest_checkpoints.py", *argv]), \
            contextlib.redirect_stdout(out):
        root_ingest.main()
    text = out.getvalue()
    return json.loads(text[text.rindex("\n{") + 1:])


@pytest.fixture(scope="module")
def vanilla(release, tmp_path_factory):
    """(the micro tree with a vanilla unet.pth, the port's output directory
    and report, the root tool's, the vanilla state dict)."""
    src, written = release
    sd = {k: v for k, v in written["unet"].items() if ".processor.id_to_" not in k}
    tmp = tmp_path_factory.mktemp("vanilla")
    tree = _tree_with_unet(src, tmp / "tree", sd)
    port_out, root_out = tmp / "port", tmp / "root"
    with contextlib.redirect_stdout(io.StringIO()):
        report = ingest_checkpoints.main(["--source", str(tree), "--output", str(port_out),
                                          "--model_scale", "micro"])
    root_report = _root_main(["--source", str(tree), "--output", str(root_out)])
    return tree, port_out, report, root_out, root_report, sd


def test_ingest_takes_a_vanilla_svd_unet_as_the_root_tool_does(release, vanilla, tmp_path):
    _, written = release
    _, port_out, report, root_out, root_report, sd = vanilla
    assert len(written["unet"]) - len(sd) == 20
    assert sorted(report) == sorted(root_report)
    assert report["unet.npz"] == f"ok:{len(sd)} ({ingest_checkpoints.VANILLA_NOTE})"
    assert "--init_id_adapter" in ingest_checkpoints.VANILLA_NOTE
    for npz, status in report.items():
        assert status.startswith("ok:") and root_report[npz].startswith("ok:"), (npz, status)
    assert _files(port_out) == _files(root_out)
    for npz in report:
        with np.load(port_out / npz) as a, np.load(root_out / npz) as b:
            assert sorted(a.files) == sorted(b.files), npz
            for k in b.files:
                assert a[k].dtype == b[k].dtype, (npz, k)
                np.testing.assert_array_equal(a[k], b[k])

    # the port's load with init_id_adapter is the JAX CLI's, through the
    # JAX package's converters, at 0 error; without it the strict load refuses
    kwargs = dict(**micro_model_kwargs(), dtype=torch.float32, device="cpu", seed=None)
    models = animation.build_models(**kwargs)
    with pytest.raises(RuntimeError, match=r"Missing key\(s\).*processor\.id_to_k"):
        load_state_dicts(str(port_out), models, allow_random_init=False, init_id_adapter=False)
    assert load_state_dicts(str(port_out), models, allow_random_init=False,
                            init_id_adapter=True) == list(animation.AnimationModels._fields)
    jm = jax_build_models(**jax_micro_kwargs(), dtype=None, use_flash=False)
    want = jax_load_params(str(root_out), jm, allow_random_init=False, init_id_adapter=True,
                           height=64, width=64)
    converters = {"unet": jax_convert.convert_unet, "vae": jax_convert.convert_vae,
                  "clip": jax_convert.convert_clip_vision,
                  "pose_net": jax_convert.convert_pose_net,
                  "face_encoder": jax_convert.convert_face_encoder}
    for name, convert in converters.items():
        got = convert({k: v.numpy() for k, v in getattr(models, name).state_dict().items()})
        got_leaves, got_tree = jax.tree_util.tree_flatten(got["params"])
        want_leaves, want_tree = jax.tree_util.tree_flatten(want[name])
        assert got_tree == want_tree, name
        for a, b in zip(got_leaves, want_leaves):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # a UNet that keeps half of the adapter is refused, naming what it lacks
    half = dict(sd, **{k: v for k, v in sorted(written["unet"].items())
                       if ".processor.id_to_k" in k})
    tree = _tree_with_unet(release[0], tmp_path / "half", half)
    with pytest.raises(ValueError, match=r"unet: parameters the file lacks \(10\).*id_to_v"):
        ingest_checkpoints.main(["--source", str(tree), "--output", str(tmp_path / "p"),
                                 "--model_scale", "micro"])


def _fake_render(monkeypatch, calls: list):
    """subprocess.run that writes two pose PNGs for the skeleton CLIs and, in
    place of the render, records its command and raises _Rendered."""
    def run(cmd, check=False, **kwargs):
        if cmd[2].endswith("extract_skeleton"):
            poses = cmd[cmd.index("--poses_folder_path") + 1]
            os.makedirs(poses, exist_ok=True)
            for i in range(2):
                Image.new("RGB", (64, 64)).save(os.path.join(poses, f"frame_{i}.png"))
            return subprocess.CompletedProcess(cmd, 0)
        calls.append(cmd)
        raise _Rendered

    monkeypatch.setattr(subprocess, "run", run)


def test_validation_renders_a_vanilla_unet_where_the_root_tool_cannot(vanilla, tmp_path,
                                                                      monkeypatch):
    tree, _, _, root_out, _, _ = vanilla
    image = tmp_path / "face.png"
    Image.fromarray(np.random.default_rng(6).integers(0, 255, (64, 64, 3), dtype=np.uint8)
                    ).save(image)
    calls = []
    _fake_render(monkeypatch, calls)
    with pytest.raises(_Rendered), contextlib.redirect_stdout(io.StringIO()):
        ingest_checkpoints.main(["--source", str(tree), "--output", str(tmp_path / "port"),
                                 "--validate_image", str(image), "--device", "cpu",
                                 "--model_scale", "micro"])
    with pytest.raises(_Rendered):
        root_ingest.validate(str(root_out), str(image))
    (port_render,), root_render = calls[:1], calls[1]
    assert port_render[2].endswith("stableanimator_tpu_torch.cli.animate")
    assert "--init_id_adapter" in port_render
    assert root_render[2] == "stableanimator_tpu.cli.animate"
    assert "--init_id_adapter" not in root_render

    # what the root tool's render loads, the JAX UNet cannot run: the
    # adapter's parameters are missing; with --init_id_adapter it runs
    jm = jax_build_models(**jax_micro_kwargs(), dtype=None, use_flash=False)
    ucfg = jm.unet.config
    args = (jnp.zeros((1, 2, 8, 8, ucfg.in_channels)), jnp.float32(0.0),
            jnp.zeros((1, 1 + ucfg.num_id_tokens, ucfg.cross_attention_dim)),
            jnp.zeros((1, 3)), jnp.zeros((2, 8, 8, ucfg.block_out_channels[0])))

    def unet_out(init_id_adapter):
        params = jax_load_params(str(root_out), jm, allow_random_init=False,
                                 init_id_adapter=init_id_adapter, height=64, width=64)
        return jax.eval_shape(lambda p: jm.unet.apply({"params": p}, *args), params["unet"])

    assert unet_out(True).shape == (1, 2, 8, 8, ucfg.out_channels)
    with pytest.raises(Exception, match="id_to_k"):
        unet_out(False)
