"""Guards of the PyTorch port (`stableanimator_tpu_torch`):

  (a) the port and chip_smoke.py load no jax, flax, optax, orbax, cv2,
      safetensors or JAX-package module;
  (b) its entry points default to CUDA and raise without it, unless the
      caller asks for the CPU;
  (c) the JAX package's converters, applied to the port's state dicts,
      give back the JAX parameter trees exactly (the port's names are the
      reference/diffusers names);
  (d) the full-size port models map through the JAX package's key rules
      onto the full-size Flax parameter trees, key for key and shape for
      shape;
  (e) the training step takes a mesh that splits frames, and no
      NotImplementedError of the port points at a queue item.
"""

import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax

from stableanimator_tpu.convert import torch_to_jax as t2j
from stableanimator_tpu.core.config import micro_model_kwargs as jax_micro_kwargs
from stableanimator_tpu.pipeline import build_models as jax_build_models
from stableanimator_tpu.pipeline import fast_init_params, init_params
from stableanimator_tpu_torch.convert.from_jax import state_dicts_from_jax
from stableanimator_tpu_torch.core.config import PipelineConfig, micro_model_kwargs
from stableanimator_tpu_torch.pipeline import animation
from tests.torch_threads import share_cores

THREADS = share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("unet", "vae", "clip", "pose_net", "face_encoder")
CONVERTERS = {"unet": t2j.convert_unet, "vae": t2j.convert_vae, "clip": t2j.convert_clip_vision,
              "pose_net": t2j.convert_pose_net, "face_encoder": t2j.convert_face_encoder}
KEY_RULES = {"unet": t2j._unet_key, "vae": t2j._vae_key, "clip": t2j._clip_key,
             "pose_net": t2j._pose_net_key, "face_encoder": t2j._face_encoder_key}


def test_port_imports_no_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import stableanimator_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                            "stableanimator_tpu", "cv2", "safetensors"))
        print(len(names), bad)
        assert len(names) >= 20, names
        for mod in ("preproc.onnx_reader", "preproc.onnx_to_torch", "preproc.geometry",
                    "preproc.face", "preproc.standins", "pipeline.face_opt", "cli.serve",
                    "cli.extract_face_masks", "preproc.detection", "preproc.pose_estimation",
                    "preproc.wholebody", "preproc.native_raster", "preproc.skeleton_render",
                    "preproc.skeleton_extraction", "preproc.pose_worker",
                    "preproc.legacy_detectors", "cli.extract_skeleton",
                    "cli.extract_training_skeletons", "ops.gate", "ops.quant",
                    "parallel.mesh", "parallel.sequence", "core.trace",
                    "tools.export_model", "tools.evaluate", "convert.safetensors_io",
                    "tools.dump_torch_checkpoint", "tools.ingest_checkpoints",
                    "tools.eval_drill"):
            assert "stableanimator_tpu_torch." + mod in names, mod
        assert not bad, bad
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]


def test_chip_smoke_profile_categories_keep_the_kernels_apart():
    import chip_smoke

    names = {"void (anonymous namespace)::flash_fwd_sm90_kernel<__nv_bfloat16>(CUtensorMap_st, "
             "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, d64::Params)": "flash_attention_fwd",
             "void (anonymous namespace)::flash_fwd_d512_sm90_kernel<__half>(CUtensorMap_st, "
             "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, d512::Params)":
                 "flash_attention_fwd",
             "void (anonymous namespace)::flash_resident_sm90_kernel<__nv_bfloat16>(...)":
                 "flash_attention_resident",
             "void (anonymous namespace)::flash_bwd_dkv_sm90_kernel<__half>(...)":
                 "flash_attention_bwd_dkv",
             "void (anonymous namespace)::flash_bwd_dq_sm90_kernel<__nv_bfloat16>(...)":
                 "flash_attention_bwd_dq",
             "void bwd512::flash_bwd_dkv_d512_sm90_kernel<__nv_bfloat16>(CUtensorMap_st, "
             "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, bwd512::Params)":
                 "flash_attention_bwd_dkv_d512",
             "void bwd512::flash_bwd_dq_d512_sm90_kernel<__half>(CUtensorMap_st, "
             "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, bwd512::Params)":
                 "flash_attention_bwd_dq_d512",
             "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": "gemm",
             "void at::native::vectorized_elementwise_kernel<4, ...>": "elementwise"}
    assert {name: chip_smoke.category(name) for name in names} == names


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        animation.build_models(**micro_model_kwargs())
    models = animation.build_models(**micro_model_kwargs(), dtype=torch.float32, device="cpu")
    ref, pose, face = torch.rand(1, 64, 64, 3), torch.rand(4, 64, 64, 3), torch.randn(1, 32)
    cfg = PipelineConfig(num_frames=4, tile_size=4, tile_overlap=1, num_inference_steps=1,
                         decode_chunk_size=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        animation.generate(models, ref, pose, face, cfg)
    frames = animation.generate(models, ref, pose, face, cfg, device="cpu")
    assert frames.shape == (4, 64, 64, 3) and frames.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        animation.warm_generate(models, cfg)
    assert animation.warm_generate(models, cfg, device="cpu")["path"] == "flat"
    from stableanimator_tpu_torch.cli import animate, train

    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--checkpoint_dir", "none", "--output_dir", "none",
                    "--data_root_path", "none"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        animate.main(["--checkpoint_dir", "none", "--reference_image", "none",
                      "--pose_control_folder", "none", "--output_dir", "none"])
    from stableanimator_tpu_torch.cli import extract_face_masks, serve
    from stableanimator_tpu_torch.preproc import face, onnx_to_torch

    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--checkpoint_dir", "none", "--allow_random_init"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract_face_masks.main(["--image_folder", "none"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        onnx_to_torch.load_onnx_function("none.onnx")
    for cls in (face.FaceDetector, face.ArcFaceEncoder, face.FaceParser,
                face.RetinaFaceDetector, face.LandmarkModel, face.GenderAgeModel):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls("none.onnx")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        face.FaceModel("none.onnx", "none.onnx")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        face.FaceAnalyzer("none")
    from stableanimator_tpu_torch.cli import extract_skeleton, extract_training_skeletons
    from stableanimator_tpu_torch.preproc import (
        detection,
        legacy_detectors,
        pose_estimation,
        wholebody,
    )

    with pytest.raises(RuntimeError, match="device='cpu'"):
        animate.main(["--checkpoint_dir", "none", "--reference_image", "none",
                      "--driving_video_folder", "none", "--output_dir", "none"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract_skeleton.main(["--target_image_folder_path", "none", "--ref_image_path", "none",
                               "--poses_folder_path", "none"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract_training_skeletons.main(["--video_folder", "none"])
    for cls in (detection.PersonDetector, pose_estimation.PoseEstimator):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls("none.onnx")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wholebody.WholebodyDetector("none.onnx", "none.onnx")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        legacy_detectors.DWposeDetector("none.onnx", "none.onnx")
    from stableanimator_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        animation.build_models(**micro_model_kwargs(), quant=True)
    quantized = animation.build_models(**micro_model_kwargs(), device="cpu", quant=True)
    assert next(quantized.unet.parameters()).device.type == "cpu"
    from stableanimator_tpu_torch.tools import evaluate, export_model

    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_model.main(["--what", "vae_encode", "--output", "none.pt2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate.csim([], np.zeros((8, 8, 3), np.uint8), "none")
    frames = [np.zeros((8, 8, 3), np.uint8)] * 32      # two 16-frame clips a side
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate.fvd(frames, frames, "none.onnx")


def _paths(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


@pytest.fixture(scope="module")
def micro_params():
    jm = jax_build_models(**jax_micro_kwargs(), dtype=None, use_flash=False)
    return fast_init_params(jm, height=64, width=64)


@pytest.mark.parametrize("data,frame", [(1, 2), (2, 2)])
def test_make_train_step_takes_a_frame_mesh(data, frame):
    """(e): building the step for a (data, frame) mesh with frame > 1 raises
    nothing (tests/test_torch_train_frame.py runs it on gloo ranks)."""
    from types import SimpleNamespace

    from stableanimator_tpu_torch.core.config import TrainConfig
    from stableanimator_tpu_torch.train.train_step import make_train_step

    models = animation.build_models(**micro_model_kwargs(), dtype=torch.float32, device="cpu")
    mesh = SimpleNamespace(shape={"data": data, "frame": frame})
    assert callable(make_train_step(models, TrainConfig(), PipelineConfig(), mesh=mesh))
    for root, _, files in os.walk(os.path.join(REPO, "stableanimator_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as fh:
                    text = fh.read()
                assert not re.search(r"NotImplementedError\([^)]*ROADMAP", text), name


@pytest.mark.parametrize("model", MODELS)
def test_jax_converters_invert_the_port_state_dict(micro_params, model):
    port = animation.build_models(**micro_model_kwargs(), dtype=torch.float32, device="cpu",
                                  seed=None)
    module = getattr(port, model)
    module.load_state_dict(state_dicts_from_jax(micro_params)[model], strict=True)
    sd = {k: v.numpy() for k, v in module.state_dict().items()}
    back = _paths(CONVERTERS[model](sd)["params"])
    want = _paths(micro_params[model])
    assert set(back) == set(want), (sorted(set(want) - set(back))[:5],
                                    sorted(set(back) - set(want))[:5])
    for path, arr in want.items():
        np.testing.assert_array_equal(back[path], np.asarray(arr), err_msg=str(path))


_PERMS = {5: (2, 3, 4, 1, 0), 4: (2, 3, 1, 0), 2: (1, 0)}


def _flax_leaf(model, key, shape):
    """(Flax path, Flax shape) of a torch parameter under the JAX package's
    key and layout rules (convert/torch_to_jax.py)."""
    path = KEY_RULES[model](key)
    if path is None:
        return None, None
    if model == "clip" and key == "vision_model.embeddings.position_embedding.weight":
        return path, tuple(shape)
    leaf, _ = t2j._leaf(key, np.zeros((1,) * len(shape), np.float32))
    if leaf is None:
        return path, tuple(shape)
    if leaf == "kernel":
        shape = tuple(shape[i] for i in _PERMS[len(shape)])
    return path + (leaf,), tuple(shape)


def test_full_size_port_maps_onto_the_flax_trees():
    jm = jax_build_models(dtype=None, use_flash=False)
    flax = jax.eval_shape(lambda: init_params(jm, jax.random.PRNGKey(0), 64, 64, 2))
    with torch.device("meta"):
        port = animation.AnimationModels(
            unet=animation.UNetSpatioTemporal(), vae=animation.AutoencoderKLTemporalDecoder(),
            clip=animation.CLIPVisionModelWithProjection(), pose_net=animation.PoseNet(),
            face_encoder=animation.FusionFaceId())
    for model in MODELS:
        want = {p: tuple(s.shape) for p, s in _paths(flax[model]).items()}
        got, unmapped = {}, []
        for key, p in getattr(port, model).state_dict().items():
            path, shape = _flax_leaf(model, key, p.shape)
            if path is None:
                unmapped.append(key)
            else:
                got[path] = shape
        assert not unmapped, (model, unmapped[:5])
        assert set(got) == set(want), (model, sorted(set(want) - set(got))[:5],
                                       sorted(set(got) - set(want))[:5])
        bad = [(p, got[p], want[p]) for p in want if got[p] != want[p]]
        assert not bad, (model, bad[:5])
