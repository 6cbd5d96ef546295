"""The plain reference against the port's CPU path at micro widths, on the
same seeded weights and inputs; its independence from the program and
from JAX; the run's guard against JAX."""

import ast
from pathlib import Path

import pytest
import torch

from benchmark import common, guard, inputs, weights
from benchmark.reference import models as ref_models
from benchmark.reference import pipeline as ref_pipeline
from benchmark.tests.conftest import micro_infer, micro_train

BENCH = Path(__file__).resolve().parents[1]


def _pair(cfg, seed, dtype=torch.float32, remat=False):
    from stableanimator_tpu_torch.pipeline import animation

    port = animation.build_models(**common.port_model_kwargs(cfg), dtype=dtype, device="cpu",
                                  seed=None, remat=remat)
    ref = ref_models.build(cfg, "cpu", checkpoint=remat)
    sds = weights.make(cfg, seed, "cpu", dtype)
    for name in weights.ORDER:
        getattr(port, name).load_state_dict(sds[name], strict=True)
        ref[name].load_state_dict({k: v.float() for k, v in sds[name].items()}, strict=True)
    return port, ref


def test_unet_call_and_decode_agree_with_the_port():
    port, ref = _pair(micro_infer(), 11)
    g = torch.Generator().manual_seed(0)
    b, f, h, w = 2, 4, 16, 16
    args = (torch.randn(b, f, h, w, 8, generator=g), torch.tensor(1.3),
            torch.randn(b, 5, 48, generator=g), torch.tensor([[6.0, 127.0, 0.02]] * b),
            torch.randn(b * f, h, w, 32, generator=g))
    z = torch.randn(4, h, w, 4, generator=g)
    with torch.no_grad():
        got, want = port.unet(*args), ref["unet"](*args)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
        got, want = port.vae.decode(z, num_frames=4), ref["vae"].decode(z, 4)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_a_request_agrees_with_the_ports_generate():
    from stableanimator_tpu_torch.core.config import PipelineConfig
    from stableanimator_tpu_torch.pipeline import animation

    cfg = micro_infer()
    port, ref = _pair(cfg, 12)
    sampling = dict(cfg["sampling"], num_inference_steps=3, tile_size=4, tile_overlap=2)
    x = inputs.request(5, 0, 128, 128, 8, 4, 32, "cpu")
    pipe = PipelineConfig(height=128, width=128, num_frames=8,
                          **{k: sampling[k] for k in ("num_inference_steps", "min_guidance_scale",
                                                      "max_guidance_scale", "tile_size",
                                                      "tile_overlap", "decode_chunk_size",
                                                      "noise_aug_strength", "motion_bucket_id",
                                                      "fps")})
    got = animation.generate(port, x["ref"], x["pose"], x["face"], pipe, aug_noise=x["aug"],
                             init_noise=x["init"], device="cpu")
    with torch.no_grad():
        want = ref_pipeline.generate(ref, x["ref"].float() / 255, x["pose"].float() / 127.5 - 1,
                                     x["face"], x["aug"], x["init"], sampling, cfg["scheduler"])
    assert got.shape == want.shape == (8, 128, 128, 3)
    assert (got - want).abs().max() < 1e-4


def test_a_training_loss_and_its_gradients_agree_with_the_port():
    from stableanimator_tpu_torch.core.config import PipelineConfig, TrainConfig
    from stableanimator_tpu_torch.train import train_step

    cfg = micro_train()
    port, ref = _pair(cfg, 13, remat=True)
    tr = cfg["training"]
    batch, draws = inputs.train_step(3, 0, 128, 128, 4, 32, 4, 0.1, cfg["scheduler"], "cpu")
    draws["keep"] = torch.ones(1)
    s = cfg["sampling"]
    for name in tr["trainable"]:
        getattr(port, name).requires_grad_(True)
        ref[name].requires_grad_(True)
    got = train_step.train_loss(port, batch, TrainConfig(mixed_precision="no"),
                                PipelineConfig(fps=s["fps"], motion_bucket_id=s["motion_bucket_id"],
                                               noise_aug_strength=s["noise_aug_strength"]),
                                noises=draws)
    want = ref_pipeline.train_loss(ref, batch, draws, s, tr)
    assert abs(got.item() - want.item()) <= 1e-5 * abs(want.item())
    got.backward()
    want.backward()
    pairs = {}
    for name in tr["trainable"]:
        p_port = dict(getattr(port, name).named_parameters())
        for key, p in ref[name].named_parameters():
            a, b = p_port[key].grad, p.grad
            pairs[f"{name}.{key}"] = (torch.zeros_like(p) if a is None else a,
                                      torch.zeros_like(p) if b is None else b)
    # each leaf against the larger of its own norm and the median leaf's
    med = torch.stack([b.norm() for _, b in pairs.values()]).median()
    for key, (a, b) in pairs.items():
        assert (a - b).norm() <= 1e-4 * torch.maximum(b.norm(), med), key


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_neither_jax_nor_the_packages(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "optax", "stableanimator_tpu",
                                 "stableanimator_tpu_torch"}


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_of_the_benchmark_imports_jax(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "optax", "stableanimator_tpu"}


@pytest.mark.parametrize("modules,found", [
    ({"stableanimator_tpu.ops.attention": None}, ["stableanimator_tpu.ops.attention"]),
    ({"stableanimator_tpu_torch.ops.attention": None, "stableanimator_tpu_torch": None}, []),
    ({"jax": None, "jaxlib.xla_client": None, "flax.linen": None, "optax": None},
     ["flax.linen", "jax", "jaxlib.xla_client", "optax"]),
    ({"jaxtyping": None, "flaxen": None}, []),
])
def test_the_guard_compares_top_level_names_whole(modules, found):
    assert guard.loaded_forbidden(modules) == found
