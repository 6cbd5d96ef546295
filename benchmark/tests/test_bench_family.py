"""A configuration's model family decides its counts and its weights: the
SVD family's (a configuration file without `"family"`) are what the cells
were measured with, number for number; another family's come from
`benchmark/families/<name>.py`, found by name, with no other file of the
harness changed."""

import json
import math
import re

import pytest
import torch

from benchmark import common, counts, run, weights
from benchmark.tests.conftest import micro_infer

SPEC = common.benchmark_spec()
CALL_KEYS = ("pass", "b", "sq", "sk", "h", "d", "lse", "n")

# model FLOPs and attention calls (CALL_KEYS) of each cell's unit of work,
# as counts.py gave them before families existed
PARENT = {
    "animate-512x512-16f": (1042823492698112, [
        ("fwd", 32, 4096, 4096, 5, 64, False, 125), ("fwd", 32, 1024, 1024, 10, 64, False, 125),
        ("fwd", 16, 4096, 4096, 1, 512, False, 1)]),
    "train-512x512-16f": (78999109435392, [
        ("fwd", 16, 4096, 4096, 5, 64, True, 10), ("bwd", 16, 4096, 4096, 5, 64, True, 5),
        ("fwd", 16, 1024, 1024, 10, 64, True, 10), ("bwd", 16, 1024, 1024, 10, 64, True, 5)]),
    "animate-576x1024-16f": (2622607434350592, [
        ("fwd", 32, 9216, 9216, 5, 64, False, 125), ("fwd", 32, 2304, 2304, 10, 64, False, 125),
        ("fwd", 32, 576, 576, 20, 64, False, 125)] + [("fwd", 4, 9216, 9216, 1, 512, False, 1)] * 4),
    "train-1024x576-16f": (195472766861312, [
        ("fwd", 16, 9216, 9216, 5, 64, True, 10), ("bwd", 16, 9216, 9216, 5, 64, True, 5),
        ("fwd", 16, 2304, 2304, 10, 64, True, 10), ("bwd", 16, 2304, 2304, 10, 64, True, 5),
        ("fwd", 16, 576, 576, 20, 64, True, 10), ("bwd", 16, 576, 576, 20, 64, True, 5)]),
}

TOY = '''
import torch
import torch.nn as nn

ORDER = ("head", "encoder")
NORMS = (nn.LayerNorm,)


def model_flops(cfg, work):
    return 7 * cfg["models"]["width"] * work["frames"]


def attention_calls(cfg, work):
    return [{"pass": "fwd", "b": 2, "sq": work["frames"], "sk": 1024, "h": 3,
             "d": cfg["models"]["width"], "lse": False, "n": 5}]


def build(cfg, device, *, meta=False):
    d = cfg["models"]["width"]
    with torch.device("meta"):
        models = {"encoder": nn.Sequential(nn.Embedding(11, d), nn.LayerNorm(d), nn.Linear(d, d)),
                  "head": nn.Sequential(nn.Linear(d, 2 * d), nn.Conv1d(2 * d, 3, 5))}
    if not meta:
        for m in models.values():
            m.to_empty(device=device)
    return models


def served_dtype(model, module, key, name, dtype):
    if isinstance(module, NORMS) or (model == "head" and key.startswith("1.")):
        return torch.float32
    return dtype
'''


def _calls(cfg, work):
    return [tuple(c[k] for k in CALL_KEYS) for c in counts.attention_calls(cfg, work)]


@pytest.fixture
def families(tmp_path, monkeypatch):
    """The families directory moved to `tmp_path`, with the toy family in it."""
    (tmp_path / "toy.py").write_text(TOY)
    monkeypatch.setattr(common, "FAMILIES", tmp_path)
    return tmp_path


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_the_cells_count_as_before(workload):
    """(a) Each cell's counts, on its driver's own unit of work, are the
    ones its metrics were read with."""
    cell, cfg, _ = run.make_cell(run.cell_spec(SPEC, workload), 1, "cpu")
    flops, calls = PARENT[workload]
    assert counts.model_flops(cfg, cell.work()) == flops
    assert _calls(cfg, cell.work()) == calls


def test_a_family_brings_its_counts_and_weights(families):
    """(b) A configuration of the toy family is counted by the toy file, and
    its leaves are drawn by the shared rule, models in the toy's ORDER,
    norm scales by its NORMS, its islands in float32."""
    cfg = {"family": "toy", "models": {"width": 8}}
    work = {"kind": "step", "frames": 6}
    assert counts.model_flops(cfg, work) == 7 * 8 * 6
    assert _calls(cfg, work) == [("fwd", 2, 6, 1024, 3, 8, False, 5)]
    call = counts.attention_calls(cfg, work)[0]
    assert counts.call_work(call)[0] == 4.0 * 2 * 3 * 6 * 1024 * 8
    assert counts.bound_seconds(call) > 0

    seed = 2 ** 31 + 21
    sds = weights.make(cfg, seed, "cpu", torch.bfloat16)
    assert list(sds) == ["head", "encoder"]
    assert list(sds["encoder"]) == ["0.weight", "1.weight", "1.bias", "2.weight", "2.bias"]
    served = {m: {k: v.dtype for k, v in sd.items()} for m, sd in sds.items()}
    assert served == {"head": {"0.weight": torch.bfloat16, "0.bias": torch.bfloat16,
                               "1.weight": torch.float32, "1.bias": torch.float32},
                      "encoder": {"0.weight": torch.bfloat16, "1.weight": torch.float32,
                                  "1.bias": torch.float32, "2.weight": torch.bfloat16,
                                  "2.bias": torch.bfloat16}}
    # the shared rule: one uniform draw a model from its own stream, in the
    # order of its state dict; norm scales 1, biases 0, matrices and kernels
    # +-sqrt(3 / fan-in) (an embedding's fan-in its rows)
    drawn = {"head": {"0.weight": ((16, 8), 8), "1.weight": ((3, 16, 5), 16 * 5)},
             "encoder": {"0.weight": ((11, 8), 11), "2.weight": ((8, 8), 8)}}
    for model, sd in sds.items():
        gen = torch.Generator().manual_seed(common.stream_seed(seed, "weights", model))
        flat = torch.rand(sum(v.numel() for v in sd.values()), generator=gen)
        at = 0
        for key, got in sd.items():
            n = got.numel()
            if key in drawn[model]:
                shape, fan_in = drawn[model][key]
                lim = math.sqrt(3.0) / math.sqrt(fan_in)
                want = (flat[at:at + n].view(shape) * 2 * lim - lim).to(got.dtype)
            elif key.endswith("bias"):
                want = torch.zeros_like(got)
            else:
                assert model == "encoder" and key == "1.weight"       # the LayerNorm's scale
                want = torch.ones_like(got)
            assert torch.equal(got, want), (model, key)
            at += n
    assert list(weights.make(cfg, seed, "cpu", torch.float32, models=("encoder",))) == ["encoder"]


def test_an_unknown_family_names_its_missing_file(families):
    """(c) A family without its file raises, naming the file."""
    cfg = {"family": "nope", "models": {}}
    missing = re.escape(str(families / "nope.py"))
    for call in (lambda: counts.model_flops(cfg, {"frames": 1}),
                 lambda: counts.attention_calls(cfg, {"frames": 1}),
                 lambda: weights.make(cfg, 1, "cpu", torch.float32)):
        with pytest.raises(FileNotFoundError, match=missing):
            call()


def test_a_configuration_without_a_family_is_svd(families, tmp_path):
    """(d) A configuration file without `"family"` is counted and given
    weights as the SVD family, whatever the families directory holds."""
    for c in SPEC["configs"]:
        assert "family" not in common.load_json(common.ROOT / c["file"])
    path = tmp_path / "micro.json"
    path.write_text(json.dumps(micro_infer()))
    cfg = common.load_json(path)
    assert common.family(cfg) is None
    m = cfg["models"]
    work = {"kind": "request", "height": 64, "width": 64, "frames": 4, "steps": 2,
            "decode_chunk": 4, "batched_decode_max_latent_volume": 4 * 8 * 8}
    assert counts.model_flops(cfg, work) == (
        2 * counts.unet_flops(m["unet"], 2, 4, 8, 8) + counts.vae_decode_flops(m["vae"], 4, 8, 8)
        + counts.vae_encode_flops(m["vae"], 1, 64, 64) + counts.clip_flops(m["clip"])
        + counts.pose_flops(m["pose_net"], 4, 64, 64) + counts.face_flops(m["face_encoder"]))
    sds = weights.make(cfg, 3, "cpu", torch.bfloat16)
    assert tuple(sds) == weights.ORDER
    assert sds["vae"]["encoder.conv_in.weight"].dtype == torch.float32
    assert sds["vae"]["decoder.conv_in.weight"].dtype == torch.bfloat16
    assert sds["unet"]["conv_in.weight"].dtype == torch.bfloat16
