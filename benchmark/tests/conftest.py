"""The benchmark's tests: the micro configuration and traffic they run the
harness at on the CPU."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import common  # noqa: E402

HERE = Path(__file__).resolve().parent


def micro_infer() -> dict:
    """The inference configuration at micro widths (float32)."""
    return common.load_json(HERE / "micro-infer.json")


def micro_train() -> dict:
    """The training configuration with the micro models, 4-frame clips, in
    float32."""
    cfg = copy.deepcopy(common.config("stableanimator-svdxt-train"))
    cfg["models"] = micro_infer()["models"]
    cfg["training"].update(sample_n_frames=4, mixed_precision="no")
    return cfg


def micro_traffic(workload: str) -> dict:
    """The cell's traffic at 128 x 128, a portrait cell's at 128 x 64
    (animate: 8 frames, 3 steps, tiles of 4 at overlap 2), with the cell's
    own limits."""
    wl = next(w for w in common.benchmark_spec()["workloads"] if w["name"] == workload)
    t = copy.deepcopy(common.traffic(wl["traffic"]))
    t.update(height=128, width=64 if t["height"] > t["width"] else 128)
    if t["driver"] == "animate":
        t.update(frames=8, warmup_steps=1,
                 sampling={"num_inference_steps": 3, "tile_size": 4, "tile_overlap": 2})
    return t


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")
