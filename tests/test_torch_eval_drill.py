"""The port's day-0 evaluation drill (`stableanimator_tpu_torch/tools/eval_drill.py`)
on the CPU at the micro scale: two requests through the port's CLI, the
stand-ins, and the port's evaluation tool, written as JSON with the keys of
the committed EVAL_r05.json (the root drill's), every metric finite. The
drill's CLI runs on CUDA unless the CPU is asked for.
"""

import json
import math
import os

import pytest
import torch

from stableanimator_tpu_torch.tools import eval_drill
from tests.torch_threads import share_cores

THREADS = share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_micro_drill_writes_the_root_drills_json(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", str(THREADS))     # the CLI's subprocesses
    out = tmp_path / "eval.json"
    result = eval_drill.main(["--device", "cpu", "--model_scale", "micro", "--out", str(out),
                              "--work_dir", str(tmp_path / "work")])
    with open(os.path.join(REPO, "EVAL_r05.json")) as f:
        committed = json.load(f)
    assert json.loads(out.read_text()) == result
    assert sorted(result) == sorted(committed)
    assert sorted(result["metrics"]) == sorted(committed["metrics"])
    assert result["standin_weights"] is True and result["config"] == committed["config"]
    assert result["frames_generated"] == [16, 16]
    assert all(s > 0 for s in result["generate_seconds"])
    metrics = result["metrics"]
    assert metrics["num_frames"] == 16 and metrics["frames_with_face"] == 16
    # two 8-frame clips a side: one clip has no covariance (the root drill's 1)
    assert metrics["fvd_gen_clips"] == metrics["fvd_real_clips"] == 2
    for key in ("csim_mean", "csim_min", "l1_mean", "psnr_mean", "fvd"):
        assert math.isfinite(metrics[key]), key
    assert -1.0 <= metrics["csim_min"] <= metrics["csim_mean"] <= 1.0
    # the two seeds give two videos
    assert metrics["l1_mean"] > 0.0
    for tag in ("a", "b"):
        assert len(os.listdir(tmp_path / "work" / f"out_{tag}" / "animated_images")) == 16


def test_drill_runs_on_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the drill runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_drill.main(["--work_dir", str(tmp_path)])
