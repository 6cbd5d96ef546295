"""The control and a planted fault at each cell's own size, on the card.

The control (the reference with the models served in bf16 computed in fp8,
in the program's place) has to read above at least one of the cell's limits
on every seed, and so has each training cell's program with half of its
clip left out. Each case prints its numbers beside the limits as one JSON
line. The cases of one cell and seed share the float32 reference. Needs the
card (`-k <cell>` for one cell's cases):

    python -m pytest benchmark/tests/test_bench_control.py -m cuda -s
"""

import json

import pytest
import torch

from benchmark import common, run
from benchmark.tests.test_bench_harness import _half_batch_train

SPEC = common.benchmark_spec()
TRAIN = [w["name"] for w in SPEC["workloads"] if common.traffic(w["traffic"])["driver"] == "train"]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)
_WANTED: dict = {}   # (workload, seed) -> the reference's reading


def _cell(workload: str, seed: int):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    wl = run.cell_spec(SPEC, workload)
    cell, _, traffic = run.make_cell(wl, seed, torch.device("cuda", 0))
    cell._wanted = _WANTED.get((workload, seed))
    return cell, traffic["limits"]


def _fails_a_limit(kind: str, workload: str, seed: int, cell, numbers: dict, limits: dict) -> bool:
    _WANTED[(workload, seed)] = cell._wanted
    print(json.dumps({"workload": workload, "seed": seed, kind: numbers, "limits": limits}),
          flush=True)
    return any(numbers[n] > lim for n, lim in limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_the_control_is_not_correct(workload, seed):
    cell, limits = _cell(workload, seed)
    assert _fails_a_limit("control", workload, seed, cell, cell.control(), limits)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", TRAIN)
def test_half_the_clip_left_out_is_not_correct(monkeypatch, workload, seed):
    """A training cell's program with the loss over the clip's first half
    (frames, poses, masks and noises), its set-up steps judged as a run
    judges them."""
    cell, limits = _cell(workload, seed)
    _half_batch_train(monkeypatch)
    cell.setup()
    cell.free_program()
    assert _fails_a_limit("half_clip", workload, seed, cell, cell.check([]), limits)
