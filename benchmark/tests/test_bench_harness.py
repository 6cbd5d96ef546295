"""The harness as data, on the CPU: inputs from the seed, the window's rate,
the names in BENCHMARK.json, additions found by name, no fall-back to the
CPU, the guard in a process of its own, and faults planted under a run
that `correct` has to catch."""

import hashlib
import json
import re
import subprocess
import sys
import time
import uuid

import pytest
import torch

from benchmark import common, inputs, run
from benchmark.tests.conftest import ROOT, micro_infer, micro_traffic, micro_train

SPEC = common.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


# -- inputs ------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda s, i: inputs.request(s, i, 64, 64, 4, 4, 32, "cpu"),
    lambda s, i: {**inputs.train_step(s, i, 64, 64, 4, 32, 4, 0.1, {"p_mean": 0.7, "p_std": 1.6},
                                      "cpu")[0],
                  **inputs.train_step(s, i, 64, 64, 4, 32, 4, 0.1, {"p_mean": 0.7, "p_std": 1.6},
                                      "cpu")[1]},
], ids=["request", "train_step"])
def test_inputs_follow_the_seed(make):
    big = 2 ** 31 + 977
    a, b = make(big, 3), make(big, 3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    for other in (make(big + 1, 3), make(big, 4)):
        varied = [k for k in a if not torch.equal(a[k], other[k])]
        assert len(varied) >= len(a) - 1          # keep may agree by chance


def test_a_training_clip_changes_from_frame_to_frame():
    """The subject walks up to the camera: the face box and the person grow
    frame by frame, so the clip's first half weighs the face far less than
    the whole clip does."""
    batch, _ = inputs.train_step(2 ** 31 + 977, 0, 128, 128, 16, 32, 4, 0.1,
                                 {"p_mean": 0.7, "p_std": 1.6}, "cpu")
    face = batch["face_mask"][0].mean((1, 2, 3))
    drawn = (batch["pose_pixels"][0] > -1).float().mean((1, 2, 3))
    assert bool((face[1:] > face[:-1]).all()) and bool((drawn[1:] >= drawn[:-1]).all())
    assert face[0] < 0.01 and face[-1] > 0.5
    assert face[:8].mean() < 0.5 * face.mean()
    steps = (batch["frames"][0, 1:] - batch["frames"][0, :-1]).abs().mean((1, 2, 3))
    assert bool((steps > 0).all())
    assert torch.equal(batch["ref_image"], batch["frames"][:, 0] * 0.5 + 0.5)


# -- the window --------------------------------------------------------------

class _Timed:
    """A unit of work that takes `seconds[i]` seconds."""

    RATE_SCALE = 1.0

    def __init__(self, seconds):
        self.seconds = seconds

    def unit(self, i, timings=None):
        time.sleep(self.seconds[i])
        return 2


def test_the_window_finishes_and_counts_the_unit_in_flight():
    units, window_s, done = run.window(_Timed([0.06] * 10), 0, 0.1, False)
    assert len(units) == 2 and done == 4          # the second crosses the end and counts
    assert window_s >= 0.12 and done / window_s == pytest.approx(2 / 0.06, rel=0.2)


def test_a_stall_inside_the_window_lowers_the_rate():
    steady = run.window(_Timed([0.03] * 20), 0, 0.2, False)
    stalled = run.window(_Timed([0.03, 0.15] + [0.03] * 18), 0, 0.2, False)
    rate = [done / s for _, s, done in (steady, stalled)]
    assert rate[1] < 0.8 * rate[0]


# -- BENCHMARK.json ----------------------------------------------------------

def test_names_and_units():
    named = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for group in (SPEC["configs"], SPEC["workloads"], SPEC["end_to_end"] + SPEC["per_layer"]):
        assert len({e["name"] for e in group}) == len(group)


def test_every_name_has_its_file_and_every_cell_its_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and all(m["bound"] <= 0.25 for m in e2e.values())
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in SPEC["workloads"]:
        common.config(w["config"])
        t = common.traffic(w["traffic"])
        assert (run.common.HERE / "drivers" / f"{t['driver']}.py").is_file()
        reported = {n for n, m in e2e.items() if run.applies(m, w["name"], set())}
        assert "setup_s" in reported and len(reported) >= 2
        layers = [m for m in SPEC["per_layer"] if run.applies(m, w["name"], reported)]
        assert layers and all(m["moves"] in reported for m in layers)
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert callable(common.metric_reader(m["name"]).read)


# -- additions are files -----------------------------------------------------

def _digests():
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (ROOT / "benchmark").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_traffic_mix_and_metric_are_found_by_name():
    before = _digests()
    tag = uuid.uuid4().hex[:8]
    traffic_file = ROOT / "benchmark" / "traffic" / f"extra-{tag}.json"
    metric_file = ROOT / "benchmark" / "metrics" / f"extra_{tag}.animate.py"
    try:
        traffic_file.write_text(json.dumps(dict(common.traffic("animate-512x512-16f"), frames=32)))
        metric_file.write_text("def read(rec):\n    return float(len(rec['units']))\n")
        spec = json.loads(json.dumps(SPEC))
        spec["workloads"].append({"name": f"animate-512x512-32f-{tag}",
                                  "config": "stableanimator-svdxt-infer",
                                  "traffic": f"extra-{tag}", "chips": 1, "why": "an addition"})
        spec["per_layer"].append({"name": f"extra_{tag}.animate", "unit": "1", "better": "lower",
                                  "source": "program_span", "layer": "unet",
                                  "moves": "frames_per_s"})
        wl = run.cell_spec(spec, f"animate-512x512-32f-{tag}")
        cell, cfg, traffic = run.make_cell(wl, 1, "cpu")
        assert traffic["frames"] == 32 and cell.work()["frames"] == 32
        metric = spec["per_layer"][-1]
        assert run.applies(metric, wl["name"], {"frames_per_s", "peak_gib", "setup_s"})
        assert common.metric_reader(metric["name"]).read({"units": [1, 2]}) == 2.0
    finally:
        traffic_file.unlink(missing_ok=True)
        metric_file.unlink(missing_ok=True)
    assert _digests() == before


# -- the measuring path needs the card --------------------------------------

def test_the_run_fails_without_a_card_and_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "animate-512x512-16f", "--seed", "1", "--seconds", "1"])
    assert e.value.code == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("module,code", [("stableanimator_tpu.ops", 3),
                                         ("stableanimator_tpu_torch.ops", 2)])
def test_the_guard_in_a_process(module, code):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    prog = ("import runpy, sys, types; sys.modules[%r] = types.ModuleType('m'); "
            "sys.argv = ['run.py', '--workload', 'animate-512x512-16f', '--seed', '1']; "
            "runpy.run_path('benchmark/run.py', run_name='__main__')" % module)
    out = subprocess.run([sys.executable, "-c", prog], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == code, out.stderr[-2000:]
    assert out.stdout == ""


# -- faults under a run ------------------------------------------------------

def _state_unchanged_animate(mp):
    from stableanimator_tpu_torch.pipeline import animation
    mp.setattr(animation, "step_euler", lambda out, sample, sigma, nxt: sample)


def _half_batch_animate(mp):
    from stableanimator_tpu_torch.pipeline import animation
    unet = animation._unet

    def half(models, batch, t, ctx, ids, pose, mesh):
        r, f = batch.shape[:2]
        h = r // 2
        out = unet(models, batch[:h], t, ctx[:h], ids[:h], pose[:h * f], mesh)
        return torch.cat([out, out.mean(0, keepdim=True).expand_as(out)])
    mp.setattr(animation, "_unet", half)


def _answer_altered_animate(mp):
    from stableanimator_tpu_torch.pipeline import animation
    to_frames = animation._to_frames

    def altered(decoded, cfg):
        frames = to_frames(decoded, cfg).clone()
        frames[1] = frames[0]
        return frames
    mp.setattr(animation, "_to_frames", altered)


def _state_unchanged_train(mp):
    from stableanimator_tpu_torch.train import train_step

    def unchanged(state, grads, cfg):
        state.updates += 1
    mp.setattr(train_step, "_apply_update", unchanged)


def _half_batch_train(mp):
    from stableanimator_tpu_torch.train import train_step
    loss = train_step.train_loss

    def half(models, batch, cfg, pipe, **kw):
        f = batch["frames"].shape[1] // 2
        batch = {k: (v[:, :f] if k in train_step.VIDEO_KEYS else v) for k, v in batch.items()}
        nz = dict(kw["noises"], eps0=kw["noises"]["eps0"][:f], noise=kw["noises"]["noise"][:, :f])
        return loss(models, batch, cfg, pipe, **dict(kw, noises=nz))
    mp.setattr(train_step, "train_loss", half)


def _answer_altered_train(mp):
    from stableanimator_tpu_torch.train import train_step
    loss = train_step.train_loss

    def altered(*args, **kw):
        value = loss(*args, **kw)
        return value + 0.5 * value.detach()
    mp.setattr(train_step, "train_loss", altered)


FAULTS = {"animate-512x512-16f": [None, _state_unchanged_animate, _half_batch_animate,
                                  _answer_altered_animate],
          "train-512x512-16f": [None, _state_unchanged_train, _half_batch_train,
                                _answer_altered_train]}
FAULTS["train-1024x576-16f"] = FAULTS["train-512x512-16f"]      # at micro size, portrait


@pytest.mark.parametrize("workload,fault", [(w, f) for w, fs in FAULTS.items() for f in fs],
                         ids=lambda x: x if isinstance(x, str) else getattr(x, "__name__", "sound"))
def test_correct_catches_a_planted_fault(monkeypatch, cpu, workload, fault):
    """A run of the cell's harness at micro size on the CPU (the program in
    float32), judged by the cell's own limits: sound, it is correct; with
    the timed path broken underneath, it is not. (One chip: no exchange
    between chips to leave out.)"""
    cfg = micro_infer() if workload.startswith("animate") else micro_train()
    if fault is not None:
        fault(monkeypatch)
    result = run.run_cell(SPEC, workload, 2 ** 31 + 5, 0.01, False, cpu, cfg=cfg,
                          traffic=micro_traffic(workload))
    assert result["correct"] is (fault is None), result["checks"]
