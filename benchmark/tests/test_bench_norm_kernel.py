"""The reader of `norm_kernel_pct.animate` on planted request spans: the
share of norm calls that took a kernel, over the profiled requests; None
without requests and where the counts lack the norm counters (a program
without them)."""

import pytest

from benchmark import common, spans

NAME = "norm_kernel_pct.animate"
FLASH = {"flash_fwd": 251, "flash_resident": 0, "flash_bwd": 0}


def _request(unit, counts):
    return {"name": "request", "id": unit, "parent": None, "unit": unit, "attrs": {},
            "start_ns": unit * 1000, "end_ns": unit * 1000 + 500, "counts": counts,
            "device_s": 0.5}


@pytest.mark.parametrize("planted,want", [
    ([dict(FLASH, norm_kernel=5400, norm_eager=20), dict(FLASH, norm_kernel=5400, norm_eager=20)],
     100.0 * 10800 / 10840),
    ([dict(FLASH, norm_kernel=0, norm_eager=5420)], 0.0),
    ([dict(FLASH, norm_kernel=300, norm_eager=0)], 100.0),
    ([dict(FLASH)], None),
    ([dict(FLASH, norm_kernel=0, norm_eager=0)], None),
    ([], None)])
def test_the_share_of_norm_calls_on_a_kernel(monkeypatch, planted, want):
    monkeypatch.setattr(spans, "recorded",
                        lambda: [_request(i + 1, c) for i, c in enumerate(planted)])
    got = common.metric_reader(NAME).read({"units": []})
    assert got == (None if want is None else pytest.approx(want))


def test_the_metric_is_a_request_cells_share():
    m = next(m for m in common.benchmark_spec()["per_layer"] if m["name"] == NAME)
    assert m["unit"] == "%" and m["moves"] == "frames_per_s" and m["layer"] == "unet"
    assert m["workloads"] == ["animate-512x512-16f", "animate-576x1024-16f"]
