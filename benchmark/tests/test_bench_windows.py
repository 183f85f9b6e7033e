"""A tiny train and render window, driven on the CPU through the measured
package's plain kernel versions, with the cells' own limits; and the
traced sub-window's plumbing."""

import math

import pytest
import torch
from conftest import SEED, tiny_cell

import run as bench_run


def bench_run_cells():
    import json
    return {w["name"] for w in json.loads(
        (bench_run.ROOT / "BENCHMARK.json").read_text())["workloads"]}


@pytest.mark.parametrize("name", ["mipnerf360_outdoor.render"])
def test_tiny_window_is_correct(name):
    cell = tiny_cell(name)
    import time
    res = bench_run.run(cell, SEED, 1.5, False, torch.device("cpu"),
                        time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    e2e = {m["name"] for m in cell.end_to_end}
    # frame_ms_p95 is read from the card's timeline: not on the CPU
    assert set(res["metrics"]) == e2e - {"frame_ms_p95"}
    for m in res["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0


def test_tiny_train_window_shows_the_rate_fault():
    """The held-out train cell runs end to end; its first gradient agrees
    with the reference, its change over the checked steps does not: the
    measured package's rates depart from the paper's (PERF.md, Open
    questions), and the cell has no limits until they follow it."""
    cell = tiny_cell("nerf_synthetic_800.train")
    import time
    res = bench_run.run(cell, SEED, 1.5, False, torch.device("cpu"),
                        time.perf_counter())
    assert not res["correct"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"train_step_ms", "setup_s"}
    checks = res["checks"]
    assert all(c["limit"] is None for c in checks.values())
    assert checks["grad_gap"]["value"] < 1e-4
    assert checks["change_gap"]["value"] > 1.0


@pytest.mark.parametrize("name", ["nerf_synthetic_800.train",
                                  "mipnerf360_outdoor.render"])
def test_tiny_traced_window(name):
    cell = tiny_cell(name)
    import time
    res = bench_run.run(cell, SEED, 1.5, True, torch.device("cpu"),
                        time.perf_counter())
    # the train cells have no limits yet (held out)
    assert res["correct"] == (name in bench_run_cells()), res["checks"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU has no device timeline: no launch to read a roofline from
    assert not any("roofline" in k for k in res["metrics"])
    assert 0 < res["metrics"][f"mfu.{cell.traffic['kind']}"]["value"] < 100


def test_same_seed_same_inputs():
    from harness import scene
    cell = tiny_cell("mipnerf360_outdoor.render")
    a = scene.make_gaussians(cell.config, SEED, "cpu")
    b = scene.make_gaussians(cell.config, SEED, "cpu")
    c = scene.make_gaussians(cell.config, SEED + 1, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["xyz"], c["xyz"])
    assert a["xyz"].shape == c["xyz"].shape
