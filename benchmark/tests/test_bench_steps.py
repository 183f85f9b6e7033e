"""The train-step cell of the 3DGS paper's recipe
(`mipnerf360_outdoor_3dgs.steps`, a mix of the kind `steps`) at a tiny size
on the CPU: it loads by name and runs through `run.run` to `frame_ms` and
`setup_s`, correct with its own limits; the control (the reference in
bfloat16 put in the program's place), the fault of half the batch left
out, and the port's cosine schedule in place of the paper's are not."""

import time

import torch
from conftest import SEED, tiny_cell

import run as bench_run
from harness import check

CELL = "mipnerf360_outdoor_3dgs.steps"
CPU = torch.device("cpu")


def _set_up(cell, seed=SEED):
    drv = cell.driver(cell, seed, CPU, bench_run.ROOT / "build" / "t")
    drv.setup()
    drv.release()
    return drv


def test_the_cell_runs_to_frame_ms_and_is_correct():
    cell = tiny_cell(CELL)
    assert cell.traffic["kind"] == "steps"
    assert cell.config["settings"]["lr_schedule"] == "3dgs"
    assert set(cell.limits) == {"loss_gap", "grad_gap", "change_gap"}
    res = bench_run.run(cell, SEED, 1.0, False, CPU, time.perf_counter())
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"frame_ms", "setup_s"}
    assert res["metrics"]["frame_ms"]["value"] > 0
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_the_control_the_fault_and_the_cosine_are_not_correct():
    cell = tiny_cell(CELL)
    drv = _set_up(cell)
    ref = drv.reference()
    ok, checks = check.judge(drv.numbers(ref), cell.limits)
    assert ok, checks
    for name, numbers in drv.controls(ref).items():
        assert not check.judge(numbers, cell.limits)[0], (name, numbers)
    ratios = drv.calibration(ref)["change_ratio"]
    assert all(abs(r - 1.0) < 0.02 for r in ratios.values()), ratios

    cell.config["settings"]["lr_schedule"] = "cosine"
    drv = _set_up(cell)
    ok, checks = check.judge(drv.numbers(drv.reference()), cell.limits)
    assert not ok, checks
    assert checks["change_gap"]["value"] > checks["change_gap"]["limit"]
