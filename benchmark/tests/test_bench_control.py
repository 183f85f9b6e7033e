"""`correct` comes out false for the control and for each fault a cell can
have, with the cells' own limits, at a tiny size on the CPU: the control
(the reference put in the program's place, in bfloat16), and runs of the
harness past its look for a card with the timed path broken underneath.
The cells run on one card, so no exchange between cards can be left
out.  The train cells are held out (`held_out.json`) and have no limits
yet: of their faults, the state left unchanged is checked by its
reading."""

import time

import pytest
import torch
from conftest import SEED, tiny_cell

import run as bench_run
from harness import check


def _run(name):
    return bench_run.run(tiny_cell(name), SEED, 1.5, False,
                         torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("name", ["mipnerf360_outdoor.render"])
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    drv = cell.driver(cell, SEED, torch.device("cpu"),
                      bench_run.ROOT / "build" / "t")
    drv.setup()
    drv.check_run(1.5)
    drv.release()
    ref = drv.reference()
    numbers = drv.controls(ref)["control"]
    ok, _ = check.judge(numbers, cell.limits)
    assert not ok, numbers
    ok, checks = check.judge(drv.numbers(ref), cell.limits)
    assert ok, checks


@pytest.mark.parametrize("name", ["nerf_synthetic_800.train"])
def test_a_step_that_keeps_its_state(name, monkeypatch):
    from mini3dgs_tpu_torch.train import trainer
    real = trainer.train_step

    def unchanged(state, *args, **kw):
        _, metrics = real(state, *args, **kw)
        return state.replace(step=state.step + 1), metrics

    monkeypatch.setattr(trainer, "train_step", unchanged)
    res = _run(name)
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_a_frame_altered_where_it_is_made(monkeypatch):
    from mini3dgs_tpu_torch.ops import renderer
    real = renderer.render

    def altered(*args, **kw):
        out = real(*args, **kw)
        image = out["image"].clone()
        x = image[:, 10, 20]
        image[:, 10, 20] = torch.where(x < 0.5, x + 0.5, x - 0.5)
        return dict(out, image=image)

    monkeypatch.setattr(renderer, "render", altered)
    assert not _run("mipnerf360_outdoor.render")["correct"]
