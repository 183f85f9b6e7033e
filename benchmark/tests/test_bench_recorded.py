"""The readers of the measured package's stage recorder
(`harness/recorded.py`): each on a hand-built context, the tiny render and
train cells on the CPU (counters of the traced views, and no device
walls), the readers that were there unchanged by what the recorder adds,
and on the card a traced run of the tiny render cell that reports all
four."""

import copy
import json
import time

import pytest
import torch
from conftest import ROOT, SEED, tiny_cell

import run as bench_run
from harness import recorded, spec
from harness.context import ReadContext
from harness.profile import Trace

NEW = ("host_syncs.render", "projection.idle_ms.render",
       "binning.idle_ms.render", "instances.render")
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
OLD = [m["name"] for m in BENCHMARK["per_layer"] if m["name"] not in NEW]
HELD_OUT_TRAIN = ["nerf_synthetic_800.train", "mipnerf360_outdoor.train"]


def _ctx():
    tr = Trace(steps=2, window_s=0.03, busy_s=0.024, launches=1230,
               stage_s={"projection": 0.0134, "binning": 0.0060,
                        "pack": 0.0016},
               raster_s={"raster_fwd": [0.0011, 0.0012], "raster_bwd": []},
               device_ops=[], idle_gaps=[])
    return ReadContext("render", tr, 0.0136,
                       {"raster_fwd": [0.0005, 0.0005], "step_ops": 2e12})


PROGRAM = {"steps": 6,
           "spans": {"3dgs:projection": {"wall_ms": 7.0},
                     "3dgs:binning": {"wall_ms": 3.5},
                     "3dgs:pack": {"wall_ms": 1.0},
                     "3dgs:backward": {"wall_ms": 9.25}},
           "counters": {"instances": 2200000.0, "host_syncs": 11.0},
           "sync_sites": {"(none) renderer.py:86": 1.0,
                          "3dgs:binning binning.py:145": 9.0,
                          "3dgs:raster_fwd raster_cuda.py:432": 1.0}}
EXPECTED = {"host_syncs.render": 11.0,
            "projection.idle_ms.render": 7.0 - 6.7,
            "binning.idle_ms.render": 3.5 + 1.0 - 3.8,
            "instances.render": 2200000.0,
            "backward.wall_ms.train": 9.25}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_hand_built_context(name):
    read = spec.load_reader(name)
    ctx = _ctx()
    ctx.program = PROGRAM
    assert read(ctx) == pytest.approx(EXPECTED[name])
    ctx = _ctx()
    ctx.program = None
    assert read(ctx) is None
    # no walls (the CPU): the idle and wall readers give nothing
    ctx = _ctx()
    ctx.program = copy.deepcopy(PROGRAM)
    for row in ctx.program["spans"].values():
        row["wall_ms"] = None
    ctx.program["counters"].pop("host_syncs")
    value = read(ctx)
    assert (value is None) == (name != "instances.render")


def test_readers_that_were_there_read_the_same():
    plain, with_program = _ctx(), _ctx()
    with_program.program = PROGRAM
    for name in OLD:
        read = spec.load_reader(name)
        assert read(plain) == read(with_program), name


def test_a_context_with_no_driver_behind_it(monkeypatch):
    """Reads nothing on the CPU; raises on a card, where the readers
    must find the driver."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert recorded.program(_ctx()) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="no driver"):
        recorded.program(_ctx())


def test_a_package_without_the_recorder_reads_nothing(monkeypatch):
    """The parent commit's package: the readers give None, and no process
    is started.  The driver is found whatever the caller names it."""
    from types import SimpleNamespace
    from mini3dgs_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "recording")
    monkeypatch.setattr(recorded.subprocess, "run", None)
    held = SimpleNamespace(trace=lambda: None, seed=1, device="cpu",
                           out_dir=ROOT, replay=lambda views: None,
                           cell=SimpleNamespace(traffic={"kind": "render"}))
    ctx = _ctx()
    assert recorded._driver() is held
    for name in NEW:
        assert spec.load_reader(name)(ctx) is None


def test_a_driver_without_replay_reads_nothing(monkeypatch):
    """A driver that offers the recorder nothing to replay: the readers
    give None, and no process is started."""
    from types import SimpleNamespace
    monkeypatch.setattr(recorded.subprocess, "run", None)
    held = SimpleNamespace(trace=lambda: None, seed=1, device="cpu",
                           out_dir=ROOT,
                           cell=SimpleNamespace(traffic={"kind": "other"}))
    ctx = _ctx()
    assert recorded._driver() is held
    for name in NEW:
        assert spec.load_reader(name)(ctx) is None


def test_tiny_render_cell_on_the_cpu(monkeypatch):
    cell = tiny_cell("mipnerf360_outdoor.render")
    monkeypatch.setattr(cell.driver, "PASS_STEPS", 5)
    drv = cell.driver(cell, SEED, torch.device("cpu"),
                      bench_run.ROOT / "build" / "t")
    drv.setup()
    drv.window(0.5)
    ctx = drv.trace()
    p = recorded.program(ctx)
    k = cell.traffic["trace_frames"]
    # the profiled views, in whole rounds: 3 of 2 for at least 5 frames
    assert p is ctx.program and p["steps"] == 6
    assert p["views"] == [(drv.frame - k + j) % len(drv.cams)
                          for j in range(k)]
    with torch.no_grad():
        live = [drv._render(drv.gaussians, drv.cams[i],
                            drv.settings)["n_live"] for i in p["views"]]
    assert p["counters"]["instances"] == pytest.approx(sum(live) / k)
    # and the reference's binning of the same views
    from harness.windows import ref_camera, ref_settings
    from reference.train import render as ref_render
    st = ref_settings(drv.cfg, drv.cfg.sh_degree)
    ref = [ref_render(drv.params, ref_camera(drv.views, i, drv.device), st,
                      count_pairs=True)[1].n_instances for i in p["views"]]
    assert p["counters"]["instances"] == pytest.approx(sum(ref) / k)
    assert p["counters"]["raster_fwd.launches"] == 0  # the plain version
    assert "host_syncs" not in p["counters"] and p["sync_sites"] is None
    for name, row in p["spans"].items():
        assert row["wall_ms"] is None and row["host_ms"] > 0, name
    assert p["spans"]["render"]["calls"] == pytest.approx(1)
    trace = json.loads((drv.out_dir / f"{cell.name}.spans.json").read_text())
    assert {e["name"] for e in trace["traceEvents"]} >= {"render",
                                                        "3dgs:binning"}
    assert json.loads((drv.out_dir / f"{cell.name}.program.json"
                       ).read_text()) == p
    # through run.py: the counter is reported, no device metric
    res = bench_run.run(cell, SEED, 3.0, True, torch.device("cpu"),
                        time.perf_counter())
    got = {k for k in res["metrics"] if k in NEW}
    assert got == {"instances.render"}
    assert res["metrics"]["instances.render"]["value"] > 0


def test_train_readers_load_on_the_tiny_train_cell(monkeypatch):
    """`host_syncs.train` and `backward.wall_ms.train`, listed with the
    held-out train cells, load with them and read the recorder there."""
    b = spec.with_held_out()
    for name, unit in (("host_syncs.train", "syncs/step"),
                       ("backward.wall_ms.train", "ms")):
        b["per_layer"].append({"name": name, "unit": unit,
                               "better": "lower", "source": "program_span",
                               "layer": "host dispatch",
                               "moves": "train_step_ms",
                               "workloads": HELD_OUT_TRAIN})
    full = spec.load_cell(HELD_OUT_TRAIN[0], b)
    assert {"host_syncs.train", "backward.wall_ms.train"} <= set(full.readers)
    cell = tiny_cell(HELD_OUT_TRAIN[0])
    monkeypatch.setattr(cell.driver, "PASS_STEPS", 3)
    drv = cell.driver(cell, SEED, torch.device("cpu"),
                      bench_run.ROOT / "build" / "t")
    drv.setup()
    drv.window(0.5)
    ctx = drv.trace()
    p = recorded.program(ctx)
    k = cell.traffic["trace_steps"]
    assert p["views"] == drv._draws(drv.trainer.iteration - k, k)
    assert p["steps"] == 4
    assert p["spans"]["train_step"]["calls"] == pytest.approx(1)
    assert p["spans"]["3dgs:backward"]["host_ms"] > 0
    assert p["counters"]["instances"] > 0
    for name in ("host_syncs.train", "backward.wall_ms.train"):
        assert full.readers[name](ctx) is None  # no card


@pytest.mark.cuda
def test_traced_run_reports_the_four_on_the_card(monkeypatch):
    """`run.run` with tracing on, the tiny render cell on the card: the
    four readers find the driver and read the recorder."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = tiny_cell("mipnerf360_outdoor.render")
    monkeypatch.setattr(cell.driver, "PASS_STEPS", 12)
    res = bench_run.run(cell, SEED, 1.0, True, torch.device("cuda", 0),
                        time.perf_counter())
    assert res["correct"], res["checks"]
    got = {k: m["value"] for k, m in res["metrics"].items() if k in NEW}
    assert set(got) == set(NEW), got
    assert got["host_syncs.render"] == 11
    assert got["instances.render"] > 0
