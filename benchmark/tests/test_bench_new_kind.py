"""A traffic mix of a kind the benchmark does not run, added by files and
entries alone, end to end on the CPU: its driver (`two_views_driver.py`,
copied in as `drivers/two_views.py`), mix, limits and entries beside a
copy of the benchmark's files; a traced run through `run.run`, whose
recorder readers replay the traced calls in a process of their own that
has to find the new driver in the folder the cell came from; an untraced
run that comes out correct; and `calibrate.readings`, whose control does
not."""

import json
import shutil
import time

import torch
from conftest import BENCH, ROOT, SEED, shrink

import calibrate
import run as bench_run
from harness import check, spec

CELL = "mipnerf360_outdoor.two_views"
METRICS = ("instances.two_views", "mfu.two_views", "host_syncs.two_views")


def _files(folder):
    return {p: p.read_bytes() for p in folder.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _toy_benchmark(tmp_path):
    """(a folder of the benchmark's files found by name, with the new
    cell's added; BENCHMARK.json with its entries; the bytes of each file
    the folder had before the new ones).  The folder holds no `harness`:
    the recorder's process runs this checkout's, which has to load the
    driver from the folder the cell came from."""
    bench = tmp_path / "benchmark"
    for part in ("configs", "traffic", "drivers", "limits", "metrics"):
        shutil.copytree(BENCH / part, bench / part,
                        ignore=shutil.ignore_patterns("__pycache__"))
    before = _files(bench)
    shutil.copy(BENCH / "tests" / "two_views_driver.py",
                bench / "drivers" / "two_views.py")
    mix = json.loads((bench / "traffic" / "render.json").read_text())
    mix.update(kind="two_views", about="one viewer, two views a call")
    (bench / "traffic" / "two_views.json").write_text(json.dumps(mix))
    shutil.copy(bench / "limits" / "mipnerf360_outdoor.render.json",
                bench / "limits" / f"{CELL}.json")
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": CELL, "config": "mipnerf360_outdoor",
                           "traffic": "two_views", "chips": 1,
                           "why": "two views a call"})
    for m in b["end_to_end"]:
        if m["name"] == "frame_ms":
            m["workloads"].append(CELL)
    for name in METRICS:
        b["per_layer"].append({"name": name, "unit": "1",
                               "better": "lower", "source": "program_counter",
                               "layer": "host dispatch", "moves": "frame_ms",
                               "workloads": [CELL]})
    return bench, b, before


def test_a_cell_of_a_new_kind_end_to_end(tmp_path):
    ours = _files(BENCH)
    bench, b, before = _toy_benchmark(tmp_path)
    cell = shrink(spec.load_cell(CELL, b, bench))
    assert cell.bench_dir == bench and cell.driver.PASS_STEPS == 4
    cpu = torch.device("cpu")

    res = bench_run.run(cell, SEED, 1.0, True, cpu, time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["metrics"]["instances.two_views"]["value"] > 0
    assert 0 < res["metrics"]["mfu.two_views"]["value"] < 100
    assert "host_syncs.two_views" not in res["metrics"]  # no card
    out = bench_run.ROOT / "build" / "benchmark_out"
    p = json.loads((out / f"{CELL}.program.json").read_text())
    # the traced calls, in whole rounds: 2 rounds of 2 for at least 4
    assert len(p["views"]) == cell.traffic["trace_frames"]
    assert p["steps"] == 4
    assert p["spans"]["render"]["calls"] == 2  # two views a call

    res = bench_run.run(cell, SEED, 1.0, False, cpu, time.perf_counter())
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"frame_ms", "setup_s"}

    row = calibrate.readings(cell, SEED + 1, cpu, True, 1.0)
    assert set(row["program"]) == set(cell.limits)
    assert check.judge(row["program"], cell.limits)[0]
    assert not check.judge(row["upper"]["control"], cell.limits)[0]

    for path, data in before.items():
        assert path.read_bytes() == data
    assert _files(BENCH) == ours
