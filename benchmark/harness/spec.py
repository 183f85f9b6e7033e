"""Everything of one cell, found by name under the benchmark's folder:

- `BENCHMARK.json` at the checkout's root: the cell, its metrics;
- `configs/<config>.json`: the configuration (sizes, settings, the recipe
  of the measured package that it runs through, what was cut and assumed);
- `traffic/<mix>.json`: the traffic mix's parameters, read by the one
  driver of its `kind`;
- `drivers/<kind>.py`: that driver, a class `Driver(cell, seed, device,
  out_dir)`.  `run.py` calls its `setup`, `window`, `trace`, `release`,
  `reference`, `numbers` and `scene_line`; `calibrate.py` its `check_run`,
  `controls` and `calibration`; the stage recorder (`recorded.py`) its
  `PASS_STEPS`, `traced_views` and `replay`, where it has them;
- `limits/<cell>.json`: the limit of each number `correct` compares (a
  cell without one is never correct);
- `metrics/<metric>.py`: the reader of one per-layer metric, a function
  `read(ctx)` that returns a number or None.  A metric named
  `<stem>.<suffix>` (`mfu.render`) takes `metrics/<stem>.py` where it has
  no file of its own.

A cell, a mix of a new kind or a metric is added by adding files and
entries.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable]
    driver: type
    bench_dir: Path = BENCH_DIR   # the folder its files were found in


def _read_json(path: Path) -> dict:
    return json.loads(path.read_text(encoding="utf-8"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _load(path: Path, module: str):
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """The `read` function of `metrics/<name>.py`, or of
    `metrics/<stem>.py` where `name` is `<stem>.<suffix>` and has no file
    of its own."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        path = bench_dir / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    return _load(path, "benchmark_metric_" + path.stem.replace(".", "_")).read


def load_driver(kind: str, bench_dir: Path = BENCH_DIR) -> type:
    """The `Driver` class of `drivers/<kind>.py`."""
    return _load(bench_dir / "drivers" / f"{kind}.py",
                 "benchmark_driver_" + kind).Driver


def with_held_out(bench_dir: Path = BENCH_DIR) -> dict:
    """BENCHMARK.json with the entries of `held_out.json` added: the cells
    left out for a fault of the program, as they would return."""
    b = _read_json(bench_dir.parent / "BENCHMARK.json")
    held = _read_json(bench_dir / "held_out.json")
    return {k: b[k] + held[k] if k in held else b[k] for k in b}


def load_cell(name: str, benchmark: dict = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `name` of `benchmark` (BENCHMARK.json by default)."""
    if benchmark is None:
        benchmark = _read_json(bench_dir.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in benchmark["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the cells are "
                       f"{sorted(cells)}")
    w = cells[name]
    config = _read_json(bench_dir / "configs" / f"{w['config']}.json")
    config["name"] = w["config"]
    traffic = _read_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    traffic["name"] = w["traffic"]
    per_layer = [m for m in benchmark["per_layer"] if _applies(m, name)]
    limits = bench_dir / "limits" / f"{name}.json"
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                limits=_read_json(limits) if limits.is_file() else {},
                end_to_end=[m for m in benchmark["end_to_end"]
                            if _applies(m, name)],
                per_layer=per_layer,
                readers={m["name"]: load_reader(m["name"], bench_dir)
                         for m in per_layer},
                driver=load_driver(traffic["kind"], bench_dir),
                bench_dir=bench_dir)
