"""The measured package's own stage recorder
(`mini3dgs_tpu_torch.utils.profiling`), read after the profiled
sub-window.  The views (or train steps' views) that the sub-window
profiled (the driver's `traced_views()`) are run again with no profiler,
in whole rounds of them (the driver's `replay(views)`), its `PASS_STEPS`
frames or steps at least: first under `recording()`, for the stages'
device walls and the program's counters; then as many under
`recording(count_syncs=True)`, for the host syncs (the warning hook costs
host time at each sync, so that pass times nothing; a run on the CPU
counts none).  So the walls and
`instances` are of the very views whose kernels the profiled sub-window
timed, and a wall less their busy time is the card's idle in those
frames.  The first pass's Chrome trace goes to
`<out_dir>/<cell>.spans.json`, the readings to
`<out_dir>/<cell>.program.json`.

The passes run in a process of their own, set up as the run's is, from
the cell, the seed and the driver of the folder the cell came from: a
`torch.profiler` session leaves the process that ran it launching slower
for seconds after (PERF.md), and the profiled sub-window comes first.
A traced run thus sets the cell up twice.  Each pass follows a garbage
collection and one unrecorded round.

What a reader gets from `program(ctx)`: {"steps": the frames or steps of
a pass, "views": the views replayed (one round), "spans": {span: its
summary a step}, "counters": {counter: a step}, "sync_sites": {"stage
file:line": syncs a step} or None where syncs were not counted,
"launch_us": the passes' host microseconds a launch, "setup_s" and
"passes_s": the seconds the process took to set up and for the passes};
or None where the package has no recorder or the driver no replay.

A reader is handed the ReadContext alone: the driver that made it is
found among its callers' locals (`run.run` holds it while it calls the
readers).  The passes run once, on the first reader that asks; the
context keeps the result as `ctx.program`.  On a card, a reader with no
driver behind it raises rather than read nothing.

    python3 -m harness.recorded '<json>'   # the passes' process
"""

from __future__ import annotations

import gc
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

import torch

from .env import host_launch_us
from .spec import BENCH_DIR, ROOT, Cell, load_driver


def program(ctx) -> Optional[dict]:
    """The recorder's readings of the cell behind `ctx` (see above)."""
    if not hasattr(ctx, "program"):
        drv = _driver()
        if drv is None and torch.cuda.is_available():
            raise RuntimeError("a reader of the stage recorder found no "
                               "driver of the benchmark among its callers")
        ctx.program = None if drv is None else _record(drv)
    return ctx.program


def wall_ms(ctx, *stages: str) -> Optional[float]:
    """The summed device walls a step of the `3dgs:` stages, with no
    profiler; None without a card or where one of them did not run."""
    p = program(ctx)
    if p is None:
        return None
    walls = [p["spans"].get("3dgs:" + s, {}).get("wall_ms") for s in stages]
    return None if None in walls else sum(walls)


def idle_ms(ctx, *stages: str) -> Optional[float]:
    """The stages' device walls with no profiler less the device ms of
    their kernels in the profiled sub-window: the card's idle inside them."""
    wall, busy = wall_ms(ctx, *stages), ctx.device_ms(*stages)
    return None if wall is None or busy is None else wall - busy


def _is_driver(v) -> bool:
    return all(hasattr(v, a) for a in ("cell", "seed", "device",
                                       "out_dir")) \
        and callable(getattr(v, "trace", None))


def _driver():
    """The driver held by the nearest caller that holds one."""
    frame = inspect.currentframe()
    while frame is not None:
        for v in frame.f_locals.values():
            if _is_driver(v):
                return v
        frame = frame.f_back
    return None


def _record(drv) -> Optional[dict]:
    """The passes of `drv`'s cell, seed and traced views, in a process of
    their own."""
    from mini3dgs_tpu_torch.utils import profiling
    if not hasattr(profiling, "recording") or \
            not callable(getattr(drv, "replay", None)):
        return None
    c = drv.cell
    arg = json.dumps({"name": c.name, "chips": c.chips, "config": c.config,
                      "traffic": c.traffic, "bench_dir": str(c.bench_dir),
                      "seed": drv.seed, "device": str(drv.device),
                      "out_dir": str(drv.out_dir),
                      "views": drv.traced_views(),
                      "steps": drv.PASS_STEPS})
    path = os.pathsep.join([str(BENCH_DIR), str(ROOT),
                            os.environ.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-m", "harness.recorded", arg],
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=path),
                         capture_output=True, text=True, timeout=1200)
    if out.returncode != 0:
        raise RuntimeError("the recorder's passes failed:\n"
                           + out.stderr[-3000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def measure(drv, views: List[int], steps: int) -> dict:
    """Both passes on the set-up driver `drv`; see the module's doc."""
    from mini3dgs_tpu_torch.utils.profiling import recording
    run = drv.replay(views)
    rounds = -(-steps // len(views))
    n = rounds * len(views)
    rec = recording(drv.device)
    # syncs are a card's: a run on the CPU counts none, wherever it runs
    counted = recording(drv.device,
                        count_syncs=drv.device.type == "cuda")
    for r in (rec, counted):
        gc.collect()
        run(1)
        with r:
            run(rounds)
    rec.write_chrome_trace(drv.out_dir / f"{drv.cell.name}.spans.json")
    counters = rec.counters(n)
    syncs = counted.counters(n).get("host_syncs")
    if syncs is not None:
        counters["host_syncs"] = syncs
    sites = counted.sync_sites
    return {"steps": n, "views": views, "spans": rec.summary(n),
            "counters": counters,
            "sync_sites": None if sites is None else
            {s: c / n for s, c in sites.items()}}


def main(arg: str) -> None:
    a = json.loads(arg)
    bench_dir = Path(a["bench_dir"])
    cell = Cell(name=a["name"], chips=a["chips"], config=a["config"],
                traffic=a["traffic"], limits={}, end_to_end=[],
                per_layer=[], readers={},
                driver=load_driver(a["traffic"]["kind"], bench_dir),
                bench_dir=bench_dir)
    drv = cell.driver(cell, a["seed"], torch.device(a["device"]),
                      Path(a["out_dir"]))
    t0 = time.perf_counter()
    drv.setup()
    t1 = time.perf_counter()
    res = measure(drv, a["views"], a["steps"])
    res["setup_s"], res["passes_s"] = t1 - t0, time.perf_counter() - t1
    if drv.device.type == "cuda":
        res["launch_us"] = host_launch_us(drv.device)
    line = json.dumps(res)
    (drv.out_dir / f"{cell.name}.program.json").write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
