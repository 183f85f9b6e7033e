"""The measured package's own stage recorder
(`mini3dgs_tpu_torch.utils.profiling`), read after the profiled
sub-window.  The views (or train steps' views) that the sub-window
profiled are run again with no profiler, in whole rounds of them, `STEPS`
frames or steps at least: first under `recording()`, for the stages'
device walls and the program's counters; then as many under
`recording(count_syncs=True)`, for the host syncs (the warning hook costs
host time at each sync, so that pass times nothing).  So the walls and
`instances` are of the very views whose kernels the profiled sub-window
timed, and a wall less their busy time is the card's idle in those
frames.  The first pass's Chrome trace goes to
`<out_dir>/<cell>.spans.json`, the readings to
`<out_dir>/<cell>.program.json`.

The passes run in a process of their own, set up as the run's is, from
the cell and the seed: a `torch.profiler` session leaves the process that
ran it launching slower for seconds after (PERF.md), and the profiled
sub-window comes first.  A traced run thus sets the cell up twice.  Each
pass follows a garbage collection and one unrecorded round.

What a reader gets from `program(ctx)`: {"steps": the frames or steps of
a pass, "views": the views replayed (one round), "spans": {span: its
summary a step}, "counters": {counter: a step}, "sync_sites": {"stage
file:line": syncs a step} or None where syncs were not counted,
"launch_us": the passes' host microseconds a launch, "setup_s" and
"passes_s": the seconds the process took to set up and for the passes};
or None where the package has no recorder.

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
from .windows import sync

STEPS = {"render": 240, "train": 40}  # a pass's frames or steps, at least


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


def _traced(drv) -> List[int]:
    """The views of the frames or steps the profiled sub-window ran: the
    driver's latest."""
    mix = drv.cell.traffic
    if mix["kind"] == "render":
        k, n = int(mix["trace_frames"]), len(drv.views.poses)
        return [(drv.frame - k + j) % n for j in range(k)]
    k = int(mix["trace_steps"])
    return drv._draws(drv.trainer.iteration - k, k)


def _record(drv) -> Optional[dict]:
    """The passes of `drv`'s cell, seed and traced views, in a process of
    their own."""
    from mini3dgs_tpu_torch.utils import profiling
    kind = drv.cell.traffic["kind"]
    if kind not in STEPS or not hasattr(profiling, "recording"):
        return None
    c = drv.cell
    arg = json.dumps({"name": c.name, "chips": c.chips, "config": c.config,
                      "traffic": c.traffic, "seed": drv.seed,
                      "device": str(drv.device), "out_dir": str(drv.out_dir),
                      "views": _traced(drv), "steps": STEPS[kind]})
    path = os.pathsep.join([str(BENCH_DIR), str(ROOT),
                            os.environ.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-m", "harness.recorded", arg],
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=path),
                         capture_output=True, text=True, timeout=1200)
    if out.returncode != 0:
        raise RuntimeError("the recorder's passes failed:\n"
                           + out.stderr[-3000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def _rounds(drv, views: List[int]):
    """A call that runs the views `rounds` times over as the window runs
    them: each frame ending in a synchronisation, train steps back to
    back."""
    if drv.cell.traffic["kind"] == "render":
        def frames(rounds):
            for _ in range(rounds):
                for i in views:
                    drv.frame = i
                    drv._frame()
                    sync(drv.device)
        return frames
    t = drv.trainer
    cams = t.train_cameras()

    def steps(rounds):
        for _ in range(rounds):
            for i in views:
                t.train_step(cams[i], i)
        sync(drv.device)
    return steps


def measure(drv, views: List[int], steps: int) -> dict:
    """Both passes on the set-up driver `drv`; see the module's doc."""
    from mini3dgs_tpu_torch.utils.profiling import recording
    run = _rounds(drv, views)
    rounds = -(-steps // len(views))
    n = rounds * len(views)
    rec = recording(drv.device)
    counted = recording(drv.device, count_syncs=True)
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
    cell = Cell(name=a["name"], chips=a["chips"], config=a["config"],
                traffic=a["traffic"], limits={}, end_to_end=[],
                per_layer=[], readers={},
                driver=load_driver(a["traffic"]["kind"]))
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
