"""The readings that a cell's limits are set from (not part of a run).

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 13 ...
        [--controls 3] [--out FILE]

A cell of BENCHMARK.json or of `held_out.json`.  For each seed, in one
process: the cell's set-up as a run makes it, then what its driver's
`check_run` adds before the checked outputs all exist (for the viewer a
short window at the cell's own load, long enough to keep every checked
frame; a train cell's checked steps are part of its set-up), then the
plain reference and the numbers `correct` compares: the program's
readings, from which the lower end of each limit comes, with what the
driver's `calibration` adds (for a train cell each leaf's change, the
program's over the reference's).  On the first `--controls` seeds also
the driver's `controls`: the control, the reference itself put in the
program's place and computed in bfloat16, the precision below the
configuration's float32, and the faults that the driver plants (for a
train cell half the batch left out).  One JSON line a seed, then one of
the largest program reading and the smallest reading of the control and
of each fault, for each number.  A step that returns its state unchanged
reads 1 in `change_gap` by definition, and needs no run.
"""

import argparse
import json
import sys
import time

import torch

import run as bench_run
from harness import env
from harness.spec import load_cell, with_held_out


def readings(cell, seed: int, device, control: bool,
             window_s: float) -> dict:
    drv = cell.driver(cell, seed, device,
                      bench_run.ROOT / "build" / "cal_out")
    t0 = time.perf_counter()
    drv.setup()
    drv.check_run(window_s)
    drv.release()
    ref = drv.reference()
    out = {"seed": seed, "setup_s": time.perf_counter() - t0,
           "program": drv.numbers(ref), **drv.calibration(ref)}
    if control:
        out["upper"] = drv.controls(ref)
    out["seconds"] = time.perf_counter() - t0
    return out


def _pick(pick, rows: list) -> dict:
    """Of each number, the `pick` of its readings over `rows`."""
    return {k: pick(r[k] for r in rows) for k in rows[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--window", type=float, default=4.0,
                    help="seconds of the window of `check_run`, where "
                    "the driver takes one")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench_run._paths()
    env.set_cache_dirs(bench_run.ROOT)
    cell = load_cell(args.workload, with_held_out())
    device = torch.device("cuda", 0)
    rows = []
    for i, seed in enumerate(args.seeds):
        rows.append(readings(cell, seed, device, i < args.controls,
                             args.window))
        print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": args.workload, "card": env.card_state(),
               "program": _pick(max, [r["program"] for r in rows])}
    uppers = [r["upper"] for r in rows if "upper" in r]
    for part in (uppers[0] if uppers else ()):
        summary[part] = _pick(min, [u[part] for u in uppers])
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
