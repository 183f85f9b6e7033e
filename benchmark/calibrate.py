"""The readings that a cell's limits are set from (not part of a run).

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 13 ...
        [--controls 3] [--out FILE]

A cell of BENCHMARK.json or of `held_out.json`.  For each seed, in one
process: the cell's set-up as a run makes it (for a train cell the
checked steps of the timed trainer; for the viewer a short window at the
cell's own load, long enough to keep every checked frame), then the plain
reference and the numbers `correct` compares: the program's readings,
from which the lower end of each limit comes (for a train cell also each
leaf's change, the program's over the reference's).  On
the first `--controls` seeds also the control, the reference itself put
in the program's place and computed in bfloat16, the precision below the
configuration's float32; and for a train cell the fault of half the batch
left out (the loss's mean taken over the image's top half of rows, in the
reference put in the program's place).  One JSON line a seed, then one of
the largest program reading and the smallest control and fault reading of
each number.  A step that returns its state unchanged reads 1 in
`change_gap` by definition, and needs no run.
"""

import argparse
import json
import sys
import time

import torch

import run as bench_run
from harness import check, env
from harness.spec import load_cell, with_held_out


def half_batch_loss(image, target, lambda_dssim):
    """The loss over the image's top half of rows only."""
    from reference.train import photometric_loss
    h = image.shape[1] // 2
    return photometric_loss(image[:, :h], target[:, :h], lambda_dssim)


def readings(cell, seed: int, device, control: bool,
             window_s: float) -> dict:
    drv = cell.driver(cell, seed, device,
                      bench_run.ROOT / "build" / "cal_out")
    t0 = time.perf_counter()
    drv.setup()
    if cell.traffic["kind"] == "render":
        drv.window(window_s)
    drv.release()
    ref = drv.reference()
    out = {"seed": seed, "setup_s": time.perf_counter() - t0,
           "program": drv.numbers(ref)}
    if cell.traffic["kind"] == "train":
        # each leaf's change over the checked steps, the program's over the
        # reference's: a rate that departs shows as its ratio
        out["change_ratio"] = {k: drv.program["change"][k] / v
                               for k, v in ref["change"].items()}
    if control:
        if cell.traffic["kind"] == "render":
            low = drv.reference(torch.bfloat16)
            out["control"] = check.render_numbers(
                [low[k] for k in sorted(ref)], [ref[k] for k in sorted(ref)])
        else:
            out["control"] = check.train_numbers(
                drv.reference(torch.bfloat16), ref)
            out["half_batch"] = check.train_numbers(
                drv.reference(loss_fn=half_batch_loss), ref)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--window", type=float, default=4.0,
                    help="seconds of the viewer's window")
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
    summary = {"workload": args.workload, "card": env.card_state()}
    for part, pick in (("program", max), ("control", min),
                       ("half_batch", min)):
        got = [r[part] for r in rows if part in r]
        if got:
            summary[part] = {k: pick(g[k] for g in got) for k in got[0]}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
