"""Why `bench_torch.py`'s headline moves from run to run (GPU only).

The bench step is launch-bound: the card is busy for about a third of the
slope, and the host's time to issue the step's ~960 launches sets the
rest.  This script builds the headline chain once (800^2, 100,000
Gaussians in 2^17 slots, `bench_torch.build`) and, for --reps rounds,
takes one slope pair as `bench_torch.time_step` does (chains of 2 and 12
steps) and beside it what could move it:

- `thread_share`: the launching thread's CPU time over the wall time of
  the pair (below 1 when the thread waited: on the card, on autograd's
  device thread, which runs the backward, or for a core);
- `host_launch_us`: the host's time to launch one one-element kernel
  (`bench_torch.host_launch_us`);
- `python_loop_ns`: the time of one turn of a pure-Python loop that
  touches neither torch nor the card (the host core's own speed);
- the load average, the cores this process may use, the mean `cpu MHz`
  of /proc/cpuinfo, and the card's SM clock, power draw and temperature
  (nvidia-smi) after the pair.

Then the device time of one step under the profiler
(`bench_torch.device_busy`).  The last line is one JSON object: the rows,
their medians, and the correlation of the slope with each host figure.

Usage:  python3 scripts/bench_swing_torch.py [--reps 6] [--output F.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def python_loop_ns(n: int = 200_000) -> float:
    """Nanoseconds a turn of a fixed pure-Python loop takes."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(n):
        acc += i & 7
    return (time.perf_counter() - t0) / n * 1e9


def cpu_mhz() -> float | None:
    """Mean of the `cpu MHz` lines of /proc/cpuinfo, where it has them."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return None
    mhz = [float(l.split(":")[1]) for l in lines if l.startswith("cpu MHz")]
    return float(np.mean(mhz)) if mhz else None


def card_state(index: int) -> dict:
    """The card's SM clock (MHz), power draw (W) and temperature (C)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits", "-i", str(index)],
        check=True, capture_output=True, text=True).stdout
    sm, draw, temp = (float(x) for x in out.strip().split(","))
    return {"sm_mhz": sm, "power_draw_w": draw, "temp_c": temp}


def main(argv=None) -> int:
    import bench_torch as B

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--output", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_swing_torch: needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    chain = B.build(device=dev)
    k1, k2 = 2, 12
    for iters in (k1, k2):
        chain(0.5, iters)
    rows = []
    for j in range(args.reps):
        w0, c0 = time.perf_counter(), time.thread_time()
        chain(0.1 + 0.01 * j, k1)
        w1 = time.perf_counter()
        chain(0.2 + 0.01 * j, k2)
        w2, c2 = time.perf_counter(), time.thread_time()
        slope_ms = ((w2 - w1) - (w1 - w0)) / (k2 - k1) * 1e3
        rows.append({
            "slope_ms": slope_ms,
            "mpix_s": 800 * 800 / slope_ms / 1e3,
            "thread_share": (c2 - c0) / (w2 - w0),
            "host_launch_us": B.host_launch_us(dev),
            "python_loop_ns": python_loop_ns(),
            "loadavg_1m": os.getloadavg()[0],
            "cores": len(os.sched_getaffinity(0)),
            "cpu_mhz": cpu_mhz(),
            **card_state(dev.index or 0)})
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    busy_ms, launches = B.device_busy(chain)
    slope = np.array([r["slope_ms"] for r in rows])
    corr = {}
    for key in ("thread_share", "host_launch_us", "python_loop_ns",
                "loadavg_1m", "sm_mhz"):
        x = np.array([r[key] for r in rows], dtype=float)
        corr[key] = (float(np.corrcoef(slope, x)[0, 1])
                     if len(rows) > 2 and x.std() > 0 else None)
    out = {
        "card": torch.cuda.get_device_name(dev),
        "power_limit_w": B.power_limit_w(dev),
        "cpu_count": os.cpu_count(),
        "rows": rows,
        "median": {k: float(np.median([r[k] for r in rows])) for k in (
            "slope_ms", "mpix_s", "thread_share", "host_launch_us",
            "python_loop_ns", "sm_mhz")},
        "slope_spread_ms": float(slope.max() - slope.min()),
        "device_busy_ms": busy_ms,
        "device_launches": launches,
        "corr_with_slope": corr,
    }
    if args.output is not None:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        args.output.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
