"""What the stage recorder (`mini3dgs_tpu_torch.utils.profiling.recording`)
costs on a viewer cell of the benchmark: blocks of frames with the
recorder off and on, in turns, each frame timed on the host clock and by a
CUDA event pair around it, as the benchmark's window times `frame_ms` and
`frame_ms_p95`; and the recorder's frame wall (the device wall of each
`render` step) against the event time of the same frame.  The idle by
stage is the benchmark's to read (`benchmark/harness/recorded.py`).

    python3 scripts/recorder_cost_torch.py --out build/recorder_cost.json

With `--device cpu --gaussians 2000 --size 64 48 --rounds 2 --frames 2` a
smoke run on the CPU (host times only).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "benchmark"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from mini3dgs_tpu_torch.utils import profiling  # noqa: E402


def _frames(drv, n, rec=None):
    """n frames, each ending in a synchronisation, inside the recording
    `rec` if one is given: (host ms, event ms) of each."""
    cuda = drv.device.type == "cuda"
    host, marks = [], []
    with rec or contextlib.nullcontext():
        for _ in range(n):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            drv._frame()
            if cuda:
                ev[1].record()
                marks.append(ev)
                torch.cuda.synchronize()
            host.append(1e3 * (time.perf_counter() - t0))
    return host, [a.elapsed_time(b) for a, b in marks]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="mipnerf360_outdoor.render")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 1515)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--gaussians", type=int)
    ap.add_argument("--size", type=int, nargs=2)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from harness import env, spec

    device = torch.device(args.device)
    cell = spec.load_cell(args.cell)
    cell.config = copy.deepcopy(cell.config)
    if args.gaussians:
        cell.config["n_gaussians"] = args.gaussians
    if args.size:
        cell.config["settings"]["image_width"] = args.size[0]
        cell.config["settings"]["image_height"] = args.size[1]
    drv = cell.driver(cell, args.seed, device,
                      ROOT / "build" / "recorder_cost")
    drv.setup()
    med = statistics.median
    res = {"cell": cell.name, "seed": args.seed, "device": str(device)}
    if device.type == "cuda":
        res["card"] = env.card_state(device.index or 0)
        res["host_launch_us"] = env.host_launch_us(device)
    blocks = {False: ([], []), True: ([], [])}
    walls, events_on = [], []
    for _ in range(args.rounds):
        for on in (False, True):
            rec = profiling.recording(device) if on else None
            host, ev = _frames(drv, args.frames, rec)
            blocks[on][0].extend(host)
            blocks[on][1].extend(ev)
            if on and ev:
                walls.extend((s.d1 - s.d0) / 1e6 for s in rec.spans
                             if s.name == "render")
                events_on.extend(ev)
    for on, (host, ev) in blocks.items():
        key = "on" if on else "off"
        res[f"host_ms_{key}"] = med(host)
        if ev:
            res[f"event_ms_{key}"] = med(ev)
    if walls:
        res["recorder_frame_wall_ms"] = med(walls)
        res["wall_over_event"] = med(w / e for w, e in zip(walls, events_on))
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return res


if __name__ == "__main__":
    main()
