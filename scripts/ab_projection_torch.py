"""Time the projection kernel against the plain chain it replaces, on the
viewer cell's scene.

Runs on a CUDA device.  The projection's counterpart of
scripts/ab_raster_fwd_torch.py: it makes the scene of the benchmark's
`mipnerf360_outdoor` configuration from `--seed` (2,960,000 Gaussians, SH
3, 1237 x 822; `benchmark/harness/scene.py`) and the viewer's orbit, then

- holds `project_fwd` (csrc/project_fwd.cu) against
  `project_gaussians_plain` on `--views` views of the orbit: the rows whose
  `visible`, `depth`, `radius` or extents differ in any bit, the largest
  relative difference of every other field, and the instances binning
  emits from each (`Binning.n_live` at the recipe's tile 32, what the
  benchmark's `instances.render` reads);
- times both in turns (plain, kernel, kernel, plain) on the card's clock: a
  time is the median of `--reps` CUDA-event timings, each over `--inner`
  calls back to back along the orbit, divided by `--inner`; beside it the
  host's time to issue one call (no synchronisation inside);
- sets the kernel's time beside its bound: the 290 bytes a Gaussian reads
  and writes (237 + 53) over 3.35 TB/s, and ptxas' registers and shared
  memory for the SH 3 build.

Prints one JSON object that names the card and its power limit; --output
also writes it to a file.

Usage: python3 scripts/ab_projection_torch.py [--seed 7] [--output F]
"""

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "benchmark"))

from harness import scene  # noqa: E402
from mini3dgs_tpu_torch.core.camera import Camera  # noqa: E402
from mini3dgs_tpu_torch.core.gaussians import Gaussians  # noqa: E402
from mini3dgs_tpu_torch.ops import binning  # noqa: E402
from mini3dgs_tpu_torch.ops import projection as pj  # noqa: E402
from mini3dgs_tpu_torch.ops import raster_cuda as rc  # noqa: E402

BYTES_PER_GAUSSIAN = 237 + 53
HBM_BYTES_PER_S = 3.35e12
EXACT = ("visible", "depth", "radius", "ext_x", "ext_y")
TILE = 32  # configs/sdf_tex_30k.yaml, the cell's recipe


def card() -> dict:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    name, limit = out[0].split(", ") if out else ("unknown", "unknown")
    return {"device": name, "power_limit": limit, "torch": torch.__version__}


def ptxas(log: str, degree: int = 3) -> str:
    """ptxas' report of the project_fwd build of `degree`."""
    tag = f"project_fwd_kernelILi{degree}E"
    lines = log.splitlines()
    for k, line in enumerate(lines):
        if "Compiling entry function" in line and tag in line:
            for nxt in lines[k + 1:k + 4]:
                if "Used" in nxt:
                    return re.sub(r"^ptxas info\s*:\s*", "", nxt).strip()
    return "not in the build log (the library was reused)"


def parity(cams, g, kw) -> dict:
    worst = {"instances": []}
    for cam in cams:
        got = pj.project_fwd(g, cam, **kw)
        want = pj.project_gaussians_plain(g, cam, **kw)
        worst["instances"].append(
            [int(binning.bin_gaussians(p, cam.height, cam.width, TILE).n_live)
             for p in (got, want)])
        for f in pj.Projected._fields:
            a, b = getattr(got, f), getattr(want, f)
            if f in EXACT:
                if f != "visible":
                    a, b = a.view(torch.int32), b.view(torch.int32)
                rows = (a != b).reshape(a.shape[0], -1).any(-1)
                v = int(rows.sum())
                worst[f + "_rows_differing"] = max(
                    worst.get(f + "_rows_differing", 0), v)
            else:
                rel = ((a - b).abs() / b.abs().clamp(min=1e-30))
                v = float(torch.nan_to_num(rel, nan=0.0).max())
                worst[f + "_max_rel"] = max(worst.get(f + "_max_rel", 0.0),
                                            v)
    return worst


def time_turns(fns: dict, cams, reps: int, inner: int) -> dict:
    """Device ms a call of each of `fns`, timed in turns: a, b, b, a."""
    names = list(fns)
    order = names + names[::-1]
    times = {n: [] for n in names}
    host = {n: [] for n in names}
    k = 0
    for n in names:  # warm-up
        fns[n](cams[0])
    torch.cuda.synchronize()
    for n in order:
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            for _ in range(inner):
                fns[n](cams[k % len(cams)])
                k += 1
            host[n].append((time.perf_counter() - t0) * 1e3 / inner)
            end.record()
            end.synchronize()
            times[n].append(start.elapsed_time(end) / inner)
    return {n: {"device_ms": float(np.median(times[n])),
                "device_ms_turns": [float(np.median(times[n][:reps])),
                                    float(np.median(times[n][reps:]))],
                "host_ms": float(np.median(host[n]))} for n in names}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--views", type=int, default=6)
    p.add_argument("--reps", type=int, default=7)
    p.add_argument("--inner", type=int, default=10)
    p.add_argument("--output", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ab_projection_torch.py times the card: no CUDA "
                           "device here")
    dev = torch.device("cuda")
    bench = ROOT / "benchmark"
    config = json.loads((bench / "configs/mipnerf360_outdoor.json")
                        .read_text())
    mix = json.loads((bench / "traffic/render.json").read_text())
    params = scene.make_gaussians(config, args.seed, dev)
    n = params["xyz"].shape[0]
    g = Gaussians(**params, alive=torch.ones(n, dtype=torch.bool,
                                             device=dev))
    views = scene.orbit_views(config, mix)
    step = max(1, len(views.poses) // args.views)
    cams = [Camera.create(i, R, T, views.fovx, views.fovy, views.width,
                          views.height, device=dev)
            for i, (R, T) in enumerate(views.poses[::step][:args.views])]
    kw = dict(color_mode="sh", sh_degree=int(config["settings"]
                                              ["sh_degree"]))
    built = rc.kernel_library()
    with torch.no_grad():
        check = parity(cams, g, kw)
        turns = time_turns(
            {"plain": lambda c: pj.project_gaussians_plain(g, c, **kw),
             "kernel": lambda c: pj.project_fwd(g, c, **kw)},
            cams, args.reps, args.inner)
    bound_ms = BYTES_PER_GAUSSIAN * n / HBM_BYTES_PER_S * 1e3
    result = {**card(), "gaussians": n, "views": len(cams),
              "bound_ms": bound_ms,
              "kernel_ms": turns["kernel"]["device_ms"],
              "plain_ms": turns["plain"]["device_ms"],
              "roofline_pct": 100.0 * bound_ms
              / turns["kernel"]["device_ms"],
              "turns": turns, "parity": check,
              "ptxas_sh3": ptxas(built.build_log),
              "build_seconds": built.build_seconds}
    line = json.dumps(result)
    print(line)
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(line + "\n")
    return result


if __name__ == "__main__":
    main()
