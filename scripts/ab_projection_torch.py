"""Time the projection kernels against the plain chain they replace: P1
on the viewer cell's scene, or P1 and P2 with the chain's backward on the
train-step cell's.

Runs on a CUDA device.  The projection's counterpart of
scripts/ab_raster_fwd_torch.py.  By default it makes the scene of the
benchmark's `mipnerf360_outdoor` configuration from `--seed` (2,960,000
Gaussians, SH 3, 1237 x 822; `benchmark/harness/scene.py`) and the viewer's
orbit, then

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

With `--backward` it makes the `mipnerf360_outdoor_3dgs` configuration's
Gaussians from `--seed` in the train-step cell's pool (4,194,304 slots, the
rest dead, as the trainer's capacity rule makes it), projects them from
the cell's first training view, and takes the cotangents of the
projection's fields from one real backward through binning, B1, the loss
(L1 + 0.2 D-SSIM against the render of the second view) and B2.  Then it

- holds P2 (`project_bwd`) against `project_bwd_plain` on those
  cotangents: each gradient's distance from the plain one by its norm;
- times in turns (chain, kernels, kernels, chain) the chain's forward and
  `torch.autograd.grad` against `project_gaussians` through its one op
  (P1, then P2 inside the same `autograd.grad`), and P2
  alone, against P2's bound: 513 bytes a Gaussian (237 + 40 in, 236 out)
  over 3.35 TB/s; with ptxas' report of P2's SH 3 build.

Prints one JSON object that names the card and its power limit; --output
also writes it to a file.

Usage: python3 scripts/ab_projection_torch.py [--seed 7] [--backward]
           [--output F]
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
from mini3dgs_tpu_torch.ops import cuda_library as cl  # noqa: E402
from mini3dgs_tpu_torch.ops import projection as pj  # noqa: E402
from mini3dgs_tpu_torch.ops import raster_cuda as rc  # noqa: E402

BYTES_PER_GAUSSIAN = 237 + 53
BWD_BYTES_PER_GAUSSIAN = 237 + 40 + 236
STEPS_POOL = 1 << 22  # the train-step cell's pool (PERF.md section 4)
HBM_BYTES_PER_S = 3.35e12
EXACT = ("visible", "depth", "radius", "ext_x", "ext_y")
TILE = 32  # configs/sdf_tex_30k.yaml, the cell's recipe


def card() -> dict:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    name, limit = out[0].split(", ") if out else ("unknown", "unknown")
    return {"device": name, "power_limit": limit, "torch": torch.__version__}


def ptxas(log: str, degree: int = 3, kernel: str = "project_fwd") -> str:
    """ptxas' report of the `kernel` build of `degree`."""
    tag = f"{kernel}_kernelILi{degree}E"
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


def forward_turns(args, dev) -> dict:
    """P1 against the chain on the viewer cell's scene and orbit."""
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
    built = cl.kernel_library()
    with torch.no_grad():
        check = parity(cams, g, kw)
        turns = time_turns(
            {"plain": lambda c: pj.project_gaussians_plain(g, c, **kw),
             "kernel": lambda c: pj.project_fwd(g, c, **kw)},
            cams, args.reps, args.inner)
    bound_ms = BYTES_PER_GAUSSIAN * n / HBM_BYTES_PER_S * 1e3
    return {"gaussians": n, "views": len(cams),
            "bound_ms": bound_ms,
            "kernel_ms": turns["kernel"]["device_ms"],
            "plain_ms": turns["plain"]["device_ms"],
            "roofline_pct": 100.0 * bound_ms
            / turns["kernel"]["device_ms"],
            "turns": turns, "parity": check,
            "ptxas_sh3": ptxas(built.build_log),
            "build_seconds": built.build_seconds}


def backward_turns(args, dev) -> dict:
    """`--backward`: P2 against the plain VJP, and P1 + P2 against the
    chain's forward and backward, on the train-step cell's shapes."""
    from mini3dgs_tpu_torch.core.gaussians import empty_gaussians
    from mini3dgs_tpu_torch.core.loss import gaussian_loss

    bench = ROOT / "benchmark"
    config = json.loads((bench / "configs/mipnerf360_outdoor_3dgs.json")
                        .read_text())
    params = scene.make_gaussians(config, args.seed, dev)
    n = params["xyz"].shape[0]
    g = empty_gaussians(STEPS_POOL, dev)
    g = g.with_params({k: torch.cat([params[k], v[n:]])
                       for k, v in g.params().items()})
    g.alive[:n] = True
    views = scene.train_views(config, args.seed, dev, with_targets=False)
    cams = [Camera.create(i, R, T, views.fovx, views.fovy, views.width,
                          views.height, device=dev)
            for i, (R, T) in enumerate(views.poses[:2])]
    cam = cams[0]
    H, W = cam.height, cam.width
    kw = dict(color_mode="sh", sh_degree=int(config["settings"]
                                              ["sh_degree"]))
    bg = torch.zeros(3, device=dev)
    built = cl.kernel_library()
    with torch.no_grad():
        target = rc.rasterize_tiles(pj.project_gaussians(g, cams[1], **kw),
                                    H, W, bg, tile_size=TILE)["image"]
        proj = pj.project_fwd(g, cam, **kw)
    # One backward through binning, B1, the loss and B2 gives the
    # cotangents of the projection's fields.
    fields = {f: getattr(proj, f).clone().requires_grad_(True)
              for f in pj.COTANGENT_FIELDS}
    image = rc.rasterize_tiles(proj._replace(**fields), H, W, bg,
                               tile_size=TILE)["image"]
    loss, _ = gaussian_loss(image, target, 0.2)
    cots = torch.autograd.grad(loss, list(fields.values()))
    del fields, image, loss, proj
    active = sum((t != 0).reshape(t.shape[0], -1).any(-1).long()
                 for t in cots)

    got = pj.project_bwd(g, cam, cots, **kw)
    want = pj.project_bwd_plain(g, cam, cots, **kw)
    check = {k: float((got[k] - want[k]).norm() / want[k].norm())
             for k in got}
    del got, want

    def through(fn):
        def run():
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in g.params().items()}
            p = fn(g.with_params(leaves), cam, **kw)
            torch.autograd.grad([getattr(p, f) for f in pj.COTANGENT_FIELDS],
                                list(leaves.values()), cots)
        return run

    fns = {"chain": through(pj.project_gaussians_plain),
           "kernels": through(pj.project_gaussians)}
    turns = time_turns({k: (lambda c, f=f: f()) for k, f in fns.items()},
                       [cam], args.reps, 1)
    p2 = time_turns({"p2": lambda c: pj.project_bwd(g, cam, cots, **kw)},
                    [cam], args.reps, args.inner)["p2"]
    bound_ms = BWD_BYTES_PER_GAUSSIAN * STEPS_POOL / HBM_BYTES_PER_S * 1e3
    return {"gaussians": n, "rows": STEPS_POOL,
            "rows_with_cotangents": int((active > 0).sum()),
            "p2_rel_err_by_norm": check,
            "chain_fwd_bwd_ms": turns["chain"]["device_ms"],
            "kernels_fwd_bwd_ms": turns["kernels"]["device_ms"],
            "p2_ms": p2["device_ms"], "p2_bound_ms": bound_ms,
            "p2_roofline_pct": 100.0 * bound_ms / p2["device_ms"],
            "turns": {**turns, "p2": p2},
            "ptxas_p2_sh3": ptxas(built.build_log, 3, "project_bwd"),
            "build_seconds": built.build_seconds}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--views", type=int, default=6)
    p.add_argument("--reps", type=int, default=7)
    p.add_argument("--inner", type=int, default=10)
    p.add_argument("--backward", action="store_true",
                   help="P1 + P2 against the chain's forward and backward "
                        "on the train-step cell's shapes")
    p.add_argument("--output", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ab_projection_torch.py times the card: no CUDA "
                           "device here")
    dev = torch.device("cuda")
    if args.backward:
        result = {**card(), **backward_turns(args, dev)}
    else:
        result = {**card(), **forward_turns(args, dev)}
    line = json.dumps(result)
    print(line)
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(line + "\n")
    return result


if __name__ == "__main__":
    main()
