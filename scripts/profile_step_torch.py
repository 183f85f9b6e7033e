"""Where one full-width train step of the PyTorch port spends its time.

Runs on a CUDA device, on the flagship scene (100,000 Gaussians in a 2^17
pool, SH 3, 800x800, tile 32, bench view).  Whole steps of
`trainer.train_step` are timed on the host clock with a synchronise after
each, and then run again under `torch.profiler`.  The step marks its stages
with `record_function` ranges ("3dgs:projection", ...); from the trace come,
per step:

- each stage's device time and kernel launches (the kernels launched inside
  its range) and its host time under the profiler.  Autograd's backward runs
  on its own thread, outside the ranges, so its two halves are read off the
  device's timeline: what runs between the forward and the backward raster
  kernel and is neither epilogue nor loss is the backward of loss and
  epilogue, and what runs after the backward raster kernel and belongs to
  no range is the backward of pack and projection;
- the device's busy time, and its busy share twice: over the traced window
  itself (the union of the kernels' intervals over the span from the first
  kernel's start to the last one's end; the profiler slows the host, so this
  is a lower bound) and over the unprofiled steps (busy time over the
  slowest, the median and the fastest step).

With --tile-shards N (and --ring) the step is the band-sharded one of
parallel/sharded.py over N ranks on the one card, and the pool holds
--capacity slots (the ring needs a capacity that divides by N: 131075 for
N = 5).  Its ranges ("3dgs:ring_ranks", "3dgs:ring_reshard" of ring v2 /
v3, "3dgs:ring_origin", "3dgs:ring_exchange", "3dgs:ring_raster", ...) are
read the same way, each with the raster
kernels it launches; what the device runs outside every range is autograd's
backward of everything but the raster.

Last, as many steps again with no profiler under the stage recorder
(`utils/profiling.recording`): each stage's device wall a step, the
backward's too, which the ranges above cannot give, and the recorder's
counters a step: `instances`, the raster launches (`raster_fwd.launches`,
`raster_fwd.launches_t0`, ...) and the mesh's exchange traffic
(`traffic.*`, the ring's bytes and calls).

Prints one JSON object that names the card and its power limit; --output
also writes it to a file.

Usage: python scripts/profile_step_torch.py [--steps 10]
           [--output profile.json] [--tile-shards 5 --ring
           --capacity 131075]
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from mini3dgs_tpu_torch import convert  # noqa: E402
from mini3dgs_tpu_torch.config import TrainingConfig  # noqa: E402
from mini3dgs_tpu_torch.core.gaussians import scene_extent_of  # noqa: E402
from mini3dgs_tpu_torch.ops.renderer import RenderSettings, render  # noqa: E402
from mini3dgs_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from mini3dgs_tpu_torch.parallel.sharded import make_sharded_train_step  # noqa: E402
from mini3dgs_tpu_torch.train import trainer  # noqa: E402
from mini3dgs_tpu_torch.utils.profiling import recording  # noqa: E402

SIZE, N, CAPACITY, TILE = 800, 100_000, 2 ** 17, 32
RANGES = ("projection", "binning", "pack", "raster_fwd", "epilogue", "loss",
          "backward", "raster_bwd", "adam", "statistics")


RASTER_KERNELS = {"raster_fwd": "raster_fwd_kernel",
                  "raster_bwd": "raster_bwd_kernel"}


def _launched(event):
    """The kernels (name, duration in us) launched inside a host event,
    apart from the two raster kernels, which have rows of their own."""
    for k in event.kernels:
        if not any(r in k.name for r in RASTER_KERNELS.values()):
            yield k
    for child in event.cpu_children:
        yield from _launched(child)


def analyse(events, steps: int) -> dict:
    """Per-step stage and device figures from a profiler's `events()`."""
    from torch.autograd import DeviceType
    stages = {r: dict(device_ms=0.0, launches=0.0, host_ms_profiled=0.0)
              for r in RANGES}
    for e in events:
        name = e.name[5:] if e.name.startswith("3dgs:") else None
        if name in stages and e.device_type == DeviceType.CPU:
            launched = list(_launched(e))
            stages[name]["device_ms"] += sum(
                k.duration for k in launched) / 1e3 / steps
            stages[name]["launches"] += len(launched) / steps
            stages[name]["host_ms_profiled"] += e.cpu_time_total / 1e3 / steps

    # Kernels, copies and fills; the ranges' own device-side annotations
    # are no work.
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and not e.name.startswith("3dgs:")),
                     key=lambda e: e.time_range.start)
    # Zones of the device's timeline, cut at the two raster kernels.
    zones = {z: dict(device_ms=0.0, launches=0.0)
             for z in ("fwd_to_bwd", "bwd_to_fwd")}
    raster = {r: dict(device_ms=0.0, launches=0.0) for r in RASTER_KERNELS}
    zone, by_name, busy_us, covered_us = "bwd_to_fwd", {}, 0.0, 0.0
    end = kernels[0].time_range.start if kernels else 0.0
    for k in kernels:
        start, stop = k.time_range.start, k.time_range.end
        busy_us += stop - start
        covered_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        row = by_name.setdefault(k.name, [0.0, 0])
        row[0] += stop - start
        row[1] += 1
        here = zones[zone]
        if RASTER_KERNELS["raster_fwd"] in k.name:
            zone, here = "fwd_to_bwd", raster["raster_fwd"]
        elif RASTER_KERNELS["raster_bwd"] in k.name:
            zone, here = "bwd_to_fwd", raster["raster_bwd"]
        here["device_ms"] += (stop - start) / 1e3 / steps
        here["launches"] += 1 / steps
    window_us = (end - kernels[0].time_range.start) if kernels else 0.0

    def rest(zone_name, inside):
        """What the zone holds beyond the ranges `inside`."""
        return {k: zones[zone_name][k] - sum(stages[r][k] for r in inside)
                for k in ("device_ms", "launches")}
    # The backward range lives on the calling thread and launches nothing.
    stages["backward"] = dict(
        host_ms_profiled=stages["backward"]["host_ms_profiled"])
    # A raster wrapper's range checks, copies and fills run before its
    # kernel, so they lie in the zone that ends there.
    stages["backward of loss + epilogue"] = rest(
        "fwd_to_bwd", ("epilogue", "loss", "raster_bwd"))
    stages["backward of pack + projection"] = rest(
        "bwd_to_fwd", ("projection", "binning", "pack", "raster_fwd", "adam",
                       "statistics"))
    for r in RASTER_KERNELS:
        stages[f"{r} wrapper"] = stages.pop(r)
        stages[f"{r} kernel"] = raster[r]
    stages["sum"] = {k: sum(v.get(k, 0.0) for v in stages.values())
                     for k in ("device_ms", "launches")}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "stages": stages,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "kernel_launches_per_step": len(kernels) / steps,
        "traced_window_ms_per_step": window_us / 1e3 / steps,
        "device_busy_share_of_traced_window":
            covered_us / window_us if window_us else 0.0,
        "top_kernels_ms_per_step": [
            {"name": name[:80], "ms": us / 1e3 / steps,
             "calls_per_step": n / steps} for name, (us, n) in top]}


SHARDED_RANGES = ("projection", "ring_ranks", "ring_reshard", "ring_origin",
                  "ring_exchange", "ring_raster", "binning", "pack",
                  "raster_fwd", "epilogue", "loss", "backward", "raster_bwd",
                  "adam", "statistics")


def analyse_sharded(events, steps: int) -> dict:
    """Per-step figures of the sharded step: every range with the kernels
    launched inside it, the raster kernels in rows of their own (by build),
    and what else the device runs outside every range: autograd's backward
    of everything but the raster."""
    from torch.autograd import DeviceType
    stages = {}
    for e in events:
        name = e.name[5:] if e.name.startswith("3dgs:") else None
        if name in SHARDED_RANGES and e.device_type == DeviceType.CPU:
            row = stages.setdefault(name, dict(
                device_ms=0.0, launches=0.0, host_ms_profiled=0.0,
                calls=0.0))
            launched = list(_launched(e))
            row["device_ms"] += sum(k.duration for k in launched) / 1e3 / steps
            row["launches"] += len(launched) / steps
            row["host_ms_profiled"] += e.cpu_time_total / 1e3 / steps
            row["calls"] += 1 / steps
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and not e.name.startswith("3dgs:")),
                     key=lambda e: e.time_range.start)
    by_name, busy_us, covered_us = {}, 0.0, 0.0
    end = kernels[0].time_range.start if kernels else 0.0
    for k in kernels:
        start, stop = k.time_range.start, k.time_range.end
        busy_us += stop - start
        covered_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        row = by_name.setdefault(k.name, [0.0, 0])
        row[0] += stop - start
        row[1] += 1
    window_us = (end - kernels[0].time_range.start) if kernels else 0.0
    for name, (us, n) in by_name.items():
        for wrapper, kernel in RASTER_KERNELS.items():
            if kernel in name:
                build = "with t0" if "true>" in name else "without t0"
                stages[f"{wrapper} kernel {build}"] = {
                    "device_ms": us / 1e3 / steps, "launches": n / steps}
    accounted = {k: sum(v[k] for v in stages.values())
                 for k in ("device_ms", "launches")}
    stages["backward outside the ranges"] = {
        "device_ms": busy_us / 1e3 / steps - accounted["device_ms"],
        "launches": len(kernels) / steps - accounted["launches"]}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "stages": stages,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "kernel_launches_per_step": len(kernels) / steps,
        "traced_window_ms_per_step": window_us / 1e3 / steps,
        "device_busy_share_of_traced_window":
            covered_us / window_us if window_us else 0.0,
        "top_kernels_ms_per_step": [
            {"name": name[:80], "ms": us / 1e3 / steps,
             "calls_per_step": n / steps} for name, (us, n) in top]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--output", type=Path, default=None)
    p.add_argument("--tile-shards", type=int, default=1)
    p.add_argument("--ring", action="store_true")
    p.add_argument("--capacity", type=int, default=CAPACITY)
    args = p.parse_args(argv)
    capacity = args.capacity
    sharded = args.tile_shards > 1 or args.ring
    if not torch.cuda.is_available():
        raise SystemExit("profile_step_torch: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]

    params, alive, cam = convert.flagship_scene_numpy(capacity, N, seed=0)
    t_params, t_alive, _ = convert.flagship_scene_numpy(capacity, N, seed=7)
    t_params["features_rest"][:N] = np.random.default_rng(1).normal(
        0.0, 0.1, (N, 15, 3))
    camera = convert.camera_from_numpy(**cam, width=SIZE, height=SIZE,
                                       device=dev)
    settings = RenderSettings(image_height=SIZE, image_width=SIZE,
                              bg_color=(1.0, 1.0, 1.0), tile_size=TILE,
                              color_mode="sh", sh_degree=3)
    with torch.no_grad():
        target = render(convert.gaussians_from_numpy(t_params, t_alive, dev),
                        camera, settings)["image"]
    camera = camera.replace(image=target)
    g = convert.gaussians_from_numpy(params, alive, dev)
    config = trainer.scale_position_lr(TrainingConfig(
        image_height=SIZE, image_width=SIZE, tile_size=TILE, color_mode="sh",
        sh_degree=3, capacity=capacity, background_color=[1.0, 1.0, 1.0]),
        float(scene_extent_of(g)))

    if sharded:
        sharded_step = make_sharded_train_step(
            config, settings.replace(ring=args.ring),
            make_mesh(1, args.tile_shards, devices=[dev]))
        step = lambda st: sharded_step(st, [camera])
    else:
        step = lambda st: trainer.train_step(st, camera, config, settings)
    state = trainer.create_train_state(g, config)
    for _ in range(3):  # warm-up
        state, metrics = step(state)
    torch.cuda.synchronize()
    step_ms = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        state, metrics = step(state)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, metrics = step(state)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    traced = (analyse_sharded if sharded else analyse)(prof.events(),
                                                       args.steps)
    with recording(dev) as rec:
        for _ in range(args.steps):
            state, metrics = step(state)
    recorded = {"stage_wall_ms": {n: r["wall_ms"] for n, r in
                                  rec.summary(args.steps).items()},
                "counters": rec.counters(args.steps)}
    busy = traced["device_busy_ms_per_step"]
    result = {
        "card": smi, "device": torch.cuda.get_device_name(0),
        "config": f"{SIZE}^2, {N} Gaussians (pool {capacity}), SH 3, tile "
                  f"{TILE}, bench view" + (
                      f", {args.tile_shards} ranks on one card, "
                      f"{'ring' if args.ring else 'band'} route"
                      if sharded else ""),
        "n_live": metrics["render_instances"],
        "step_ms": {"median": float(np.median(step_ms)),
                    "min": min(step_ms), "max": max(step_ms),
                    "steps": args.steps},
        "step_ms_under_profiler": profiled_ms,
        "device_busy_share_of_step": {
            "of_slowest": busy / max(step_ms),
            "of_median": busy / float(np.median(step_ms)),
            "of_fastest": busy / min(step_ms)},
        **traced, "recorder": recorded}
    if args.output is not None:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        args.output.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
