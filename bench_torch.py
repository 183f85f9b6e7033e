"""Benchmark of the PyTorch/CUDA port: the full differentiable render step
on the flagship scene (counterpart of bench.py).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "spread",
"reps", "mgaussians_per_s", "device_busy_ms", "device_launches",
"host_launch_us", "aniso_rotated_mpix_s", the "trained_*" keys, "device",
"power_limit_w"}; timings and progress go to stderr.

Metric: Mpixels/s of a full differentiable render step (projection ->
binning and pack -> the forward tile kernel B1 -> L1 loss against a black
target -> the backward tile kernel B2 -> autograd back to the six
parameter groups), as bench.py defines it: 800x800, tile 32, SH 0
(`dc_sigmoid`), black background, no D-SSIM, no optimizer.  The step is
the port's eager loop as users run it: a host that launches every kernel,
one synchronisation a frame to size its instance stream.  vs_baseline is
the port's golden step (ops/raster_ref.py differentiated by autograd) at
the same size on the same kind of card, `FULL_GOLDEN_S`, over the step.

Runs on the card unless `--device cpu` is given; without a card it
raises.  The CPU run is bench.py's smoke size (64x64, 2,000 Gaussians in
4,096 slots, the kernels' plain versions), with no anisotropic and no
trained line and vs_baseline 1.0.

Beside the slope, which is on the host clock, the card's own share of a
step: `device_busy_ms`, the device time of the kernels of one chain step
under `torch.profiler`, with their `launches`; and `host_launch_us`, the
host time of one launch of a one-element kernel, taken after the
headline's slope (what the host's speed makes of a launch-bound step).

Environment: BENCH_FULL_GOLDEN=1 times the golden step at the headline
size instead of reading `FULL_GOLDEN_S`; BENCH_SKIP_TRAINED=1 skips the
trained line.

Usage:  python3 bench_torch.py [--device cpu] [--trained-config YAML]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

# The port's golden step at the headline size (800^2, 100,000 Gaussians in
# 2^17 slots, tile 32, SH 0), one step after one warm step, through
# `build(raster="golden")` (the golden's default pixel block, 65,536; the
# 196 chunks of 512 that hold the visible Gaussians); peak 3.05 GiB.
FULL_GOLDEN_S = 26.181
FULL_GOLDEN_SOURCE = ("measured with BENCH_FULL_GOLDEN=1 on an NVIDIA H100 "
                      "80GB HBM3 at a 700.00 W power limit (nvidia-smi), "
                      "2026-10-17")

METRIC = "fwd+bwd render Mpixels/s/chip (800x800, 100K gaussians)"


def _device(device) -> torch.device:
    """The card unless the caller names a device; without a card that is
    an error, never a fallback to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_torch: no CUDA device is visible "
                           "(torch.cuda.is_available() is False); pass "
                           "--device cpu to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def make_chain(g, cam, settings, target):
    """`chain(s, iters)`: `iters` gradient steps of the bench loss
    |render - target|.mean() with respect to all six parameter groups (as
    `jax.grad` of the params dict), each on xyz perturbed by the carried
    scalar c, which each step's gradient feeds: the steps run one after
    another on the card.  Returns float(c), the loop's one wait for the
    device."""
    from mini3dgs_tpu_torch.ops.renderer import render

    params0 = {k: v.detach() for k, v in g.params().items()}
    names = list(params0)

    def chain(s: float, iters: int) -> float:
        c = torch.tensor(s, dtype=torch.float32, device=target.device)
        for i in range(iters):
            leaves = {**params0, "xyz": params0["xyz"] * (1.0 + c * 1e-9)}
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in leaves.items()}
            out = render(g.with_params(leaves), cam, settings)
            loss = (out["image"] - target).abs().mean()
            grads = dict(zip(names, torch.autograd.grad(
                loss, [leaves[k] for k in names], allow_unused=True,
                materialize_grads=True)))
            c = grads["xyz"].sum() * 1e-12 + c + 1e-6 * i
        return float(c)

    return chain


def build(width=800, height=800, n=100_000, capacity=2 ** 17, seed=0,
          raster="tiles", aniso=False, device=None):
    """The chain of the flagship scene (`convert.flagship_scene_numpy`,
    the numpy scene of `__graft_entry__._scene`) at bench.py's settings:
    tile 32, SH 0 (`dc_sigmoid`), black background, a zero target.
    `raster` "tiles" is bench.py's `use_pallas=True`, "golden" its False.
    `aniso` adds [0.45, -1.1, -1.1] to every slot's log-scale (rotated,
    strongly anisotropic splats, as bench.py does).  bench.py's
    `max_instances`, `gaussian_chunk` and `max_dup_per_axis` have no
    counterpart: the port sizes its instance stream to each frame and
    drops nothing."""
    from mini3dgs_tpu_torch import convert
    from mini3dgs_tpu_torch.ops.renderer import RenderSettings

    dev = _device(device)
    params, alive, cam = convert.flagship_scene_numpy(capacity, n, seed)
    if aniso:
        params["scaling"] = params["scaling"] + np.array(
            [0.45, -1.1, -1.1], np.float32)[None, :]
    g = convert.gaussians_from_numpy(params, alive, dev)
    camera = convert.camera_from_numpy(**cam, width=width, height=height,
                                       device=dev)
    settings = RenderSettings(image_height=height, image_width=width,
                              tile_size=32, raster=raster)
    target = torch.zeros(3, height, width, device=dev)
    return make_chain(g, camera, settings, target)


def build_trained(config_yaml="configs/sdf_tex_30k.yaml"):
    """The chain of a trained checkpoint: the latest checkpoint under the
    config's output path, loaded through `GaussianTrainer` (setup, then
    load_checkpoint), its pool compacted,
    train camera 0 and its image as the target, at the active SH degree.
    Returns (chain, info), or (None, {"error": ...}) without a checkpoint.

    One render of the camera reports the stream's instances, the large
    splats and the drops (0: the port drops nothing).  bench.py's probe
    also sized `max_instances` and `large_capacity` from it; the port has
    neither knob, so `trained_max_instances` and `trained_large_capacity`
    are not reported."""
    from mini3dgs_tpu_torch.config import ConfigManager
    from mini3dgs_tpu_torch.core.gaussians import compact
    from mini3dgs_tpu_torch.ops.renderer import render
    from mini3dgs_tpu_torch.train.checkpoint import latest_checkpoint_iteration
    from mini3dgs_tpu_torch.train.trainer import GaussianTrainer

    config = ConfigManager.load_from_yaml(config_yaml)
    it = latest_checkpoint_iteration(config.output_path)
    if it is None:
        return None, {"error": f"no checkpoint under {config.output_path}"}
    config = dataclasses.replace(config, verify_sharding=False)
    trainer = GaussianTrainer(config)
    # The trainer reports on stdout; the bench's stdout is its JSON line.
    with contextlib.redirect_stdout(sys.stderr):
        trainer.setup()
        trainer.load_checkpoint(it)
    g = trainer.state.gaussians
    cap0 = g.capacity
    # Per-Gaussian stages scale with the pool's capacity; compacting it
    # leaves the render unchanged.
    g = compact(g)
    cam = trainer.train_cameras()[0].replace(uid=0, image_name="")
    settings = trainer.settings.replace(sh_degree=trainer.active_sh_degree())
    with torch.no_grad():
        probe = render(g, cam, settings)
    info = {"checkpoint_iteration": it,
            "trained_capacity": int(g.capacity),
            "trained_capacity_raw": int(cap0),
            "n_alive": int(g.num_alive()),
            "trained_instances": int(probe["n_live"]),
            "trained_n_large": int(probe["n_large"]),
            "trained_n_dropped": int(probe["n_dropped"]),
            "height": cam.height, "width": cam.width}
    return make_chain(g, cam, settings, cam.image), info


def time_step(chain, k1=2, k2=12, reps=3):
    """Per-step time as the slope between k1- and k2-step chains on the
    host clock, in `reps` interleaved pairs, after one run of each length
    (the kernels' build and the allocator's growth stay outside).
    Returns (median, spread, reps): spread = max - min of the slopes."""
    for iters in (k1, k2):
        chain(0.5, iters)
    pers = []
    for j in range(reps):
        t0 = time.perf_counter()
        chain(0.1 + 0.01 * j, k1)
        t1 = time.perf_counter()
        chain(0.2 + 0.01 * j, k2)
        t2 = time.perf_counter()
        pers.append(((t2 - t1) - (t1 - t0)) / (k2 - k1))
    return float(np.median(pers)), float(max(pers) - min(pers)), reps


def device_busy(chain, steps=2):
    """(device ms, kernel launches) of one chain step: the kernels, copies
    and fills of `steps` steps under `torch.profiler`, over `steps`.  The
    `3dgs:*` ranges the profiler also puts on the device's timeline are
    not device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        chain(0.3, steps)
    work = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith("3dgs:")]
    busy_us = sum(e.time_range.end - e.time_range.start for e in work)
    return busy_us / 1e3 / steps, len(work) / steps


def host_launch_us(dev: torch.device, n=2000) -> float:
    """Host microseconds a launch of a one-element kernel takes: n
    launches on the host clock, the card idle before and far ahead of
    the host throughout."""
    x = torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    t1 = time.perf_counter()
    torch.cuda.synchronize(dev)
    return (t1 - t0) / n * 1e6


def power_limit_w(dev: torch.device) -> float:
    """The card's power limit in watts, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit",
         "--format=csv,noheader,nounits", "-i", str(dev.index or 0)],
        check=True, capture_output=True, text=True).stdout
    return float(out.strip().splitlines()[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", type=str, default=None,
                    help="cpu for the smoke size on the CPU; default the "
                         "card")
    ap.add_argument("--trained-config", type=str,
                    default="configs/sdf_tex_30k.yaml",
                    help="the config whose output path holds the trained "
                         "line's checkpoint")
    args = ap.parse_args(argv)
    dev = _device(args.device)
    on_card = dev.type == "cuda"
    width = height = 800 if on_card else 64
    n = 100_000 if on_card else 2_000
    chain = build(width=width, height=height, n=n,
                  capacity=2 ** 17 if on_card else 4096, device=dev)
    if on_card:
        dt, dt_spread, reps = time_step(chain)
    else:
        dt, dt_spread, reps = time_step(chain, k1=1, k2=3, reps=1)
    mpix_s = width * height / dt / 1e6
    # the slopes' spread in throughput units
    spread_mpix = (width * height / 1e6) * dt_spread / (dt * dt)
    print(f"headline: {dt * 1e3:.3f} ms/step ({mpix_s:.3f} Mpix/s, spread "
          f"{spread_mpix:.3f}) on {dev}", file=sys.stderr)
    busy_ms = launches = launch_us = None
    if on_card:
        launch_us = host_launch_us(dev)
        busy_ms, launches = device_busy(chain)
        print(f"headline step on the card: busy {busy_ms:.3f} ms in "
              f"{launches:.0f} launches ({100 * busy_ms / (dt * 1e3):.1f} % "
              f"of the slope); the host takes {launch_us:.2f} us a launch",
              file=sys.stderr)

    aniso_mpix_s = None
    if on_card:
        a_chain = build(width=width, height=height, aniso=True, device=dev)
        a_dt, _, _ = time_step(a_chain, k1=2, k2=10, reps=2)
        aniso_mpix_s = width * height / a_dt / 1e6
        print(f"anisotropic variant: {a_dt * 1e3:.3f} ms/step "
              f"({aniso_mpix_s:.3f} Mpix/s)", file=sys.stderr)

    trained = None
    if on_card and os.environ.get("BENCH_SKIP_TRAINED") != "1":
        t_chain, t_info = build_trained(args.trained_config)
        if t_chain is None:
            print(f"trained bench skipped: {t_info}", file=sys.stderr)
        else:
            t_dt, t_spread, _ = time_step(t_chain, k1=2, k2=10, reps=3)
            px = t_info["height"] * t_info["width"]
            trained = dict(t_info)
            trained["trained_mpix_s"] = px / t_dt / 1e6
            trained["trained_spread_mpix_s"] = (
                (px / 1e6) * t_spread / (t_dt * t_dt))
            print(f"trained checkpoint it{t_info['checkpoint_iteration']} "
                  f"({t_info['n_alive']} splats, {t_info['trained_instances']}"
                  f" instances): {t_dt * 1e3:.3f} ms/step "
                  f"({trained['trained_mpix_s']:.3f} Mpix/s)",
                  file=sys.stderr)

    vs_baseline = 1.0
    if on_card and os.environ.get("BENCH_FULL_GOLDEN") == "1":
        g_chain = build(width=800, height=800, raster="golden", device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        g_chain(0.5, 1)
        t0 = time.perf_counter()
        g_chain(0.25, 1)
        g_dt = time.perf_counter() - t0
        vs_baseline = g_dt / dt
        print(f"full-size golden: {g_dt:.3f} s/step, peak "
              f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB "
              f"-> ratio {vs_baseline:.1f}x", file=sys.stderr)
    elif on_card:
        vs_baseline = FULL_GOLDEN_S / dt

    out = {
        "metric": METRIC,
        "value": mpix_s,
        "unit": "Mpix/s",
        "vs_baseline": vs_baseline,
        # max - min of `reps` interleaved slope pairs, in Mpix/s
        "spread": spread_mpix,
        "reps": reps,
        # Gaussians composited per second: scene size x step rate
        "mgaussians_per_s": n / dt / 1e6,
        # the card's work in a headline step and the host's launch cost
        # (null on the CPU)
        "device_busy_ms": busy_ms,
        "device_launches": launches,
        "host_launch_us": launch_us,
    }
    if aniso_mpix_s is not None:
        out["aniso_rotated_mpix_s"] = aniso_mpix_s
    if trained is not None:
        out.update(trained)
    out["device"] = torch.cuda.get_device_name(dev) if on_card else "cpu"
    out["power_limit_w"] = power_limit_w(dev) if on_card else None
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
