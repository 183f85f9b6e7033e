"""A real optimisation run at >= 1M Gaussians with the PyTorch port
(counterpart of scripts/train_1m.py).

A 2^20-slot pool seeded with 1M surface samples of the procedural SDF scene
(`data/synthetic.sample_surface_points`) trains the full L1 + D-SSIM /
5-group-Adam step (densify off: the pool starts full) at 800^2, SH 0, tile
32, on a Blender scene made by scripts/make_synthetic_scene_torch.py.  It
prints the first step, a first window, the steady-state ms/step, the
instances of the last logged step's stream (n_live), the peak device memory
(`torch.cuda.max_memory_allocated`) and the final `validate()`; the last
line is one JSON object with these numbers.

    python scripts/make_synthetic_scene_torch.py --out data/sdf_scene
    python scripts/train_1m_torch.py --scene data/sdf_scene

Usage:  python scripts/train_1m_torch.py [--scene data/sdf_scene]
            [--iters 500] [--steady 200] [--n-points 1000000]
            [--capacity 1048576] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", type=str, default="data/sdf_scene")
    ap.add_argument("--iters", type=int, default=500,
                    help="the first step and the first window")
    ap.add_argument("--steady", type=int, default=200,
                    help="steps of the steady-state window after them")
    ap.add_argument("--n-points", type=int, default=1_000_000)
    ap.add_argument("--capacity", type=int, default=2 ** 20)
    ap.add_argument("--log-interval", type=int, default=50)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from mini3dgs_tpu_torch.config import TrainingConfig
    from mini3dgs_tpu_torch.core.gaussians import create_from_pcd
    from mini3dgs_tpu_torch.core.sh import rgb_to_sh_dc
    from mini3dgs_tpu_torch.data.dataset import BlenderDataset
    from mini3dgs_tpu_torch.data.synthetic import sample_surface_points
    from mini3dgs_tpu_torch.train.trainer import (GaussianTrainer,
                                                  resolve_device)

    dev = resolve_device(args.device)
    cfg = TrainingConfig(
        data_path=args.scene, output_path="runs/sdf_1m",
        iterations=args.iters, eval_interval=10 ** 9,
        save_interval=10 ** 9, log_interval=args.log_interval,
        densify_from_iter=10 ** 9, densify_until_iter=0,
        opacity_reset_interval=0, prune_interval=10 ** 9,
        image_height=800, image_width=800,
        background_color=[1.0, 1.0, 1.0],
        tile_size=32, sh_degree=0, color_mode="sh",
        sh_increase_interval=0, capacity=args.capacity, use_pallas=True,
        device=args.device)

    ds = BlenderDataset(args.scene, white_background=True, device=dev)
    ds.load_cameras()
    cam0 = ds.get_train_cameras()[0]
    print(f"{len(ds.get_train_cameras())} train cameras at "
          f"{cam0.width}x{cam0.height}", flush=True)

    pts, cols = sample_surface_points(n=args.n_points)
    g = create_from_pcd(pts, rgb_to_sh_dc(cols), capacity=args.capacity,
                        device=dev)
    print(f"{args.n_points} seed points in a {args.capacity}-slot pool",
          flush=True)

    tr = GaussianTrainer(cfg)
    tr.setup(dataset=ds, gaussians=g)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    last = {}

    def log(it, m):
        last.update(m)
        print(f"[{it:5d}] loss={m['total_loss']:.5f} l1={m['l1']:.5f} "
              f"n_live={int(m['render_instances'])}", flush=True)

    sync()
    t = time.perf_counter()
    tr.train(iterations=1, log_fn=log)
    sync()
    first_s = time.perf_counter() - t
    print(f"first step: {first_s:.2f}s", flush=True)

    t = time.perf_counter()
    tr.train(iterations=args.iters - 1, log_fn=log)
    sync()
    win_s = time.perf_counter() - t
    win_ms = 1e3 * win_s / max(args.iters - 1, 1)
    print(f"window 1: {win_s:.1f}s for {args.iters - 1} it -> "
          f"{win_ms:.1f} ms/it", flush=True)

    steady_ms = None
    if args.steady > 0:
        t = time.perf_counter()
        tr.train(iterations=args.steady, log_fn=log)
        sync()
        steady_ms = 1e3 * (time.perf_counter() - t) / args.steady
        print(f"steady-state: {args.steady} it -> {steady_ms:.1f} ms/it",
              flush=True)

    peak = total = None
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        total = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
        print(f"device memory: peak {peak:.2f} GiB allocated / "
              f"{total:.2f} GiB on the card", flush=True)
    else:
        print("device memory: not measured on the CPU", flush=True)

    n_alive = tr.state.gaussians.num_alive()
    n_live = int(last["render_instances"]) if last else None
    m = tr.validate()
    print(f"eval after {tr.iteration} it: psnr={m.get('psnr', 0):.2f} "
          f"ssim={m.get('ssim', 0):.4f} n_alive={n_alive} n_live={n_live}",
          flush=True)
    print(json.dumps({
        "iterations": tr.iteration, "points": args.n_points,
        "capacity": args.capacity, "size": [cam0.width, cam0.height],
        "first_step_s": first_s, "window_ms_per_it": win_ms,
        "steady_ms_per_it": steady_ms, "n_alive": n_alive, "n_live": n_live,
        "peak_gib": peak, "card_gib": total, "losses": tr.train_losses,
        "psnr": m.get("psnr"), "ssim": m.get("ssim")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
