"""Training probe with the PyTorch port (counterpart of
scripts/train_probe.py): random-init Gaussians fit one target image with
the whole training machinery -- `GaussianTrainer.train` on a one-camera
dataset: L1 + D-SSIM, 5-group Adam with the cosine LR, densify (split /
clone / prune) every 100 steps and the pool's growth when it fills -- and
print the PSNR trajectory and steps/s.

The target is a render, at tile 32 through the tile kernels, of the
flagship scene (`convert.flagship_scene_numpy`, 8,000 Gaussians, seed 23)
made anisotropic; the model starts from 2,000 random Gaussians
(`create_from_random`, torch's generator, seed 1) in a 4,096-slot pool.
The last line is one JSON object with the trajectory.

Usage: python scripts/train_probe_torch.py [--steps 1200] [--size 256]
           [--log-interval 100] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


class OneView:
    """A dataset of one training camera and no test views."""

    def __init__(self, cam):
        self.cam = cam

    def get_train_cameras(self):
        return [self.cam]

    def get_test_cameras(self):
        return []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--log-interval", type=int, default=100)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from mini3dgs_tpu_torch import convert
    from mini3dgs_tpu_torch.config import TrainingConfig
    from mini3dgs_tpu_torch.core.gaussians import create_from_random
    from mini3dgs_tpu_torch.ops.renderer import RenderSettings, render
    from mini3dgs_tpu_torch.train.trainer import (GaussianTrainer,
                                                  resolve_device)
    from mini3dgs_tpu_torch.utils.metrics import psnr

    dev = resolve_device(args.device)
    steps, size = args.steps, args.size
    # Target: a render of a rich random scene (8K anisotropic Gaussians).
    params, alive, cam = convert.flagship_scene_numpy(2 ** 13, 8000, seed=23)
    params["scaling"] += np.asarray([0.3, 0.0, -0.4], np.float32)
    gt = convert.gaussians_from_numpy(params, alive, dev)
    settings = RenderSettings(image_height=size, image_width=size,
                              tile_size=32)
    cam = convert.camera_from_numpy(**cam, width=size, height=size,
                                    device=dev)
    with torch.no_grad():
        target = render(gt, cam, settings)["image"]
    cam = cam.replace(image=target)

    config = TrainingConfig(
        iterations=steps, capacity=2 ** 12,
        densify_from_iter=100, densify_until_iter=steps - 200,
        densify_interval=100, densify_grad_threshold=5e-5,
        opacity_reset_interval=0, log_interval=args.log_interval,
        eval_interval=10 ** 9, save_interval=10 ** 9, tile_size=32,
        use_pallas=True, compact_after_densify=False, device=args.device)
    gen = torch.Generator(device=dev).manual_seed(1)
    g0 = create_from_random(gen, num_points=2000, scene_extent=1.0,
                            capacity=config.capacity)
    trainer = GaussianTrainer(config, settings)
    # The trainer's loop over a dataset of the one camera: its draws all
    # land on camera 0, and nothing is validated or saved.
    trainer.setup(dataset=OneView(cam), gaussians=g0)

    logs = []

    def log_fn(it, m):
        g = trainer.state.gaussians
        with torch.no_grad():
            img = render(g, cam, trainer.settings)["image"]
        p = float(psnr(img, target))
        logs.append({"it": it, "loss": m["total_loss"], "psnr": p,
                     "alive": g.num_alive()})
        print(f"[{it:5d}] loss={m['total_loss']:.4f} psnr={p:5.2f} dB "
              f"alive={logs[-1]['alive']} capacity={g.capacity}", flush=True)

    t0 = time.perf_counter()
    trainer.train(steps, log_fn=log_fn)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    final_psnr = logs[-1]["psnr"] if logs else 0.0
    g = trainer.state.gaussians
    print(f"\n{steps} steps in {dt:.1f}s = {steps / dt:.1f} it/s "
          "(densify, growth and the logged renders included)")
    print(f"final: psnr={final_psnr:.2f} dB, alive={g.num_alive()}, "
          f"capacity={g.capacity}")
    print("TRAIN PROBE", "OK" if final_psnr > 28.0 else "WEAK")
    print(json.dumps({"steps": steps, "size": size, "seconds": dt,
                      "steps_per_s": steps / dt, "psnr": final_psnr,
                      "alive": g.num_alive(), "capacity": g.capacity,
                      "log": logs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
