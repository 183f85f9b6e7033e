"""Train a seeded synthetic scene with the PyTorch port (counterpart of the
training half of scripts/train_path_parity.py, without datasets).

The scene is the flagship random scene (`convert.flagship_scene_numpy`);
the targets are renders, through the port's own renderer, of a second,
differently seeded Gaussian set from a bench camera and a turntable.  The
loop runs the single-device train step with the config's densify, prune
and opacity-reset cadences and the progressive SH unlock, prints one JSON
line per log interval, and ends with one JSON line holding the mean PSNR
over the training views before and after.

With --tile-shards N the step is the band-sharded one
(parallel/sharded.make_sharded_train_step) over a mesh of N ranks, each
owning a band of image rows; --ring makes the bands exchange depth-rank-range
segments around the ring (parallel/ring.py).  The ranks are spread over the
visible CUDA devices; on one card they all share it.  The image's tile rows
must divide into N bands and, with --ring, the capacity into N ranges:
python scripts/train_torch.py --tile-shards 5 --ring --capacity 131075.

Usage: python scripts/train_torch.py [--iterations 200] [--size 800]
           [--n-gaussians 100000] [--capacity 131072] [--device cuda]
           [--tile-shards 1] [--ring]
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mini3dgs_tpu_torch import convert  # noqa: E402
from mini3dgs_tpu_torch.config import TrainingConfig  # noqa: E402
from mini3dgs_tpu_torch.core.gaussians import scene_extent_of  # noqa: E402
from mini3dgs_tpu_torch.ops.renderer import RenderSettings, render  # noqa: E402
from mini3dgs_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from mini3dgs_tpu_torch.parallel.sharded import make_sharded_train_step  # noqa: E402
from mini3dgs_tpu_torch.train import density, trainer  # noqa: E402
from mini3dgs_tpu_torch.utils.metrics import psnr  # noqa: E402
from mini3dgs_tpu_torch.utils.vis import turntable_cameras  # noqa: E402


def build_scene(args, device):
    """(initial Gaussians, training cameras with their target images)."""
    size = args.size
    params, alive, cam = convert.flagship_scene_numpy(
        args.capacity, args.n_gaussians, seed=args.seed)
    t_params, t_alive, _ = convert.flagship_scene_numpy(
        args.capacity, args.n_gaussians, seed=args.seed + 7)
    if args.sh_degree > 0:
        rng = np.random.default_rng(args.seed + 1)
        t_params["features_rest"][:args.n_gaussians] = rng.normal(
            0.0, 0.1, (args.n_gaussians, 15, 3))
    cams = [convert.camera_from_numpy(**cam, width=size, height=size,
                                      device=device)]
    cams += turntable_cameras(args.n_cameras - 1, width=size,
                              image_height=size, device=device)
    target = convert.gaussians_from_numpy(t_params, t_alive, device)
    return (convert.gaussians_from_numpy(params, alive, device), cams,
            target)


def mean_psnr(g, cams, settings) -> float:
    with torch.no_grad():
        return float(np.mean([float(psnr(render(g, c, settings)["image"],
                                         c.image)) for c in cams]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    d = TrainingConfig()
    p.add_argument("--iterations", type=int, default=200)
    p.add_argument("--size", type=int, default=800)
    p.add_argument("--n-gaussians", type=int, default=100_000)
    p.add_argument("--capacity", type=int, default=2 ** 17)
    p.add_argument("--n-cameras", type=int, default=4)
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument("--tile-size", type=int, default=32)
    p.add_argument("--log-interval", type=int, default=10)
    for name in ("densify_from_iter", "densify_until_iter",
                 "densify_interval", "prune_interval",
                 "opacity_reset_interval", "sh_increase_interval"):
        p.add_argument("--" + name.replace("_", "-"), type=int,
                       default=getattr(d, name))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tile-shards", type=int, default=1,
                   help="ranks of the mesh's tile axis (image bands)")
    p.add_argument("--ring", action="store_true",
                   help="ring exchange between the bands (parallel/ring.py)")
    args = p.parse_args(argv)
    if args.n_cameras < 1 or args.n_gaussians > args.capacity:
        p.error("need at least one camera and capacity >= n-gaussians")

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch.cuda.is_available() is "
                           "False; pass --device cpu to train on the CPU")
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)

    config = TrainingConfig(
        iterations=args.iterations, log_interval=args.log_interval,
        image_height=args.size, image_width=args.size,
        background_color=[1.0, 1.0, 1.0], tile_size=args.tile_size,
        color_mode="sh", sh_degree=args.sh_degree, capacity=args.capacity,
        position_lr_max_steps=args.iterations,
        densify_from_iter=args.densify_from_iter,
        densify_until_iter=args.densify_until_iter,
        densify_interval=args.densify_interval,
        prune_interval=args.prune_interval,
        opacity_reset_interval=args.opacity_reset_interval,
        sh_increase_interval=args.sh_increase_interval,
        mesh_tile=args.tile_shards, ring_exchange=args.ring)
    settings = RenderSettings(
        image_height=config.image_height, image_width=config.image_width,
        bg_color=tuple(config.background_color), tile_size=config.tile_size,
        color_mode=config.color_mode, sh_degree=config.sh_degree)

    gaussians, cams, target = build_scene(args, device)
    with torch.no_grad():
        cams = [c.replace(image=render(target, c, settings)["image"])
                for c in cams]
    del target
    scene_extent = float(scene_extent_of(gaussians))
    config = trainer.scale_position_lr(config, scene_extent)
    state = trainer.create_train_state(gaussians, config)
    sharded_step = None
    if config.mesh_tile > 1 or config.ring_exchange:
        # On the CPU the ranks are CPU ranks; on CUDA they are spread over
        # every visible card.
        mesh = make_mesh(config.mesh_data, config.mesh_tile,
                         devices=None if device.type == "cuda" else [device])
        sharded_step = make_sharded_train_step(
            config, settings.replace(ring=config.ring_exchange), mesh)
    psnr_start = mean_psnr(gaussians, cams, settings)

    rng = np.random.default_rng(args.seed)          # camera order
    noise_gen = torch.Generator(device=device)      # clone jitter
    noise_gen.manual_seed(args.seed)
    sync()
    t_window, it_window, first_loss, loss = time.perf_counter(), 0, None, None
    for it in range(1, config.iterations + 1):
        cam_idx = int(rng.integers(len(cams)))
        deg = config.sh_degree
        if config.sh_increase_interval > 0:
            deg = min(it // config.sh_increase_interval, config.sh_degree)
        if sharded_step is not None:
            state, metrics = sharded_step(state, [cams[cam_idx]], [cam_idx],
                                          sh_degree=deg)
        else:
            state, metrics = trainer.train_step(
                state, cams[cam_idx], config, settings, cam_idx,
                sh_degree=deg)
        events = {}
        if density.should_densify(it, config):
            noise = torch.randn(config.capacity, 3, generator=noise_gen,
                                device=device)
            size_prune = 0 < config.opacity_reset_interval < it
            state, events = trainer.densify_step(state, noise, scene_extent,
                                                 config, size_prune)
        elif density.should_prune(it, config):
            state, n_pruned = trainer.prune_step(state, config)
            events = {"n_pruned": n_pruned}
        if (config.opacity_reset_interval > 0
                and it % config.opacity_reset_interval == 0
                and it <= config.densify_until_iter):
            state = trainer.reset_opacity_step(state)
            events["opacity_reset"] = True
        if it == 1:
            first_loss = float(metrics["total_loss"])
        if it % config.log_interval == 0 or it == config.iterations or events:
            loss = float(metrics["total_loss"])
            sync()
            now = time.perf_counter()
            print(json.dumps({
                "iteration": it, "total_loss": loss,
                "l1": float(metrics["l1"]), "dssim": float(metrics["dssim"]),
                "sh_degree": deg, "n_visible": int(metrics["n_visible"]),
                "render_instances": metrics["render_instances"],
                "n_alive": state.gaussians.num_alive(),
                "ms_per_step": (now - t_window) * 1e3 / (it - it_window),
                **events}), flush=True)
            t_window, it_window = now, it
    psnr_end = mean_psnr(state.gaussians, cams, settings)
    print(json.dumps({
        "iterations": config.iterations, "size": args.size,
        "n_gaussians": args.n_gaussians, "capacity": args.capacity,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "first_loss": first_loss, "last_loss": loss,
        "psnr_start": psnr_start, "psnr_end": psnr_end,
        "n_alive": state.gaussians.num_alive()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
