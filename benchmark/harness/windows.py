"""What the window's drivers (`drivers/<kind>.py`, one for each `kind` of
traffic mix) share: the measured package's recipe with the configuration's
settings over it, the plain reference's settings and cameras for the same
views, and the benchmark's own pair counts of the traced views."""

from __future__ import annotations

import dataclasses
import gc
from pathlib import Path

import torch

from . import counting, scene
from .spec import ROOT, Cell


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def ref_settings(cfg, sh_degree: int, lrs=(), extent: float = 1.0):
    from reference.train import Settings
    return Settings(
        tile_size=cfg.tile_size, bg=tuple(float(v) for v in
                                          cfg.background_color),
        sh_degree=sh_degree, radius_min=cfg.radius_min,
        radius_max=cfg.radius_max, lambda_dssim=cfg.lambda_dssim,
        lrs=tuple(lrs), position_lr_init=cfg.position_lr_init * extent,
        position_lr_final=cfg.position_lr_final * extent,
        position_lr_delay_steps=cfg.position_lr_delay_steps,
        position_lr_delay_mult=cfg.position_lr_delay_mult,
        position_lr_max_steps=cfg.position_lr_max_steps)


def ref_camera(views: scene.Views, i: int, device, dtype=torch.float32):
    from reference.projection import Camera
    R, T = views.poses[i]
    return Camera.from_pose(R, T, views.fovx, views.fovy, views.width,
                            views.height, device, dtype)


def recipe_config(cell: Cell, device: torch.device, out_dir: Path):
    """The measured package's TrainingConfig: the recipe file read by its
    ConfigManager, with the configuration's own settings over it."""
    from mini3dgs_tpu_torch.config import ConfigManager
    cfg = ConfigManager.load_from_yaml(str(ROOT / cell.config["recipe"]))
    return dataclasses.replace(cfg, **cell.config["settings"],
                               device=device.type,
                               output_path=str(out_dir))


def pair_needs(params: dict, cams, ref_settings, counting_fn,
               n_pixels: int):
    """The per-launch least seconds of the forward and backward raster and
    the mean operations a step of the views `cams`, from the reference's
    own binning and pair counts."""
    from reference.train import render
    fwd, bwd, ops = [], [], []
    n = params["xyz"].shape[0]
    for cam in cams:
        _, bins, pairs = render(params, cam, ref_settings, count_pairs=True)
        T, P = bins.tile_count.shape[0], ref_settings.tile_size ** 2
        fwd.append(counting.bound_s(*counting.raster_fwd_need(
            pairs, bins.n_instances, T, P)))
        bwd.append(counting.bound_s(*counting.raster_bwd_need(
            pairs, bins.n_instances, T, P)))
        ops.append(counting_fn(pairs, n, n_pixels))
    return fwd, bwd, sum(ops) / len(ops)


def scene_line(params: dict, cams, ref_settings) -> str:
    """Instances a view and the heaviest and mean tile (over all tiles and
    over those that hold any), from the reference's binning."""
    from reference.projection import project
    from reference.raster import bin_tiles
    parts = []
    for cam in cams:
        with torch.no_grad():
            proj = project(params, cam, sh_degree=0,
                           radius_min=ref_settings.radius_min,
                           radius_max=ref_settings.radius_max)
            b = bin_tiles(proj, cam.height, cam.width, ref_settings.tile_size)
        c = b.tile_count.double()
        parts.append(f"{b.n_instances} instances, heaviest tile "
                     f"{int(c.max())}, mean {float(c.mean()):.1f} "
                     f"({float(c[c > 0].mean()):.1f} over the "
                     f"{int((c > 0).sum())} tiles that hold any)")
    return f"{params['xyz'].shape[0]} Gaussians; " + "; ".join(parts)




def release(device: torch.device) -> None:
    """Give the memory of what a driver dropped back to the card."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
