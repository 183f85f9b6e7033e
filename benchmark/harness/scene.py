"""A cell's inputs, made from the seed on the device: the Gaussians, the
training views with their ray-marched targets, and the viewer's orbit.

The same seed gives the same inputs.  The seed moves every sample on the
surfaces and the Gaussians' shapes, opacities and SH terms, and orders
the training views; the surfaces, the counts and the camera poses stay
those of the configuration, so every seed asks for the same work in
another order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from . import generator

GOLDEN = 0.618034       # azimuth step of the rig's spiral, in turns
ELEV_STEP = 0.381966    # elevation step, in shares of the band


@dataclass
class Views:
    poses: List[Tuple[np.ndarray, np.ndarray]]   # (R c2w, centre)
    fovx: float
    fovy: float
    width: int
    height: int
    targets: List[torch.Tensor]                  # [3, H, W] each, or []


def scene_of(config: dict, device) -> generator.Scene:
    s = config["scene"]
    return generator.Scene(s["texture"], device,
                           [tuple(e) for e in s.get("extras", ())])


def generator_of(seed: int, device, stream: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 4 + stream) % (1 << 63))
    return gen


def make_gaussians(config: dict, seed: int, device) -> dict:
    """The configuration's Gaussians on their surfaces (plain tensors)."""
    s = config["scene"]
    n = int(config["n_gaussians"])
    counts = {k: int(round(n * v)) for k, v in s["split"].items()}
    counts["objects"] = counts.get("objects", 0) + n - sum(counts.values())
    return generator.sample_gaussians(
        scene_of(config, device), counts, generator_of(seed, device, 0),
        sigma_per_spacing=s["sigma_per_spacing"], flatten=s["flatten"],
        opacity_range=s["opacity"], sh_rest_std=s["sh_rest_std"],
        ground=tuple(s.get("ground", ())), shell=tuple(s.get("shell", ())))


def _fovs(config: dict):
    cam = config["camera"]
    W, H = int(config["settings"]["image_width"]), \
        int(config["settings"]["image_height"])
    fovx = float(cam["camera_angle_x"])
    f = 0.5 * W / math.tan(0.5 * fovx)
    return fovx, 2.0 * math.atan(0.5 * H / f), W, H


def train_views(config: dict, seed: int, device,
                with_targets: bool = True) -> Views:
    """The configuration's training views on a spiral over its band of
    elevations, in an order drawn from the seed, with ray-marched targets
    composited over the background."""
    cam, s = config["camera"], config["scene"]
    fovx, fovy, W, H = _fovs(config)
    lo, hi = (math.radians(v) for v in cam["elevation_deg"])
    n = int(config["n_train_views"])
    order = np.random.default_rng(int(seed)).permutation(n)
    poses = [generator.camera_pose(
        2 * math.pi * (i * GOLDEN % 1.0),
        lo + (hi - lo) * (i * ELEV_STEP % 1.0), cam["radius"])
        for i in order.tolist()]
    targets = []
    if with_targets:
        scene = scene_of(config, device)
        bg = torch.tensor(config["settings"]["background_color"],
                          dtype=torch.float32, device=device)
        for R, T in poses:
            rgba = generator.render_view(
                scene, R, T, W, H, fovx, spp=s["spp"],
                march_steps=s["march_steps"], max_t=s["max_t"])
            a = rgba[..., 3:]
            targets.append((rgba[..., :3] * a + bg * (1.0 - a))
                           .permute(2, 0, 1).contiguous())
    return Views(poses, fovx, fovy, W, H, targets)


def orbit_views(config: dict, traffic: dict) -> Views:
    """The viewer's orbit: `orbit_frames` views evenly round the vertical
    axis at one elevation, half a step off the azimuth 0 of the training
    spiral's first view."""
    cam = config["camera"]
    fovx, fovy, W, H = _fovs(config)
    n = int(traffic["orbit_frames"])
    phi = math.radians(traffic["orbit_elevation_deg"])
    poses = [generator.camera_pose(math.pi * (2 * k + 1) / n, phi,
                                   cam["radius"]) for k in range(n)]
    return Views(poses, fovx, fovy, W, H, [])
