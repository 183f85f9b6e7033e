"""Visualisation: the camera rig and the Gaussians' centres as scatter
plots, novel-view camera paths, and frames (and a video) of a camera path
(counterpart of mini3dgs_tpu/utils/vis.py).  matplotlib and imageio are
imported only by the functions that need them."""

from __future__ import annotations

import math
import sys
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.camera import Camera
from .io import save_image


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _figure_3d():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure(figsize=(6, 6))
    return plt, fig, fig.add_subplot(projection="3d")


def _save(plt, fig, path: Optional[str]) -> None:
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(path, dpi=120)
        plt.close(fig)


def visualize_cameras(cameras: Sequence[Camera], path: Optional[str] = None):
    """Scatter the camera rig (positions + view directions) to a PNG."""
    centers = np.stack([_numpy(c.camera_center) for c in cameras])
    dirs = np.stack([_numpy(c.R)[:, 2] for c in cameras])  # +z forward
    plt, fig, ax = _figure_3d()
    ax.scatter(centers[:, 0], centers[:, 1], centers[:, 2], c="tab:blue", s=12)
    ax.quiver(centers[:, 0], centers[:, 1], centers[:, 2],
              dirs[:, 0], dirs[:, 1], dirs[:, 2], length=0.3, color="tab:red")
    ax.set_title(f"{len(cameras)} cameras")
    _save(plt, fig, path)
    return fig


def visualize_gaussians(gaussians, path: Optional[str] = None,
                        max_points: int = 20000):
    """Scatter alive Gaussian centres coloured by their DC colour."""
    alive = _numpy(gaussians.alive)
    xyz = _numpy(gaussians.xyz)[alive]
    col = 1.0 / (1.0 + np.exp(-_numpy(gaussians.features_dc)[alive, 0]))
    if len(xyz) > max_points:
        sel = np.random.default_rng(0).choice(len(xyz), max_points,
                                              replace=False)
        xyz, col = xyz[sel], col[sel]
    plt, fig, ax = _figure_3d()
    ax.scatter(xyz[:, 0], xyz[:, 1], xyz[:, 2], c=np.clip(col, 0, 1), s=2)
    ax.set_title(f"{alive.sum()} gaussians")
    _save(plt, fig, path)
    return fig


def turntable_cameras(n: int, radius: float = 4.0, height: float = 0.0,
                      width: int = 512, image_height: int = 512,
                      fov_deg: float = 60.0, device="cpu") -> List[Camera]:
    """A circular orbit of cameras looking at the origin."""
    cams = []
    fov = math.radians(fov_deg)
    for i in range(n):
        theta = 2 * math.pi * i / n
        center = np.array([radius * math.sin(theta), height,
                           -radius * math.cos(theta)], np.float32)
        fwd = -center
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        right = np.cross(up, fwd)
        right = right / np.linalg.norm(right)
        upv = np.cross(fwd, right)
        R = np.stack([right, upv, fwd], axis=1)
        cams.append(Camera.create(uid=i, R=R, T=center, FoVx=fov, FoVy=fov,
                                  width=width, height=image_height,
                                  device=device))
    return cams


def create_video_from_cameras(render_fn, cameras: Sequence[Camera],
                              out_dir: str, fps: int = 30,
                              video_path: Optional[str] = None):
    """Render every camera to PNG frames (`render_fn(camera)` -> [3,H,W]
    in [0,1]); with `video_path`, also assemble them into a video through
    imageio.  Without imageio the frames stay, and stderr says so."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    frames = []
    for i, cam in enumerate(cameras):
        p = out / f"frame_{i:04d}.png"
        save_image(render_fn(cam), str(p))
        frames.append(p)
    if video_path:
        try:
            import imageio.v2 as imageio
        except ImportError:
            print(f"create_video_from_cameras: imageio is not installed; "
                  f"{video_path} not written, the frames are in {out}",
                  file=sys.stderr)
            return frames
        from . import png
        with imageio.get_writer(video_path, fps=fps) as w:
            for p in frames:
                w.append_data(png.decode(p.read_bytes()))
    return frames
