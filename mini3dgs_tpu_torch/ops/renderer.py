"""Renderer: projection -> cull -> sort -> tile raster -> blend
(counterpart of mini3dgs_tpu/ops/renderer.py).

Two raster modes, both behind the same projection and both differentiable:
  * "tiles"  — binning + the hand-written CUDA tile kernels, forward and
               backward (ops/binning.py, ops/raster_cuda.py); on CPU
               tensors the kernels' plain PyTorch versions run instead.
  * "golden" — the vectorized reference compositor (ops/raster_ref.py),
               differentiated by autograd.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch.profiler import record_function

from ..core.camera import Camera
from ..core.gaussians import Gaussians
from . import raster_ref
from .projection import project_gaussians
from .raster_cuda import rasterize_tiles

RASTER_MODES = ("tiles", "golden")


@dataclass(frozen=True)
class RenderSettings:
    """The reference RenderSettings knobs plus the tile size."""

    image_height: int = 256
    image_width: int = 256
    bg_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    scale_modifier: float = 1.0
    tile_size: int = 16
    radius_min: float = 0.01
    radius_max: float = 50.0
    color_mode: str = "dc_sigmoid"
    sh_degree: int = 0
    # Mip-splatting antialiasing: dilate Sigma2D by the 0.3 px^2 pixel
    # filter and scale opacity by sqrt(det ratio).  Off by default.
    antialias: bool = False
    raster: str = "tiles"
    # Ring exchange for the band-sharded raster (parallel/ring.py):
    # instances partitioned by depth-rank range and passed around the ring
    # of the mesh's `tile` axis, with the per-pixel transmittance carried
    # from range to range.  Only the sharded entry points of
    # parallel/sharded.py read it; `render` renders on one device.
    ring: bool = False
    # Ring v2: send each projected row to the owner of its depth-rank range
    # first, so the origin's emission, sort and pack run on C/n rows; the
    # same segments as v1, bit for bit.
    ring_reshard: bool = False
    # Ring v3, in the gauss-sharded train step only (where it takes
    # precedence over ring_reshard): the ring takes each tile rank's own
    # block of projected rows, the depth ranks come from a ring-rotation
    # counting sort, and no rank holds a tensor of C rows.
    ring_local: bool = False

    def replace(self, **changes) -> "RenderSettings":
        return dataclasses.replace(self, **changes)


def render(gaussians: Gaussians, camera: Camera,
           settings: Optional[RenderSettings] = None,
           means2d_probe: Optional[torch.Tensor] = None) -> dict:
    """Render one view.  Returns image [3,H,W], alpha [1,H,W],
    depth [1,H,W], viewspace_points [C,2], visibility_filter [C],
    radii [C], conics [C,3], and the instance-stream counters n_dropped,
    n_live, n_dropped_large, n_large (ints; 0 on the golden path).

    `means2d_probe` ([C,2], zeros) is added to the projected pixel means,
    so its gradient is the viewspace positional gradient that
    densification accumulates."""
    if settings is None:
        settings = RenderSettings(image_height=camera.height,
                                  image_width=camera.width)
    if settings.raster not in RASTER_MODES:
        raise ValueError(f"raster must be one of {RASTER_MODES}, got "
                         f"{settings.raster!r}")
    H, W = settings.image_height, settings.image_width
    bg = torch.as_tensor(settings.bg_color, dtype=torch.float32,
                         device=gaussians.device)

    # The record_function ranges name the stages of a step in a
    # torch.profiler trace (scripts/profile_step_torch.py reads them).
    with record_function("3dgs:projection"):
        proj = project_gaussians(
            gaussians, camera,
            radius_min=settings.radius_min, radius_max=settings.radius_max,
            color_mode=settings.color_mode, sh_degree=settings.sh_degree,
            scale_modifier=settings.scale_modifier,
            antialias=settings.antialias)
        if means2d_probe is not None:
            # the exact-cull half-extents are relative to the centre, so
            # they stay valid under the (identically zero) probe offset
            proj = proj._replace(means2d=proj.means2d + means2d_probe)

    if settings.raster == "tiles":
        out = rasterize_tiles(proj, H, W, bg, tile_size=settings.tile_size)
    else:
        out = raster_ref.rasterize_image(
            proj.means2d, proj.conic, proj.depth, proj.color, proj.opacity,
            proj.visible, H, W, bg, radius=proj.radius,
            tile_size=settings.tile_size)

    return {
        "image": out["image"],
        "alpha": out["alpha"],
        "depth": out["depth"],
        "viewspace_points": proj.means2d,
        "visibility_filter": proj.visible,
        "radii": proj.radius,
        "conics": proj.conic,
        "n_dropped": out.get("n_dropped", 0),
        "n_live": out.get("n_live", 0),
        "n_dropped_large": out.get("n_dropped_large", 0),
        "n_large": out.get("n_large", 0),
    }
