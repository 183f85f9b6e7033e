"""Rendering and training over a (data, tile) mesh (counterpart of
mini3dgs_tpu/parallel/sharded.py, the replicated-state half).

  * data axis: one camera per rank; the loss, and so the gradients, are the
    mean over the cameras.
  * tile axis: the image is split into horizontal bands of whole tile rows.
    Each rank projects its share of the Gaussian slots (one all_gather
    reassembles the projected set), rasterizes its band, and the banded loss
    exchanges a 5-row halo for the SSIM term.  Per-Gaussian gradients are
    the sum over the bands.

Two band routes: the ring exchange of depth-rank-range segments
(parallel/ring.py, `settings.ring`), which runs the raster kernels' `t0`
builds, and the band-restricted `rasterize_tiles` (every rank bins the whole
image and launches the kernels on its band's tile rows), which the ring is
compared against.  The sharded candidate sort (`bin_gaussians_sharded`), ring
v2/v3 and the gauss-sharded state are not ported yet.

The ranks of an axis are a Python loop (parallel/mesh.py) and autograd
differentiates through the collectives as they stand: the state's
parameters are leaves on the state's device, every rank works on a `.to`
copy, and the gradient of the one scalar loss is already the sum over bands
and the mean over cameras.  None of the JAX package's psum-transpose factors
exists here.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
from torch.profiler import record_function

from ..config import TrainingConfig
from ..core.camera import Camera
from ..core.gaussians import Gaussians
from ..core.loss import gaussian_loss_banded
from ..ops.projection import Projected, project_gaussians
from ..ops.raster_cuda import rasterize_tiles
from ..ops.renderer import RenderSettings
from ..train.exposure import apply_exposure
from ..train.trainer import TrainState, apply_gradients, mask_dead_gradients
from . import mesh as M
from .ring import ring_rasterize_bands


def _band_height(settings: RenderSettings, n_tile: int) -> int:
    H, ts = settings.image_height, settings.tile_size
    if H % (n_tile * ts):
        raise ValueError(f"image height {H} must split into {n_tile} bands "
                         f"of whole {ts}px tile rows")
    return H // n_tile


def _project(gs: Sequence[Gaussians], cameras: Sequence[Camera],
             settings: RenderSettings, devices: Sequence) -> List[Projected]:
    """EWA projection, primitive-sharded: rank i (holding the replicated
    pool `gs[i]`) projects Gaussian slots [i*C/n, (i+1)*C/n) only, and one
    all_gather reassembles the projected set on every rank.  The math is
    elementwise per slot, so the result equals the replicated projection;
    when C does not divide over the ranks every rank projects the whole
    pool."""
    kw = dict(radius_min=settings.radius_min, radius_max=settings.radius_max,
              color_mode=settings.color_mode, sh_degree=settings.sh_degree,
              scale_modifier=settings.scale_modifier,
              antialias=settings.antialias)
    n, C = len(devices), gs[0].capacity
    if n <= 1 or C % n:
        return [project_gaussians(g, cam, **kw)
                for g, cam in zip(gs, cameras)]
    Cs = C // n
    shards = [project_gaussians(g.slots(i * Cs, (i + 1) * Cs), cam, **kw)
              for i, (g, cam) in enumerate(zip(gs, cameras))]
    fields = [M.all_gather([sh[f] for sh in shards], devices)
              for f in range(len(Projected._fields))]
    return [Projected(*(field[i] for field in fields)) for i in range(n)]


def _render_bands(projs: Sequence[Projected], settings: RenderSettings,
                  band_h: int, devices: Sequence) -> List[dict]:
    """Render band i (rows [i*band_h, (i+1)*band_h) of the image) on rank i
    from the projected set `projs[i]`.  All tile geometry stays in image
    coordinates, so the bands compose to the single-device render."""
    n = len(devices)
    H, W = settings.image_height, settings.image_width
    if settings.raster != "tiles":
        raise NotImplementedError(
            f"the band-sharded render runs the tile kernels only, not "
            f"raster={settings.raster!r}")
    if settings.ring:
        C = projs[0].means2d.shape[0]
        if C % n:
            raise ValueError(
                f"settings.ring: the pool's capacity {C} does not divide "
                f"over the {n} ranks of the tile axis, and the ring route "
                "takes no other partition")
        return ring_rasterize_bands(projs, band_h, W, settings.bg_color,
                                    devices, tile_size=settings.tile_size)
    return [rasterize_tiles(
        proj, band_h, W,
        torch.as_tensor(settings.bg_color, dtype=torch.float32, device=dev),
        tile_size=settings.tile_size, row0=i * band_h, full_height=H)
        for i, (proj, dev) in enumerate(zip(projs, devices))]


def make_sharded_render(settings: RenderSettings, mesh: M.Mesh) -> Callable:
    """Band-sharded inference renderer over the mesh's tile axis:
    (Gaussians, Camera) -> dict with the whole image [3,H,W], alpha and
    depth [1,H,W] assembled on the first rank's device, `n_live` (per
    rank) and, on the ring route, `seg_live[r][b]`: the instances of depth
    range r in band b."""
    devices = mesh.tile_devices(0)
    band_h = _band_height(settings, mesh.tile)

    def sharded_render(g: Gaussians, camera: Camera) -> dict:
        gs = [g.to(dev) for dev in devices]
        cams = [camera.to(dev) for dev in devices]
        with record_function("3dgs:projection"):
            projs = _project(gs, cams, settings, devices)
        outs = _render_bands(projs, settings, band_h, devices)
        full = {k: M.all_gather([o[k] for o in outs], devices[:1], dim=1)[0]
                for k in ("image", "alpha", "depth")}
        full["n_live"] = [o["n_live"] for o in outs]
        if settings.ring:
            full["seg_live"] = [o["seg_live"] for o in outs]
        return full

    return sharded_render


def make_sharded_train_step(config: TrainingConfig, settings: RenderSettings,
                            mesh: M.Mesh, grads_only: bool = False
                            ) -> Callable:
    """The train step over the mesh: step(state, cameras, cam_idx=None,
    sh_degree=None) -> (state', metrics), with `cameras` one Camera (with
    its target image) per rank of the data axis and `cam_idx` their indices
    into the state's exposure table.

    The state is replicated: it lives on its own device and every rank
    works on a copy.  The image is band-sharded over `tile`; with
    `state.exposure` each data rank applies its camera's affine exposure to
    its bands before the banded loss (pointwise per pixel, so bands compose
    exactly).  The statistic buffers take the radii and the visibility of
    the first camera, as the JAX package's replicated step does.  With
    `grads_only` the step returns (masked gradients, metrics) and updates
    nothing."""
    band_h = _band_height(settings, mesh.tile)
    W = settings.image_width

    def step(state: TrainState, cameras: Sequence[Camera],
             cam_idx: Optional[Sequence[int]] = None,
             sh_degree: Optional[int] = None):
        if len(cameras) != mesh.data:
            raise ValueError(f"the step takes {mesh.data} cameras, one per "
                             f"rank of the data axis, got {len(cameras)}")
        st = settings if sh_degree is None \
            else settings.replace(sh_degree=sh_degree)
        g0 = state.gaussians
        home = g0.device
        params = {k: v.detach().requires_grad_(True)
                  for k, v in g0.params().items()}
        # A zero probe on the projected means: its gradient is the
        # viewspace densification statistic.
        probe = torch.zeros(g0.capacity, 2, dtype=torch.float32, device=home,
                            requires_grad=True)
        exposure = None
        if state.exposure is not None:
            exposure = state.exposure.detach().requires_grad_(True)
        g = g0.with_params(params)

        totals, parts_all, n_live, n_dropped = [], [], [], []
        radii = visible = None
        for d, camera in enumerate(cameras):
            devices = mesh.tile_devices(d)
            gs = [g.to(dev) for dev in devices]
            cams = [camera.to(dev) for dev in devices]
            with record_function("3dgs:projection"):
                projs = _project(gs, cams, st, devices)
                projs = [p._replace(means2d=p.means2d + probe.to(dev))
                         for p, dev in zip(projs, devices)]
            if d == 0:
                radii = projs[0].radius.detach().to(home)
                visible = projs[0].visible.to(home)
            outs = _render_bands(projs, st, band_h, devices)
            with record_function("3dgs:loss"):
                images = [o["image"] for o in outs]
                if exposure is not None:
                    images = [apply_exposure(exposure.to(dev)[cam_idx[d]], im)
                              for im, dev in zip(images, devices)]
                targets = [cam.image[:, i * band_h:(i + 1) * band_h, :W]
                           for i, cam in enumerate(cams)]
                total, parts = gaussian_loss_banded(
                    images, targets, devices, config.lambda_dssim)[0]
            totals.append(total.to(home))
            parts_all.append({k: v.detach().to(home)
                              for k, v in parts.items()})
            n_live += [o["n_live"] for o in outs]
            n_dropped.append(sum(o["n_dropped"] for o in outs))
        total = torch.stack(totals).mean()          # the mean over cameras

        wrt = list(params.values()) + [probe]
        if exposure is not None:
            wrt.append(exposure)
        with record_function("3dgs:backward"):
            grads_all = torch.autograd.grad(total, wrt, allow_unused=True)
        metrics = {k: torch.stack([p[k] for p in parts_all]).mean()
                   for k in parts_all[0]}
        metrics.update(
            render_drops=sum(n_dropped) / len(n_dropped),
            # the fullest stream of any rank, not the sum
            render_instances=max(n_live),
            n_visible=visible.sum())
        if grads_only:
            return mask_dead_gradients(params, grads_all, g0.alive), metrics
        new_state = apply_gradients(state, params, probe, exposure,
                                    grads_all, config, st, radii, visible)
        return new_state, metrics

    return step
