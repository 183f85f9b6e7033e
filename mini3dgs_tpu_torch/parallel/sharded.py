"""Rendering and training over a (data, tile) mesh (counterpart of
mini3dgs_tpu/parallel/sharded.py).

  * data axis: one camera per rank; the loss, and so the gradients, are the
    mean over the cameras.
  * tile axis: the image is split into horizontal bands of whole tile rows.
    Each rank projects its share of the Gaussian slots (one all_gather
    reassembles the projected set), rasterizes its band, and the banded loss
    exchanges a 5-row halo for the SSIM term.  Per-Gaussian gradients are
    the sum over the bands.

Two layouts of the train state:
  * replicated (`make_sharded_train_step`): one `TrainState` on its own
    device, every rank works on a copy;
  * gauss-sharded (`shard_train_state`, `make_gauss_sharded_train_step`):
    every [C, ...] leaf (parameters, Adam moments, statistic buffers,
    `alive`) is split into data x tile row blocks of C/n, one per rank, and
    the Adam update runs on each block where it lives.  Rank (d, t) holds
    global block t * data + d (the JAX package's tile-major `GAUSS_AXES`),
    so a gather over `data` at a fixed t is one contiguous block of slots.

Two band routes:
  * the ring exchange of depth-rank-range segments (parallel/ring.py,
    `settings.ring`), which runs the raster kernels' `t0` builds: ring v1,
    v2 with `settings.ring_reshard`, and in the gauss-sharded step v3 with
    `settings.ring_local` (each tile rank hands the ring its own gid block,
    and no rank holds the whole projected set);
  * the band route: rank i rasterizes its band's tile rows with the kernels
    built without `t0`.  It bins through the sharded candidate sort
    (`bin_gaussians_sharded`: rank i sorts the keys of gid shard i, one
    all_to_all sends each band its keys) and packs its band's instances
    only.

The ranks of an axis are a Python loop (parallel/mesh.py) and autograd
differentiates through the collectives as they stand: every rank works on
`.to` copies of the leaves, and the gradient of the one scalar loss is
already the sum over bands and the mean over cameras, delivered to each
leaf where it lives.  None of the JAX package's psum-transpose factors
exists here.  `verify_shard_grad_parity` holds either layout's gradients
against single-device autograd at setup.

Over ranks of several processes (parallel/distributed.py) every axis may
lie in one process or cross several; an axis that crosses exchanges
through the group of its processes.  Both train steps run each process's
own ranks (the others' entries are None in every per-rank list) and differ
in three places only.  Each process takes the backward of its own copy of
the loss, whose other processes' terms arrived detached (`mesh.psum`, and
the mean over cameras here), so each term is differentiated once.  The
gradients of what every process of the mesh holds (the replicated state,
the probe, the exposure table) are then added over those processes by one
`mesh.all_reduce_sum`, so the replicas take the same Adam step bit for
bit; a gauss-sharded row gets its gradient through the exchanges' backward
alone.  And what a process did not compute (other cameras' losses, other
ranks' counters, the first camera's radii and visibility that the
replicated state's statistics take) arrives after the forward pass through
`mesh.gather_processes` over the mesh's processes.  The renderers return
the whole image on every process that holds a rank, as the JAX package's
`shard_map` with `out_specs=P()` does: each process renders the bands of a
data row it holds ranks of, and the bands of the row's other processes
arrive through the row's group.  `verify_shard_grad_parity` runs over such
a mesh too, each process against the autograd of its own first rank.  A
process that holds no rank of the mesh computes nothing and gets None from
the steps, the renderers and the check.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from ..config import TrainingConfig
from ..core.camera import Camera
from ..core.gaussians import Gaussians
from ..core.loss import gaussian_loss, gaussian_loss_banded
from ..ops import binning as B
from ..ops.projection import Projected, project_gaussians
from ..ops.raster_cuda import rasterize_tiles
from ..ops.renderer import RenderSettings, render
from ..train.exposure import apply_exposure
from ..train.optimizer import AdamState
from ..train.trainer import (TrainState, apply_gradients, create_train_state,
                             densify_step, mask_dead_gradients)
from . import mesh as M
from .ring import ring_rasterize_bands


def _band_height(settings: RenderSettings, n_tile: int) -> int:
    H, ts = settings.image_height, settings.tile_size
    if H % (n_tile * ts):
        raise ValueError(f"image height {H} must split into {n_tile} bands "
                         f"of whole {ts}px tile rows")
    return H // n_tile


def _projection_kw(settings: RenderSettings) -> dict:
    return dict(radius_min=settings.radius_min,
                radius_max=settings.radius_max,
                color_mode=settings.color_mode, sh_degree=settings.sh_degree,
                scale_modifier=settings.scale_modifier,
                antialias=settings.antialias)


def _gather_projected(shards: Sequence[Projected],
                      devices: Sequence) -> List[Projected]:
    """Every rank receives the ranks' projected rows concatenated in rank
    order (an all_gather, field by field)."""
    return M.all_gather(list(shards), devices)


def _project(gs: Sequence[Gaussians], cameras: Sequence[Camera],
             settings: RenderSettings, devices: Sequence) -> List[Projected]:
    """EWA projection, primitive-sharded: rank i (holding the replicated
    pool `gs[i]`) projects Gaussian slots [i*C/n, (i+1)*C/n) only, and one
    all_gather reassembles the projected set on every rank.  The math is
    elementwise per slot, so the result equals the replicated projection;
    when C does not divide over the ranks every rank projects the whole
    pool."""
    kw = _projection_kw(settings)
    n, C = len(devices), gs[M.local_ranks(devices)[0]].capacity
    if n <= 1 or C % n:
        return [None if g is None else project_gaussians(g, cam, **kw)
                for g, cam in zip(gs, cameras)]
    Cs = C // n
    shards = [None if g is None else
              project_gaussians(g.slots(i * Cs, (i + 1) * Cs), cam, **kw)
              for i, (g, cam) in enumerate(zip(gs, cameras))]
    return _gather_projected(shards, devices)


def bin_gaussians_sharded(projs: Sequence[Projected], band_h: int, W: int,
                          tile_size: int, devices: Sequence
                          ) -> List[B.Binning]:
    """The band route's sharded candidate sort (counterpart of the JAX
    `bin_gaussians_sharded`): rank i owns image band i (rows [i * band_h,
    (i + 1) * band_h) of the band_h * n x W image) and gid shard i, the
    slots [i * C // n, (i + 1) * C // n), so C need not divide over the
    ranks.  `projs[i]` is the full projected set as rank i holds it.

    Rank i emits and sorts the (tile << 32 | depth rank) keys of its gid
    shard only, over the whole image (`binning.shard_keys`); bands are
    contiguous key ranges, so it cuts its sorted keys into n segments,
    sends segment b to rank b (one `all_to_all` of variable-length slices)
    and merges the n sorted segments it receives with one sort.  Returns
    one `Binning` per rank: exactly the single-device binning of its band's
    tiles (the same `s_rank`, tile ranges local to the band), with
    `counts_gid` the instances each Gaussian emits in the band.  The depth
    order is one stable sort over the full set on every rank, as in the
    JAX package."""
    n = len(devices)
    C = projs[M.local_ranks(devices)[0]].means2d.shape[0]
    if band_h % tile_size:
        raise ValueError(f"a band of {band_h} rows is not whole "
                         f"{tile_size}-pixel tile rows")
    ntb = band_h // tile_size * -(-W // tile_size)
    send, orders = [], []
    for i, proj in enumerate(projs):
        if proj is None:
            send.append(None)
            orders.append(None)
            continue
        s_key, order, rank = B.shard_keys(
            proj, band_h * n, W, tile_size, slice(i * C // n,
                                                  (i + 1) * C // n))
        cuts = torch.arange(n + 1, device=s_key.device) * ntb << 32
        bounds = torch.searchsorted(s_key, cuts).tolist()
        send.append([s_key[bounds[b]:bounds[b + 1]] for b in range(n)])
        orders.append((order, rank))
    recv = M.all_to_all(send, devices)
    return [None if keys is None else B.band_binning(
        torch.sort(torch.cat(keys)).values if n > 1 else keys[0],
        *order_rank, i * ntb, ntb)
        for i, (keys, order_rank) in enumerate(zip(recv, orders))]


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
        C = projs[M.local_ranks(devices)[0]].means2d.shape[0]
        if C % n:
            raise ValueError(
                f"settings.ring: the pool's capacity {C} does not divide "
                f"over the {n} ranks of the tile axis, and the ring route "
                "takes no other partition")
        return ring_rasterize_bands(projs, band_h, W, settings.bg_color,
                                    devices, tile_size=settings.tile_size,
                                    reshard=settings.ring_reshard)
    with record_function("3dgs:binning"):
        bins = bin_gaussians_sharded(projs, band_h, W, settings.tile_size,
                                     devices)
    return [None if proj is None else rasterize_tiles(
        proj, band_h, W,
        torch.as_tensor(settings.bg_color, dtype=torch.float32, device=dev),
        tile_size=settings.tile_size, row0=i * band_h, full_height=H,
        binning=b)
        for i, (proj, dev, b) in enumerate(zip(projs, devices, bins))]


_BAND_KEYS = ("image", "alpha", "depth", "n_live", "seg_live")


def _every_band(outs: Sequence[dict], devices: Sequence) -> List[dict]:
    """Across processes: every band's render (the keys `_assemble` reads),
    the other processes' bands detached, through the axis's group."""
    got = M.gather_ranks([None if o is None else
                          tuple(o.get(k) for k in _BAND_KEYS) for o in outs],
                         devices)
    return [dict(zip(_BAND_KEYS, v)) for v in got]


def _render_rows(mesh: M.Mesh) -> List[int]:
    """The data rows whose bands this process renders: the first that holds
    one of its ranks, and every later one that holds one of them and
    crosses processes (its other processes need this one's bands)."""
    rows = [d for d in range(mesh.data)
            if M.local_ranks(mesh.tile_devices(d))]
    return rows[:1] + [d for d in rows[1:]
                       if M.spans_processes(mesh.tile_devices(d))]


def _assemble(outs: Sequence[dict], device, ring: bool) -> dict:
    """The whole image, alpha and depth from the bands, on `device`."""
    full = {k: M.all_gather([o[k] for o in outs], [device], dim=1)[0]
            for k in ("image", "alpha", "depth")}
    full["n_live"] = [o["n_live"] for o in outs]
    if ring:
        full["seg_live"] = [o["seg_live"] for o in outs]
    return full


def _band_loss(outs: Sequence[dict], camera: Camera, devices: Sequence,
               band_h: int, W: int, config: TrainingConfig,
               exposure: Optional[torch.Tensor], cam_idx: Optional[int]):
    """The banded L1 + D-SSIM of one camera's bands (with its affine
    exposure applied to each band first): (total, parts) on the device of
    the first of this process's ranks."""
    with record_function("3dgs:loss"):
        images = [None if o is None else o["image"] for o in outs]
        if exposure is not None:
            images = [None if im is None else
                      apply_exposure(exposure.to(dev)[cam_idx], im)
                      for im, dev in zip(images, devices)]
        targets = [camera.image.to(dev)[:, i * band_h:(i + 1) * band_h, :W]
                   if M.is_local(dev) else None
                   for i, dev in enumerate(devices)]
        return gaussian_loss_banded(images, targets, devices,
                                    config.lambda_dssim)[
                                        M.local_ranks(devices)[0]]


def _camera_mean(totals: Sequence[torch.Tensor]) -> torch.Tensor:
    """The data axis' reduction of the loss: the mean over the cameras."""
    return torch.stack(totals).mean()


_PARTS = ("l1", "dssim", "total_loss")


def _rank_counters(out: dict) -> tuple:
    """(n_live, n_dropped, reshard_drops) of one band's render."""
    return out["n_live"], out["n_dropped"], out.get("reshard_drops", 0)


def _from_processes(mesh: M.Mesh, home, totals: list, parts_all: list,
                    counters: list, extra=None):
    """Across processes: fill in what this process did not compute from the
    processes that did, after the forward pass.  `totals` / `parts_all`
    are per camera and `counters` per rank (None where another process
    holds the camera's or the rank's results); `extra` is a value that one
    process holds and the others take.  The losses arrive detached, on
    `home`: the gradient of the mean over cameras stays with each camera's
    own process."""
    got = M.gather_processes((
        [None if t is None else t.detach() for t in totals],
        [None if p is None else [p[k] for k in _PARTS] for p in parts_all],
        counters, extra), home, mesh.processes())

    def held(pick):
        return next(v for v in map(pick, got) if v is not None)

    for d in range(len(totals)):
        if totals[d] is None:
            totals[d] = held(lambda g: g[0][d])
            parts_all[d] = dict(zip(_PARTS, held(lambda g: g[1][d])))
    counters = [held(lambda g: g[2][r]) for r in range(len(counters))]
    if any(g[3] is not None for g in got):
        extra = held(lambda g: g[3])
    return totals, parts_all, counters, extra


def _grads(total: torch.Tensor, wrt: list, mesh: M.Mesh, cross: bool,
           replicated: Sequence[int]) -> list:
    """The gradients of `total` with respect to `wrt` (None where the loss
    does not reach a leaf).  Across processes the leaves at the positions
    `replicated` are held by every process of the mesh: their gradients
    (zeros for None) are added over those processes."""
    with record_function("3dgs:backward"):
        if not cross:
            return list(torch.autograd.grad(total, wrt, allow_unused=True))
        grads = list(torch.autograd.grad(total, wrt + [M.ANCHOR],
                                         allow_unused=True)[:-1])
    summed = M.all_reduce_sum([torch.zeros_like(wrt[i]) if grads[i] is None
                               else grads[i] for i in replicated],
                              mesh.processes())
    for i, g in zip(replicated, summed):
        grads[i] = g
    return grads


def _step_metrics(parts_all, counters, n_visible, ring: bool,
                  n_tile: int) -> dict:
    """The step's metrics from each camera's loss terms and each rank's
    counters (rank d * n_tile + t renders band t of camera d): the loss
    terms and the drops the mean over the cameras (drops summed over each
    camera's bands), the fullest stream of any rank; on the ring route
    also `reshard_drops`, rows of the rank reshard (always 0 here: it moves
    every row)."""
    metrics = {k: torch.stack([p[k] for p in parts_all]).mean()
               for k in parts_all[0]}
    per_cam = lambda i: [sum(c[i] for c in counters[d:d + n_tile])
                         for d in range(0, len(counters), n_tile)]
    n_dropped = per_cam(1)
    metrics.update(
        render_drops=sum(n_dropped) / len(n_dropped),
        # the fullest stream of any rank, not the sum
        render_instances=max(c[0] for c in counters),
        n_visible=n_visible)
    if ring:
        drops = per_cam(2)
        metrics["reshard_drops"] = sum(drops) / len(drops)
    return metrics


def _row_image(outs: Sequence[dict], devices: Sequence, ring: bool) -> dict:
    """`_assemble` of one data row's bands on the device of this process's
    first rank of the row, the other processes' bands gathered first."""
    if M.spans_processes(devices):
        outs = _every_band(outs, devices)
    return _assemble(outs, devices[M.local_ranks(devices)[0]], ring)


def make_sharded_render(settings: RenderSettings, mesh: M.Mesh) -> Callable:
    """Band-sharded inference renderer over the mesh's tile axis:
    (Gaussians, Camera) -> dict with the whole image [3,H,W], alpha and
    depth [1,H,W] assembled on the device of this process's first rank of
    the row it renders (data row 0 in one process), `n_live` (per rank)
    and, on the ring route, `seg_live[r][b]`: the instances of depth range
    r in band b.  Over several processes every process that holds a rank
    gets the whole image (`_render_rows`); one that holds none gets None."""
    band_h = _band_height(settings, mesh.tile)
    rows = _render_rows(mesh)

    def sharded_render(g: Gaussians, camera: Camera) -> Optional[dict]:
        full = None
        for d in rows:
            devices = mesh.tile_devices(d)
            gs = [g.to(dev) if M.is_local(dev) else None for dev in devices]
            cams = [camera.to(dev) if M.is_local(dev) else None
                    for dev in devices]
            with record_function("3dgs:projection"):
                projs = _project(gs, cams, settings, devices)
            outs = _render_bands(projs, settings, band_h, devices)
            out = _row_image(outs, devices, settings.ring)
            full = full or out
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
    works on a copy (over several processes, every process holds one, and
    the replicas stay equal bit for bit).  The image is band-sharded over
    `tile`; with `state.exposure` each data rank applies its camera's
    affine exposure to its bands before the banded loss (pointwise per
    pixel, so bands compose exactly).  The statistic buffers take the radii
    and the visibility of the first camera, as the JAX package's
    replicated step does.  With `grads_only` the step returns (masked
    gradients, metrics) and updates nothing."""
    band_h = _band_height(settings, mesh.tile)
    W = settings.image_width
    cross = M.spans_processes(mesh.devices)

    def step(state: TrainState, cameras: Sequence[Camera],
             cam_idx: Optional[Sequence[int]] = None,
             sh_degree: Optional[int] = None):
        if len(cameras) != mesh.data:
            raise ValueError(f"the step takes {mesh.data} cameras, one per "
                             f"rank of the data axis, got {len(cameras)}")
        if not mesh.local_ranks():
            return None, None  # this process holds no rank of the mesh
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

        totals, parts_all, counters = [], [], []
        radii = visible = None
        for d, camera in enumerate(cameras):
            devices = mesh.tile_devices(d)
            if not M.local_ranks(devices):
                # another process renders this camera
                totals.append(None)
                parts_all.append(None)
                counters += [None] * len(devices)
                continue
            here = [M.is_local(dev) for dev in devices]
            gs = [g.to(dev) if h else None for dev, h in zip(devices, here)]
            cams = [camera.to(dev) if h else None
                    for dev, h in zip(devices, here)]
            with record_function("3dgs:projection"):
                projs = _project(gs, cams, st, devices)
                projs = [None if p is None else
                         p._replace(means2d=p.means2d + probe.to(dev))
                         for p, dev in zip(projs, devices)]
            if d == 0 and here[0]:
                radii = projs[0].radius.detach().to(home)
                visible = projs[0].visible.to(home)
            outs = _render_bands(projs, st, band_h, devices)
            total, parts = _band_loss(outs, camera, devices, band_h, W,
                                      config, exposure,
                                      None if cam_idx is None else cam_idx[d])
            totals.append(total.to(home))
            parts_all.append({k: v.detach().to(home)
                              for k, v in parts.items()})
            counters += [None if o is None else _rank_counters(o)
                         for o in outs]
        if cross:
            totals, parts_all, counters, first = _from_processes(
                mesh, home, totals, parts_all, counters,
                None if radii is None else (radii, visible))
            radii, visible = first
        total = _camera_mean(totals)

        wrt = list(params.values()) + [probe]
        if exposure is not None:
            wrt.append(exposure)
        grads_all = _grads(total, wrt, mesh, cross, range(len(wrt)))
        metrics = _step_metrics(parts_all, counters, visible.sum(), st.ring,
                                mesh.tile)
        if grads_only:
            return mask_dead_gradients(params, grads_all, g0.alive), metrics
        new_state = apply_gradients(state, params, probe, exposure,
                                    grads_all, config, st, radii, visible)
        return new_state, metrics

    return step


# ---------------------------------------------------------------------------
# The gauss-sharded state: every [C, ...] leaf split over the mesh's ranks.
# ---------------------------------------------------------------------------

# The order in which the mesh's axes split the slots: tile-major, so that
# rank (d, t) holds global block t * data + d.  A gather over `data` at a
# fixed t then yields one contiguous block of slots per tile index, and a
# second gather over `tile` restores the global slot order.
GAUSS_AXES = ("tile", "data")


def gauss_block(mesh: M.Mesh, rank: int) -> int:
    """The global block of slots that rank `rank` (= d * tile + t, the
    index of its device in `mesh.devices`) holds: t * data + d."""
    d, t = divmod(rank, mesh.tile)
    return t * mesh.data + d


def _rank_of(mesh: M.Mesh, d: int, t: int) -> int:
    return d * mesh.tile + t


@dataclass
class GaussShardedState:
    """A `TrainState` split over the ranks of a mesh: `shards[r]` is rank
    r's own `TrainState`, on `mesh.devices[r]`, holding the C/n slots of
    global block `gauss_block(mesh, r)` of every [C, ...] leaf (None for a
    rank of another process).  `step`, the Adam counts and the exposure
    table (with its Adam state) are replicated: every shard has them,
    equal."""

    shards: List[Optional[TrainState]]

    @property
    def _first(self) -> TrainState:
        return next(s for s in self.shards if s is not None)

    @property
    def step(self) -> int:
        return self._first.step

    @property
    def capacity(self) -> int:
        return self._first.gaussians.capacity * len(self.shards)

    def num_alive(self) -> int:
        """The live slots of this process's ranks."""
        return sum(s.gaussians.num_alive() for s in self.shards
                   if s is not None)


def _copy_to(x, device):
    return None if x is None else x.to(device, copy=True)


def _adam_copy(s: Optional[AdamState], device, rows=slice(None)
               ) -> Optional[AdamState]:
    if s is None:
        return None
    rows_of = lambda moments: {k: _copy_to(v[rows], device)
                               for k, v in moments.items()}
    return AdamState(count=s.count, sched_count=s.sched_count,
                     mu=rows_of(s.mu), nu=rows_of(s.nu))


def shard_train_state(state: TrainState, mesh: M.Mesh) -> GaussShardedState:
    """Split `state` over the mesh: every [C, ...] leaf (each field of the
    pool, each Adam moment) by rows, the rest replicated -- the JAX
    package's `train_state_specs`, which torch needs no annotations for.
    The shards are copies: they share no storage with `state`.  Over
    several processes each process keeps its own ranks' shards.  Raises
    ValueError when the capacity does not divide over the ranks."""
    C = state.gaussians.capacity
    n = mesh.data * mesh.tile
    if C % n:
        raise ValueError(
            f"the pool's capacity {C} does not divide over the {n} ranks of "
            f"the ({mesh.data}, {mesh.tile}) mesh; the gauss-sharded state "
            f"needs a multiple of {n}")
    Cs = C // n
    shards = []
    for r, dev in enumerate(mesh.devices):
        if not M.is_local(dev):
            shards.append(None)
            continue
        b = gauss_block(mesh, r)
        rows = slice(b * Cs, (b + 1) * Cs)
        g = state.gaussians._map(lambda x: _copy_to(x[rows], dev))
        shards.append(TrainState(
            gaussians=g, opt_state=_adam_copy(state.opt_state, dev, rows),
            step=state.step, exposure=_copy_to(state.exposure, dev),
            exp_opt_state=_adam_copy(state.exp_opt_state, dev)))
    return GaussShardedState(shards)


def _by_block(mesh: M.Mesh) -> List[int]:
    """The ranks in the order of the blocks they hold."""
    return sorted(range(mesh.data * mesh.tile),
                  key=lambda r: gauss_block(mesh, r))


def _every_rank(xs: Sequence, mesh: M.Mesh, device) -> list:
    """Per-rank values (tensors, or tuples of them) with the entries of
    other processes' ranks filled in from them, on `device`, without
    autograd; `xs` itself in one process."""
    if not M.spans_processes(mesh.devices):
        return list(xs)
    got = M.gather_processes(list(xs), device, mesh.processes())
    return [next(g[r] for g in got if g[r] is not None)
            for r in range(len(xs))]


def _gather_rows(xs: Sequence[torch.Tensor], mesh: M.Mesh,
                 device) -> torch.Tensor:
    """Per-rank row blocks `xs[r]` concatenated in global slot order on
    `device`."""
    xs = _every_rank(xs, mesh, device)
    return torch.cat([xs[r].to(device) for r in _by_block(mesh)])


_POOL_FIELDS = tuple(f.name for f in dataclasses.fields(Gaussians))


def _cat_gaussians(gs: Sequence[Gaussians], device) -> Gaussians:
    """Row blocks of the pool concatenated on `device` (differentiable)."""
    return Gaussians(**{k: torch.cat([getattr(g, k).to(device) for g in gs])
                        for k in _POOL_FIELDS})


def gather_gaussians(shards: Sequence[Gaussians], mesh: M.Mesh,
                     device) -> Gaussians:
    """The whole pool on `device` from its per-rank blocks."""
    if M.spans_processes(mesh.devices):
        fields = _every_rank([None if g is None else
                              tuple(getattr(g, k) for k in _POOL_FIELDS)
                              for g in shards], mesh, device)
        shards = [Gaussians(**dict(zip(_POOL_FIELDS, f))) for f in fields]
    return _cat_gaussians([shards[r] for r in _by_block(mesh)], device)


def gather_train_state(state: GaussShardedState, mesh: M.Mesh,
                       device=None) -> TrainState:
    """The inverse of `shard_train_state`, bit for bit: the whole state on
    `device` (default the device of this process's first rank).  Over
    several processes every process receives it."""
    device = mesh.devices[mesh.local_ranks()[0]] if device is None \
        else device
    shards = state.shards
    first = state._first
    opt = first.opt_state
    rows = lambda slot, k: _gather_rows(
        [None if s is None else getattr(s.opt_state, slot)[k]
         for s in shards], mesh, device)
    return TrainState(
        gaussians=gather_gaussians([None if s is None else s.gaussians
                                    for s in shards], mesh, device),
        opt_state=AdamState(count=opt.count, sched_count=opt.sched_count,
                            mu={k: rows("mu", k) for k in opt.mu},
                            nu={k: rows("nu", k) for k in opt.nu}),
        step=first.step, exposure=_copy_to(first.exposure, device),
        exp_opt_state=_adam_copy(first.exp_opt_state, device))


def _data_blocks(mesh: M.Mesh, local: Sequence[Gaussians],
                 probes: Sequence[torch.Tensor]) -> dict:
    """For each rank (d, t) of this process: the pool rows of ranks (d', t)
    for every d' (one contiguous block of slots) and their probes, as one
    all_gather over the data axis at each t (differentiable)."""
    blocks = {}
    for t in range(mesh.tile):
        if not M.local_ranks(mesh.data_devices(t)):
            continue  # another process holds this axis
        ranks = [_rank_of(mesh, d, t) for d in range(mesh.data)]
        got = M.all_gather(
            [None if local[r] is None else
             tuple(getattr(local[r], k) for k in _POOL_FIELDS) + (probes[r],)
             for r in ranks], mesh.data_devices(t))
        for r, fields in zip(ranks, got):
            if fields is not None:
                blocks[r] = (Gaussians(**dict(zip(_POOL_FIELDS, fields))),
                             fields[-1])
    return blocks


def make_gauss_sharded_train_step(config: TrainingConfig,
                                  settings: RenderSettings, mesh: M.Mesh,
                                  grads_only: bool = False) -> Callable:
    """The train step over a gauss-sharded state: step(state, cameras,
    cam_idx=None, sh_degree=None) -> (state', metrics), with the camera
    batch of `make_sharded_train_step`.

    For each data rank d: every rank (d, t) gathers the parameter rows of
    ranks (d', t) over `data` (one contiguous block of slots), projects
    them under camera d and adds the zero probe; the projected blocks are
    gathered over `tile` (the global slot order), the bands render, and the
    banded loss is taken; the loss is the mean over the cameras.  With
    `settings.ring` and `settings.ring_local` over more than one tile rank
    (ring v3, which takes precedence over `ring_reshard` here) the tile
    gather is skipped: each tile rank hands the ring its projected block,
    and per-rank activations stay O(C / tile).  Autograd
    through the gathers hands each rank the gradient of its own rows.  Each
    rank then masks its dead rows and runs Adam on its rows where they live;
    the exposure table gets the one gradient of the whole loss on every
    rank, so its replicas stay equal.  The statistic buffers accumulate the
    radius and visibility of each rank's own rows under its own data
    camera, as the JAX package's gauss-sharded step does.  With
    `grads_only` the step returns (the masked gradients gathered in global
    slot order on the first rank's device, metrics) and updates nothing.
    The data gathers run before the cameras (over several processes every
    process takes part in each), and the state's entries of other
    processes' ranks are None."""
    band_h = _band_height(settings, mesh.tile)
    W = settings.image_width
    n_data, n_tile = mesh.data, mesh.tile
    mine = mesh.local_ranks()
    cross = M.spans_processes(mesh.devices)

    def step(state: GaussShardedState, cameras: Sequence[Camera],
             cam_idx: Optional[Sequence[int]] = None,
             sh_degree: Optional[int] = None):
        if len(cameras) != n_data:
            raise ValueError(f"the step takes {n_data} cameras, one per "
                             f"rank of the data axis, got {len(cameras)}")
        if not mine:
            return None, None  # this process holds no rank of the mesh
        st = settings if sh_degree is None \
            else settings.replace(sh_degree=sh_degree)
        kw = _projection_kw(st)
        ring_local = st.ring and st.ring_local and n_tile > 1
        shards = state.shards
        first = state._first
        Cs = first.gaussians.capacity
        home = mesh.devices[mine[0]]
        params = [None if s is None else
                  {k: v.detach().requires_grad_(True)
                   for k, v in s.gaussians.params().items()} for s in shards]
        probes = [torch.zeros(Cs, 2, dtype=torch.float32, device=dev,
                              requires_grad=True) if M.is_local(dev) else None
                  for dev in mesh.devices]
        exposure = None
        if first.exposure is not None:
            exposure = first.exposure.detach().requires_grad_(True)
        local = [None if s is None else s.gaussians.with_params(p)
                 for s, p in zip(shards, params)]
        blocks = _data_blocks(mesh, local, probes)

        totals, parts_all, counters = [], [], []
        radii, visible = [None] * len(shards), [None] * len(shards)
        for d, camera in enumerate(cameras):
            devices = mesh.tile_devices(d)
            if not M.local_ranks(devices):
                totals.append(None)
                parts_all.append(None)
                counters += [None] * n_tile
                continue
            slices = []
            with record_function("3dgs:projection"):
                for t, dev in enumerate(devices):
                    r = _rank_of(mesh, d, t)
                    if not M.is_local(dev):
                        slices.append(None)
                        continue
                    block, probe = blocks[r]
                    proj = project_gaussians(block, camera.to(dev), **kw)
                    proj = proj._replace(means2d=proj.means2d + probe)
                    # this rank's own rows sit at position d of the block
                    own = slice(d * Cs, (d + 1) * Cs)
                    radii[r] = proj.radius[own].detach()
                    visible[r] = proj.visible[own]
                    slices.append(proj)
                if not ring_local:
                    slices = _gather_projected(slices, devices)
            if ring_local:
                # ring v3: rank t's slices are the contiguous gid block t
                outs = ring_rasterize_bands(
                    slices, band_h, W, st.bg_color, devices,
                    tile_size=st.tile_size, gid_sharded=True)
            else:
                outs = _render_bands(slices, st, band_h, devices)
            total, parts = _band_loss(outs, camera, devices, band_h, W,
                                      config, exposure,
                                      None if cam_idx is None else cam_idx[d])
            totals.append(total.to(home))
            parts_all.append({k: v.detach().to(home)
                              for k, v in parts.items()})
            counters += [None if o is None else _rank_counters(o)
                         for o in outs]
        vis_sums = [None if v is None else v.sum() for v in visible]
        if cross:
            counters = [None if c is None else (*c, v)
                        for c, v in zip(counters, vis_sums)]
            totals, parts_all, counters, _ = _from_processes(
                mesh, home, totals, parts_all, counters)
            vis_sums = [c[3] for c in counters]
        total = _camera_mean(totals)

        n_params = len(params[mine[0]])
        wrt = [v for r in mine for v in params[r].values()] \
            + [probes[r] for r in mine]
        if exposure is not None:
            wrt.append(exposure)
        # the exposure table is the one leaf that every process holds
        grads_all = _grads(total, wrt, mesh, cross,
                           [len(wrt) - 1] if exposure is not None else [])
        n_visible = sum(v.to(home) for v in vis_sums)
        metrics = _step_metrics(parts_all, counters, n_visible, st.ring,
                                n_tile)
        rank_grads = [None] * len(shards)
        for k, r in enumerate(mine):
            own = list(grads_all[k * n_params:(k + 1) * n_params])
            own.append(grads_all[len(mine) * n_params + k])
            if exposure is not None:
                gr = grads_all[-1]
                own.append(None if gr is None else gr.to(mesh.devices[r]))
            rank_grads[r] = own
        if grads_only:
            masked = [None if p is None else
                      mask_dead_gradients(p, gr, s.gaussians.alive)
                      for p, gr, s in zip(params, rank_grads, shards)]
            return {k: _gather_rows([None if m is None else m[k]
                                     for m in masked], mesh, home)
                    for k in masked[mine[0]]}, metrics
        new = [None if s is None else
               apply_gradients(s, p, probe, s.exposure, gr, config, st,
                               rad, vis)
               for s, p, probe, gr, rad, vis in zip(
                   shards, params, probes, rank_grads, radii, visible)]
        return GaussShardedState(new), metrics

    return step


def make_gauss_sharded_render(settings: RenderSettings,
                              mesh: M.Mesh) -> Callable:
    """Inference renderer over a gauss-sharded pool: (shards, Camera) ->
    the dict of `make_sharded_render`, with `shards[r]` rank r's Gaussians
    (None for another process's rank).  Each rank projects its own rows,
    one gather over every rank reassembles the projected set in global
    slot order on the ranks of the tile axis (over several processes: one
    exchange of the mesh's processes brings every rank's rows to each of
    them), the bands render and the image is assembled as
    `make_sharded_render` does.  The parameters are never gathered."""
    band_h = _band_height(settings, mesh.tile)
    kw = _projection_kw(settings)
    rows = _render_rows(mesh)

    def gauss_sharded_render(shards: Sequence[Gaussians],
                             camera: Camera) -> Optional[dict]:
        if not rows:
            return None
        with record_function("3dgs:projection"):
            local = [None if g is None else
                     project_gaussians(g, camera.to(dev), **kw)
                     for g, dev in zip(shards, mesh.devices)]
            local = [Projected(*p) for p in
                     M.gather_ranks(local, mesh.devices)]
            blocks = [local[r] for r in _by_block(mesh)]
        full = None
        for d in rows:
            devices = mesh.tile_devices(d)
            with record_function("3dgs:projection"):
                # every block is here: concatenate on the local ranks
                here = iter(M.all_gather(
                    blocks, [dev for dev in devices if M.is_local(dev)]))
                projs = [next(here) if M.is_local(dev) else None
                         for dev in devices]
            outs = _render_bands(projs, settings, band_h, devices)
            out = _row_image(outs, devices, settings.ring)
            full = full or out
        return full

    return gauss_sharded_render


def make_gauss_sharded_densify_step(config: TrainingConfig,
                                    mesh: M.Mesh) -> Callable:
    """Densify and prune over a gauss-sharded state: step(state, noise,
    scene_extent, size_prune=False) -> (state', stats).  It gathers the
    state on the device of `noise`, runs `train.trainer.densify_step` on it
    (the global cumsum and nonzero that decide which free slots the
    children fill; the Adam moments of every changed slot zeroed) and
    splits the result again, so it equals the single-device densify of the
    gathered state bit for bit."""
    def densify(state: GaussShardedState, noise: torch.Tensor,
                scene_extent: float, size_prune: bool = False):
        whole = gather_train_state(state, mesh, noise.device)
        whole, stats = densify_step(whole, noise, scene_extent, config,
                                    size_prune)
        return shard_train_state(whole, mesh), stats

    return densify


def verify_shard_grad_parity(config: TrainingConfig, mesh: M.Mesh,
                             gauss_sharded: bool = False,
                             tol: float = 0.05) -> float:
    """One tiny step through the real sharded step factory (`grads_only`),
    in either layout, against single-device autograd of `render` on the
    device of this process's first rank: an image of mesh.tile bands of
    one 16-pixel tile row and 16 columns, 8 slots per rank.  Returns the
    worst deviation of a parameter's gradient, normalised by that
    gradient's largest entry; raises RuntimeError above `tol`.  Over
    several processes every process checks its own (all must call it
    together); one that holds no rank gets None.  The band render runs
    the tile kernels (their plain versions on CPU ranks)."""
    n_tile, n_data = mesh.tile, mesh.data
    ts = 16
    H, W = n_tile * ts, ts
    n = 8 * n_data * n_tile
    mine = mesh.local_ranks()
    if not mine:
        return None
    dev = mesh.devices[mine[0]]
    rng = np.random.default_rng(0)
    xyz = np.concatenate([rng.uniform(-0.4, 0.4, (n, 2)),
                          rng.uniform(1.0, 3.0, (n, 1))],
                         axis=1).astype(np.float32)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    rotation = np.zeros((n, 4), np.float32)
    rotation[:, 0] = 1.0
    g = Gaussians(
        xyz=as_t(xyz), features_dc=as_t(rng.uniform(-1, 1, (n, 1, 3))),
        features_rest=as_t(np.zeros((n, 15, 3))),
        scaling=as_t(np.full((n, 3), np.log(0.15))), rotation=as_t(rotation),
        opacity=as_t(rng.uniform(-1, 1, (n, 1))),
        alive=torch.ones(n, dtype=torch.bool, device=dev))
    cam = Camera.create(0, np.eye(3, dtype=np.float32),
                        np.asarray([0.0, 0.0, -1.0], np.float32), 1.2, 1.2,
                        width=W, height=H, device=dev,
                        image=rng.uniform(0, 1, (3, H, W)))
    tiny = dataclasses.replace(
        config, capacity=n, image_height=H, image_width=W,
        use_exposure=False, tile_size=ts, mesh_data=n_data, mesh_tile=n_tile)
    settings = RenderSettings(image_height=H, image_width=W, tile_size=ts)

    params = {k: v.detach().requires_grad_(True)
              for k, v in g.params().items()}
    total, _ = gaussian_loss(render(g.with_params(params), cam,
                                    settings)["image"], cam.image,
                             tiny.lambda_dssim)
    ref = dict(zip(params, torch.autograd.grad(total, list(params.values()),
                                               allow_unused=True)))

    state = create_train_state(g, tiny)
    if gauss_sharded:
        step = make_gauss_sharded_train_step(tiny, settings, mesh,
                                             grads_only=True)
        state = shard_train_state(state, mesh)
    else:
        step = make_sharded_train_step(tiny, settings, mesh, grads_only=True)
    grads, _ = step(state, [cam] * n_data)

    worst, worst_key = 0.0, None
    for k, a in ref.items():
        a = torch.zeros_like(params[k]) if a is None else a
        b = grads[k].to(a.device)
        dev_k = float((a - b).abs().max() / (a.abs().max() + 1e-12))
        if dev_k > worst:
            worst, worst_key = dev_k, k
    if worst > tol:
        raise RuntimeError(
            f"the sharded gradient reduction deviates from single-device "
            f"autograd by {worst:.3g} (leaf {worst_key!r}, tol {tol}) on the "
            f"({n_data}, {n_tile}) mesh, "
            f"{'gauss-sharded' if gauss_sharded else 'replicated'} state: "
            f"the step's reductions are wrong; do not train with it")
    return worst

