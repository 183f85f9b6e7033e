"""numpy <-> port bridges.

Parameters, statistic buffers, target images and the optimizer state cross
between the JAX package and this port as numpy arrays, so both compute on
identical inputs in the parity tests; the flagship scene is
rebuilt here in numpy, array for array as `__graft_entry__._scene` builds
it, so the port can render it without importing the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .core.camera import Camera
from .core.gaussians import PARAM_NAMES, STAT_NAMES, Gaussians
from .train.optimizer import AdamState


def gaussians_from_numpy(params: dict, alive, device="cpu",
                         stats: dict = None) -> Gaussians:
    """Slot pool from full-capacity numpy arrays named as in PARAM_NAMES
    (the JAX `Gaussians.params()` keys) plus the [C] `alive` mask and,
    optionally, the statistic buffers named as in STAT_NAMES (zeros when
    left out)."""
    f32 = dict(dtype=torch.float32, device=device)
    as_f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), **f32)
    return Gaussians(
        **{k: as_f32(params[k]) for k in PARAM_NAMES},
        **{k: as_f32(stats[k]) for k in STAT_NAMES if stats is not None},
        alive=torch.as_tensor(np.asarray(alive, bool), device=device))


def gaussians_to_numpy(g: Gaussians):
    """(params, alive, stats) as numpy arrays: the inverse of
    `gaussians_from_numpy`."""
    n = lambda t: t.detach().cpu().numpy()
    return ({k: n(getattr(g, k)) for k in PARAM_NAMES}, n(g.alive),
            {k: n(getattr(g, k)) for k in STAT_NAMES})


def adam_state_from_numpy(count: int, mu: dict, nu: dict, sched_count: int,
                          device="cpu") -> AdamState:
    """The port's Adam state from optax's slots: `count`, `mu` and `nu` of
    `ScaleByAdamState` (dicts keyed as PARAM_NAMES) and the count of
    `ScaleByScheduleState`."""
    f32 = dict(dtype=torch.float32, device=device)
    as_f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), **f32)
    return AdamState(count=int(count), sched_count=int(sched_count),
                     mu={k: as_f32(v) for k, v in mu.items()},
                     nu={k: as_f32(v) for k, v in nu.items()})


def adam_state_to_numpy(state: AdamState) -> dict:
    """dict(count, sched_count, mu, nu) with numpy moments: the inverse of
    `adam_state_from_numpy`."""
    n = lambda t: t.detach().cpu().numpy()
    return dict(count=state.count, sched_count=state.sched_count,
                mu={k: n(v) for k, v in state.mu.items()},
                nu={k: n(v) for k, v in state.nu.items()})


def camera_from_numpy(R, T, FoVx, FoVy, width: int, height: int,
                      uid: int = 0, device="cpu", image=None) -> Camera:
    """Camera from a camera->world rotation, a world-frame center and
    float32 FoVs (as the JAX `Camera.create` takes them), with an optional
    [3,H,W] target image."""
    return Camera.create(uid, R, T, FoVx, FoVy, width=width, height=height,
                         device=device, image=image)


def flagship_scene_numpy(capacity: int = 2048, n: int = 1024,
                         seed: int = 0):
    """The flagship scene of `__graft_entry__._scene`: n random isotropic
    Gaussians in a +-1 cube inside a `capacity` slot pool, and the bench
    camera 3 units in front of it (60 deg FoV).  Returns
    (params, alive, camera) with `camera` the keyword arguments of
    `camera_from_numpy` minus width/height."""
    rng = np.random.default_rng(seed)
    ext = 1.0
    xyz = np.zeros((capacity, 3), np.float32)
    xyz[:n] = (rng.random((n, 3)) - 0.5) * (2 * ext)
    fdc = np.zeros((capacity, 1, 3), np.float32)
    fdc[:n] = rng.random((n, 1, 3))
    frest = np.zeros((capacity, 15, 3), np.float32)
    scal = np.full((capacity, 3), -10.0, np.float32)
    scal[:n] = math.log(0.02 * ext)
    rot = np.zeros((capacity, 4), np.float32)
    rot[:, 0] = 1.0
    q = rng.standard_normal((n, 4)).astype(np.float32)
    rot[:n] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    opac = np.full((capacity, 1), -10.0, np.float32)
    opac[:n] = -2.0
    alive = np.zeros(capacity, bool)
    alive[:n] = True
    params = dict(xyz=xyz, features_dc=fdc, features_rest=frest,
                  scaling=scal, rotation=rot, opacity=opac)
    camera = dict(R=np.eye(3), T=np.array([0.0, 0.0, -3.0]),
                  FoVx=math.radians(60), FoVy=math.radians(60))
    return params, alive, camera


def ring_tile_lists(rank, tile_start, tile_count, seg_offset) -> list:
    """The per-band, per-tile depth-rank lists of one origin of the ring
    binning: `lists[b][t]` are the ranks of band b's tile t in stream
    order.  `rank` is the origin's flat stream of depth ranks, `tile_start`
    and `tile_count` [n_bands, T_band] its segment-local tile ranges and
    `seg_offset[b]` the place of band b's segment in the stream: the JAX
    `RingBinning` (`flat_rank`, segments `seg_capacity` apart) and the
    port's (`s_rank`, `seg_start`) both read this way, as numpy arrays."""
    rank, tile_start, tile_count = (np.asarray(a) for a in
                                    (rank, tile_start, tile_count))
    return [[rank[off + s:off + s + c].tolist()
             for s, c in zip(tile_start[b], tile_count[b])]
            for b, off in enumerate(seg_offset)]
