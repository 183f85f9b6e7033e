"""Gaussian scene state (counterpart of mini3dgs_tpu/core/gaussians.py).

A fixed-capacity slot pool with an `alive` mask, as in the JAX package, so
parameters map slot for slot onto JAX's: dead slots carry ~0 opacity and
tiny scales and are culled by the projection.  The pool is made from a
point cloud (`create_from_pcd`) or at random (`create_from_random`), and
`compact` packs its alive slots into a smaller pool.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .transforms import normalize_quat

SH_REST = 15  # degree <= 3: 16 coefficients per channel, 1 DC + 15 rest
PARAM_NAMES = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
               "opacity")
STAT_NAMES = ("xyz_gradient_accum", "denom", "max_radii2D")


@dataclass
class Gaussians:
    """All tensors have leading dim = capacity C; `alive` masks real points."""

    xyz: torch.Tensor            # [C,3]
    features_dc: torch.Tensor    # [C,1,3]
    features_rest: torch.Tensor  # [C,15,3]
    scaling: torch.Tensor        # [C,3] log-sigma
    rotation: torch.Tensor       # [C,4] wxyz quaternion (unnormalized)
    opacity: torch.Tensor        # [C,1] logit
    alive: torch.Tensor          # [C] bool
    # Densification statistics, accumulated per train step
    # (train/density.py); zeros when not given.
    xyz_gradient_accum: torch.Tensor = field(default=None)  # [C]
    denom: torch.Tensor = field(default=None)               # [C]
    max_radii2D: torch.Tensor = field(default=None)         # [C]

    def __post_init__(self):
        for name in STAT_NAMES:
            if getattr(self, name) is None:
                setattr(self, name, torch.zeros(
                    self.xyz.shape[0], dtype=torch.float32,
                    device=self.xyz.device))

    @property
    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    @property
    def get_rotation(self) -> torch.Tensor:
        return normalize_quat(self.rotation)

    @property
    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    @property
    def get_features(self) -> torch.Tensor:
        """[C,16,3] = concat(dc, rest)."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    @property
    def capacity(self) -> int:
        return int(self.xyz.shape[0])

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def num_alive(self) -> int:
        return int(self.alive.sum())

    def params(self) -> dict:
        """The trainable tensors (what the optimizer updates)."""
        return {k: getattr(self, k) for k in PARAM_NAMES}

    def with_params(self, p: dict) -> "Gaussians":
        return self.replace(**{k: p[k] for k in PARAM_NAMES})

    def replace(self, **changes) -> "Gaussians":
        return dataclasses.replace(self, **changes)

    def _map(self, fn) -> "Gaussians":
        return Gaussians(**{f.name: fn(getattr(self, f.name))
                            for f in dataclasses.fields(self)})

    def to(self, device) -> "Gaussians":
        """The same pool with every tensor on `device` (differentiable)."""
        return self._map(lambda x: x.to(device))

    def slots(self, lo: int, hi: int) -> "Gaussians":
        """The pool of slots [lo, hi) only."""
        return self._map(lambda x: x[lo:hi])


def empty_gaussians(capacity: int, device="cpu") -> Gaussians:
    """A pool of dead slots: ~0 opacity, tiny scales, identity rotation."""
    f32 = dict(dtype=torch.float32, device=device)
    rotation = torch.zeros(capacity, 4, **f32)
    rotation[:, 0] = 1.0
    return Gaussians(
        xyz=torch.zeros(capacity, 3, **f32),
        features_dc=torch.zeros(capacity, 1, 3, **f32),
        features_rest=torch.zeros(capacity, SH_REST, 3, **f32),
        scaling=torch.full((capacity, 3), -10.0, **f32),
        rotation=rotation,
        opacity=torch.full((capacity, 1), -10.0, **f32),
        alive=torch.zeros(capacity, dtype=torch.bool, device=device))


def _fill(g: Gaussians, n: int, **tensors) -> Gaussians:
    """`g` with slots [0, n) set from `tensors` and marked alive."""
    for name, t in tensors.items():
        getattr(g, name)[:n] = t
    g.alive[:n] = True
    return g


def create_from_random(generator: torch.Generator, num_points: int,
                       scene_extent: float = 1.0,
                       capacity: Optional[int] = None) -> Gaussians:
    """Random init on the generator's device: xyz uniform in +-extent, DC
    features uniform [0,1), sigma = 0.02*extent, random unit quaternions,
    opacity logit -2.0.  The draws are torch's, not JAX's."""
    capacity = capacity or num_points
    if capacity < num_points:
        raise ValueError(f"capacity {capacity} < {num_points} points")
    kw = dict(generator=generator, device=generator.device)
    xyz = (torch.rand(num_points, 3, **kw) - 0.5) * (2.0 * scene_extent)
    features_dc = torch.rand(num_points, 1, 3, **kw)
    rotation = normalize_quat(torch.randn(num_points, 4, **kw))
    return _fill(empty_gaussians(capacity, generator.device), num_points,
                 xyz=xyz, features_dc=features_dc,
                 scaling=math.log(0.02 * scene_extent), rotation=rotation,
                 opacity=-2.0)


def create_from_pcd(points: np.ndarray, colors: Optional[np.ndarray] = None,
                    spatial_lr_scale: float = 1.0,
                    capacity: Optional[int] = None,
                    device="cpu") -> Gaussians:
    """Point-cloud init: DC features = the colours as given, sigma =
    0.01 * extent * lr_scale, unit quaternions from numpy's
    default_rng(0) (the JAX package's draws), opacity 0.5."""
    points = np.asarray(points, np.float32)
    if points.size == 0:
        raise ValueError("No points found in the point cloud.")
    n = points.shape[0]
    capacity = capacity or n
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} points")
    if colors is None:
        colors = np.ones((n, 3), np.float32)
    extent = float((points.max(0) - points.min(0)).mean())
    base_scale = 0.01 * max(extent, 1e-2) * spatial_lr_scale
    rng = np.random.default_rng(0)
    rotation = rng.standard_normal((n, 4)).astype(np.float32)
    rotation /= np.linalg.norm(rotation, axis=-1, keepdims=True)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return _fill(empty_gaussians(capacity, device), n, xyz=as_t(points),
                 features_dc=as_t(colors)[:, None, :],
                 scaling=math.log(base_scale), rotation=as_t(rotation),
                 opacity=0.0)  # logit(0.5)


def compact_capacity(n: int, margin: float = 1.25) -> int:
    """The pool `compact` picks for n alive Gaussians: the smaller of the
    next power of two over margin * n (small scenes) and a 256-aligned
    1.15 * n (large scenes, where power-of-two rounding wastes up to 2x)."""
    pow2 = 1 << max(int(np.ceil(np.log2(max(n * margin, 2.0)))), 1)
    aligned = max(-(-int(n * 1.15) // 256) * 256, 256)
    return min(pow2, aligned) if aligned >= n else pow2


def compact(g: Gaussians, capacity: Optional[int] = None,
            margin: float = 1.25) -> Gaussians:
    """Alive slots packed to the front, in slot order, in a pool of
    `capacity` (default `compact_capacity`).  The render is unchanged:
    dead slots emit nothing."""
    idx = torch.nonzero(g.alive)[:, 0]
    n = int(idx.shape[0])
    if capacity is None:
        capacity = compact_capacity(n, margin)
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} alive Gaussians")
    names = PARAM_NAMES + STAT_NAMES
    out = empty_gaussians(capacity, g.device)
    return _fill(out, n, **{k: getattr(g, k)[idx] for k in names})


def reset_opacity(g: Gaussians, new_opacity: float = 0.01) -> Gaussians:
    """Clamp alive opacities down to logit(new_opacity); the reset never
    raises a nearly transparent splat back above the prune threshold."""
    val = min(max(new_opacity, 1e-4), 1 - 1e-4)
    logit = math.log(val / (1 - val))
    new = torch.where(g.alive[:, None], torch.clamp(g.opacity, max=logit),
                      g.opacity)
    return g.replace(opacity=new)


def scene_extent_of(g: Gaussians) -> torch.Tensor:
    """Mean axis range of the alive points."""
    alive = g.alive[:, None]
    big = torch.where(alive, g.xyz, torch.full_like(g.xyz, -torch.inf))
    small = torch.where(alive, g.xyz, torch.full_like(g.xyz, torch.inf))
    return (big.max(0).values - small.min(0).values).mean()
