"""Gaussian scene state (counterpart of mini3dgs_tpu/core/gaussians.py).

A fixed-capacity slot pool with an `alive` mask, as in the JAX package, so
parameters map slot for slot onto JAX's: dead slots carry ~0 opacity and
tiny scales and are culled by the projection.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

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
