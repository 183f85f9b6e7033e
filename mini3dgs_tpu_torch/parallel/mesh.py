"""A (data, tile) mesh of ranks and the collectives over it (counterpart of
mini3dgs_tpu/parallel/mesh.py and of the `jax.lax` collectives its SPMD
programs use).

The JAX package is single-controller: one process runs `shard_map` programs
over a mesh of devices.  The port keeps that shape.  A `Mesh` names one
`torch.device` per rank; the per-rank code of a `shard_map` body becomes a
Python loop over the ranks of an axis, holding one value per rank in a
list, and the collectives are plain functions over such lists.  A tensor
moves with `.to(device)` when source and destination differ, so on one
card every rank shares `cuda:0` (as JAX's virtual devices share the CPU)
and on a host with several cards each exchange is a device-to-device copy.
Autograd differentiates through the collectives as they stand: the
gradient of `.to` flows back to the source device, and the gradient of a
sum over ranks is the sum over ranks.

Axes:
  * data: camera-batch parallelism; rank d trains view d, gradients are
    averaged over the axis.
  * tile: image-band parallelism; rank t owns a horizontal band of whole
    tile rows, per-Gaussian gradients are summed over the axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    """`data` x `tile` ranks; rank (d, t) lives on `devices[d * tile + t]`."""

    data: int
    tile: int
    devices: Tuple[torch.device, ...]

    def tile_devices(self, d: int = 0) -> List[torch.device]:
        """The devices of the `tile` axis at data index `d`."""
        return list(self.devices[d * self.tile:(d + 1) * self.tile])


def make_mesh(data: int = 1, tile: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of `data * tile` ranks.  `devices` defaults to every visible
    CUDA device; rank k lives on `devices[k % len(devices)]`, so fewer
    devices than ranks are shared round-robin.  Without a card and without
    `devices` this raises: nothing moves to the CPU unless the caller names
    CPU devices."""
    if data < 1 or tile < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data} "
                         f"tile={tile}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass devices= "
                "explicitly to build a mesh of CPU ranks")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_mesh needs at least one device")
    n = data * tile
    return Mesh(data, tile, tuple(devices[k % len(devices)]
                                  for k in range(n)))


def _to(x, device):
    """Move a tensor, or a tuple/list of them, to `device`."""
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, device) for v in x)
    return x.to(device)


def all_to_all(xs: Sequence[Sequence], devices: Sequence) -> List[list]:
    """`xs[r][d]` is what rank r sends to rank d; returns `out[d][r]`, what
    rank d received from rank r (a transpose of the list of lists)."""
    n = len(devices)
    return [[_to(xs[r][d], devices[d]) for r in range(n)] for d in range(n)]


def ppermute(xs: Sequence, perm: Sequence[Tuple[int, int]],
             devices: Sequence) -> list:
    """Rank `dst` receives `xs[src]` for every (src, dst) of `perm`; a rank
    that no pair names as destination receives zeros of its own value's
    shape (as `jax.lax.ppermute` gives)."""
    sources = dict((dst, src) for src, dst in perm)
    if len(sources) != len(perm) or len({s for s, _ in perm}) != len(perm):
        raise ValueError(f"ppermute: {perm} is not a partial permutation")
    return [_to(xs[sources[d]], devices[d]) if d in sources
            else torch.zeros_like(xs[d]) for d in range(len(devices))]


def all_gather(xs: Sequence[torch.Tensor], devices: Sequence,
               dim: int = 0) -> List[torch.Tensor]:
    """Every rank receives the ranks' tensors concatenated along `dim`."""
    return [torch.cat([x.to(dev) for x in xs], dim=dim) for dev in devices]


def psum(xs: Sequence[torch.Tensor], devices: Sequence) -> List[torch.Tensor]:
    """Every rank receives the sum over the ranks, added in rank order."""
    out = []
    for dev in devices:
        total = xs[0].to(dev)
        for x in xs[1:]:
            total = total + x.to(dev)
        out.append(total)
    return out


def pmean(xs: Sequence[torch.Tensor], devices: Sequence) -> List[torch.Tensor]:
    """Every rank receives the mean over the ranks."""
    return [x / len(devices) for x in psum(xs, devices)]
