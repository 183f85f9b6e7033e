"""Ring exchange of depth-rank-range instance segments (counterpart of
mini3dgs_tpu/parallel/ring.py, ring v1: the full projected set on every
rank, origin binning restricted to the rank's depth range).

The image is split into n horizontal bands of whole tile rows, one per rank
of the `tile` axis, and the global depth order into n contiguous rank
ranges, one per rank.  Front-to-back compositing is associative but not
commutative, so a band can consume the ranges one after another only if
range s lies behind every range < s everywhere; depth-rank ranges give
exactly that, and the per-pixel transmittance at the end of range s - 1 is
the initial transmittance of range s (the raster kernels' `t0`).

Schedule (rank i = owner of band i = owner of range i):
  1. origin: bin and pack MY range's instances for ALL bands
     (ops/binning.bin_gaussians_ring_origin): n segments.
  2. pre-placement all_to_all: segment (band b, range r) goes to rank
     (b + r) mod n, so every rank starts with one segment per band and the
     buffers form a ring schedule.
  3. n steps: rasterize buffer entry 0 (which at step s is MY band's
     range-s segment) with the carried transmittance, then pass the entries
     not yet consumed one hop backward (j -> j - 1).

The ranks are a Python loop (parallel/mesh.py); with every rank on one card
the exchanges move nothing.  The output differs from a single pass only by
float32 association at the segment borders.  Gradients flow through the
transmittance chain (the backward kernel's `d_t0`) and through the
exchanges back to the origin packs.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch.profiler import record_function

from ..ops import binning as B
from ..ops import raster_cuda as RC
from ..ops.projection import Projected
from . import mesh as M


def ring_rasterize_bands(projs: Sequence[Projected], band_h: int, W: int,
                         bg: Sequence[float], devices: Sequence, *,
                         tile_size: int = 16) -> List[dict]:
    """Render every band of the (band_h * n) x W image through the ring
    schedule.  `projs[i]` is the full projected set as rank i holds it (on
    `devices[i]`).  Returns one dict per band: image [3, band_h, W], alpha,
    depth, and the counters of rank i as an origin: `n_live` (instances of
    its depth range, all bands), `seg_live` (the same per band) and
    `n_dropped`, `reshard_drops` (always 0: a segment holds exactly its
    live instances, and there is no reshard in ring v1)."""
    n = len(devices)
    H = band_h * n
    tiles_x = -(-W // tile_size)
    P = tile_size * tile_size
    if band_h % tile_size:
        raise ValueError(f"a band of {band_h} rows is not whole "
                         f"{tile_size}-pixel tile rows")
    ntb = band_h // tile_size * tiles_x                 # tiles per band

    # ---- origin: bin + pack MY rank range for all bands ----
    send, origins = [], []
    for i, proj in enumerate(projs):
        with record_function("3dgs:ring_origin"):
            rb = B.bin_gaussians_ring_origin(proj, H, W, tile_size, i, n)
            stream = B.pack_instances(RC.instance_attrs(proj), rb)
            sizes = torch.tensor([rb.seg_start[b + 1] - rb.seg_start[b]
                                  for b in range(n)], device=stream.device)
            # One wait per origin instead of one per launch.
            RC.check_tile_ranges(sizes, rb.tile_start, rb.tile_count)
            segs = [(stream[:, rb.seg_start[b]:rb.seg_start[b + 1]]
                     .contiguous(), rb.tile_start[b], rb.tile_count[b])
                    for b in range(n)]
        # ---- pre-placement: segment b -> rank (b + i) mod n ----
        send.append([segs[(d - i) % n] for d in range(n)])
        origins.append(rb)
    with record_function("3dgs:ring_exchange"):
        buf = M.all_to_all(send, devices)
    # entry r at rank j now holds (band (j - r) mod n, range r); after s
    # backward shifts, entry 0 is (band j, range s): the ring invariant.

    # ---- ring steps: raster entry 0 with the carried T, shift the rest ----
    perm = [(j, (j - 1) % n) for j in range(n)]
    trans = [torch.ones(ntb, 1, P, dtype=torch.float32, device=d)
             for d in devices]
    acc = [None] * n
    for s in range(n):
        for j in range(n):
            stream, start, count = buf[j][0]
            with record_function("3dgs:ring_raster"):
                out = RC.raster_op(stream, start, count, tiles_x, tile_size,
                                   t0=trans[j], tile0=j * ntb,
                                   ranges_checked=True)
            # Rows 0..4 add up; row 5 is the transmittance handed on.
            acc[j] = out[:, :5] if s == 0 else acc[j] + out[:, :5]
            trans[j] = out[:, 5:6]
        if s + 1 < n:
            with record_function("3dgs:ring_exchange"):
                buf = M.ppermute([entries[1:] for entries in buf], perm,
                                 devices)

    outs = []
    for j, dev in enumerate(devices):
        with record_function("3dgs:epilogue"):
            pad = torch.zeros(ntb, RC.N_ACC - 5, P, dtype=torch.float32,
                              device=dev)
            image, alpha, depth = RC.compose_image(
                torch.cat([acc[j], pad], dim=1), band_h, W, tile_size,
                torch.as_tensor(bg, dtype=torch.float32, device=dev))
        rb = origins[j]
        outs.append({"image": image, "alpha": alpha, "depth": depth,
                     "n_live": rb.n_live, "n_dropped": rb.n_dropped,
                     "reshard_drops": 0,
                     "seg_live": [rb.seg_start[b + 1] - rb.seg_start[b]
                                  for b in range(n)]})
    return outs
