"""Ring exchange of depth-rank-range instance segments (counterpart of
mini3dgs_tpu/parallel/ring.py: ring v1, v2 and v3).

The image is split into n horizontal bands of whole tile rows, one per rank
of the `tile` axis, and the global depth order into n contiguous rank
ranges, one per rank.  Front-to-back compositing is associative but not
commutative, so a band can consume the ranges one after another only if
range s lies behind every range < s everywhere; depth-rank ranges give
exactly that, and the per-pixel transmittance at the end of range s - 1 is
the initial transmittance of range s (the raster kernels' `t0`).

Schedule (rank i = owner of band i = owner of range i):
  1. origin: bin and pack MY range's instances for ALL bands: n segments.
     Three ways to get there:
       v1: every rank holds the full projected set and restricts the
           emission to its range (ops/binning.bin_gaussians_ring_origin),
           so every per-Gaussian stage runs on C rows;
       v3 (`gid_sharded`): rank i holds only its gid block; the ranks come
           from the ring-rotation counting sort (`distributed_ranks`), each
           rank sends the visible rows of its block to their ranges' owners
           (`rank_reshard_rows`), and the origin bins its C/n rank-ordered
           rows (binning.bin_gaussians_ring_origin_resharded); no tensor of
           C rows exists;
       v2 (`reshard`): every rank holds the full projected set and takes
           v3's path from its own gid block.  (The JAX package's v2 ranks
           the replicated set on every rank; the ranks are the same on
           every visible row, and invisible rows emit nothing.)
     The candidate keys are the same in all three, so the segments and
     everything after them are bitwise v1's.
  2. pre-placement all_to_all: segment (band b, range r) goes to rank
     (b + r) mod n, so every rank starts with one segment per band and the
     buffers form a ring schedule.
  3. n steps: rasterize buffer entry 0 (which at step s is MY band's
     range-s segment) with the carried transmittance, then pass the entries
     not yet consumed one hop backward (j -> j - 1).

The ranks are a Python loop (parallel/mesh.py); with every rank on one card
the exchanges move nothing.  Over ranks of several processes each process
runs the loop over its own ranks (the others' entries are None), and every
exchange crosses the processes once for all of them.  The output differs
from a single pass only by float32 association at the segment borders.
Gradients flow through the transmittance chain (the backward kernel's
`d_t0`), through the exchanges back to the origin packs and, in v2 / v3,
through the reshard back to the gid owners' rows.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..ops import binning as B
from ..ops import raster_cuda as RC
from ..ops.projection import Projected
from ..utils import profiling
from . import mesh as M


def _as_rows(proj: Projected) -> torch.Tensor:
    """[rows, 14] the fields of `proj` side by side, in the order of the
    JAX package's reshard rows (`visible` as 0 / 1, so a zero row that no
    rank carries comes out invisible).  The radius and the exact-cull
    extents only place instances in tiles, as in ring v1, so they are
    detached: a zero cotangent through their clamps and square roots would
    come back as NaN where those have no finite derivative."""
    col = lambda x: x[:, None]
    return torch.cat([proj.means2d, proj.conic, col(proj.depth),
                      col(proj.radius.detach()), col(proj.visible.float()),
                      proj.color, col(proj.opacity), col(proj.ext_x.detach()),
                      col(proj.ext_y.detach())], dim=1)


def _from_rows(m: torch.Tensor) -> Projected:
    return Projected(means2d=m[:, 0:2], conic=m[:, 2:5], depth=m[:, 5],
                     radius=m[:, 6], visible=m[:, 7] > 0.5, color=m[:, 8:11],
                     opacity=m[:, 11], ext_x=m[:, 12], ext_y=m[:, 13])


# The rank of a row that no range holds (an invisible row of ring v2 / v3),
# as the JAX package gives it.
RANK_SENTINEL = 2 ** 31 - 1


def distributed_ranks(depths: Sequence[torch.Tensor],
                      visibles: Sequence[torch.Tensor],
                      devices: Sequence) -> List[torch.Tensor]:
    """Global stable depth ranks of gid-sharded rows with O(C/n) memory a
    rank (counterpart of the JAX `distributed_ranks`).  Rank i holds the
    depth and visibility [C/n] of gid block i; the result is, for each of
    its rows, the position in the stable sort of (visible ? depth : +inf)
    over the whole pool, ties broken by global gid, and RANK_SENTINEL for
    invisible rows (they emit nothing and take no part in the reshard).

    Each rank sorts its block's keys once, and the sorted blocks rotate
    around the ring (n - 1 `ppermute` hops).  A row's rank is its position
    in its own block plus, for every other block, the count of its keys
    below the row's key (blocks of higher gids) or at most the row's key
    (blocks of lower gids).  The keys are detached: ranking is routing
    metadata."""
    n = len(devices)
    mine = M.local_ranks(devices)
    keys = [torch.where(v, d.detach().float(),
                        torch.full_like(d, torch.inf, dtype=torch.float32))
            if i in mine else None
            for i, (d, v) in enumerate(zip(depths, visibles))]
    blocks, total = [None] * n, [None] * n
    for i in mine:
        blocks[i], perm = torch.sort(keys[i], stable=True)
        total[i] = B.inverse_permutation(perm)
    hop = [(j, (j - 1) % n) for j in range(n)]
    for s in range(1, n):
        blocks = M.ppermute(blocks, hop, devices)
        for i in mine:
            # rank i now holds the sorted block of rank (i + s) mod n
            total[i] = total[i] + torch.searchsorted(
                blocks[i], keys[i], right=(i + s) % n < i)
    return [torch.where(v, t, torch.full_like(t, RANK_SENTINEL))
            if t is not None else None for t, v in zip(total, visibles)]


def rank_reshard_rows(mats: Sequence[torch.Tensor],
                      ranks: Sequence[torch.Tensor], devices: Sequence):
    """Route gid-sharded rows to the owners of their depth-rank ranges
    (counterpart of the JAX `rank_reshard_rows` and
    `rank_reshard_rows_compact`).  `mats[i]` [C/n, R] are rank i's rows,
    `ranks[i]` [C/n] their global depth ranks (RANK_SENTINEL: sent
    nowhere).  Each rank sorts its rows by rank, sends every destination d
    exactly the rows of ranks [d * C/n, (d + 1) * C/n) (one `all_to_all`
    of variable-length slices), and places what it receives at local row
    rank - d * C/n.  Returns (rows [C/n, R] of each rank's range in rank
    order, 0 rows dropped); a rank that no row carries is a zero row.
    Differentiable with respect to `mats`: the cotangents go back to the
    gid owners through `index_select`, `.to` and `cat`."""
    n = len(devices)
    Cs = mats[M.local_ranks(devices)[0]].shape[0]
    send = []
    for mat, rank in zip(mats, ranks):
        if mat is None:
            send.append(None)
            continue
        s_rank, perm = torch.sort(rank)
        cuts = torch.arange(n + 1, device=rank.device) * Cs
        bounds = torch.searchsorted(s_rank, cuts).tolist()
        rows = mat.index_select(0, perm)
        send.append([(rows[bounds[d]:bounds[d + 1]],
                      s_rank[bounds[d]:bounds[d + 1]]) for d in range(n)])
    out = []
    for d, got in enumerate(M.all_to_all(send, devices)):
        if got is None:
            out.append(None)
            continue
        rows = torch.cat([r for r, _ in got])
        local = torch.cat([k for _, k in got]) - d * Cs
        # The last row of `padded` is zero: every local rank that no row
        # carries reads it.
        where = torch.full((Cs,), rows.shape[0], dtype=torch.long,
                           device=rows.device)
        where[local] = torch.arange(rows.shape[0], device=rows.device)
        padded = torch.cat([rows, rows.new_zeros(1, rows.shape[1])])
        out.append(padded.index_select(0, where))
    return out, 0


def _rank_local_rows(blocks: Sequence[Projected],
                     devices: Sequence) -> List[Projected]:
    """Ring v2 / v3's first stage: from rank i's gid block `blocks[i]` of
    the projected set, each rank's C/n projected rows of its depth-rank
    range, in rank order."""
    field = lambda f, ps: [None if p is None else f(p) for p in ps]
    with profiling.stage("3dgs:ring_ranks"):
        ranks = distributed_ranks(field(lambda p: p.depth, blocks),
                                  field(lambda p: p.visible, blocks), devices)
    with profiling.stage("3dgs:ring_reshard"):
        rows, _ = rank_reshard_rows(field(_as_rows, blocks), ranks, devices)
    return field(_from_rows, rows)


def ring_rasterize_bands(projs: Sequence[Projected], band_h: int, W: int,
                         bg: Sequence[float], devices: Sequence, *,
                         tile_size: int = 16, reshard: bool = False,
                         gid_sharded: bool = False) -> List[dict]:
    """Render every band of the (band_h * n) x W image through the ring
    schedule.  `projs[i]` is the full projected set as rank i holds it (on
    `devices[i]`), or with `gid_sharded` (ring v3) rank i's gid block
    [i * C/n, (i + 1) * C/n) alone; `reshard` selects ring v2 for the full
    set.  Returns one dict per band: image [3, band_h, W], alpha, depth,
    and the counters of rank i as an origin: `n_live` (instances of its
    depth range, all bands), `seg_live` (the same per band) and
    `n_dropped`, `reshard_drops` (always 0: a segment holds exactly its
    live instances, and the reshard moves every row)."""
    n = len(devices)
    H = band_h * n
    tiles_x = -(-W // tile_size)
    P = tile_size * tile_size
    if band_h % tile_size:
        raise ValueError(f"a band of {band_h} rows is not whole "
                         f"{tile_size}-pixel tile rows")
    ntb = band_h // tile_size * tiles_x                 # tiles per band
    mine = M.local_ranks(devices)
    C = projs[mine[0]].means2d.shape[0] * (n if gid_sharded else 1)
    local = None
    if gid_sharded or reshard:
        if C % n:
            raise ValueError(f"capacity {C} must divide over the {n} ring "
                             "devices")
        Cs = C // n
        blocks = projs if gid_sharded else [
            None if p is None else B.slice_rows(p, slice(i * Cs, (i + 1) * Cs))
            for i, p in enumerate(projs)]
        local = _rank_local_rows(blocks, devices)

    # ---- origin: bin + pack MY rank range for all bands ----
    send, origins = [None] * n, [None] * n
    for i in mine:
        proj = projs[i]
        with profiling.stage("3dgs:ring_origin"):
            if local is None:
                rb = B.bin_gaussians_ring_origin(proj, H, W, tile_size, i, n)
            else:
                proj = local[i]
                rb = B.bin_gaussians_ring_origin_resharded(
                    proj, i * C // n, C, H, W, tile_size, n)
            stream = B.pack_instances(RC.instance_attrs(proj), rb)
            sizes = torch.tensor([rb.seg_start[b + 1] - rb.seg_start[b]
                                  for b in range(n)], device=stream.device)
            # One wait per origin instead of one per launch.
            RC.check_tile_ranges(sizes, rb.tile_start, rb.tile_count)
            segs = [(stream[:, rb.seg_start[b]:rb.seg_start[b + 1]]
                     .contiguous(), rb.tile_start[b], rb.tile_count[b])
                    for b in range(n)]
        # ---- pre-placement: segment b -> rank (b + i) mod n ----
        send[i] = [segs[(d - i) % n] for d in range(n)]
        origins[i] = rb
    with profiling.stage("3dgs:ring_exchange"):
        buf = M.all_to_all(send, devices)
    # entry r at rank j now holds (band (j - r) mod n, range r); after s
    # backward shifts, entry 0 is (band j, range s): the ring invariant.

    # ---- ring steps: raster entry 0 with the carried T, shift the rest ----
    perm = [(j, (j - 1) % n) for j in range(n)]
    trans = [torch.ones(ntb, 1, P, dtype=torch.float32, device=devices[j])
             if j in mine else None for j in range(n)]
    acc = [None] * n
    for s in range(n):
        for j in mine:
            stream, start, count = buf[j][0]
            with profiling.stage("3dgs:ring_raster"):
                out = RC.raster_op(stream, start, count, tiles_x, tile_size,
                                   t0=trans[j], tile0=j * ntb,
                                   ranges_checked=True)
            # Rows 0..4 add up; row 5 is the transmittance handed on.
            acc[j] = out[:, :5] if s == 0 else acc[j] + out[:, :5]
            trans[j] = out[:, 5:6]
        if s + 1 < n:
            with profiling.stage("3dgs:ring_exchange"):
                buf = M.ppermute([None if entries is None else entries[1:]
                                  for entries in buf], perm, devices)

    outs = [None] * n
    for j in mine:
        dev = devices[j]
        with profiling.stage("3dgs:epilogue"):
            pad = torch.zeros(ntb, RC.N_ACC - 5, P, dtype=torch.float32,
                              device=dev)
            image, alpha, depth = RC.compose_image(
                torch.cat([acc[j], pad], dim=1), band_h, W, tile_size,
                torch.as_tensor(bg, dtype=torch.float32, device=dev))
        rb = origins[j]
        outs[j] = {"image": image, "alpha": alpha, "depth": depth,
                   "n_live": rb.n_live, "n_dropped": rb.n_dropped,
                   "reshard_drops": 0,
                   "seg_live": [rb.seg_start[b + 1] - rb.seg_start[b]
                                for b in range(n)]}
    return outs
