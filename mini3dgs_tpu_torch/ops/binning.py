"""Tile binning: (tile, depth-rank) instances, sort, per-tile ranges
(counterpart of mini3dgs_tpu/ops/binning.py: the single-device path, one
rank's share of the band route's sharded candidate sort, and the ring
route's origin binning in ring v1 and on rank-resharded rows, v2 / v3).

Each visible Gaussian is duplicated into one instance per image tile its
footprint overlaps; instances are sorted by the composite key
(tile << 32) | depth_rank, which makes every tile's working set a contiguous
front-to-back slice of the stream.  Depth ranks come from one stable global
depth sort, so ties keep the reference's order.

The JAX package sizes everything statically for the TPU (stream capacity,
a two-level candidate grid, an int32 key with a two-operand fallback, the
reshard's and the route's per-destination capacities).  Here the stream
holds exactly `n_live` instances: each Gaussian's candidate tiles are
enumerated from its span, filtered by the exact ellipse-vs-tile test, and
compacted, and the collectives move variable-length slices, so nothing is
ever dropped (`n_dropped*`, `n_large` and the reshard's drops are kept in
the outputs for the render dict and are always 0).

The functions here work on one rank's tensors; the collectives that join
them (the distributed depth ranks, the rank reshard, the sharded sort's
exchange) are in parallel/ring.py and parallel/sharded.py.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .projection import Projected

# Row layout of the instance stream the raster kernel reads ([10, n_live]).
ROW_X, ROW_Y, ROW_QA, ROW_QB, ROW_QC, ROW_OP = 0, 1, 2, 3, 4, 5
ROW_R, ROW_G, ROW_B, ROW_DEPTH = 6, 7, 8, 9
STREAM_ROWS = 10


class Binning(NamedTuple):
    """Instance stream of `n_live` rows; tile t's instances are rows
    [tile_start[t], tile_start[t] + tile_count[t]), in depth order."""

    s_rank: torch.Tensor      # [n_live] depth rank of each sorted instance
    order: torch.Tensor       # [C] gaussian id at each depth rank
    inv_order: torch.Tensor   # [C] depth rank of each gaussian id
    counts_gid: torch.Tensor  # [C] instances emitted per gaussian id
    tile_start: torch.Tensor  # [T] int32 start row of each tile
    tile_count: torch.Tensor  # [T] int32 instance count per tile
    n_live: int
    n_dropped: int = 0
    n_dropped_large: int = 0
    n_large: int = 0

    @property
    def gauss_id(self) -> torch.Tensor:
        """[n_live] source Gaussian of each instance."""
        return self.order[self.s_rank]


def _tile_bounds(means2d, radius, H, W, tile_size, ext_x=None, ext_y=None):
    """Integer AABB -> inclusive tile bounds.  The reference's int()
    truncates toward zero, not floor.  Optional `ext_x`/`ext_y` intersect
    the box with |px - cx| <= ext (pixels outside it have w < W_EPS).
    Integers are int64, so no float->int conversion can wrap."""
    r = torch.trunc(radius).long()
    cx = torch.trunc(means2d[:, 0]).long()
    cy = torch.trunc(means2d[:, 1]).long()
    x0, x1 = cx - r, cx + 1 + r
    y0, y1 = cy - r, cy + 1 + r
    if ext_x is not None:
        mx, my = means2d[:, 0], means2d[:, 1]
        x0 = torch.maximum(x0, torch.floor(mx - ext_x).long())
        x1 = torch.minimum(x1, torch.floor(mx + ext_x).long() + 1)
        y0 = torch.maximum(y0, torch.floor(my - ext_y).long())
        y1 = torch.minimum(y1, torch.floor(my + ext_y).long() + 1)
    x0, x1 = x0.clamp(0, W), x1.clamp(0, W)
    y0, y1 = y0.clamp(0, H), y1.clamp(0, H)
    degenerate = (x0 >= x1) | (y0 >= y1)
    fdiv = lambda v: torch.div(v, tile_size, rounding_mode="floor")
    return fdiv(x0), fdiv(x1 - 1), fdiv(y0), fdiv(y1 - 1), degenerate


def _viewport_spans(proj: Projected, H, W, tile_size):
    """Tile origins and spans: gaussian g covers tiles
    [tx0, tx0+sx) x [ty0, ty0+sy), with sx = sy = 0 when culled."""
    tiles_x = -(-W // tile_size)
    tiles_y = -(-H // tile_size)
    tx0, tx1, ty0, ty1, degen = _tile_bounds(proj.means2d, proj.radius, H, W,
                                             tile_size, proj.ext_x,
                                             proj.ext_y)
    in_band = ((tx1 >= 0) & (tx0 <= tiles_x - 1)
               & (ty1 >= 0) & (ty0 <= tiles_y - 1))
    tx0, tx1 = tx0.clamp(0, tiles_x - 1), tx1.clamp(0, tiles_x - 1)
    ty0, ty1 = ty0.clamp(0, tiles_y - 1), ty1.clamp(0, tiles_y - 1)
    ok = proj.visible & ~degen & in_band
    zero = torch.zeros_like(tx0)
    sx = torch.where(ok, tx1 - tx0 + 1, zero)
    sy = torch.where(ok, ty1 - ty0 + 1, zero)
    return tx0, ty0, sx, sy


# w = exp(-0.5 s) >= W_EPS iff s <= _SMAX: a tile whose minimum s over its
# (margin-inflated) rect exceeds _SMAX gets exactly zero from the Gaussian.
_SMAX = 2.0 * math.log(1.0 / 1e-5)
# Rect inflation in pixels: absorbs rounding differences between this test
# and the kernel's per-pixel quadratic form.
_EXACT_MARGIN = 1.0


def _exact_tile_keep(tx, ty, ex, tile_size):
    """Exact ellipse-vs-tile test.  tx/ty: candidate tile indices;
    ex = (mx, my, qa, qb, qc): pixel means and conic, broadcast against tx.
    True when the tile may hold a pixel with w >= W_EPS: the mean lies in
    the rect, or the minimum of s over one of its edges is <= _SMAX."""
    mx, my, qa, qb, qc = ex
    byc = -qb / torch.clamp(qc, min=1e-12)
    bya = -qb / torch.clamp(qa, min=1e-12)
    x0 = tx * tile_size - _EXACT_MARGIN - mx
    x1 = tx * tile_size + (tile_size - 1) + _EXACT_MARGIN - mx
    y0 = ty * tile_size - _EXACT_MARGIN - my
    y1 = ty * tile_size + (tile_size - 1) + _EXACT_MARGIN - my
    inside = (x0 <= 0) & (0 <= x1) & (y0 <= 0) & (0 <= y1)

    def edge_x(ex_):
        ys = torch.clamp(byc * ex_, y0, y1)
        return qa * ex_ * ex_ + 2.0 * qb * ex_ * ys + qc * ys * ys

    def edge_y(ey_):
        xs = torch.clamp(bya * ey_, x0, x1)
        return qa * xs * xs + 2.0 * qb * ey_ * xs + qc * ey_ * ey_

    smin = torch.minimum(torch.minimum(edge_x(x0), edge_x(x1)),
                         torch.minimum(edge_y(y0), edge_y(y1)))
    return inside | (smin <= _SMAX)


def _grid_counts(proj: Projected, tx0, ty0, sx, sy, tile_size):
    """Enumerate each Gaussian's span grid row-major and keep the tiles that
    pass the exact ellipse test.  Returns (gid, tx, ty) of the kept
    candidates and the per-Gaussian kept counts [C]."""
    C = sx.shape[0]
    n_cand = sx * sy
    gid = torch.repeat_interleave(
        torch.arange(C, device=sx.device), n_cand)
    first = torch.cumsum(n_cand, 0) - n_cand
    d = torch.arange(gid.shape[0], device=sx.device) - first[gid]
    sxg = sx[gid]
    tx = tx0[gid] + d % sxg
    ty = ty0[gid] + torch.div(d, sxg, rounding_mode="floor")
    ex = (proj.means2d[gid, 0], proj.means2d[gid, 1], proj.conic[gid, 0],
          proj.conic[gid, 1], proj.conic[gid, 2])
    keep = _exact_tile_keep(tx, ty, ex, tile_size)
    gid, tx, ty = gid[keep], tx[keep], ty[keep]
    return gid, tx, ty, torch.bincount(gid, minlength=C)


def _depth_order(proj: Projected) -> torch.Tensor:
    """Global stable depth sort; invisible Gaussians sort last (+inf).
    Returns order: the gaussian id at each depth rank."""
    key = torch.where(proj.visible, proj.depth,
                      torch.full_like(proj.depth, torch.inf))
    return torch.sort(key, stable=True).indices


def _layout(s_tile: torch.Tensor, num_tiles: int):
    """Per-tile [start, start + count) ranges of the tile-sorted stream."""
    count = torch.bincount(s_tile, minlength=num_tiles)
    start = torch.cumsum(count, 0) - count
    return start.int(), count.int()


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """The inverse of a permutation of 0 .. len - 1."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return inv


def _emit_keys(proj: Projected, H: int, W: int, tile_size: int,
               rank: torch.Tensor, keep=None):
    """The sorted (tile << 32 | rank) keys of the instances of the rows of
    `proj`, row g carrying depth rank `rank[g]`, and the instances each row
    emits.  `keep` [rows] bool restricts the emitting rows."""
    tiles_x = -(-W // tile_size)
    tx0, ty0, sx, sy = _viewport_spans(proj, H, W, tile_size)
    if keep is not None:
        zero = torch.zeros_like(sx)
        sx, sy = torch.where(keep, sx, zero), torch.where(keep, sy, zero)
    gid, tx, ty, counts = _grid_counts(proj, tx0, ty0, sx, sy, tile_size)
    # One int64 sort key per instance: tile in the high word, depth rank in
    # the low word, so the sorted stream is tile-major and front-to-back.
    s_key = torch.sort((ty * tiles_x + tx) << 32 | rank[gid]).values
    return s_key, counts


def _sorted_keys(proj: Projected, H: int, W: int, tile_size: int,
                 rank_range=None):
    """The sorted (tile << 32 | depth rank) keys of the instances, with
    (order, inv_order, counts_gid).  `rank_range` = (lo, hi) keeps only the
    Gaussians whose depth rank lies in [lo, hi)."""
    order = _depth_order(proj)
    inv_order = inverse_permutation(order)
    keep = None
    if rank_range is not None:
        keep = (inv_order >= rank_range[0]) & (inv_order < rank_range[1])
    s_key, counts_gid = _emit_keys(proj, H, W, tile_size, inv_order, keep)
    return s_key, order, inv_order, counts_gid


def bin_gaussians(proj: Projected, H: int, W: int,
                  tile_size: int) -> Binning:
    """Bin the projected Gaussians into the tiles of an [H, W] image."""
    num_tiles = -(-W // tile_size) * -(-H // tile_size)
    s_key, order, inv_order, counts_gid = _sorted_keys(proj, H, W, tile_size)
    s_rank = s_key & 0xFFFFFFFF
    tile_start, tile_count = _layout(s_key >> 32, num_tiles)
    return Binning(s_rank=s_rank, order=order, inv_order=inv_order,
                   counts_gid=counts_gid, tile_start=tile_start,
                   tile_count=tile_count, n_live=int(s_key.shape[0]))


def slice_rows(proj: Projected, rows: slice) -> Projected:
    """The rows `rows` of every field of `proj`."""
    return Projected(*(f[rows] for f in proj))


def shard_keys(proj: Projected, H: int, W: int, tile_size: int,
               rows: slice):
    """One rank's half of the band route's sharded candidate sort
    (parallel/sharded.py `bin_gaussians_sharded`): the depth order of the
    full projected set `proj`, its inverse, and the sorted (tile << 32 |
    depth rank) keys of the instances of the rows `rows` alone, over the
    whole [H, W] image."""
    order = _depth_order(proj)
    rank = inverse_permutation(order)
    s_key, _ = _emit_keys(slice_rows(proj, rows), H, W, tile_size, rank[rows])
    return s_key, order, rank


def band_binning(s_key: torch.Tensor, order: torch.Tensor,
                 inv_order: torch.Tensor, tile0: int,
                 num_tiles: int) -> Binning:
    """The `Binning` of the sorted keys `s_key` of tiles [tile0, tile0 +
    num_tiles) alone, with tile ranges local to them; `counts_gid` counts
    each Gaussian's instances in these tiles."""
    s_rank = s_key & 0xFFFFFFFF
    tile_start, tile_count = _layout((s_key >> 32) - tile0, num_tiles)
    return Binning(s_rank=s_rank, order=order, inv_order=inv_order,
                   counts_gid=torch.bincount(order[s_rank],
                                             minlength=order.shape[0]),
                   tile_start=tile_start, tile_count=tile_count,
                   n_live=int(s_key.shape[0]))


class RingBinning(NamedTuple):
    """Origin-side binning of the ring-exchange raster (parallel/ring.py):
    the instances of ONE depth-rank range, for every image band.  The
    stream is tile-major over the whole image, so band b's segment is the
    contiguous slice [seg_start[b], seg_start[b + 1]) of it, in (tile,
    rank) order, with tile ranges local to the segment."""

    s_rank: torch.Tensor      # [n_live] depth rank of each sorted instance
    order: torch.Tensor       # [C] gaussian id at each depth rank
    counts_gid: torch.Tensor  # [C] instances emitted per gaussian id
    tile_start: torch.Tensor  # [n_bands, T_band] int32, segment-local
    tile_count: torch.Tensor  # [n_bands, T_band] int32
    seg_start: tuple          # n_bands + 1 ints: the segments' bounds
    n_live: int               # instances of this range, all bands
    n_dropped: int = 0

    @property
    def gauss_id(self) -> torch.Tensor:
        """[n_live] source Gaussian of each instance."""
        return self.order[self.s_rank]


def _ring_checks(C: int, tiles_y: int, n_shards: int) -> None:
    if C % n_shards:
        raise ValueError(f"capacity {C} must divide over the {n_shards} ring "
                         "devices")
    if tiles_y % n_shards:
        raise ValueError(f"{tiles_y} tile rows must divide into {n_shards} "
                         "bands")


def _ring_segments(s_key: torch.Tensor, tiles_x: int, tiles_y: int,
                   n_shards: int):
    """Band segments of an origin's sorted whole-image keys: (tile_start,
    tile_count) [n_bands, T_band] local to each segment, the segments'
    bounds and the stream's length."""
    ntb = tiles_y // n_shards * tiles_x
    start, count = _layout(s_key >> 32, tiles_x * tiles_y)
    start, count = start.reshape(n_shards, ntb), count.reshape(n_shards, ntb)
    n_live = int(s_key.shape[0])
    seg_start = (*start[:, 0].tolist(), n_live)
    return start - start[:, :1], count, seg_start, n_live


def bin_gaussians_ring_origin(proj: Projected, full_h: int, full_w: int,
                              tile_size: int, range_index: int,
                              n_shards: int) -> RingBinning:
    """Ring-exchange origin binning for depth-rank range `range_index` of
    `n_shards` (counterpart of the JAX `bin_gaussians_ring_origin`).

    Depth ranks come from one stable sort over the full set, invisible rows
    last; range r is ranks [r * C/n, (r + 1) * C/n) of the pool's capacity
    C, so late ranges may hold only invisible rows.  Front-to-back
    compositing is associative but not commutative: range r lies behind
    every range < r everywhere, so a band can composite the ranges one
    after another with the transmittance carried.  The union over the
    ranges of band b's segments is the single-device stream of band b's
    tiles as a multiset.  A segment holds exactly its live instances:
    nothing is dropped."""
    C = proj.means2d.shape[0]
    tiles_x = -(-full_w // tile_size)
    tiles_y = -(-full_h // tile_size)
    _ring_checks(C, tiles_y, n_shards)
    Cs = C // n_shards
    s_key, order, _, counts_gid = _sorted_keys(
        proj, full_h, full_w, tile_size,
        rank_range=(range_index * Cs, (range_index + 1) * Cs))
    start, count, seg_start, n_live = _ring_segments(s_key, tiles_x, tiles_y,
                                                     n_shards)
    return RingBinning(s_rank=s_key & 0xFFFFFFFF, order=order,
                       counts_gid=counts_gid, tile_start=start,
                       tile_count=count, seg_start=seg_start, n_live=n_live)


def bin_gaussians_ring_origin_resharded(
        proj_local: Projected, rank_base: int, C: int, full_h: int,
        full_w: int, tile_size: int, n_shards: int) -> RingBinning:
    """Origin binning on rank-local rows (ring v2 / v3; counterpart of the
    JAX `bin_gaussians_ring_origin_resharded`): `proj_local` holds the
    C/n rows of global depth ranks [rank_base, rank_base + C/n) in rank
    order (from parallel/ring.py `rank_reshard_rows`; a rank no row
    carries is a zero row, invisible).  The candidate keys are
    tile << 32 | GLOBAL rank, so the
    segments, their tile ranges and the stream are bitwise those of
    `bin_gaussians_ring_origin` for the same range, while every
    per-Gaussian stage runs on C/n rows.  `s_rank`, `order` and
    `counts_gid` are in local row space (rank - rank_base), the space of
    the caller's [R, C/n] `instance_attrs`."""
    Cs = proj_local.means2d.shape[0]
    tiles_x = -(-full_w // tile_size)
    tiles_y = -(-full_h // tile_size)
    _ring_checks(C, tiles_y, n_shards)
    if Cs * n_shards != C:
        raise ValueError(f"{Cs} local rows are not 1/{n_shards} of the "
                         f"capacity {C}")
    local = torch.arange(Cs, device=proj_local.means2d.device)
    s_key, counts = _emit_keys(proj_local, full_h, full_w, tile_size,
                               rank_base + local)
    start, count, seg_start, n_live = _ring_segments(s_key, tiles_x, tiles_y,
                                                     n_shards)
    return RingBinning(s_rank=(s_key & 0xFFFFFFFF) - rank_base, order=local,
                       counts_gid=counts, tile_start=start, tile_count=count,
                       seg_start=seg_start, n_live=n_live)


def pack_instances(attrs: torch.Tensor, b) -> torch.Tensor:
    """Gather per-Gaussian attribute rows [R, C] into the stream layout the
    raster kernel reads: [R, n_live], instance i = Gaussian gauss_id[i] of
    the `Binning` or `RingBinning` b."""
    return attrs.index_select(1, b.gauss_id).contiguous()
