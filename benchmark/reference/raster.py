"""Tile binning and front-to-back compositing, plain and in blocks (frozen
copy of the measured package's binning and of its raster functions' plain
versions, rewritten to walk only the tiles that are still open).

Binning: each visible Gaussian goes to every tile of its integer box (the
3-sigma radius, truncated toward zero, intersected with the W_EPS contour's
box) that passes the exact ellipse-against-tile test; each tile's list is
in the order of one stable global depth sort.

Compositing, per pixel in that order: w = min(exp(lw), 1) with lw the
quadratic form of the conic, skip w < W_EPS, alpha = min(op w, 1),
contribution T alpha while the gate 1 - T < 0.995 is open.  The image is
rgb + (1 - A) bg, clamped to [0, 1].

`composite` walks every tile's list in chunks, all open tiles at once, and
drops a tile once its list ends or all its pixels have closed.  It records
how far each tile got, so that `composite_backward` can walk the same
instances again in blocks of tiles under autograd, one block's graph at a
time, and hand back the gradient of the instance rows.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .projection import W_EPS, Projected

EARLY_STOP_A = 0.995
# Rows of the instance stream: x, y, the conic scaled so that the
# quadratic form is lw (-a/2, -b, -c/2), opacity, r, g, b.
STREAM_ROWS = 9
_SMAX = 2.0 * math.log(1.0 / W_EPS)
_EXACT_MARGIN = 1.0
# Pixel x instance terms computed per chunk (all open tiles together).
PAIR_BUDGET = 1 << 25


class Bins(NamedTuple):
    gid: torch.Tensor         # [n] Gaussian of each instance, tile-major
    tile_start: torch.Tensor  # [T] int64
    tile_count: torch.Tensor  # [T] int64
    tiles_x: int
    tiles_y: int

    @property
    def n_instances(self) -> int:
        return int(self.gid.shape[0])


def _tile_bounds(proj: Projected, H: int, W: int, ts: int):
    r = torch.trunc(proj.radius).long()
    cx = torch.trunc(proj.means2d[:, 0]).long()
    cy = torch.trunc(proj.means2d[:, 1]).long()
    x0, x1, y0, y1 = cx - r, cx + 1 + r, cy - r, cy + 1 + r
    mx, my = proj.means2d[:, 0], proj.means2d[:, 1]
    x0 = torch.maximum(x0, torch.floor(mx - proj.ext_x).long())
    x1 = torch.minimum(x1, torch.floor(mx + proj.ext_x).long() + 1)
    y0 = torch.maximum(y0, torch.floor(my - proj.ext_y).long())
    y1 = torch.minimum(y1, torch.floor(my + proj.ext_y).long() + 1)
    x0, x1 = x0.clamp(0, W), x1.clamp(0, W)
    y0, y1 = y0.clamp(0, H), y1.clamp(0, H)
    degenerate = (x0 >= x1) | (y0 >= y1)
    fdiv = lambda v: torch.div(v, ts, rounding_mode="floor")
    return fdiv(x0), fdiv(x1 - 1), fdiv(y0), fdiv(y1 - 1), degenerate


def _exact_keep(tx, ty, mx, my, qa, qb, qc, ts):
    byc = -qb / torch.clamp(qc, min=1e-12)
    bya = -qb / torch.clamp(qa, min=1e-12)
    x0 = tx * ts - _EXACT_MARGIN - mx
    x1 = tx * ts + (ts - 1) + _EXACT_MARGIN - mx
    y0 = ty * ts - _EXACT_MARGIN - my
    y1 = ty * ts + (ts - 1) + _EXACT_MARGIN - my
    inside = (x0 <= 0) & (0 <= x1) & (y0 <= 0) & (0 <= y1)

    def edge_x(e):
        ys = torch.clamp(byc * e, y0, y1)
        return qa * e * e + 2.0 * qb * e * ys + qc * ys * ys

    def edge_y(e):
        xs = torch.clamp(bya * e, x0, x1)
        return qa * xs * xs + 2.0 * qb * e * xs + qc * e * e

    smin = torch.minimum(torch.minimum(edge_x(x0), edge_x(x1)),
                         torch.minimum(edge_y(y0), edge_y(y1)))
    return inside | (smin <= _SMAX)


@torch.no_grad()
def bin_tiles(proj: Projected, H: int, W: int, ts: int) -> Bins:
    tiles_x, tiles_y = -(-W // ts), -(-H // ts)
    tx0, tx1, ty0, ty1, degen = _tile_bounds(proj, H, W, ts)
    in_view = (tx1 >= 0) & (tx0 <= tiles_x - 1) & (ty1 >= 0) \
        & (ty0 <= tiles_y - 1)
    tx0, tx1 = tx0.clamp(0, tiles_x - 1), tx1.clamp(0, tiles_x - 1)
    ty0, ty1 = ty0.clamp(0, tiles_y - 1), ty1.clamp(0, tiles_y - 1)
    ok = proj.visible & ~degen & in_view
    zero = torch.zeros_like(tx0)
    sx = torch.where(ok, tx1 - tx0 + 1, zero)
    sy = torch.where(ok, ty1 - ty0 + 1, zero)
    n_cand = sx * sy
    C = n_cand.shape[0]
    dev = n_cand.device
    gid = torch.repeat_interleave(torch.arange(C, device=dev), n_cand)
    first = torch.cumsum(n_cand, 0) - n_cand
    d = torch.arange(gid.shape[0], device=dev) - first[gid]
    tx = tx0[gid] + d % sx[gid]
    ty = ty0[gid] + torch.div(d, sx[gid], rounding_mode="floor")
    keep = _exact_keep(tx, ty, proj.means2d[gid, 0], proj.means2d[gid, 1],
                       proj.conic[gid, 0], proj.conic[gid, 1],
                       proj.conic[gid, 2], ts)
    gid, tx, ty = gid[keep], tx[keep], ty[keep]
    key = torch.where(proj.visible, proj.depth,
                      torch.full_like(proj.depth, torch.inf))
    order = torch.sort(key, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(C, device=dev)
    s_key = torch.sort((ty * tiles_x + tx) << 32 | rank[gid]).values
    count = torch.bincount(s_key >> 32, minlength=tiles_x * tiles_y)
    return Bins(gid=order[s_key & 0xFFFFFFFF],
                tile_start=torch.cumsum(count, 0) - count, tile_count=count,
                tiles_x=tiles_x, tiles_y=tiles_y)


def stream_rows(proj: Projected) -> torch.Tensor:
    """[STREAM_ROWS, n] per-Gaussian rows (what an instance carries)."""
    return torch.stack([
        proj.means2d[:, 0], proj.means2d[:, 1], -0.5 * proj.conic[:, 0],
        -proj.conic[:, 1], -0.5 * proj.conic[:, 2], proj.opacity,
        proj.color[:, 0], proj.color[:, 1], proj.color[:, 2]], dim=0)


def _pixels(tiles: torch.Tensor, tiles_x: int, ts: int, dtype):
    i = torch.arange(ts * ts, device=tiles.device)[None, :]
    t = tiles[:, None]
    px = (t % tiles_x) * ts + i % ts
    py = torch.div(t, tiles_x, rounding_mode="floor") * ts \
        + torch.div(i, ts, rounding_mode="floor")
    return px.to(dtype), py.to(dtype)


def _chunk(stream, start, count, px, py, trans, base, G):
    """Terms of instances base .. base + G of the tiles' lists: returns
    (weights [t, P, G] of the gate-open contributions, the stream rows [9,
    t, 1, G], the transmittance handed on [t, P], the pair masks)."""
    lanes = torch.arange(G, device=stream.device)[None, :]
    j = base + lanes
    valid = j < count[:, None]
    idx = (start[:, None] + j).clamp(max=stream.shape[1] - 1)
    ch = stream[:, idx][:, :, None, :]                   # [rows, t, 1, G]
    dx = px[:, :, None] - ch[0]
    dy = py[:, :, None] - ch[1]
    lw = dx * dx * ch[2] + dx * dy * ch[3] + dy * dy * ch[4]
    # min(exp(lw), 1) without an exp that can overflow: a conic that
    # rounding left indefinite gives lw > 0, whose exp's gradient times the
    # clamp's zero would be NaN.
    w = torch.exp(torch.clamp(lw, max=0.0))
    a_raw = ch[5] * w
    live = (w >= W_EPS) & valid[:, None, :]
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    alpha = torch.where(live, torch.clamp(a_raw, max=1.0), zero)
    cp = torch.cumprod(1.0 - alpha, dim=-1)
    T_before = trans[:, :, None] * torch.cat(
        [torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)
    gate = ((1.0 - T_before) < EARLY_STOP_A).detach()
    passed = torch.cumprod(1.0 - torch.where(gate, alpha, zero), dim=-1)
    wgt = torch.where(gate, T_before * alpha, zero)
    masks = dict(valid=valid, gate=gate, live=live, a_raw=a_raw, w=w)
    return wgt, ch, trans * passed[..., -1], masks


def _chunk_width(n_tiles: int, P: int) -> int:
    g = max(PAIR_BUDGET // max(n_tiles * P, 1), 32)
    return 1 << min(int(math.log2(g)), 12)


@torch.no_grad()
def composite(stream: torch.Tensor, bins: Bins, ts: int,
              count_pairs: bool = False):
    """Accumulators [T, 4, P] (r, g, b, alpha, before the background) of
    the stream [STREAM_ROWS, n] over the tiles of `bins`, how far each
    tile's list was walked (`used` [T]) and, with `count_pairs`, the pixel
    x instance pairs by how far they get: `open` (the pixel's gate is
    open), of those `live` (w >= W_EPS), of those `alpha` (0 < op w < 1),
    of those `geom` (also w < 1)."""
    T, P = bins.tile_count.shape[0], ts * ts
    dt, dev = stream.dtype, stream.device
    acc = torch.zeros(T, 4, P, dtype=dt, device=dev)
    trans = torch.ones(T, P, dtype=dt, device=dev)
    used = torch.zeros(T, dtype=torch.long, device=dev)
    pairs = torch.zeros(4, dtype=torch.long, device=dev)
    act = torch.nonzero(bins.tile_count > 0)[:, 0]
    base = 0
    while act.numel():
        G = _chunk_width(act.numel(), P)
        px, py = _pixels(act, bins.tiles_x, ts, dt)
        cnt = bins.tile_count[act]
        wgt, ch, tr, m = _chunk(stream, bins.tile_start[act], cnt, px, py,
                                trans[act], base, G)
        acc[act] += torch.stack([(wgt * ch[6]).sum(-1), (wgt * ch[7]).sum(-1),
                                 (wgt * ch[8]).sum(-1), wgt.sum(-1)], dim=1)
        trans[act] = tr
        base += G
        used[act] = torch.clamp(cnt, max=base)
        if count_pairs:
            op = m["gate"] & m["valid"][:, None, :]
            live = op & m["live"]
            al = live & (m["a_raw"] < 1.0) & (m["a_raw"] > 0.0)
            pairs += torch.stack([op.sum(), live.sum(), al.sum(),
                                  (al & (m["w"] < 1.0)).sum()])
        keep = (cnt > base) & ((1.0 - tr) < EARLY_STOP_A).any(dim=1)
        act = act[keep]
    counts = None
    if count_pairs:
        counts = dict(zip(("open", "live", "alpha", "geom"), pairs.tolist()))
    return acc, used, counts


def composite_backward(stream: torch.Tensor, bins: Bins, ts: int,
                       used: torch.Tensor,
                       gout: torch.Tensor) -> torch.Tensor:
    """The gradient of sum(acc * gout) with respect to the stream rows,
    by autograd: the walk of `composite` again, up to `used` of each tile,
    in blocks of tiles of like length (longest first), each block's
    tiles x longest walk x pixels within PAIR_BUDGET where a tile allows,
    each block's graph freed before the next."""
    P = ts * ts
    leaf = stream.detach().requires_grad_(True)
    order = torch.argsort(used, descending=True)
    sizes = used[order].tolist()
    order = order.tolist()
    t = 0
    while t < len(order) and sizes[t] > 0:
        hi = t + 1
        while (hi < len(order) and sizes[hi] > 0
               and (hi + 1 - t) * sizes[t] * P <= PAIR_BUDGET):
            hi += 1
        tiles = torch.tensor(order[t:hi], device=stream.device)
        t = hi
        px, py = _pixels(tiles, bins.tiles_x, ts, stream.dtype)
        cnt = used[tiles]
        start = bins.tile_start[tiles]
        trans = torch.ones(tiles.numel(), P, dtype=stream.dtype,
                           device=stream.device)
        terms = []
        G = _chunk_width(tiles.numel(), P)
        for base in range(0, int(cnt.max()), G):
            wgt, ch, trans, _ = _chunk(leaf, start, cnt, px, py, trans,
                                       base, G)
            terms.append(torch.stack(
                [(wgt * ch[6]).sum(-1), (wgt * ch[7]).sum(-1),
                 (wgt * ch[8]).sum(-1), wgt.sum(-1)], dim=1))
        acc = torch.stack(terms).sum(0)
        torch.autograd.backward(acc, gout[tiles])
    if leaf.grad is None:
        return torch.zeros_like(stream)
    return leaf.grad


def compose_image(acc: torch.Tensor, bins: Bins, ts: int, H: int, W: int,
                  bg: torch.Tensor) -> torch.Tensor:
    """[3, H, W] image from the accumulators [T, 4, P] over `bg` [3]."""
    img = acc.reshape(bins.tiles_y, bins.tiles_x, 4, ts, ts)
    img = img.permute(2, 0, 3, 1, 4).reshape(
        4, bins.tiles_y * ts, bins.tiles_x * ts)[:, :H, :W]
    return torch.clamp(img[:3] + (1.0 - img[3])[None] * bg[:, None, None],
                       0.0, 1.0)


def render(proj: Projected, H: int, W: int, ts: int, bg: torch.Tensor,
           count_pairs: bool = False):
    """(image [3, H, W], bins, pair counts or None) without gradients."""
    with torch.no_grad():
        bins = bin_tiles(proj, H, W, ts)
        stream = stream_rows(proj)[:, bins.gid]
        acc, _, counts = composite(stream, bins, ts, count_pairs)
        return compose_image(acc, bins, ts, H, W, bg), bins, counts
