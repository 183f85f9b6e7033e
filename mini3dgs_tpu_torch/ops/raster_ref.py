"""Golden rasterizer: exact reference compositing semantics in plain torch
(counterpart of mini3dgs_tpu/ops/raster_ref.py); autograd differentiates
it.

Per pixel, in ascending-depth order: s = d^T Q d, w = clamp(exp(-0.5 s),
0, 1), skip w < 1e-5, alpha = clamp(op*w, 0, 1), contrib = T*alpha,
accumulate rgb/alpha/depth, stop once A >= 0.995; then the background is
composited once and depth = D/(A+1e-6).

The sequential loop is reformulated exactly with an exclusive cumulative
product of (1 - alpha) along the sorted Gaussian axis; the early stop is the
gate [A_before < 0.995] on the ungated transmittance, which reproduces the
loop (alphas are only zeroed after the first crossing).  Chunks of Gaussians
keep memory at O(pixels * chunk).  This is the renderer's `raster="golden"`
mode and the port's own oracle.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

EARLY_STOP_A = 0.995
W_EPS = 1e-5


def composite_chunk(px, py, x, y, qa, qb, qc, op, valid, T_in):
    """Shared per-chunk compositing math.  px/py: [P] pixel coords;
    Gaussian attributes: [G]; valid: [G] or [P,G] bool; T_in: [P] carried
    transmittance.  Returns (contrib [P,G], T_out [P])."""
    dx = px[:, None] - x[None, :]
    dy = py[:, None] - y[None, :]
    s = (dx * dx * qa[None, :] + 2.0 * dx * dy * qb[None, :]
         + dy * dy * qc[None, :])
    w = torch.clamp(torch.exp(-0.5 * s), 0.0, 1.0)
    alpha = torch.clamp(op[None, :] * w, 0.0, 1.0)
    valid_b = valid if valid.ndim == 2 else valid[None, :]
    alpha = torch.where((w >= W_EPS) & valid_b, alpha,
                        torch.zeros_like(alpha))
    one_minus = 1.0 - alpha
    cp = torch.cumprod(one_minus, dim=-1)
    T_excl = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=-1)
    T_before = T_in[:, None] * T_excl
    gate = (1.0 - T_before) < EARLY_STOP_A
    contrib = T_before * alpha * gate
    T_out = T_in * cp[:, -1]
    return contrib, T_out


def _chunk_terms(px, py, ptx, pty, x, y, qa, qb, qc, op, col, dep, val,
                 tx0, tx1, ty0, ty1, T):
    """One chunk of depth-sorted Gaussians composited onto the pixels:
    (T after the chunk, its rgb [P,3], alpha [P] and depth [P] terms).
    With tile bounds (tx0 not None) a Gaussian reaches only the pixels
    whose tile (ptx, pty) lies inside its bounds."""
    if tx0 is not None:
        val = (val[None, :]
               & (ptx[:, None] >= tx0[None, :]) & (ptx[:, None] <= tx1[None, :])
               & (pty[:, None] >= ty0[None, :]) & (pty[:, None] <= ty1[None, :]))
    contrib, T = composite_chunk(px, py, x, y, qa, qb, qc, op, val, T)
    # One product for the three sums: its node saves `contrib` and runs
    # whenever any of rgb, alpha and depth takes a gradient.  Under
    # checkpointing, a node that saved it and never runs (depth's, when the
    # loss reads only the image) would hold its recomputed [P, chunk] copy
    # until the backward pass ends.
    sums = contrib @ torch.cat([col, torch.ones_like(dep)[:, None],
                                dep[:, None]], dim=1)
    return T, sums[:, :3], sums[:, 3], sums[:, 4]


def rasterize_pixels(px, py, means2d, conic, depth, color, opacity, visible,
                     chunk: int = 512, tile_bounds=None, tile_size: int = 16):
    """Composite the visible Gaussians (depth-sorted internally) onto
    pixels [P].

    `tile_bounds` = (tx0, tx1, ty0, ty1) inclusive per-Gaussian tile AABBs:
    a Gaussian composites only onto pixels whose tile lies inside its AABB
    (the reference's binning cutoff, part of the rendered function).
    Returns (rgb [P,3], alpha [P], depth_accum [P]), pre-background.

    Under autograd each chunk is recomputed in the backward pass
    (torch.utils.checkpoint, as the JAX golden's remat'd scan body), so
    one chunk's [P, chunk] intermediates are alive at a time, not all of
    them: at 800^2 and 2^17 slots those would be hundreds of GB."""
    sort_key = torch.where(visible, depth, torch.full_like(depth, torch.inf))
    # The visible Gaussians sort first; the rest would composite nothing.
    order = torch.sort(sort_key, stable=True).indices[:int(visible.sum())]
    x, y = means2d[order, 0], means2d[order, 1]
    qa, qb, qc = conic[order, 0], conic[order, 1], conic[order, 2]
    op, col, dep, val = (opacity[order], color[order], depth[order],
                         visible[order])
    bounds = (None,) * 4
    ptx = pty = None
    if tile_bounds is not None:
        bounds = tuple(b[order] for b in tile_bounds)
        ptx = torch.div(px, tile_size, rounding_mode="floor").long()
        pty = torch.div(py, tile_size, rounding_mode="floor").long()
    run = _chunk_terms
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (means2d, conic, depth, color, opacity)):
        run = lambda *a: checkpoint(_chunk_terms, *a, use_reentrant=False)

    P = px.shape[0]
    T = torch.ones(P, dtype=px.dtype, device=px.device)
    rgb = torch.zeros(P, 3, dtype=px.dtype, device=px.device)
    A = torch.zeros(P, dtype=px.dtype, device=px.device)
    D = torch.zeros(P, dtype=px.dtype, device=px.device)
    for lo in range(0, order.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        T, c_rgb, c_A, c_D = run(
            px, py, ptx, pty, x[sl], y[sl], qa[sl], qb[sl], qc[sl], op[sl],
            col[sl], dep[sl], val[sl],
            *(None if b is None else b[sl] for b in bounds), T)
        rgb = rgb + c_rgb
        A = A + c_A
        D = D + c_D
    return rgb, A, D


def rasterize_image(means2d, conic, depth, color, opacity, visible,
                    height: int, width: int, bg: torch.Tensor, radius=None,
                    chunk: int = 512, tile_size: int = 16,
                    pixel_block: int = 65536) -> dict:
    """Full-image golden raster.  Returns dict(image [3,H,W],
    alpha [1,H,W], depth [1,H,W]).  When `radius` is given, the
    reference's tile-AABB cutoff is applied.  Pixels are composited in
    blocks of `pixel_block` to bound the [pixels, chunk] intermediates."""
    tile_bounds = None
    if radius is not None:
        from .binning import _tile_bounds
        tx0, tx1, ty0, ty1, degen = _tile_bounds(means2d, radius, height,
                                                 width, tile_size)
        visible = visible & ~degen
        tile_bounds = (tx0, tx1, ty0, ty1)
    dev = means2d.device
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    parts = [rasterize_pixels(px[i:i + pixel_block], py[i:i + pixel_block],
                              means2d, conic, depth, color, opacity, visible,
                              chunk=chunk, tile_bounds=tile_bounds,
                              tile_size=tile_size)
             for i in range(0, px.shape[0], pixel_block)]
    rgb, A, D = (torch.cat(p, dim=0) for p in zip(*parts))
    image = rgb + (1.0 - A)[:, None] * bg[None, :]
    image = torch.clamp(image, 0.0, 1.0).reshape(height, width, 3)
    alpha = torch.clamp(A, 0.0, 1.0).reshape(1, height, width)
    depth_out = (D / (A + 1e-6)).reshape(1, height, width)
    return {"image": image.permute(2, 0, 1).contiguous(), "alpha": alpha,
            "depth": depth_out}
