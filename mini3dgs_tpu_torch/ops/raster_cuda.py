"""Tile rasterization through the hand-written CUDA kernels (counterpart of
mini3dgs_tpu/ops/raster_pallas.py).

`raster_fwd` and `raster_bwd` are the kernels' wrappers: on CUDA tensors
they launch `csrc/raster_fwd.cu` and `csrc/raster_bwd.cu` (built with nvcc
for sm_90a at first use into one library in `build/kernels/`, loaded with
ctypes); on CPU tensors they run the plain PyTorch versions
`raster_fwd_plain` and `raster_bwd_plain`, which compute the same function
and are what the kernels are held against on the card.  `raster_op` joins
the pair into one differentiable function, and `rasterize_tiles` is the
renderer's tile path: binning -> pack -> raster_op -> epilogue.

Each kernel has two builds.  Without `t0` a pixel's transmittance starts
at 1 (the single-pass path).  With `t0` [T, 1, P] it starts at the
transmittance the depth ranges in front of this stream left (the ring
route, parallel/ring.py): the forward writes the transmittance it ends with
into accumulator row 5, the backward also returns the cotangent of `t0`.
`tile0` is the image tile of the launch's first block, so a launch can
cover a band of whole tile rows.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from ..utils import profiling
from . import binning as B
from .projection import Projected
from .raster_ref import EARLY_STOP_A, W_EPS

N_ACC = 8  # accumulator rows: r, g, b, depth, alpha, 3 zero rows
KERNEL_TILE_SIZES = (16, 32)
# A block of either kernel covers a sub-tile SUB_TILE pixels wide and
# SUB_TILE * `pix` high, `pix` pixels a thread: the tile at tile 16; at tile
# 32 one of four quadrants (pix = 1, the forward always) or of two halves
# (pix = 2, which the backward's launch may choose).  Each of its 8 warps
# owns a patch PATCH_W wide and LANE_ROWS * pix high
# (csrc/raster_common.cuh).
SUB_TILE = 16
PATCH_W = 8
LANE_ROWS = 4
# The kernels' rule for rejecting an instance for a whole warp
# (csrc/raster_common.cuh holds the same two numbers): a patch of pixels is
# missed if the least value of -lw over it, lowered by REJECT_GUARD of the
# sum of its terms' sizes, lies above REJECT_L > -ln(1e-5).
REJECT_L = 11.6
REJECT_GUARD = 1e-4

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def instance_attrs(proj: Projected) -> torch.Tensor:
    """[STREAM_ROWS, C] per-Gaussian rows in the kernel's layout
    (binning.ROW_*).  The conic rows are pre-scaled (qa, qc by -0.5, qb by
    -1) so the kernel's quadratic form is log w."""
    return torch.stack([
        proj.means2d[:, 0], proj.means2d[:, 1],
        -0.5 * proj.conic[:, 0], -proj.conic[:, 1], -0.5 * proj.conic[:, 2],
        proj.opacity,
        proj.color[:, 0], proj.color[:, 1], proj.color[:, 2],
        proj.depth,
    ], dim=0)


def _pixel_coords(num_tiles, tiles_x, tile_size, device, tile0=0):
    """[T, P] float pixel coordinates of the pixels of image tiles
    tile0 .. tile0 + T."""
    t = tile0 + torch.arange(num_tiles, device=device)[:, None]
    i = torch.arange(tile_size * tile_size, device=device)[None, :]
    px = (t % tiles_x) * tile_size + i % tile_size
    py = torch.div(t, tiles_x, rounding_mode="floor") * tile_size \
        + torch.div(i, tile_size, rounding_mode="floor")
    return px.float(), py.float()


def _slice_terms(stream, start, count, px, py, trans, base, lanes,
                 missed=None):
    """The per-pixel terms of one slice of every tile's instance list,
    instances base .. base + len(lanes) of each tile: [T, P, G] tensors (and
    `valid` [T, G], `idx` [T, G] stream columns, `row(r)` [T, 1, G]), with
    the transmittance as a cumulative product within the slice, seeded by
    the carried `trans` [T, P].  The `trans` handed on is the kernels': a
    pixel's transmittance stops falling once its gate has closed.  `missed`
    [T, P, G] (bool) forces alpha to 0 where it is true: a model of a kernel
    that never computes those pairs."""
    j = base + lanes
    valid = j < count                                       # [T, G]
    idx = (start + j).clamp(max=stream.shape[1] - 1)
    ch = stream[:, idx]                                     # [10, T, G]
    row = lambda r: ch[r][:, None, :]                       # [T, 1, G]
    dx = px[:, :, None] - row(B.ROW_X)                      # [T, P, G]
    dy = py[:, :, None] - row(B.ROW_Y)
    lw = dx * dx * row(B.ROW_QA) + dx * dy * row(B.ROW_QB) \
        + dy * dy * row(B.ROW_QC)
    w = torch.clamp(torch.exp(lw), max=1.0)
    a_raw = row(B.ROW_OP) * w
    live = (w >= W_EPS) & valid[:, None, :]
    if missed is not None:
        live = live & ~missed
    alpha = torch.where(live, torch.clamp(a_raw, max=1.0),
                        torch.zeros_like(w))
    cp = torch.cumprod(1.0 - alpha, dim=-1)
    T_before = trans[:, :, None] * torch.cat(
        [torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)
    gate = (1.0 - T_before) < EARLY_STOP_A
    passed = torch.cumprod(
        1.0 - torch.where(gate, alpha, torch.zeros_like(w)), dim=-1)
    return dict(row=row, valid=valid, idx=idx, dx=dx, dy=dy, w=w,
                a_raw=a_raw, live=live, alpha=alpha, T_before=T_before,
                gate=gate, wgt=T_before * alpha * gate,
                trans=trans * passed[..., -1])


def raster_fwd_plain(stream: torch.Tensor, tile_start: torch.Tensor,
                     tile_count: torch.Tensor, tiles_x: int, tile_size: int,
                     t0: Optional[torch.Tensor] = None, tile0: int = 0,
                     chunk: int = 64,
                     pixels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: all tiles at once, one
    `chunk`-wide slice of every tile's instance list per step.  Returns
    [T, 8, P]; with `t0` [T, 1, P] the transmittance starts there
    and row 5 holds what it ends with.

    `pixels` (indices into a tile's P pixels) restricts every tile to those
    pixels (`t0` stays the whole tile's): the result then has their number
    as its last dimension.  A pixel's value does not depend on which others
    are computed beside it; the kernel's blocks each compute a sub-tile's
    (`sub_tile_pixels`).  It computes in the stream's dtype: a float64
    stream gives a float64 reference."""
    T = tile_start.shape[0]
    P = tile_size * tile_size
    dev, dt = stream.device, stream.dtype
    px, py = _pixel_coords(T, tiles_x, tile_size, dev, tile0)
    if pixels is not None:
        px, py, P = px[:, pixels], py[:, pixels], pixels.numel()
        t0 = None if t0 is None else t0[:, :, pixels]
    out = torch.zeros(T, N_ACC, P, dtype=dt, device=dev)
    if t0 is None:
        trans = torch.ones(T, P, dtype=dt, device=dev)
    else:
        trans = t0.reshape(T, P)
        out[:, 5] = trans
    if T == 0 or stream.shape[1] == 0:
        return out
    start = tile_start.long()[:, None]
    count = tile_count.long()[:, None]
    acc = [torch.zeros(T, P, dtype=dt, device=dev) for _ in range(5)]
    lanes = torch.arange(chunk, device=dev)[None, :]
    for base in range(0, int(tile_count.max()), chunk):
        if not bool(((1.0 - trans) < EARLY_STOP_A).any()):
            break  # every gate is closed: the rest contributes exactly 0
        m = _slice_terms(stream, start, count, px, py, trans, base, lanes)
        for k, r in enumerate((B.ROW_R, B.ROW_G, B.ROW_B, B.ROW_DEPTH)):
            acc[k] = acc[k] + (m["wgt"] * m["row"](r)).sum(-1)
        acc[4] = acc[4] + m["wgt"].sum(-1)
        trans = m["trans"]
    out[:, :5] = torch.stack(acc, dim=1)
    if t0 is not None:
        out[:, 5] = trans
    return out


@torch.no_grad()
def raster_bwd_plain(stream: torch.Tensor, tile_start: torch.Tensor,
                     tile_count: torch.Tensor, tiles_x: int, tile_size: int,
                     acc: torch.Tensor, gout: torch.Tensor,
                     t0: Optional[torch.Tensor] = None, tile0: int = 0,
                     chunk: int = 64,
                     pixels: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the backward kernel, written by hand with
    the kernel's masks (not derived by autograd: `torch.clamp` gives the
    whole gradient at an exact tie op*w == 1 or w == 1, the kernel none).
    `acc` [T, 8, P] are the forward accumulators, `gout` their cotangent.
    Returns d_stream [STREAM_ROWS, n_live]: per pixel, with
    u_j = <gout[rgbd], c_j> + gout_alpha and S_j = <gout, acc> -
    sum_{i<=j} u_i wgt_i,
        d_alpha_j = u_j T_j - S_j / (1 - alpha_j)   while the gate is open,
    chained through alpha = min(op w, 1) (w >= 1e-5) and w = min(exp lw, 1),
    and summed over the tile's pixels.  A pixel whose gate has closed gives
    every later instance exactly 0.

    With `t0` [T, 1, P] the transmittance starts there, <gout, acc> also
    takes row 5 (the outgoing transmittance and its cotangent: both are
    linear in t0, and what lies behind j is proportional to 1 - alpha_j),
    and the result is (d_stream, d_t0) with d_t0 = <gout, acc> /
    max(t0, 1e-30) of t0's shape.

    `pixels` (indices into a tile's P pixels) restricts every tile to those
    pixels: the sums then run over them only, and d_t0 has their number as
    its last dimension.  The kernel's blocks at tile 32 each compute such a
    partial sum, over `sub_tile_pixels`.  It computes in the stream's
    dtype, as the forward's plain version does."""
    T = tile_start.shape[0]
    P = tile_size * tile_size
    dev, dt = stream.device, stream.dtype
    px, py = _pixel_coords(T, tiles_x, tile_size, dev, tile0)
    if pixels is not None:
        px, py, acc, gout = (px[:, pixels], py[:, pixels], acc[:, :, pixels],
                             gout[:, :, pixels])
        t0 = None if t0 is None else t0[:, :, pixels]
        P = pixels.numel()
    d_stream = torch.zeros_like(stream)
    if t0 is None:
        total = (gout[:, :5] * acc[:, :5]).sum(1)[:, :, None]   # [T, P, 1]
        trans = torch.ones(T, P, dtype=dt, device=dev)
        result = d_stream
    else:
        total = (gout[:, :6] * acc[:, :6]).sum(1)[:, :, None]
        trans = t0.reshape(T, P)
        result = (d_stream, (total[:, :, 0] / trans.clamp(min=1e-30))
                  .reshape(t0.shape))
    if T == 0 or stream.shape[1] == 0:
        return result
    start = tile_start.long()[:, None]
    count = tile_count.long()[:, None]
    g_r, g_g, g_b, g_d, g_a = (gout[:, k, :, None] for k in range(5))
    prefix = torch.zeros(T, P, 1, dtype=dt, device=dev)
    lanes = torch.arange(chunk, device=dev)[None, :]
    zero = torch.zeros((), dtype=dt, device=dev)
    for base in range(0, int(tile_count.max()), chunk):
        if not bool(((1.0 - trans) < EARLY_STOP_A).any()):
            break  # the rows behind stay exactly 0
        m = _slice_terms(stream, start, count, px, py, trans, base, lanes)
        row, dx, dy, w, wgt = m["row"], m["dx"], m["dy"], m["w"], m["wgt"]
        u = (g_r * row(B.ROW_R) + g_g * row(B.ROW_G) + g_b * row(B.ROW_B)
             + g_d * row(B.ROW_DEPTH) + g_a)
        incl = torch.cumsum(u * wgt, dim=-1) + prefix
        mask = m["gate"] & m["live"] & (m["a_raw"] < 1.0) & (m["a_raw"] > 0.0)
        d_alpha = torch.where(
            mask, u * m["T_before"] - (total - incl) / (1.0 - m["alpha"]),
            zero)
        d_lw = torch.where(w < 1.0, w * d_alpha * row(B.ROW_OP), zero)
        qa, qb, qc = row(B.ROW_QA), row(B.ROW_QB), row(B.ROW_QC)
        rows = torch.stack([
            -(d_lw * (2.0 * dx * qa + dy * qb)).sum(1),
            -(d_lw * (2.0 * dy * qc + dx * qb)).sum(1),
            (d_lw * dx * dx).sum(1), (d_lw * dx * dy).sum(1),
            (d_lw * dy * dy).sum(1),
            (d_alpha * w).sum(1),
            (g_r * wgt).sum(1), (g_g * wgt).sum(1), (g_b * wgt).sum(1),
            (g_d * wgt).sum(1)])                            # [10, T, G]
        valid = m["valid"]
        d_stream[:, m["idx"][valid]] = rows[:, valid]
        trans = m["trans"]
        prefix = incl[..., -1:]
    return result


def sub_tile_pixels(tile_size: int, pix: int, q: int,
                    device=None) -> torch.Tensor:
    """Indices, into a tile's tile_size^2 pixels, of the pixels of the
    sub-tile that block `q` of a tile of either kernel works on at `pix`
    pixels a thread: SUB_TILE wide and SUB_TILE * pix high, sub-tile column
    q % n and row q // n of n = tile_size / SUB_TILE."""
    n = tile_size // SUB_TILE
    rows = (q // n) * SUB_TILE * pix \
        + torch.arange(SUB_TILE * pix, device=device)
    cols = (q % n) * SUB_TILE + torch.arange(SUB_TILE, device=device)
    return (rows[:, None] * tile_size + cols[None, :]).reshape(-1)


def thread_pixels(tile_size: int, pix: int, q: int) -> torch.Tensor:
    """[8 warps, 32 lanes, pix] indices, into a tile's pixels, of the pixels
    that each thread of block `q` of a tile owns, as the kernels compute
    them: warp w works on patch (w % 2, w // 2) of the sub-tile, PATCH_W
    wide and LANE_ROWS * pix high, lane l on its column l % 8 and on the
    rows l // 8 + LANE_ROWS * k, k < pix."""
    n = tile_size // SUB_TILE
    warp = torch.arange(8)[:, None, None]
    lane = torch.arange(32)[None, :, None]
    k = torch.arange(pix)[None, None, :]
    ix = (q % n) * SUB_TILE + (warp % 2) * PATCH_W + lane % 8
    iy = (q // n) * SUB_TILE * pix + (warp // 2) * LANE_ROWS * pix \
        + lane // 8 + LANE_ROWS * k
    return iy * tile_size + ix


def patch_missed(stream: torch.Tensor, x0, y0, w: int, h: int) -> torch.Tensor:
    """[n] bool: whether the footprint {w >= 1e-5} of each instance of
    `stream` surely misses the patch of pixels [x0, x0 + w - 1] x [y0, y0 +
    h - 1] (`x0`, `y0` numbers or [n] tensors), so that a warp that owns the
    patch may skip the instance without computing a pixel.  Both
    kernels' rule in plain PyTorch, in float32: with A = -qa, B = -qb,
    C = -qc the form Q = -lw = A dx^2 + B dx dy + C dy^2 is convex, so
    unless the centre lies inside the patch its least value over the patch
    is taken on one of the four edges, on each at the stationary point
    clamped to the edge.  Each value is lowered by REJECT_GUARD of the sum
    of its terms' sizes (rounding, here and in the kernel's own lw) and
    held against REJECT_L.  Never true for a conic that is not positive
    definite or for non-finite values."""
    x, y = stream[B.ROW_X], stream[B.ROW_Y]
    A, Bq, C = -stream[B.ROW_QA], -stream[B.ROW_QB], -stream[B.ROW_QC]
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=stream.device)
    y0 = torch.as_tensor(y0, dtype=torch.float32, device=stream.device)
    dx0, dx1 = x0 - x, x0 + (w - 1.0) - x
    dy0, dy1 = y0 - y, y0 + (h - 1.0) - y
    ky, kx = -0.5 * Bq / C, -0.5 * Bq / A
    ok = (A > 0) & (C > 0) & (4.0 * A * C - Bq * Bq > 0)
    for v in (A, Bq, C, x, y, ky, kx):
        ok = ok & torch.isfinite(v)
    inside = (dx0 <= 0) & (dx1 >= 0) & (dy0 <= 0) & (dy1 >= 0)
    missed = ok & ~inside
    for X, Y in ((dx0, dy0), (dx1, dy1)):
        v = torch.minimum(torch.maximum(ky * X, dy0), dy1)
        q = A * X * X + Bq * X * v + C * v * v
        m = A * X * X + (Bq * X * v).abs() + C * v * v
        missed = missed & (q - REJECT_GUARD * m > REJECT_L)
        u = torch.minimum(torch.maximum(kx * Y, dx0), dx1)
        q = A * u * u + Bq * u * Y + C * Y * Y
        m = A * u * u + (Bq * u * Y).abs() + C * Y * Y
        missed = missed & (q - REJECT_GUARD * m > REJECT_L)
    return missed


class KernelLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an up-to-date build was reused
    build_log: str        # nvcc/ptxas output (registers, spills)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: the "
                       "CUDA raster kernels cannot be built")


def kernel_sources(csrc: Path = CSRC_DIR) -> list:
    """The sources nvcc compiles, one object file each."""
    return sorted(csrc.glob("*.cu"))


def library_path(csrc: Path = CSRC_DIR) -> Path:
    """Where the library built from `csrc` lives: its name carries a hash of
    the nvcc flags and of every source and header (`*.cu`, `*.cuh`), so an
    edit to any of them builds a new one.  Builds nothing."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in kernel_sources(csrc) + sorted(csrc.glob("*.cuh")):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"kernels-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> str:
    """Compile every source to an object file, all nvcc processes started
    together, then link them into `path`.  Returns the compilers' output."""
    nvcc = _nvcc()
    sources = kernel_sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in sources]
    tmp = BUILD_DIR / f"{stem}.tmp"
    try:
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        log = "".join(proc.communicate()[0] for proc in procs)
        for proc, src in zip(procs, sources):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"({proc.returncode}):\n{log}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{log}")
        os.replace(tmp, path)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return log


@functools.cache
def kernel_library() -> KernelLibrary:
    """Build (once per set of sources and flags) and load the library that
    holds every kernel of `csrc/`."""
    path = library_path()
    seconds, log = 0.0, ""
    if not path.exists():
        t0 = time.perf_counter()
        log = _build(path)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # (inst, n_live, tile_start, tile_count, num_tiles, tiles_x, tile_size,
    #  tile0, ...)
    head = [ptr, ctypes.c_longlong, ptr, ptr, i32, i32, i32, i32]
    lib.raster_fwd_launch.argtypes = head + [ptr, ptr]
    lib.raster_fwd_t0_launch.argtypes = head + [ptr, ptr, ptr]
    # (..., gout, [t0,] d_inst, [dt0,] part_g, sync, stream)
    lib.raster_bwd_launch.argtypes = head + [ptr] * 5
    lib.raster_bwd_t0_launch.argtypes = head + [ptr] * 7
    lib.raster_fwd_blocks_per_sm.argtypes = [i32, i32]
    lib.raster_bwd_blocks_per_sm.argtypes = [i32, i32, i32]
    for fn in (lib.raster_fwd_launch, lib.raster_fwd_t0_launch,
               lib.raster_bwd_launch, lib.raster_bwd_t0_launch,
               lib.raster_fwd_blocks_per_sm, lib.raster_bwd_blocks_per_sm):
        fn.restype = i32
    return KernelLibrary(lib, path, seconds, log)


def check_tile_ranges(n_inst, tile_start: torch.Tensor,
                      tile_count: torch.Tensor) -> None:
    """Raise when a tile range [start, start + count) reaches past the
    stream's `n_inst` columns (a kernel would read outside the stream).
    `tile_start` / `tile_count` may carry leading dimensions, with `n_inst`
    a tensor that broadcasts against them without the last: a set of
    streams is then checked with one wait for the device."""
    if tile_start.numel() == 0:
        return
    end = (tile_start.long() + tile_count).amax(dim=-1)
    if bool((end > n_inst).any()):
        raise ValueError("a tile range reaches past the end of the stream")


def _check_raster_args(name, stream, tile_start, tile_count, tiles_x,
                       tile_size, *accs, t0=None, tile0=0,
                       ranges_checked=False) -> torch.device:
    """Raise on what the kernels do not take; returns the common device.
    `accs` are [T, 8, P] float32 tensors (accumulators, cotangent), `t0`
    is None or [T, 1, P] float32."""
    T = tile_start.shape[0]
    if stream.dtype != torch.float32 or stream.dim() != 2 \
            or stream.shape[0] != B.STREAM_ROWS:
        raise ValueError(f"stream must be float32 [{B.STREAM_ROWS}, n], got "
                         f"{stream.dtype} {tuple(stream.shape)}")
    for what, v in (("tile_start", tile_start), ("tile_count", tile_count)):
        if v.dtype != torch.int32 or v.shape != (T,):
            raise ValueError(f"{what} must be int32 [{T}], got {v.dtype} "
                             f"{tuple(v.shape)}")
    if T % tiles_x:
        raise ValueError(f"{T} tiles is not a whole number of rows of "
                         f"{tiles_x}")
    if tile0 % tiles_x or tile0 < 0:
        raise ValueError(f"tile0 {tile0} is not the first tile of a row of "
                         f"{tiles_x}")
    shape = (T, N_ACC, tile_size * tile_size)
    for v in accs:
        if v.dtype != torch.float32 or v.shape != shape:
            raise ValueError(f"accumulators must be float32 {shape}, got "
                             f"{v.dtype} {tuple(v.shape)}")
    if t0 is not None and (t0.dtype != torch.float32
                           or t0.shape != (T, 1, shape[2])):
        raise ValueError(f"t0 must be float32 {(T, 1, shape[2])}, got "
                         f"{t0.dtype} {tuple(t0.shape)}")
    tensors = [stream, tile_start, tile_count, *accs]
    if t0 is not None:
        tensors.append(t0)
    devices = {v.device for v in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    device = stream.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {device}")
    if device.type == "cuda":
        if tile_size not in KERNEL_TILE_SIZES:
            raise ValueError(f"the CUDA kernels support tile sizes "
                             f"{KERNEL_TILE_SIZES}, not {tile_size}")
        if not (stream.is_contiguous() and tile_start.is_contiguous()
                and tile_count.is_contiguous()):
            raise ValueError(f"{name} needs contiguous tensors")
        if not ranges_checked:
            check_tile_ranges(stream.shape[1], tile_start, tile_count)
    return device


def raster_fwd(stream: torch.Tensor, tile_start: torch.Tensor,
               tile_count: torch.Tensor, tiles_x: int, tile_size: int,
               t0: Optional[torch.Tensor] = None, tile0: int = 0,
               ranges_checked: bool = False) -> torch.Tensor:
    """Raw per-tile accumulators [T, 8, P] of the instance stream
    [STREAM_ROWS, n_live]; block t covers image tile `tile0` + t.  With
    `t0` [T, 1, P] the transmittance starts there and row 5 is what it
    ends with.  CPU tensors take `raster_fwd_plain`; CUDA tensors launch
    the kernel (and count the launch in `raster_fwd.launches`, or in
    `raster_fwd.launches_t0` for the build with `t0`) or raise.
    `ranges_checked` says the caller has held the tile ranges against the
    stream's length itself (`check_tile_ranges`, which waits for the
    device).  The kernel's output carries no autograd graph: `raster_op`
    is the differentiable function."""
    device = _check_raster_args("raster_fwd", stream, tile_start, tile_count,
                                tiles_x, tile_size, t0=t0, tile0=tile0,
                                ranges_checked=ranges_checked)
    if device.type == "cpu":
        return raster_fwd_plain(stream, tile_start, tile_count, tiles_x,
                                tile_size, t0, tile0)
    T = tile_start.shape[0]
    lib = kernel_library().lib
    out = torch.empty(T, N_ACC, tile_size * tile_size, dtype=torch.float32,
                      device=device)
    head = (stream.data_ptr(), stream.shape[1], tile_start.data_ptr(),
            tile_count.data_ptr(), T, tiles_x, tile_size, tile0)
    cuda_stream = torch.cuda.current_stream(device).cuda_stream
    # The device of the tensors, not the current one, runs the kernel.
    with torch.cuda.device(device):
        if t0 is None:
            rc = lib.raster_fwd_launch(*head, out.data_ptr(), cuda_stream)
        else:
            t0 = t0.contiguous()
            rc = lib.raster_fwd_t0_launch(*head, t0.data_ptr(),
                                          out.data_ptr(), cuda_stream)
    if rc != 0:
        raise RuntimeError(f"raster_fwd kernel launch failed: CUDA error {rc}")
    if t0 is None:
        raster_fwd.launches += 1
    else:
        raster_fwd.launches_t0 += 1
    return out


raster_fwd.launches = 0
raster_fwd.launches_t0 = 0


def raster_bwd(stream: torch.Tensor, tile_start: torch.Tensor,
               tile_count: torch.Tensor, tiles_x: int, tile_size: int,
               acc: torch.Tensor, gout: torch.Tensor,
               t0: Optional[torch.Tensor] = None, tile0: int = 0,
               ranges_checked: bool = False):
    """Gradient [STREAM_ROWS, n_live] of the instance stream from the
    cotangent `gout` [T, 8, P] of the forward accumulators `acc`; with
    `t0` the pair (d_stream, d_t0).  CPU tensors take `raster_bwd_plain`;
    CUDA tensors launch the kernel (and count the launch in
    `raster_bwd.launches`, or `raster_bwd.launches_t0`) or raise.  At tile
    32 the kernel runs two or four blocks a tile and adds their partial
    rows itself, in a fixed order, through a scratch buffer of four times
    the stream's size.  The kernel does not read `acc`: it sums each
    pixel's <gout, acc> itself, from the terms of its own walk."""
    device = _check_raster_args("raster_bwd", stream, tile_start, tile_count,
                                tiles_x, tile_size, acc, gout, t0=t0,
                                tile0=tile0, ranges_checked=ranges_checked)
    # The cotangent arrives through the epilogue's permute and slice.
    gout = gout.contiguous()
    if device.type == "cpu":
        return raster_bwd_plain(stream, tile_start, tile_count, tiles_x,
                                tile_size, acc, gout, t0, tile0)
    lib = kernel_library().lib
    # Zero-filled: the kernel leaves the rows behind a tile's early exit,
    # and any column no tile range covers, unwritten.
    d_stream = torch.zeros_like(stream)
    T = tile_start.shape[0]
    quads = (tile_size // SUB_TILE) ** 2
    scratch = (None, None)
    if quads > 1:
        # Up to `quads` blocks work on one tile, each on a sub-tile: room
        # for their partial rows (every element read is one the kernel
        # wrote) and, zero-filled, a tile's count of finished blocks with
        # room for how far each got.
        scratch = (torch.empty(quads, *stream.shape, dtype=torch.float32,
                               device=device),
                   torch.zeros((1 + quads) * T, dtype=torch.int32,
                               device=device))
    tail = (*(None if v is None else v.data_ptr() for v in scratch),
            torch.cuda.current_stream(device).cuda_stream)
    head = (stream.data_ptr(), stream.shape[1], tile_start.data_ptr(),
            tile_count.data_ptr(), T, tiles_x, tile_size, tile0,
            gout.data_ptr())
    with torch.cuda.device(device):
        if t0 is None:
            rc = lib.raster_bwd_launch(*head, d_stream.data_ptr(), *tail)
        else:
            t0 = t0.contiguous()
            d_t0 = torch.empty_like(t0)  # the kernel writes every element
            rc = lib.raster_bwd_t0_launch(*head, t0.data_ptr(),
                                          d_stream.data_ptr(),
                                          d_t0.data_ptr(), *tail)
    if rc != 0:
        raise RuntimeError(f"raster_bwd kernel launch failed: CUDA error {rc}")
    if t0 is None:
        raster_bwd.launches += 1
        return d_stream
    raster_bwd.launches_t0 += 1
    return d_stream, d_t0


raster_bwd.launches = 0
raster_bwd.launches_t0 = 0


class _RasterOp(torch.autograd.Function):
    """`raster_fwd` with `raster_bwd` as its gradient, on either device."""

    @staticmethod
    def forward(ctx, stream, tile_start, tile_count, tiles_x, tile_size, t0,
                tile0, ranges_checked):
        acc = raster_fwd(stream, tile_start, tile_count, tiles_x, tile_size,
                         t0, tile0, ranges_checked)
        ctx.save_for_backward(stream, tile_start, tile_count, acc, t0)
        ctx.tiles_x, ctx.tile_size, ctx.tile0 = tiles_x, tile_size, tile0
        return acc

    @staticmethod
    @once_differentiable
    def backward(ctx, gout):
        stream, tile_start, tile_count, acc, t0 = ctx.saved_tensors
        with profiling.stage("3dgs:raster_bwd"):
            # The forward held these ranges against this stream.
            d = raster_bwd(stream, tile_start, tile_count, ctx.tiles_x,
                           ctx.tile_size, acc, gout, t0, ctx.tile0,
                           ranges_checked=True)
        d_stream, d_t0 = (d, None) if t0 is None else d
        return d_stream, None, None, None, None, d_t0, None, None


def raster_op(stream: torch.Tensor, tile_start: torch.Tensor,
              tile_count: torch.Tensor, tiles_x: int, tile_size: int,
              t0: Optional[torch.Tensor] = None, tile0: int = 0,
              ranges_checked: bool = False) -> torch.Tensor:
    """Differentiable (once) raw accumulators [T, 8, P]: `raster_fwd`
    forward, `raster_bwd` backward, with respect to the stream and, when
    given, the incoming transmittance `t0` [T, 1, P]."""
    return _RasterOp.apply(stream, tile_start, tile_count, tiles_x,
                           tile_size, t0, tile0, ranges_checked)


def tile_stream(proj: Projected, H: int, W: int, tile_size: int):
    """Binning and pack: returns (Binning, stream [STREAM_ROWS, n_live])."""
    with profiling.stage("3dgs:binning"):
        b = B.bin_gaussians(proj, H, W, tile_size)
        profiling.count("instances", b.n_live)
    with profiling.stage("3dgs:pack"):
        return b, B.pack_instances(instance_attrs(proj), b)


def compose_image(acc: torch.Tensor, H: int, W: int, tile_size: int,
                  bg: torch.Tensor):
    """The epilogue: raw accumulators [T, 8, P] of an image (or band) of H
    rows -> (image [3,H,W] over the background `bg`, alpha [1,H,W], depth
    [1,H,W])."""
    tiles_x = -(-W // tile_size)
    tiles_y = -(-H // tile_size)
    img = acc.reshape(tiles_y, tiles_x, N_ACC, tile_size, tile_size)
    img = img.permute(2, 0, 3, 1, 4).reshape(
        N_ACC, tiles_y * tile_size, tiles_x * tile_size)[:, :H, :W]
    rgb, D, A = img[0:3], img[3], img[4]
    image = torch.clamp(rgb + (1.0 - A)[None] * bg[:, None, None], 0.0, 1.0)
    return image, torch.clamp(A, 0.0, 1.0)[None], (D / (A + 1e-6))[None]


def rasterize_tiles(proj: Projected, H: int, W: int, bg: torch.Tensor, *,
                    tile_size: int = 16, fwd: Callable = raster_op,
                    row0: int = 0, full_height: Optional[int] = None,
                    binning: Optional[B.Binning] = None) -> dict:
    """Tile raster path: binning -> pack -> `fwd` (the kernel pair by
    default; `raster_fwd_plain` to compare against it) -> epilogue.
    Differentiable with respect to the fields of `proj`.

    With `full_height` the call renders the band of rows [row0, row0 + H)
    of a `full_height` x W image, and the kernels run on the band's tile
    rows only (`tile0`).  The band route passes the `binning` of the
    band's tiles alone (tile ranges local to the band: parallel/sharded.py
    `bin_gaussians_sharded`); it is packed as it is, and the counters are
    the band's, as the JAX package's are.  Without `binning` the whole
    image is binned and packed, and the counters are those of the whole
    image's stream: the band route's reference."""
    full_h = H if full_height is None else full_height
    tiles_x = -(-W // tile_size)
    if row0 % tile_size or row0 + H > full_h \
            or (H % tile_size and row0 + H != full_h):
        raise ValueError(f"rows [{row0}, {row0 + H}) of {full_h} are not a "
                         f"band of whole {tile_size}-pixel tile rows")
    tile0 = row0 // tile_size * tiles_x
    tiles = slice(tile0, tile0 + -(-H // tile_size) * tiles_x)
    if binning is None:
        b, stream = tile_stream(proj, full_h, W, tile_size)
        start, count = b.tile_start[tiles], b.tile_count[tiles]
    else:
        b = binning
        if b.tile_start.shape[0] != tiles.stop - tiles.start:
            raise ValueError(f"the binning holds {b.tile_start.shape[0]} "
                             f"tiles, the band {tiles.stop - tiles.start}")
        with profiling.stage("3dgs:pack"):
            stream = B.pack_instances(instance_attrs(proj), b)
        start, count = b.tile_start, b.tile_count
    with profiling.stage("3dgs:raster_fwd"):
        acc = fwd(stream, start, count, tiles_x, tile_size, tile0=tile0)
    with profiling.stage("3dgs:epilogue"):
        image, alpha, depth = compose_image(acc, H, W, tile_size, bg)
    return {"image": image, "alpha": alpha, "depth": depth,
            "n_dropped": b.n_dropped, "n_dropped_large": b.n_dropped_large,
            "n_large": b.n_large, "n_live": b.n_live}
