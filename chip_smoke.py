"""On-card smoke run of the PyTorch/CUDA port (mini3dgs_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU and nvcc:

    python3 chip_smoke.py

It builds the CUDA raster kernels from mini3dgs_tpu_torch/csrc/ and holds
each against its plain PyTorch version on the card (edge cases at tile 16
and 32, a ragged image edge, the kernels' own staging and per-patch reject
cases at both launch shapes, and the golden rasterizer and its autograd on
a small scene), checks that binning on the card equals binning on the CPU,
holds the projection kernels P1 (csrc/project_fwd.cu) and P2
(csrc/project_bwd.cu) against the plain projection chain and its
autograd on that scene in every build (then on each block of the ring
render below) and times them against their byte bounds, renders the flagship 100,000-Gaussian SH-3 scene at 800x800 through
`render`, runs the novel-view entry point, takes six full-width train
steps (then one densify and one prune step) on that scene, and runs the
training entry point.  Then the ring route (parallel/ring.py) with five
ranks on the one card: the kernels' `t0` builds against their plain
versions and as a chain against one single pass, a full-width ring render
against the single-device render, ring gradients against single-device
gradients, four full-width ring train steps, and both entry points with
--tile-shards 5 --ring.  Then the trainer entry point: `main_torch.py`
trains a COLMAP scene of that SH-3 scene (8 views at 800x800, 100,000
points, written with the port's own COLMAP writers and PNG codec) with the
rendering and pool of configs/sdf_tex_30k.yaml for 16 steps, resumes for
4, and `scripts/evaluate_torch.py` and `scripts/export_ply_torch.py` run on
its checkpoint.  Then the texture scene: made on the card
(`scripts/make_synthetic_scene_torch.py --texture`, 9 views at 800x800),
exported (`scripts/export_colmap_scene_torch.py`) and trained by
`main_torch.py` for 200 steps with three densify events.  Last, the
training-quality gates of `scripts/train_path_parity_torch.py` at 256x256
and 300 iterations (the tile kernels within 0.5 dB of the JAX record and
of the golden route).  Then the trainer over a (data, tile) mesh with four
ranks on the card at tile 16: one gauss-sharded step against one
replicated step with two cameras, the setup's gradient self-check in both
layouts, and `main_torch.py` on that COLMAP scene over a (2, 2) mesh with
the pool split over the ranks (16 steps, a densify event and the
compaction, the mesh's validation image against one device's, the
checkpoint's bitwise reload, a resume), then over a (1, 2) mesh through the
ring (8 steps); after each run the kernels of its route are held against
their plain versions on its own tile-16 launches (a band's tile rows, the
ring step's (band, range) launches).  Last, `scripts/train_1m_torch.py` (1M Gaussians, a 2^20
pool, 800x800, on a Blender scene made here; B1 and B2 held against their
plain versions on its stream) and `scripts/train_probe_torch.py` (256x256,
300 steps).  Last, ring v2 and v3 and the band route's sharded candidate
sort (phase 18): the three ring routes' renders bitwise equal and one step
of each against ring v1 at phase 11's setting, with their times, launches
and peak memory; the kernels with t0 against their plain versions on ring
v3's launches; the sharded sort against the single-device binning of every
band and the kernels without t0 on its heaviest band; `main_torch.py` over
a (1, 2) mesh through ring v3 and ring v2.  Last, the mesh over two
processes (phase 19): two children of scripts/distributed_step_torch.py
join one gloo group on the card and take the replicated step and the
gauss-sharded step over (2, 2), its sharded checkpoint, the band route and
ring v1 / v3 over (1, 2), each against this process's single-process
step, the kernels held against their plain versions on the children's own
launches; then four children of one rank each over (2, 2), whose rows and
columns each cross two processes through a group of their own: both steps,
both renderers, the gradient self-check and a (1, 2) step that leaves two
of them without a rank (the two-process group runs the renderers too, over
(2, 2) and over (1, 2) on both routes); and a one-process NCCL group runs
one exchange.  Last (phase 20), graft_entry_torch.py, the twin of
__graft_entry__.py: `entry()` on the card and `dryrun_multichip(8)` on
eight ranks of the card, its losses against the JAX dryrun's record.
Last (phase 21), bench_torch.py, the twin of bench.py: the first step of
its headline and anisotropic chains (800x800, 100,000 Gaussians, SH 0)
with B1 and B2 held against their plain versions on the launches' own
inputs, and its `main` (which also profiles a headline step) with the
trained line on phase 14's checkpoint, one B1 and one B2 a chain step.
Any failure raises; nothing falls back to the CPU.
The last three lines are a JSON object with one entry per kernel, then
nvidia-smi's name and power limit, and {"ok": true, "device": {...}}.
"""

import atexit
import contextlib
import dataclasses
import inspect
import io
import json
import os
import shutil
import subprocess
import struct
import sys
import tempfile
import time
import warnings
import zlib
from pathlib import Path
from unittest import mock

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
VIEW_SIZE = 800
N_GAUSSIANS = 100_000
CAPACITY = 2 ** 17
TRAIN_STEPS = 6
# The ring route: 800 / 32 = 25 tile rows split into 5 bands of 160 rows,
# and a pool whose capacity divides over the 5 depth-rank ranges.
RING_RANKS = 5
RING_CAPACITY = 5 * 26_215
RING_STEPS = 4

# The card's published peaks (NVIDIA H100 SXM data sheet): HBM3 bytes/s and
# float32 operations/s outside the tensor cores (an FMA counts as two).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
# Float32 operations the raster functions need per pixel x instance pair,
# by how far the pair gets (an FMA as two, expf and a true division as eight
# each).  A pair whose pixel's gate has closed needs none.
# Every pair whose gate is open: the gate test 2; dx, dy 2; the quadratic
# form 8; expf 8; min(., 1) 1; the w >= 1e-5 test 1.
PAIR_TEST_OPS = 22
# Forward, further, where w >= 1e-5: op*w 1; min 1; T*alpha 1; four
# accumulator FMAs and one add 9; T update 2.
FWD_LIVE_OPS = 14
# Backward, further, where w >= 1e-5: op*w 1; min 1; T*alpha 1; u 8; running
# sum 2; four colour FMAs 8; the two tests of op*w 2; T update 2.
BWD_LIVE_OPS = 25
# Backward, further, where 0 < op*w < 1: d_alpha 13; d_op 2; the w < 1 test 1.
BWD_ALPHA_OPS = 16
# Backward, further, where also w < 1: d_lw 2; the five geometric terms 20.
BWD_GEOM_OPS = 22
N_ACC_ROWS = 8  # rows of the accumulators a forward launch writes
# The kernels' running launch totals (ops/cuda_library.LAUNCHES): the raster
# builds without (B1, B2) and with t0 (B3, B4), and the projection's P1, P2.
B1, B2 = "raster_fwd.launches", "raster_bwd.launches"
B3, B4 = "raster_fwd.launches_t0", "raster_bwd.launches_t0"
P1, P2 = "project_fwd.launches", "project_bwd.launches"


def launched(*totals) -> tuple:
    """The running launch totals named, in order."""
    from mini3dgs_tpu_torch.ops.cuda_library import LAUNCHES
    return tuple(LAUNCHES[t] for t in totals)


def zero_launches(*totals) -> None:
    """Set the running launch totals named to 0."""
    from mini3dgs_tpu_torch.ops.cuda_library import LAUNCHES
    LAUNCHES.update(dict.fromkeys(totals, 0))


def gate(a: torch.Tensor, b: torch.Tensor, name: str) -> float:
    """The cliff-aware forward gate of scripts/verify_chip.py plus a mean
    bound: p99.9 |diff| < 1e-3, at most max(8, n/100000) entries over 1e-3
    (isolated early-stop flips, each <= the remaining transmittance
    5e-3), max |diff| < 5.5e-3 and mean |diff| < 2e-5.  Returns max |diff|."""
    d = (a.double() - b.double()).abs().flatten().cpu().numpy()
    if not np.isfinite(d).all():
        raise AssertionError(f"{name}: non-finite values")
    p999 = float(np.quantile(d, 0.999))
    big = int((d > 1e-3).sum())
    ok = (p999 < 1e-3 and big <= max(8, d.size // 100_000)
          and d.max() < 5.5e-3 and d.mean() < 2e-5)
    print(f"    {name:22s} max={d.max():.3e} p99.9={p999:.3e} "
          f"mean={d.mean():.3e} >1e-3: {big}/{d.size} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel and reference disagree")
    return float(d.max())


def gate_acc(acc_k, acc_p, name, has_t0: bool = False,
             depth_scale: float | None = None) -> float:
    """Gate raw [T, 8, P] accumulators: rgb, alpha, depth / max depth; with
    `has_t0` also row 5, the outgoing transmittance.  The depth row is
    divided by `depth_scale`, by default its own largest value in `acc_p`.
    A launch deep in a chain names the largest depth of its instances
    instead: an early-stop flip costs up to 5e-3 of an instance's depth,
    whatever little the launch's own accumulated depth comes to behind the
    transmittance it was handed."""
    pad = 6 if has_t0 else 5
    if bool((acc_k[:, pad:] != 0).any()):
        raise AssertionError(f"{name}: pad rows {pad}..7 are not zero")
    scale = depth_scale or max(float(acc_p[:, 3].abs().max()), 1e-6)
    worst = max(gate(acc_k[:, 0:3], acc_p[:, 0:3], f"{name} rgb"),
                gate(acc_k[:, 4], acc_p[:, 4], f"{name} alpha"),
                gate(acc_k[:, 3] / scale, acc_p[:, 3] / scale,
                     f"{name} depth/max"))
    if has_t0:
        worst = max(worst, gate(acc_k[:, 5], acc_p[:, 5], f"{name} T_end"))
    return worst


def cuda_ms(fn, reps: int = 5, inner: int = 1) -> float:
    """Median of `reps` CUDA-event timings of fn() after one warm-up; each
    timing spans `inner` calls back to back and is divided by `inner` (for
    launches too short to time one at a time)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


# Bytes the projection kernel P1 (csrc/project_fwd.cu) reads and writes a
# Gaussian: xyz 12, log-scale 12, quaternion 16, opacity 4, features_dc 12,
# features_rest 180, alive 1 in; means 8, conic 12, depth 4, radius 4,
# visible 1, colour 12, opacity 4, the two extents 8 out.
PROJECT_FWD_BYTES = 290
# P1's fields that the cull and binning read, held bitwise against the chain.
PROJECTION_EXACT = ("visible", "depth", "radius", "ext_x", "ext_y")
PROJECTION_RTOL = 1e-6  # every other field, relative


def norm_order_matches(rotation: torch.Tensor) -> bool:
    """Whether this torch's `linalg.norm` of the quaternions sums their
    squares as P1 does (`quat_norm`: (w^2 + y^2) + (x^2 + z^2), the order
    of PyTorch's reduce kernel over a row of 4 in torch 2.11).  The radius,
    the extents and the cull follow from this norm."""
    w, x, y, z = rotation.unbind(-1)
    p1 = torch.sqrt((w * w + y * y) + (x * x + z * z))
    return torch.equal(torch.linalg.norm(rotation, dim=-1), p1)


def gate_projection(got, want, rotation: torch.Tensor, name: str) -> float:
    """P1's `Projected` against the plain chain's on the same rows and the
    same card: every field at the chain's dtype, shape and strides;
    `visible`, `depth`, `radius` and both extents bitwise, every other field
    within PROJECTION_RTOL relative (the SH colour reads the camera centre,
    which the chain takes from a cuBLAS product whose order of sums P1
    cannot see).  Where this torch sums the quaternion norm in another order
    than P1 (`norm_order_matches`), which a torch release may do, `radius`
    and the extents are held within PROJECTION_RTOL instead and `visible`
    may differ only in rows whose radius differs; a warning says so.
    Raises on a mismatch; returns the largest relative error of the fields
    held within PROJECTION_RTOL."""
    exact = norm_order_matches(rotation)
    if not exact:
        warnings.warn(f"{name}: this torch sums the quaternion norm in "
                      "another order than P1; radius and extents held within "
                      f"{PROJECTION_RTOL} relative, not bitwise")
    bits = lambda t: t.contiguous().view(torch.int32)
    worst = 0.0
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if (a.dtype, a.shape, a.stride()) != (b.dtype, b.shape, b.stride()):
            raise AssertionError(f"{name}: {f} is {a.dtype} {tuple(a.shape)} "
                                 f"{a.stride()}, the chain's {b.dtype} "
                                 f"{tuple(b.shape)} {b.stride()}")
        if f == "visible":
            moved = a != b
            if not exact:
                moved &= bits(got.radius) == bits(want.radius)
            if bool(moved.any()):
                raise AssertionError(f"{name}: visible differs in "
                                     f"{int(moved.sum())} rows")
        elif f == "depth" or (exact and f in PROJECTION_EXACT):
            if not torch.equal(bits(a), bits(b)):
                raise AssertionError(f"{name}: {f} is not bitwise the "
                                     "chain's")
        else:
            same = (a == b) | (a.isnan() & b.isnan())
            rel = torch.where(same, torch.zeros_like(a),
                              (a - b).abs() / b.abs())
            err = float(rel.max()) if rel.numel() else 0.0
            if not err <= PROJECTION_RTOL:
                raise AssertionError(f"{name}: {f} off by {err:.3g} "
                                     "relative")
            worst = max(worst, err)
    return worst


# Bytes the backward projection kernel P2 (csrc/project_bwd.cu) reads and
# writes a Gaussian: P1's 237 B of parameters and 40 B of cotangents (means
# 8, conic 12, depth 4, colour 12, opacity 4) in; 236 B of gradients (xyz
# 12, features_dc 12, features_rest 180, log-scale 12, quaternion 16,
# opacity 4) out.
PROJECT_BWD_BYTES = 513
# P2 against the plain VJP, each gradient by its leaf's norm.  Both are
# float32 evaluations of a gradient that is ill-conditioned on elongated and
# degenerate Gaussians: on the card tests' scene the float32 chain itself
# lies up to 3.4e-5 (the quaternion) and 2.1e-5 (the log-scale, under
# antialias) from the same chain in float64, and P2 up to 1.2e-5 from the
# float32 chain (measured on an H100 80GB HBM3).  So P2 is held within
# PROJECT_BWD_RTOL of the float32 chain and, against the float64 chain, to
# no more than PROJECT_BWD_F64_RATIO times the float32 chain's own distance
# (plus 1e-6): as accurate as the plain version.
PROJECT_BWD_RTOL = 5e-5
PROJECT_BWD_F64_RATIO = 1.5


def seeded_cotangents(g, seed: int) -> tuple:
    """Standard normal cotangents of the projection's five differentiable
    fields (`pj.COTANGENT_FIELDS`) on every row of `g`."""
    gen = torch.Generator(device=g.device).manual_seed(seed)
    C = g.capacity
    return tuple(torch.randn(*shape, generator=gen, device=g.device)
                 for shape in ((C, 2), (C, 3), (C,), (C, 3), (C,)))


def guarded_rows(g, cam, kw: dict) -> torch.Tensor:
    """The rows the chain's guard keeps under a graph (ops/projection.py):
    alive, in front of the camera, the centre within max(radius_min,
    radius_max) of the frame."""
    from mini3dgs_tpu_torch.ops.projection import project_gaussians_plain
    with torch.no_grad():
        p = project_gaussians_plain(g, cam, **kw)
    m = max(kw.get("radius_min", 0.01), kw.get("radius_max", 50.0))
    x, y = p.means2d.unbind(-1)
    return ((p.depth > 1e-6) & g.alive & (x >= -m) & (x < cam.width + m)
            & (y >= -m) & (y < cam.height + m))


def float64_pair(g, cam):
    """`g` and `cam` with every float32 tensor in float64."""
    up = lambda t: t.double() if t is not None and t.dtype == torch.float32 \
        else t
    return g._map(up), cam.replace(view_matrix=up(cam.view_matrix),
                                   FoVx=up(cam.FoVx), FoVy=up(cam.FoVy))


def gate_gradients(got: dict, want: dict, want64: dict, name: str,
                   dropped=None) -> float:
    """P2's gradients `got` against the plain version's, `want` in float32
    and `want64` in float64, by parameter name: each at its parameter's
    dtype and shape, finite, exactly 0 on the rows `dropped` (when given),
    within PROJECT_BWD_RTOL of `want` by the norm of the difference over
    the norm of `want` (or, where `want` itself lies farther from `want64`,
    as on a leaf whose gradient is 0 up to rounding, such as the quaternions
    of isotropic Gaussians, within PROJECT_BWD_F64_RATIO times that
    distance), and no farther from `want64` than PROJECT_BWD_F64_RATIO
    times `want`'s own distance, plus 1e-6.  Raises on a mismatch; returns
    the largest distance from `want` of a leaf held within
    PROJECT_BWD_RTOL."""
    worst = 0.0
    for k, b in want.items():
        a = got[k]
        if b is None or a is None:
            if a is not b:
                raise AssertionError(f"{name}: {k} is {a} where the chain "
                                     f"gives {b}")
            continue
        if (a.dtype, a.shape) != (b.dtype, b.shape):
            raise AssertionError(f"{name}: {k} is {a.dtype} "
                                 f"{tuple(a.shape)}, the chain's {b.dtype} "
                                 f"{tuple(b.shape)}")
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: {k} is not finite")
        if dropped is not None and bool((a[dropped] != 0).any()):
            raise AssertionError(f"{name}: {k} is not 0 on the rows the "
                                 "guard drops")
        dist = lambda x, y: float((x.double() - y).norm() / y.norm()) \
            if bool(y.any()) else float(x.abs().max())
        err, b64 = dist(a, b.double()), want64[k]
        own, ours = dist(b, b64), dist(a, b64)
        if not err <= max(PROJECT_BWD_RTOL, PROJECT_BWD_F64_RATIO * own):
            raise AssertionError(f"{name}: {k} off by {err:.3g} by its norm")
        if not ours <= PROJECT_BWD_F64_RATIO * own + 1e-6:
            raise AssertionError(f"{name}: {k} lies {ours:.3g} from the "
                                 f"float64 chain, the float32 chain "
                                 f"{own:.3g}")
        if PROJECT_BWD_F64_RATIO * own <= PROJECT_BWD_RTOL:
            worst = max(worst, err)
    return worst


def gate_projection_bwd(got: dict, g, cam, cotangents, kw: dict,
                        name: str) -> float:
    """P2's gradients (`pj.project_bwd` on `cotangents`) against the plain
    version's (`pj.project_bwd_plain`, in float32 and in float64) on the
    same rows and card, given the cotangents of the rows the chain's guard
    keeps (`guarded_rows`), through `gate_gradients`, with every row the
    guard drops exactly 0.  Returns the largest distance from the float32
    plain version."""
    from mini3dgs_tpu_torch.ops import projection as pj
    near = guarded_rows(g, cam, kw)
    kept = tuple(t * near.reshape((-1,) + (1,) * (t.dim() - 1))
                 for t in cotangents)
    want = pj.project_bwd_plain(g, cam, kept, **kw)
    g64, cam64 = float64_pair(g, cam)
    want64 = pj.project_bwd_plain(g64, cam64, [t.double() for t in kept],
                                  **kw)
    return gate_gradients(got, want, want64, name, dropped=~near)


ROWS_REL_L2 = 1e-4   # gate_rows' bound on each row's rel-L2


def gate_rows(got: torch.Tensor, want: torch.Tensor, name: str) -> float:
    """Gate the backward kernel's gradient [10, n] against the plain
    version's, row by row, each normalised by the plain row's largest
    magnitude: rel-L2 < 1e-4, at most max(8, n/100000) entries over 1e-3
    (the early stop and the w >= 1e-5 skip are cliffs: a rounding
    difference that flips one moves isolated entries), and the largest
    normalised error < 2e-2.  Returns that largest error."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite gradient")
    g, w = got.double(), want.double()
    scale = w.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    d = (g - w).abs() / scale
    l2 = (g - w).norm(dim=1) / w.norm(dim=1).clamp(min=1e-30)
    big = int((d > 1e-3).sum())
    worst, worst_l2 = float(d.max()), float(l2.max())
    ok = (worst_l2 < ROWS_REL_L2 and big <= max(8, d.numel() // 100_000)
          and worst < 2e-2)
    print(f"    {name:22s} rows max={worst:.3e} rel-L2={worst_l2:.3e} "
          f">1e-3: {big}/{d.numel()} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: backward kernel and plain disagree")
    return worst


def seeded_gout(acc: torch.Tensor, seed: int, rows: int = 5) -> torch.Tensor:
    """A cotangent of the accumulators: N(0,1) on the first `rows` rows (5,
    or 6 with the outgoing transmittance), 0 on the pad rows."""
    gen = torch.Generator(device=acc.device).manual_seed(seed)
    gout = torch.zeros_like(acc)
    gout[:, :rows] = torch.randn(acc[:, :rows].shape, generator=gen,
                                 device=acc.device)
    return gout


def seeded_t0(n_tiles: int, P: int, seed: int, device):
    """An incoming transmittance [T, 1, P] in [0, 1] with the cases of the
    chain: tiles t % 5 == 1 arrive at exactly 1 (nothing in front); tiles
    t % 5 == 3 arrive closed (t0 <= 0.005 everywhere, tile 3 at exactly 0);
    in every other tile a tenth of the pixels arrive closed and the rest lie
    in (0.006, 1].  Tiles t % 7 == 6 (the edge streams' saturating tiles)
    stay open.  Returns (t0, closed tiles, tiles at 1)."""
    rng = np.random.default_rng(seed)
    t0 = rng.uniform(0.006, 1.0, (n_tiles, 1, P))
    some = rng.random((n_tiles, 1, P)) < 0.1
    t0[some] = rng.uniform(0.0, 0.005, int(some.sum()))
    t = np.arange(n_tiles)
    sat = t % 7 == 6
    ones = (t % 5 == 1) & ~sat
    closed = (t % 5 == 3) & ~sat
    t0[sat] = rng.uniform(0.5, 1.0, (int(sat.sum()), 1, P))
    t0[ones] = 1.0
    t0[closed] = rng.uniform(0.0, 0.005, (int(closed.sum()), 1, P))
    t0[3] = 0.0
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return (as_t(t0, torch.float32), as_t(np.flatnonzero(closed), torch.long),
            as_t(np.flatnonzero(ones), torch.long))


def cut_ranges(stream, start, count, key, n: int):
    """Cut a tile-major stream into `n` streams: instance i goes to stream
    key[i] (non-decreasing within each tile's slice, so every part keeps
    the tile's front-to-back order).  Returns n (stream, start, count)."""
    T = start.shape[0]
    tile = torch.repeat_interleave(torch.arange(T, device=stream.device),
                                   count.long())
    parts = []
    for r in range(n):
        mask = key == r
        cnt = torch.bincount(tile[mask], minlength=T)
        parts.append((stream[:, mask].contiguous(),
                      (torch.cumsum(cnt, 0) - cnt).int(), cnt.int()))
    return parts


def edge_stream(tile_size, tiles_x, tiles_y, seed, device):
    """Seeded instance stream with the kernel's edge cases: empty tiles,
    slices of 1, 255, 256, 257 and 513 instances (the kernel stages 256 at
    a time), alpha = 1 splats (opacity 1 centred on a pixel), and tiles
    whose first splats are broad and opaque so they saturate early."""
    rng = np.random.default_rng(seed)
    n_tiles = tiles_x * tiles_y
    counts = rng.integers(0, 700, n_tiles)
    counts[rng.random(n_tiles) < 0.1] = 0
    counts[:6] = [0, 1, 255, 256, 257, 513]
    counts[6::7] = np.maximum(counts[6::7], 40)  # tiles that saturate
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    n = int(counts.sum())
    tile = np.repeat(np.arange(n_tiles), counts)
    ox = (tile % tiles_x) * tile_size
    oy = (tile // tiles_x) * tile_size
    s = np.zeros((10, n), np.float32)
    s[0] = ox + rng.uniform(-6, tile_size + 6, n)
    s[1] = oy + rng.uniform(-6, tile_size + 6, n)
    sig = rng.uniform(0.7, 0.5 * tile_size, (2, n))
    rho = rng.uniform(-0.7, 0.7, n)
    det = (1 - rho ** 2) * sig[0] ** 2 * sig[1] ** 2
    s[2] = -0.5 * sig[1] ** 2 / det
    s[3] = rho * sig[0] * sig[1] / det
    s[4] = -0.5 * sig[0] ** 2 / det
    s[5] = rng.uniform(0.02, 0.99, n)
    s[6:9] = rng.random((3, n))
    s[9] = rng.uniform(0.5, 6.0, n)
    one = rng.random(n) < 0.05
    s[0, one] = np.floor(s[0, one])
    s[1, one] = np.floor(s[1, one])
    s[5, one] = 1.0
    for t in range(6, n_tiles, 7):  # early saturation
        j = slice(starts[t], starts[t] + min(counts[t], 30))
        s[2, j], s[3, j], s[4, j], s[5, j] = -1e-4, 0.0, -1e-4, 0.95
    to = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return to(s, torch.float32), to(starts, torch.int32), \
        to(counts, torch.int32)


def patch_stream(tile_size, tiles_x, tiles_y, seed, device):
    """Seeded instance stream with the kernels' own edge cases (they stage
    64 instances at a time and reject an instance per patch of 8 x 4 or
    8 x 8 pixels): slices of 0, 1, 64 and 65 instances in tiles 0-3 and of
    63 and 257 in tiles 9 and 10; tile 4
    holds splats centred on a pixel whose footprint w >= 1e-5 ends exactly k
    pixels away, k = 1..12, so on a patch's edge for some patch; tile 5
    starts with a splat that covers the whole tile; tile 6 with splats of
    opacity 1 centred on a pixel (w == 1, op * w >= 1) and off it.  Returns
    (stream, tile_start, tile_count)."""
    rng = np.random.default_rng(seed)
    n_tiles = tiles_x * tiles_y
    counts = rng.integers(20, 200, n_tiles)
    counts[:4] = [0, 1, 64, 65]
    counts[9:11] = [63, 257]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    n = int(counts.sum())
    tile = np.repeat(np.arange(n_tiles), counts)
    ox = (tile % tiles_x) * tile_size
    oy = (tile // tiles_x) * tile_size
    s = np.zeros((10, n), np.float32)
    s[0] = ox + rng.uniform(-3, tile_size + 3, n)
    s[1] = oy + rng.uniform(-3, tile_size + 3, n)
    sig = rng.uniform(0.8, 0.3 * tile_size, (2, n))
    rho = rng.uniform(-0.6, 0.6, n)
    det = (1 - rho ** 2) * sig[0] ** 2 * sig[1] ** 2
    s[2] = -0.5 * sig[1] ** 2 / det
    s[3] = rho * sig[0] * sig[1] / det
    s[4] = -0.5 * sig[0] ** 2 / det
    s[5] = rng.uniform(0.02, 0.6, n)
    s[6:9] = rng.random((3, n))
    s[9] = rng.uniform(0.5, 6.0, n)

    def put(t, k, x, y, q, op):
        j = starts[t] + k
        s[0, j], s[1, j] = ox[j] + x, oy[j] + y
        s[2, j], s[3, j], s[4, j], s[5, j] = q, 0.0, q, op
    for k in range(12):  # exp(q (k + 1)^2) == 1e-5
        put(4, k, 3 + k % 8, 2 + k % 5, np.log(1e-5) / (k + 1) ** 2, 0.3)
    put(5, 0, tile_size / 2, tile_size / 2, -1e-5, 0.5)
    for k in range(6):
        put(6, k, 5 + 3 * k + 0.5 * (k % 2), 4 + k, -0.02, 1.0)
    to = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return to(s, torch.float32), to(starts, torch.int32), \
        to(counts, torch.int32)


def patch_t0(tile_size, n_tiles, seed, device):
    """An incoming transmittance [T, 1, P] for `patch_stream`: open
    everywhere (0.3 to 1) except tile 7, where only the top right 16 x 16
    pixels arrive open (at tile 16: the top right 8 x 8), and tile 8, which
    arrives closed."""
    rng = np.random.default_rng(seed)
    t0 = rng.uniform(0.3, 1.0, (n_tiles, tile_size, tile_size))
    half = tile_size // 2
    keep = t0[7, :half, half:].copy()
    t0[7] = rng.uniform(0.0, 0.005, (tile_size, tile_size))
    t0[7, :half, half:] = keep
    t0[8] = rng.uniform(0.0, 0.005, (tile_size, tile_size))
    return torch.as_tensor(t0.reshape(n_tiles, 1, -1), dtype=torch.float32,
                           device=device)


def check_patch_cases(rc, ts: int, dev, with_t0: bool) -> float:
    """The backward kernel on `patch_stream` (with `patch_t0` for the build
    with t0) against its plain version: rows and d_t0 within `gate_rows`,
    two launches bitwise equal, exact zeros for the instances of a tile that
    arrives closed and none for the tile whose one open quadrant is left.
    Returns the largest normalised error."""
    tiles_x, tiles_y = 4, 3
    stream, start, count = patch_stream(ts, tiles_x, tiles_y, 400 + ts, dev)
    args = (stream, start, count, tiles_x, ts)
    kw = dict(t0=patch_t0(ts, tiles_x * tiles_y, 500 + ts, dev)) \
        if with_t0 else {}
    acc = rc.raster_fwd(*args, **kw)
    gout = seeded_gout(acc, 600 + ts, rows=6 if with_t0 else 5)
    got = rc.raster_bwd(*args, acc, gout, **kw)
    again = rc.raster_bwd(*args, acc, gout, **kw)
    want = rc.raster_bwd_plain(*args, acc, gout, **kw)
    torch.cuda.synchronize()
    name = f"tile{ts} patch cases{' t0' if with_t0 else ''}"
    cols = lambda t: slice(int(start[t]), int(start[t]) + int(count[t]))
    if not with_t0:
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two launches differ")
        return gate_rows(got, want, name)
    (d_k, dt0_k), (d_a, dt0_a), (d_p, dt0_p) = got, again, want
    if not (torch.equal(d_k, d_a) and torch.equal(dt0_k, dt0_a)):
        raise AssertionError(f"{name}: two launches differ")
    if bool((d_k[:, cols(8)] != 0).any()) or bool((d_p[:, cols(8)] != 0).any()):
        raise AssertionError(f"{name}: a closed tile's rows are not 0")
    if not bool((d_k[:, cols(7)] != 0).any()):
        raise AssertionError(f"{name}: the open quadrant gave no gradient")
    return max(gate_rows(d_k, d_p, name),
               gate_rows(dt0_k.reshape(1, -1), dt0_p.reshape(1, -1),
                         name + " d_t0"))


def patch_tile_rows(dev) -> tuple:
    """Tile rows of 4 tiles for the patch streams' two launch shapes: 3
    (12 tiles, fewer than the card has SMs) and enough for more tiles than
    it has SMs (at tile 32 the backward kernel takes other blocks above
    that, and the forward's blocks no longer all fit at once)."""
    return 3, torch.cuda.get_device_properties(dev).multi_processor_count \
        // 4 + 1


def check_fwd_patch_cases(rc, ts: int, dev, with_t0: bool,
                          tiles_y: int = 3) -> float:
    """The forward kernel on `patch_stream` of 4 x `tiles_y` tiles (with
    `patch_t0` for the build with t0) against its plain version within
    `gate_acc`, two launches bitwise equal; with t0, tile 8 arrives closed
    and must add exactly nothing and hand t0 on, and tile 7, with one open
    quadrant, must move.  Returns the largest |difference|."""
    tiles_x = 4
    stream, start, count = patch_stream(ts, tiles_x, tiles_y, 400 + ts, dev)
    args = (stream, start, count, tiles_x, ts)
    t0 = patch_t0(ts, tiles_x * tiles_y, 500 + ts, dev) if with_t0 else None
    got = rc.raster_fwd(*args, t0=t0)
    again = rc.raster_fwd(*args, t0=t0)
    want = rc.raster_fwd_plain(*args, t0=t0)
    torch.cuda.synchronize()
    name = (f"tile{ts} {tiles_x * tiles_y} tiles patch cases"
            f"{' t0' if with_t0 else ''}")
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches differ")
    if with_t0 and (bool((got[8, :5] != 0).any())
                    or not torch.equal(got[8, 5:6], t0[8])):
        raise AssertionError(f"{name}: a closed tile moved")
    if with_t0 and not bool((got[7, 4] != 0).any()):
        raise AssertionError(f"{name}: the open quadrant did not move")
    return gate_acc(got, want, name, has_t0=with_t0)


def pair_counts(rc, stream, start, count, tiles_x, ts, t0=None,
                tile0=0) -> dict:
    """Pixel x instance pairs of this stream by how far the raster functions
    have to take them (counted with the plain version's terms): `open`, the
    pixel's gate is open before the instance; of those `live`, w >= 1e-5;
    of those `alpha`, 0 < op*w < 1 (d_alpha is needed); of those `geom`,
    w < 1 (the geometric gradient is needed).  With `t0` the transmittance
    starts there, so a pixel that arrives closed counts no pair."""
    T, P = start.shape[0], ts * ts
    n = dict(open=0, live=0, alpha=0, geom=0)
    if stream.shape[1] == 0:
        return n
    px, py = rc._pixel_coords(T, tiles_x, ts, stream.device, tile0)
    trans = torch.ones(T, P, device=stream.device) if t0 is None \
        else t0.reshape(T, P)
    lanes = torch.arange(64, device=stream.device)[None, :]
    st, ct = start.long()[:, None], count.long()[:, None]
    for base in range(0, int(count.max()), 64):
        m = rc._slice_terms(stream, st, ct, px, py, trans, base, lanes)
        live = m["gate"] & m["live"]
        alpha = live & (m["a_raw"] < 1.0) & (m["a_raw"] > 0.0)
        n["open"] += int((m["gate"] & m["valid"][:, None, :]).sum())
        n["live"] += int(live.sum())
        n["alpha"] += int(alpha.sum())
        n["geom"] += int((alpha & (m["w"] < 1.0)).sum())
        trans = m["trans"]
    return n


def raster_bounds(pairs: dict, n_live: int, T: int, P: int, has_t0: bool):
    """((bound_ms, bound_by) of the forward, the same of the backward) for
    one launch over `n_live` instances and `T` tiles of `P` pixels, from
    its pair counts.  Bytes, each input read once and each output written
    once: the stream (40 B an instance), the two ranges, the forward's 8
    output rows; for the backward the stream and its gradient, and the live
    rows of accumulators and cotangent (5, or 6 with `t0`).  With `t0`: t0
    itself, for the backward also d_t0 and its division (8 operations and
    the 2 of the extra product, a pixel)."""
    t0_bytes = 4 * T * P if has_t0 else 0
    rows = 6 if has_t0 else 5
    fwd = bound(40 * n_live + 8 * T + 4 * N_ACC_ROWS * T * P + t0_bytes,
                PAIR_TEST_OPS * pairs["open"] + FWD_LIVE_OPS * pairs["live"])
    bwd = bound(80 * n_live + 8 * T + 2 * 4 * rows * T * P + 2 * t0_bytes,
                PAIR_TEST_OPS * pairs["open"] + BWD_LIVE_OPS * pairs["live"]
                + BWD_ALPHA_OPS * pairs["alpha"]
                + BWD_GEOM_OPS * pairs["geom"]
                + (10 * T * P if has_t0 else 0))
    return fwd, bwd


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def ring_step_launches(rc, proj, target, n_rk: int, ts: int, size: int,
                       gid_sharded: bool = False):
    """The n_rk x n_rk raster launches of one ring step on the projected
    scene `proj` of a size x size view at tile `ts`, as the step makes them:
    the transmittance chained forward through each band's depth ranges and
    the loss's own cotangent (towards `target`) chained backward; with
    `gid_sharded` the origins of ring v3 (each rank's gid block of `proj`,
    the distributed ranks, the reshard, the origin binning of rank-local
    rows).  Returns dictionaries keyed by (band, range): `segs` (stream,
    tile_start, tile_count), `t_in` the incoming transmittance, `acc_seg`
    the forward accumulators, `g_in` their cotangent; and the cotangent
    `g_acc` of the whole image's accumulators."""
    from mini3dgs_tpu_torch.core.loss import gaussian_loss
    from mini3dgs_tpu_torch.ops import binning as B
    from mini3dgs_tpu_torch.parallel import ring
    dev = target.device
    P, tiles_x = ts * ts, size // ts
    ntb = (size // ts // n_rk) * tiles_x
    C = proj.means2d.shape[0]
    Cs = C // n_rk
    if gid_sharded:
        local = ring._rank_local_rows(
            [B.slice_rows(proj, slice(i * Cs, (i + 1) * Cs))
             for i in range(n_rk)], [dev] * n_rk)
    segs = {}
    for r in range(n_rk):
        if gid_sharded:
            rb = B.bin_gaussians_ring_origin_resharded(
                local[r], r * Cs, C, size, size, ts, n_rk)
            packed = B.pack_instances(rc.instance_attrs(local[r]), rb)
        else:
            rb = B.bin_gaussians_ring_origin(proj, size, size, ts, r, n_rk)
            packed = B.pack_instances(rc.instance_attrs(proj), rb)
        for b in range(n_rk):
            segs[b, r] = (
                packed[:, rb.seg_start[b]:rb.seg_start[b + 1]].contiguous(),
                rb.tile_start[b].contiguous(), rb.tile_count[b].contiguous())
    t_in, acc_seg, bands = {}, {}, []
    for b in range(n_rk):
        trans = torch.ones(ntb, 1, P, device=dev)
        total = torch.zeros(ntb, 5, P, device=dev)
        for r in range(n_rk):
            t_in[b, r] = trans
            acc_seg[b, r] = rc.raster_fwd(*segs[b, r], tiles_x, ts, t0=trans,
                                          tile0=b * ntb)
            total = total + acc_seg[b, r][:, :5]
            trans = acc_seg[b, r][:, 5:6].contiguous()
        bands.append(torch.cat([total, torch.zeros(ntb, 3, P, device=dev)], 1))
    acc_leaf = torch.cat(bands).requires_grad_(True)
    image = rc.compose_image(acc_leaf, size, size, ts,
                             torch.ones(3, device=dev))[0]
    g_acc, = torch.autograd.grad(gaussian_loss(image, target)[0], acc_leaf)
    g_in = {}
    for b in range(n_rk):
        g5 = torch.zeros(ntb, 1, P, device=dev)
        for r in reversed(range(n_rk)):
            g_in[b, r] = torch.cat(
                [g_acc[b * ntb:(b + 1) * ntb, :5], g5,
                 torch.zeros(ntb, 2, P, device=dev)], 1)
            _, g5 = rc.raster_bwd(*segs[b, r], tiles_x, ts, acc_seg[b, r],
                                  g_in[b, r], t0=t_in[b, r], tile0=b * ntb)
    return segs, t_in, acc_seg, g_in, g_acc


def gate_ring_step(rc, segs, t_in, acc_seg, g_in, tiles_x: int, ts: int,
                   ntb: int, tag: str = "") -> tuple:
    """The launches of one ring step (from `ring_step_launches`, bands of
    `ntb` tiles) against their plain versions.  Each B3 launch within
    `gate_acc`, its depth on the scale of its segment's deepest instance;
    each B4 launch's d_t0 within `gate_rows` (kernel and plain version read
    the same accumulators and the same cotangent, so d_t0 has no cliff);
    the instance rows of all launches side by side, each row on the scale
    of the step's largest entry (behind a small transmittance a launch's
    own rows are small, and one early-stop flip would outweigh them).  An
    empty segment must add nothing and hand its transmittance on.  Returns
    the largest errors of (B3, B4)."""
    from mini3dgs_tpu_torch.ops.binning import ROW_DEPTH
    err3 = err4 = 0.0
    d_kernel, d_plain = [], []
    for (b, r), seg in segs.items():
        fargs = (*seg, tiles_x, ts)
        kw = dict(t0=t_in[b, r], tile0=b * ntb)
        name = f"{tag}band{b} range{r}"
        if not seg[0].shape[1]:
            if bool((acc_seg[b, r][:, :5] != 0).any()) \
                    or not torch.equal(acc_seg[b, r][:, 5:6], t_in[b, r]):
                raise AssertionError(f"{name}: an empty segment changed the "
                                     "accumulators")
            continue
        err3 = max(err3, gate_acc(
            acc_seg[b, r], rc.raster_fwd_plain(*fargs, **kw), name,
            has_t0=True, depth_scale=float(seg[0][ROW_DEPTH].max())))
        bargs = (*fargs, acc_seg[b, r], g_in[b, r])
        d_k, dt0_k = rc.raster_bwd(*bargs, **kw)
        d_p, dt0_p = rc.raster_bwd_plain(*bargs, **kw)
        d_kernel.append(d_k)
        d_plain.append(d_p)
        err4 = max(err4, gate_rows(dt0_k.reshape(1, -1),
                                   dt0_p.reshape(1, -1), name + " d_t0"))
    err4 = max(err4, gate_rows(torch.cat(d_kernel, 1),
                               torch.cat(d_plain, 1), f"{tag}all launches"))
    return err3, err4


def mesh_kernel_gates(rc, tr, cam, size: int, ring: bool) -> dict:
    """Phase 16 (c) and (d): the kernels at the mesh run's own shapes, on
    the trained state's stream of `cam` at tile 16, against their plain
    versions.  Without `ring`: the last band's stream as `_render_bands`
    launches it, from the sharded candidate sort over the mesh's tile axis
    (`bin_gaussians_sharded`, tile ranges local to the band, `tile0` its
    first tile): B1 within `gate_acc`, B2 within `gate_rows` under a
    seeded cotangent.  With `ring`: every launch of one ring step over the
    mesh's tile axis (`ring_step_launches`, the loss's own cotangent
    towards `cam.image`), within `gate_ring_step`.  Returns the largest
    errors, the instances the kernels took and, on the card, their ms."""
    from mini3dgs_tpu_torch.ops import binning as B
    from mini3dgs_tpu_torch.parallel.sharded import bin_gaussians_sharded
    ts, n = MESH_TILE_SIZE, tr.mesh.tile
    tiles_x = size // ts
    ntb = size // ts // n * tiles_x
    proj = project_with(tr.gathered_state().gaussians, cam, tr.settings)
    if ring:
        segs, t_in, acc_seg, g_in, _ = ring_step_launches(
            rc, proj, cam.image, n, ts, size)
        err3, err4 = gate_ring_step(rc, segs, t_in, acc_seg, g_in, tiles_x,
                                    ts, ntb, tag=f"tile{ts} ")
        return {"fwd_t0_err": err3, "bwd_t0_err": err4, "launches": len(segs),
                "instances": sum(seg[0].shape[1] for seg in segs.values())}
    dev = proj.means2d.device
    b = bin_gaussians_sharded([proj] * n, size // n, size, ts, [dev] * n)[-1]
    stream = B.pack_instances(rc.instance_attrs(proj), b)
    lo = (n - 1) * ntb
    fargs = (stream, b.tile_start, b.tile_count, tiles_x, ts)
    kw = dict(tile0=lo)
    name = f"tile{ts} band{n - 1}"
    acc = rc.raster_fwd(*fargs, **kw)
    fwd_err = gate_acc(acc, rc.raster_fwd_plain(*fargs, **kw), name)
    bargs = (*fargs, acc, seeded_gout(acc, 1616))
    bwd_err = gate_rows(rc.raster_bwd(*bargs, **kw),
                        rc.raster_bwd_plain(*bargs, **kw), name)
    res = {"fwd_err": fwd_err, "bwd_err": bwd_err, "tile0": lo,
           "instances": b.n_live, "heaviest": int(b.tile_count.max())}
    if stream.is_cuda:
        res["ms"] = (
            cuda_ms(lambda: rc.raster_fwd(*fargs, **kw, ranges_checked=True)),
            cuda_ms(lambda: rc.raster_bwd(*bargs, **kw, ranges_checked=True)))
    return res


def load_script(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_colmap_scene(root: Path, g, n_points: int, settings, n_views: int,
                       size: int) -> list:
    """A COLMAP scene of `g` on disk, written by the port's own writers and
    PNG codec: a PINHOLE size x size camera (60 degrees), `n_views`
    turntable poses, points3D.bin = the first `n_points` Gaussians' centres
    with their DC colours, and images/ = renders of `g` from the poses.
    Returns the turntable cameras."""
    from mini3dgs_tpu_torch.core.sh import C0
    from mini3dgs_tpu_torch.data import colmap
    from mini3dgs_tpu_torch.ops.renderer import render
    from mini3dgs_tpu_torch.utils.io import save_image
    from mini3dgs_tpu_torch.utils.vis import turntable_cameras
    sp = root / "sparse" / "0"
    sp.mkdir(parents=True)
    (root / "images").mkdir()
    f = 0.5 * size / np.tan(np.radians(60.0) / 2)
    colmap.write_cameras_binary(
        {1: colmap.ColmapCamera(1, "PINHOLE", size, size,
                                np.array([f, f, size / 2, size / 2]))},
        str(sp / "cameras.bin"))
    cams = turntable_cameras(n_views, width=size, image_height=size,
                             device=g.device)
    rotmat_to_qvec = load_script("export_colmap_scene_torch").rotmat_to_qvec
    imgs = {}
    for i, cam in enumerate(cams):
        R_wc = cam.R.cpu().double().numpy().T
        imgs[i + 1] = colmap.ColmapImage(
            i + 1, rotmat_to_qvec(R_wc), -R_wc @ cam.T.cpu().double().numpy(),
            1, f"view_{i:03d}.png")
        with torch.no_grad():
            save_image(render(g, cam, settings)["image"],
                       str(root / "images" / imgs[i + 1].name))
    colmap.write_images_binary(imgs, str(sp / "images.bin"))
    rgb = torch.clamp(C0 * g.features_dc[:n_points, 0] + 0.5, 0.0, 1.0)
    colmap.write_points3d_binary(g.xyz[:n_points].cpu().numpy(),
                                 rgb.cpu().numpy(), str(sp / "points3D.bin"))
    return cams


def paeth_png(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of `img` [H, W, 3] uint8 with every row under the
    Paeth filter, the costliest one to undo (a writer with adaptive
    filtering picks it often on photographs)."""
    from mini3dgs_tpu_torch.utils import png
    H, W, C = img.shape
    x = img.astype(np.int16)
    a, b, c = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    a[:, 1:], b[1:], c[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.concatenate([np.full((H, 1), 4, np.uint8),
                           ((x - pred) & 255).astype(np.uint8).reshape(H, -1)],
                          axis=1)
    return (png.SIGNATURE
            + png._chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
            + png._chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + png._chunk(b"IEND", b""))


def parse_log(text: str) -> dict:
    """main_torch's `[it] k=v ...` lines as {it: {k: float}}."""
    log = {}
    for line in text.splitlines():
        if line.startswith("[") and "]" in line and "=" in line:
            head, _, rest = line.partition("]")
            if head[1:].strip().isdigit():
                log[int(head[1:])] = {k: float(v) for k, v in
                                      (kv.split("=") for kv in rest.split())}
    return log


class MethodTimes:
    """Wraps methods of a class so that each call is timed on the host
    clock up to a device synchronise; `self` of the first wrapped method's
    calls is kept in `objects`, each method's first return value in
    `first`.  Restores the methods on exit."""

    def __init__(self, cls, names, device):
        self.cls, self.names, self.device = cls, names, device
        self.times = {n: [] for n in names}
        self.objects = []
        self.first = {}      # each method's first return value

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self.saved = {n: getattr(self.cls, n) for n in self.names}
        for n in self.names:
            def wrapper(obj, *a, _n=n, **kw):
                if _n == self.names[0]:
                    self.objects.append(obj)
                self._sync()
                t0 = time.perf_counter()
                out = self.saved[_n](obj, *a, **kw)
                self._sync()
                self.times[_n].append(time.perf_counter() - t0)
                self.first.setdefault(_n, out)
                return out
            setattr(self.cls, n, wrapper)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.cls, n, fn)


def trainer_entry_phase(dev, g, n_points: int, size: int, workdir: Path,
                        steps: int = 16) -> dict:
    """Phase 13: `main_torch.main` trains a COLMAP scene of `g` (8 views,
    points3D = its first `n_points` centres) with the rendering and pool of
    configs/sdf_tex_30k.yaml for `steps` steps (prunes at 6 and 12;
    densify, opacity reset and the pool's compaction at 8: a second densify
    event could grow the live count past the three quarters of the pool at
    which the compaction is skipped), then resumes for 4 more;
    `scripts/evaluate_torch.py` and `scripts/export_ply_torch.py` run on
    its checkpoint.  Raises on any check that fails; returns the numbers
    the phase prints."""
    import main_torch
    from mini3dgs_tpu_torch.config import ConfigManager
    from mini3dgs_tpu_torch.core.gaussians import compact_capacity
    from mini3dgs_tpu_torch.ops.renderer import RenderSettings
    from mini3dgs_tpu_torch.train import checkpoint as ckpt
    from mini3dgs_tpu_torch.train import density
    from mini3dgs_tpu_torch.train.trainer import GaussianTrainer
    from mini3dgs_tpu_torch.utils import png
    from mini3dgs_tpu_torch.utils.gaussian_ply import import_gaussians_ply

    cfg = ConfigManager.load_from_yaml(str(REPO / "configs" /
                                           "sdf_tex_30k.yaml"))
    if (cfg.image_height, cfg.image_width, cfg.tile_size, cfg.sh_degree,
            cfg.color_mode, cfg.background_color, cfg.capacity) != (
            800, 800, 32, 3, "sh", [1.0, 1.0, 1.0], 2 ** 19):
        raise AssertionError(f"configs/sdf_tex_30k.yaml reads as {cfg}")
    settings = RenderSettings(image_height=size, image_width=size,
                              bg_color=tuple(cfg.background_color),
                              tile_size=cfg.tile_size, color_mode="sh",
                              sh_degree=cfg.sh_degree)
    scene, out = workdir / "scene", workdir / "out"
    t0 = time.perf_counter()
    write_colmap_scene(scene, g, n_points, settings, 8, size)
    write_s = time.perf_counter() - t0
    # One target image under the Paeth filter on every row: the decoder's
    # slowest case, timed on this host and held against the image.
    view0 = png.decode((scene / "images" / "view_000.png").read_bytes())
    paeth = paeth_png(view0)
    t0 = time.perf_counter()
    if not np.array_equal(png.decode(paeth), view0):
        raise AssertionError("the PNG decoder misread Paeth rows")
    paeth_s = time.perf_counter() - t0
    cfg = dataclasses.replace(
        cfg, data_path=str(scene), output_path=str(out),
        image_height=size, image_width=size, iterations=steps,
        log_interval=4, eval_interval=steps, save_interval=steps,
        densify_from_iter=8, densify_interval=4, densify_until_iter=8,
        prune_interval=6, opacity_reset_interval=8, sh_increase_interval=4,
        device=dev.type)
    cfg_path = workdir / "config.yaml"
    ConfigManager.save_to_yaml(cfg, str(cfg_path))
    if ConfigManager.load_from_yaml(str(cfg_path)) != cfg:
        raise AssertionError("the written config does not read back")
    names = ["setup", "train_step", "save_checkpoint", "load_checkpoint"]

    def entry(fn, argv):
        """(return code, stdout, MethodTimes) of one entry-point call, the
        kernels' counts set to 0 just before it and read just after."""
        zero_launches(B1, B2)
        buf = io.StringIO()
        with MethodTimes(GaussianTrainer, names, dev) as mt, \
                contextlib.redirect_stdout(buf):
            code = fn(argv)
        mt.launches = launched(B1, B2)
        return code, buf.getvalue(), mt

    base = ["--config", str(cfg_path), "--device", dev.type]
    code, text, run = entry(main_torch.main, base)
    tr = run.objects[0]
    log = parse_log(text)
    final = [l for l in text.splitlines() if l.startswith("final: psnr=")]
    compacts = [l for l in text.splitlines() if l.startswith("[compact]")]
    n_test = len(tr.dataset.get_test_cameras())
    dense = [it for it, m in log.items() if "n_clone" in m]
    if code != 0 or len(final) != 1 or sorted(log) != list(
            range(4, steps + 1, 4)):
        raise AssertionError(f"main_torch failed: rc {code}\n{text}")
    if (len(tr.train_cameras()), n_test) != (7, 1):
        raise AssertionError("the COLMAP split is not 7 train, 1 test view")
    if not dense or not any(log[it]["n_split"] + log[it]["n_clone"] > 0
                            for it in dense):
        raise AssertionError(f"no densify event split or cloned: {log}")
    # one compaction, after the window, to the size `compact` picks
    alive_at = int(compacts[0].split("(")[1].split()[0]) if compacts else 0
    pool = tr.state.gaussians.capacity
    if len(compacts) != 1 or pool != compact_capacity(alive_at):
        raise AssertionError(f"compaction: {compacts}, pool {pool}")
    # On the CPU (a rehearsal) the wrappers run the plain versions and
    # count nothing.
    per = 1 if dev.type == "cuda" else 0
    if run.launches != (per * (steps + 2 * n_test), per * steps):
        raise AssertionError(f"{steps} steps and 2 validations launched the "
                             f"kernels {run.launches} times")
    # The loss falls over every logged stretch that no densify or opacity
    # reset interrupts.  Across the events at 8 it rises: the reset drops
    # every opacity to 0.01, and 8 steps do not win that back.
    its = sorted(log)
    losses = [log[it]["total_loss"] for it in its]
    psnr_final = float(final[0].split("psnr=")[1].split()[0])
    quiet = [(a, b) for a, b in zip(its, its[1:])
             if not any(density.should_densify(i, cfg) or (
                 0 < cfg.opacity_reset_interval
                 and i % cfg.opacity_reset_interval == 0
                 and i <= cfg.densify_until_iter) for i in range(a, b))]
    if not (np.isfinite(losses).all() and np.isfinite(psnr_final) and quiet
            and all(log[b]["total_loss"] < log[a]["total_loss"]
                    for a, b in quiet)):
        raise AssertionError(f"losses {log}, final {final}")
    n_alive = tr.state.gaussians.num_alive()

    code, text, resume = entry(main_torch.main, base + [
        "--resume", str(steps), "--iterations", "4"])
    r_log = parse_log(text)
    if code != 0 or sorted(r_log) != [steps + 4] or \
            resume.objects[0].iteration != steps + 4 or \
            resume.launches != (per * (4 + n_test), per * 4) or \
            ckpt.latest_checkpoint_iteration(str(out)) != steps + 4:
        raise AssertionError(f"the resumed run failed: {resume.launches}\n"
                             f"{text}")

    code, text, ev = entry(load_script("evaluate_torch").main, [
        "--config", str(cfg_path), "--data", str(scene), "--output",
        str(out), "--checkpoint", str(steps), "--device", dev.type])
    mean = [l for l in text.splitlines() if l.startswith("mean: psnr=")]
    psnr_eval = float(mean[0].split("psnr=")[1].split()[0]) if mean else None
    if code != 0 or psnr_eval is None or abs(psnr_eval - psnr_final) > 0.01:
        raise AssertionError(f"evaluate_torch: {text} against {final}")

    ply = workdir / "model.ply"
    code, text, ex = entry(load_script("export_ply_torch").main, [
        "--config", str(cfg_path), "--output", str(out), "--checkpoint",
        str(steps), "--out", str(ply), "--device", dev.type])
    n_ply = import_gaussians_ply(str(ply)).num_alive()
    if code != 0 or n_ply != n_alive:
        raise AssertionError(f"export_ply_torch wrote {n_ply} Gaussians, "
                             f"not {n_alive}: {text}")
    return {
        "steps": steps, "size": size, "points": n_points,
        "launches": run.launches, "launches_resume": resume.launches,
        "log": {it: {k: log[it][k] for k in ("total_loss", "n_split",
                                             "n_clone", "n_pruned",
                                             "n_alive") if k in log[it]}
                for it in sorted(log)},
        "compaction": compacts[0], "pool": pool, "n_alive": n_alive,
        "psnr": psnr_final, "psnr_eval": psnr_eval, "write_scene_s": write_s,
        "png_paeth_decode_s": paeth_s,
        "setup_s": run.times["setup"][0],
        "step_ms_median": float(np.median(run.times["train_step"])) * 1e3,
        "step_ms_min": min(run.times["train_step"]) * 1e3,
        "step_ms_max": max(run.times["train_step"]) * 1e3,
        "save_s": run.times["save_checkpoint"],
        "load_s": resume.times["load_checkpoint"] + ev.times[
            "load_checkpoint"] + ex.times["load_checkpoint"]}


def render_gate(got: torch.Tensor, want: torch.Tensor, name: str) -> dict:
    """The renderer tolerance of data/synthetic.py (tests/
    test_torch_synthetic.py): NaN at the same values, at most 5 % of the
    others more than 1e-5 apart and at most 1 % more than 1e-3."""
    got, want = got.cpu(), want.cpu()
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        raise AssertionError(f"{name}: NaN at other values")
    d = (got - want).abs()[~nan]
    out = {"max": float(d.max()), "over_1e-5": int((d > 1e-5).sum()),
           "over_1e-3": int((d > 1e-3).sum()), "values": d.numel()}
    if out["over_1e-5"] > 0.05 * d.numel() or \
            out["over_1e-3"] > 0.01 * d.numel():
        raise AssertionError(f"{name}: the card and the CPU disagree {out}")
    return out


def texture_scene_phase(dev, workdir: Path, size: int = VIEW_SIZE,
                        steps: int = 200) -> dict:
    """Phase 14: the texture scene built and trained on the card.
    data/synthetic.py renders a 32^2 view on the card and on the CPU (held
    to the renderer tolerance); make_synthetic_scene_torch.py --texture
    writes 8 train and 1 test views at `size`^2 with spp 2 and
    points3d.ply; export_colmap_scene_torch.py turns them into a COLMAP
    model; main_torch.py trains it for `steps` steps with
    configs/sdf_tex_30k.yaml's rendering and pool, densify every 50 from 50
    to 150 and the pool's compaction when the window closes, SH bands
    unlocked every 50.  Raises on any check that fails."""
    import main_torch
    from mini3dgs_tpu_torch.config import ConfigManager
    from mini3dgs_tpu_torch.data import synthetic
    from mini3dgs_tpu_torch.train.trainer import GaussianTrainer

    R, T = synthetic.camera_pose(0.3, 0.6, 3.6)
    small = render_gate(synthetic.render_view(R, T, 32, 2, True, dev),
                        synthetic.render_view(R, T, 32, 2, True, "cpu"),
                        "texture view 32^2 card vs CPU")
    view_bytes = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        synthetic.render_view(R, T, size, 2, True, dev)
        view_bytes = torch.cuda.max_memory_allocated(dev) - base

    scene, colmap_dir = workdir / "scene", workdir / "colmap"
    gen = load_script("make_synthetic_scene_torch")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        gen.main(["--texture", "--out", str(scene), "--n-train", "8",
                  "--n-test", "1", "--size", str(size), "--spp", "2",
                  "--device", dev.type])
        gen_s = time.perf_counter() - t0
        gen.main(["--texture", "--points-only", "--out", str(scene)])
        t0 = time.perf_counter()
        load_script("export_colmap_scene_torch").main(
            ["--src", str(scene), "--out", str(colmap_dir)])
        export_s = time.perf_counter() - t0
    text = buf.getvalue()
    view_s = [float(l.rsplit("(", 1)[1].split()[0])
              for l in text.splitlines() if l.startswith("  t")]
    if len(view_s) != 9 or "pose round-trip OK" not in text or \
            len(list((colmap_dir / "images").iterdir())) != 9:
        raise AssertionError(f"the texture scene was not written:\n{text}")

    cfg = ConfigManager.load_from_yaml(str(REPO / "configs" /
                                           "sdf_tex_30k.yaml"))
    cfg = dataclasses.replace(
        cfg, data_path=str(colmap_dir), output_path=str(workdir / "out"),
        iterations=steps, log_interval=25, eval_interval=steps,
        save_interval=steps, densify_from_iter=50, densify_interval=50,
        densify_until_iter=150, sh_increase_interval=50, device=dev.type)
    cfg_path = workdir / "config.yaml"
    ConfigManager.save_to_yaml(cfg, str(cfg_path))
    zero_launches(B1, B2)
    buf = io.StringIO()
    with MethodTimes(GaussianTrainer, ["setup", "train_step"], dev) as mt, \
            contextlib.redirect_stdout(buf):
        code = main_torch.main(["--config", str(cfg_path)])
    launches = launched(B1, B2)
    text = buf.getvalue()
    tr = mt.objects[0]
    log = parse_log(text)
    final = [l for l in text.splitlines() if l.startswith("final: psnr=")]
    compacts = [l for l in text.splitlines() if l.startswith("[compact]")]
    n_test = len(tr.dataset.get_test_cameras())
    its = sorted(log)
    losses = [log[it]["total_loss"] for it in its]
    events = {it: {k: int(log[it][k]) for k in ("n_clone", "n_split",
                                                  "n_pruned", "n_alive")}
              for it in its if "n_clone" in log[it]}
    created = sum(e["n_clone"] + e["n_split"] for e in events.values())
    if code != 0 or len(final) != 1 or its != list(range(25, steps + 1, 25)):
        raise AssertionError(f"main_torch failed: rc {code}\n{text}")
    if (len(tr.train_cameras()), n_test) != (7, 2):
        raise AssertionError("the COLMAP split is not 7 train, 2 test views")
    per = 1 if dev.type == "cuda" else 0  # a CPU rehearsal counts nothing
    if launches != (per * (steps + 2 * n_test), per * steps):
        raise AssertionError(f"{steps} steps and 2 validations of {n_test} "
                             f"views launched the kernels {launches} times")
    if sorted(events) != [50, 100, 150] or created <= 0 or \
            len(compacts) != 1:
        raise AssertionError(f"densify events {events}, {compacts}")
    psnr_final = float(final[0].split("psnr=")[1].split()[0])
    if not (np.isfinite(losses).all() and np.isfinite(psnr_final)
            and losses[-1] < losses[0]):
        raise AssertionError(f"losses {losses}, final {final}")
    return {"card_vs_cpu_32": small, "view_peak_bytes": view_bytes,
            "generate_s": gen_s, "view_s": view_s, "export_s": export_s,
            "setup_s": mt.times["setup"][0],
            "step_ms_median": float(np.median(mt.times["train_step"])) * 1e3,
            "launches": launches, "n_test": n_test, "losses": dict(
                zip(its, losses)), "events": events, "created": created,
            "compaction": compacts[0],
            "n_alive": tr.state.gaussians.num_alive(), "psnr": psnr_final}


def parity_phase(dev, size: int = 256, iters: int = 300) -> dict:
    """Phase 15: scripts/train_path_parity_torch.py at `size`^2 and `iters`
    iterations on the card: the `tiles` route (B1 / B2) within 0.5 dB of
    the JAX record docs/artifacts/train_path_parity_jax_256.json (the
    golden route of scripts/train_path_parity.py at this setting), and the
    `golden` route within 0.5 dB of `tiles`.  The setting starts at its
    optimum, so both runs are noise-driven walks: at 64^2 and 300
    iterations the final PSNR of the tiles route differed by 5.1 dB
    between two runs of the same code on the card (the gathers' backward
    adds with float atomics), at 256^2 by 0.12 dB; hence 256^2 here.
    Raises if a gate fails."""
    mod = load_script("train_path_parity_torch")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = mod.main(["--size", str(size), "--iters", str(iters),
                         "--device", dev.type, "--against",
                         str(REPO / "docs" / "artifacts" /
                             f"train_path_parity_jax_{size}.json")])
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    tiles, golden = res["routes"]["tiles"], res["routes"]["golden"]
    if code != 0 or not res["pass"] or set(res["gates_db"]) != {
            "tiles_vs_jax", "tiles_vs_golden"}:
        raise AssertionError(f"train-path parity failed: {res}")
    per = 1 if dev.type == "cuda" else 0  # a CPU rehearsal counts nothing
    if (tiles["launches_fwd"], tiles["launches_bwd"]) != (
            per * (iters + 1), per * iters) \
            or (golden["launches_fwd"], golden["launches_bwd"]) != (0, 0):
        raise AssertionError(f"parity routes launched {res['routes']}")
    return res


MESH_TILE_SIZE = 16   # 800 / 16 = 50 tile rows: 2 bands of 25
BAND_ROWS = 5         # phase 17: B2 held to float64 on 5 tile rows
PRECISION_SLACK = 1.1


def mesh_step_phase(dev, g, cams, settings, extent: float) -> dict:
    """Phase 16 (a) and (b): one gauss-sharded step against one replicated
    step from the same state (the flagship set `g`, two single-device steps
    into training) over a (2, 2) mesh of 4 ranks on the card, with the two
    distinct cameras `cams`, at the tolerances of the JAX package's own
    test (tests/test_sharding.py): loss rtol 1e-5, xyz atol 2e-5, opacity
    atol 3e-3, xyz_gradient_accum atol 1e-6 / rtol 1e-4 on the slots whose
    visibility under their owner's camera is camera 0's (the gauss-sharded
    step counts each rank's rows under its own data camera, the replicated
    one under camera 0); then `verify_shard_grad_parity` for both layouts.
    Raises on any check that fails."""
    from mini3dgs_tpu_torch.config import TrainingConfig
    from mini3dgs_tpu_torch.parallel import sharded
    from mini3dgs_tpu_torch.parallel.mesh import make_mesh
    from mini3dgs_tpu_torch.train import trainer

    mesh = make_mesh(2, 2, [dev] if dev.type == "cpu" else None)
    config = trainer.scale_position_lr(TrainingConfig(
        image_height=VIEW_SIZE, image_width=VIEW_SIZE,
        background_color=[1.0, 1.0, 1.0], tile_size=MESH_TILE_SIZE,
        color_mode="sh", sh_degree=3, capacity=g.capacity, mesh_data=2,
        mesh_tile=2), extent)
    state = trainer.create_train_state(g, config)
    for cam in cams:
        state, _ = trainer.train_step(state, cam, config, settings)
    torch.cuda.synchronize()
    step_ms = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        step_ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    rep, m_rep = timed("replicated", lambda: sharded.make_sharded_train_step(
        config, settings, mesh)(state, cams))
    split = sharded.shard_train_state(state, mesh)
    gs, m_gs = timed("gauss_sharded",
                     lambda: sharded.make_gauss_sharded_train_step(
                         config, settings, mesh)(split, cams))
    got = sharded.gather_train_state(gs, mesh)
    a, b = got.gaussians, rep.gaussians
    vis = [project_with(state.gaussians, c, settings).visible
           for c in cams]
    owner = torch.zeros(g.capacity, dtype=torch.long, device=dev)
    Cs = g.capacity // 4
    for r in range(4):
        blk = sharded.gauss_block(mesh, r)
        owner[blk * Cs:(blk + 1) * Cs] = r // mesh.tile
    vis_own = torch.where(owner == 0, vis[0], vis[1])
    same = vis_own == vis[0]
    loss_rel = abs(float(m_gs["total_loss"]) / float(m_rep["total_loss"]) - 1)
    dev_xyz = float((a.xyz - b.xyz).abs().max())
    dev_op = float((a.opacity - b.opacity).abs().max())
    acc_a, acc_b = a.xyz_gradient_accum[same], b.xyz_gradient_accum[same]
    acc_ok = bool(((acc_a - acc_b).abs() <= 1e-6 + 1e-4 * acc_b.abs()).all())
    dev_acc = float((acc_a - acc_b).abs().max())
    denom_ok = torch.equal(a.denom - state.gaussians.denom, vis_own.float()) \
        and torch.equal(b.denom - state.gaussians.denom, vis[0].float())
    shards_ok = all(s.gaussians.capacity == Cs for s in gs.shards)
    print(f"[16a gauss-sharded vs replicated step] (2, 2) mesh, 4 ranks on "
          f"the card, {VIEW_SIZE}^2 tile {MESH_TILE_SIZE}, SH 3, "
          f"{g.num_alive()} Gaussians (pool {g.capacity}, {Cs} a rank), two "
          f"cameras: loss rel {loss_rel:.2e}, xyz {dev_xyz:.2e}, opacity "
          f"{dev_op:.2e}, xyz_gradient_accum {dev_acc:.2e} on "
          f"{int(same.sum())} slots of equal visibility "
          f"({int((~same).sum())} counted under the other camera), "
          f"denom by each rule {'exact' if denom_ok else 'WRONG'}; step ms "
          f"replicated {step_ms['replicated']:.1f} gauss-sharded "
          f"{step_ms['gauss_sharded']:.1f}", flush=True)
    if not (loss_rel < 1e-5 and dev_xyz < 2e-5 and dev_op < 3e-3 and acc_ok
            and denom_ok and shards_ok and int((~same).sum()) > 0):
        raise AssertionError("the gauss-sharded step disagrees with the "
                             "replicated step")
    worst = {layout: sharded.verify_shard_grad_parity(
        config, mesh, gauss_sharded=layout == "gauss_sharded")
        for layout in ("replicated", "gauss_sharded")}
    print(f"[16b verify_shard_grad_parity] (2, 2) mesh on the card, worst "
          f"normalised deviation {json.dumps(worst)} (tol 0.05)", flush=True)
    return {"loss_rel": loss_rel, "xyz": dev_xyz, "opacity": dev_op,
            "accum": dev_acc, "step_ms": step_ms, "verify": worst}


def project_with(g, cam, settings):
    from mini3dgs_tpu_torch.ops.projection import project_gaussians
    return project_gaussians(g, cam, color_mode=settings.color_mode,
                             sh_degree=settings.sh_degree)


def mesh_entry_phase(dev, g, n_points: int, size: int, workdir: Path,
                     ring: bool, overrides: dict | None = None,
                     gate_kernels: bool = True) -> dict:
    """Phase 16 (c), and with `ring` (d): `main_torch.main` trains a COLMAP
    scene of `g` (written as phase 13 writes it) with
    configs/sdf_tex_30k.yaml's rendering and pool at tile 16 over a mesh
    with `shard_gauss_state`: (2, 2) for 16 steps, or with
    `ring_exchange` (1, 2) for 8 steps; densify, opacity reset and the
    compaction at 8, prunes at 6 (and 12), SH unlocked every 4.  Phase 18
    (c) sets the ring's route keys in `overrides` (and the replicated state
    with `shard_gauss_state: False`).  Gates: the launches of each kernel
    build; a densify event and one compaction to a multiple of the ranks;
    the loss falls over each stretch no event interrupts; the mesh
    `validate` image equals the single-device render of the gathered state
    (the forward gate); with `gate_kernels` the kernels of the run's route
    hold against their plain versions on its tile-16 launches of the
    trained state (`mesh_kernel_gates`); the checkpoint the run wrote loads
    bit for bit and (for a split state) splits again shard for shard; and
    (without `ring`) `--resume` runs on.  Returns the first step's loss
    among the rest.  Raises on any check that fails."""
    import main_torch
    from mini3dgs_tpu_torch.config import ConfigManager
    from mini3dgs_tpu_torch.core.gaussians import compact_capacity
    from mini3dgs_tpu_torch.ops import raster_cuda as rc
    from mini3dgs_tpu_torch.ops.renderer import RenderSettings, render
    from mini3dgs_tpu_torch.parallel import sharded
    from mini3dgs_tpu_torch.train import checkpoint as ckpt
    from mini3dgs_tpu_torch.train import density
    from mini3dgs_tpu_torch.train.trainer import GaussianTrainer

    cfg = ConfigManager.load_from_yaml(str(REPO / "configs" /
                                           "sdf_tex_30k.yaml"))
    settings = RenderSettings(image_height=size, image_width=size,
                              bg_color=tuple(cfg.background_color),
                              tile_size=cfg.tile_size, color_mode="sh",
                              sh_degree=cfg.sh_degree)
    scene, out = workdir / "scene", workdir / "out"
    if not scene.exists():
        write_colmap_scene(scene, g, n_points, settings, 8, size)
    steps = 8 if ring else 16
    n_data, n_tile = (1, 2) if ring else (2, 2)
    cfg = dataclasses.replace(
        cfg, data_path=str(scene), output_path=str(out), image_height=size,
        image_width=size, tile_size=MESH_TILE_SIZE, iterations=steps,
        log_interval=4, eval_interval=steps, save_interval=8,
        densify_from_iter=8, densify_interval=4, densify_until_iter=8,
        prune_interval=6, opacity_reset_interval=8, sh_increase_interval=4,
        mesh_data=n_data, mesh_tile=n_tile, shard_gauss_state=True,
        ring_exchange=ring, device=dev.type)
    cfg = dataclasses.replace(cfg, **(overrides or {}))
    split = cfg.shard_gauss_state
    if out.exists():
        shutil.rmtree(out)
    cfg_path = workdir / "mesh_config.yaml"
    ConfigManager.save_to_yaml(cfg, str(cfg_path))
    if ConfigManager.load_from_yaml(str(cfg_path)) != cfg:
        raise AssertionError("the written config does not read back")

    def entry(argv):
        zero_launches(B1, B2, B3, B4)
        buf = io.StringIO()
        names = ["setup", "train_step"]
        with MethodTimes(GaussianTrainer, names, dev) as mt, \
                contextlib.redirect_stdout(buf):
            code = main_torch.main(argv)
        mt.launches = launched(B1, B2, B3, B4)
        return code, buf.getvalue(), mt

    base = ["--config", str(cfg_path)]
    code, text, run = entry(base)
    tr = run.objects[0]
    log = parse_log(text)
    final = [l for l in text.splitlines() if l.startswith("final: psnr=")]
    compacts = [l for l in text.splitlines() if l.startswith("[compact]")]
    if code != 0 or len(final) != 1 or sorted(log) != list(
            range(4, steps + 1, 4)):
        raise AssertionError(f"main_torch over a mesh failed: rc {code}\n"
                             f"{text}")
    n_dev = n_data * n_tile
    if split != isinstance(tr.state, sharded.GaussShardedState) or (
            split and len(tr.state.shards) != n_dev):
        raise AssertionError("the trainer's state is not laid out as "
                             f"shard_gauss_state={split} asks")
    if not any(log[it].get("n_split", 0) + log[it].get("n_clone", 0) > 0
               for it in log):
        raise AssertionError(f"no densify event split or cloned: {log}")
    alive_at = int(compacts[0].split("(")[1].split()[0]) if compacts else 0
    pool = tr.gathered_state().gaussians.capacity
    want_pool = -(-compact_capacity(alive_at) // n_dev) * n_dev
    if len(compacts) != 1 or pool != want_pool or pool % n_dev:
        raise AssertionError(f"compaction: {compacts}, pool {pool}")
    n_test = len(tr.dataset.get_test_cameras())
    # The setup's self-check: one render and one step of the tiny case, each
    # band of each camera one launch of the builds without t0.
    verify = 1 + n_dev
    per_view = n_tile * n_tile if ring else n_tile
    per_step = n_data * n_tile * (n_tile if ring else 1)
    evals = per_view * 2 * n_test
    want = (verify, verify, steps * per_step + evals, steps * per_step) \
        if ring else (verify + steps * per_step + evals,
                      verify + steps * per_step, 0, 0)
    if dev.type != "cuda":
        want = (0, 0, 0, 0)    # a CPU rehearsal counts nothing
    if run.launches != want:
        raise AssertionError(f"launches {run.launches}, expected {want}")
    its = sorted(log)
    quiet = [(a, b) for a, b in zip(its, its[1:])
             if not any(density.should_densify(i, cfg) or (
                 0 < cfg.opacity_reset_interval
                 and i % cfg.opacity_reset_interval == 0
                 and i <= cfg.densify_until_iter) for i in range(a, b))]
    losses = [log[it]["total_loss"] for it in its]
    if not (np.isfinite(losses).all() and quiet and all(
            log[b]["total_loss"] < log[a]["total_loss"] for a, b in quiet)):
        raise AssertionError(f"losses {log}")
    cam = tr.dataset.get_test_cameras()[0]
    with torch.no_grad():
        img_mesh = tr._mesh_render_fn(tr.settings)(cam)["image"]
        img_one = render(tr.gathered_state().gaussians, cam,
                         tr.settings)["image"]
    val_err = gate(img_mesh, img_one, "mesh validate image")
    kernels = mesh_kernel_gates(rc, tr, cam, size, ring) if gate_kernels \
        else None
    # The checkpoint of the last step: the gathered state bit for bit, and
    # split again shard for shard.
    whole = tr.gathered_state()
    loaded, _ = ckpt.load_checkpoint(str(out), steps, dev)
    resplit = sharded.shard_train_state(loaded, tr.mesh) if split else None
    same = loaded.step == whole.step and all(
        torch.equal(getattr(loaded.gaussians, k), getattr(whole.gaussians, k))
        for k in ("xyz", "features_dc", "features_rest", "scaling",
                  "rotation", "opacity", "alive", "xyz_gradient_accum",
                  "denom", "max_radii2D")) and all(
        torch.equal(loaded.opt_state.mu[k], whole.opt_state.mu[k])
        and torch.equal(loaded.opt_state.nu[k], whole.opt_state.nu[k])
        for k in whole.opt_state.mu) and all(
        torch.equal(x.gaussians.xyz, y.gaussians.xyz)
        and torch.equal(x.opt_state.nu["xyz"], y.opt_state.nu["xyz"])
        for x, y in (zip(resplit.shards, tr.state.shards) if split else ()))
    if not same:
        raise AssertionError("the checkpoint does not load bit for bit")
    res = {"mesh": [n_data, n_tile], "ring": ring, "steps": steps,
           "first_loss": float(run.first["train_step"]["total_loss"]),
           "overrides": overrides or {},
           "launches": run.launches, "compaction": compacts[0], "pool": pool,
           "n_alive": tr.gathered_state().gaussians.num_alive(),
           "log": {it: {k: log[it][k] for k in (
               "total_loss", "n_split", "n_clone", "n_pruned", "n_alive",
               "render_instances") if k in log[it]} for it in its},
           "psnr": float(final[0].split("psnr=")[1].split()[0]),
           "validate_err": val_err, "kernels": kernels,
           "setup_s": run.times["setup"][0],
           "step_ms_median": float(np.median(run.times["train_step"])) * 1e3,
           "step_ms_min": min(run.times["train_step"]) * 1e3,
           "step_ms_max": max(run.times["train_step"]) * 1e3}
    if not ring:
        code, text, resume = entry(base + ["--resume", str(steps),
                                           "--iterations", "4"])
        want_r = (verify + 4 * per_step + per_view * n_test,
                  verify + 4 * per_step, 0, 0) if dev.type == "cuda" \
            else (0, 0, 0, 0)
        if code != 0 or sorted(parse_log(text)) != [steps + 4] or \
                resume.objects[0].iteration != steps + 4 or \
                resume.launches != want_r:
            raise AssertionError(f"the resumed run failed: {resume.launches}"
                                 f"\n{text}")
        res["launches_resume"] = resume.launches
    return res


def traced(step, n: int) -> dict:
    """Device busy ms and kernel launches a call of `step` (n calls under
    `torch.profiler`), with the `3dgs:*` ranges' device ms, launches and
    host ms under the profiler (scripts/profile_step_torch.py's
    `analyse_sharded`; the backward's range holds its host time only)."""
    from torch.profiler import ProfilerActivity, profile
    prof_mod = load_script("profile_step_torch")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    t = prof_mod.analyse_sharded(prof.events(), n)
    traced.seconds += time.perf_counter() - t0
    return {"device_busy_ms": t["device_busy_ms_per_step"],
            "kernel_launches": t["kernel_launches_per_step"],
            "ms_under_profiler": wall,
            "stages": {k: {m: round(v[m], 4) for m in (
                "device_ms", "launches", "host_ms_profiled") if m in v}
                for k, v in t["stages"].items()}}


traced.seconds = 0.0   # spent in traced() calls, trace reading included


def ring_routes_phase(rc, dev, state, config, settings, cam) -> dict:
    """Phase 18 (a) and (b) on the trained ring state `state` (phase 11's
    pool of RING_CAPACITY over RING_RANKS ranks on the card, 800^2, tile
    32), with `cam` and its target.

    (a) Ring v1, v2 (`ring_reshard`, replicated state) and v3 (`ring_local`,
    the state split over a (1, 5) mesh): the three renders of the same
    projected sets bitwise equal; one train step of each from the state
    (v2 / v3 against v1: loss rtol 1e-5, xyz atol 2e-5), each with the
    counts set to 0 just before it and read just after; B3 / B4 against
    their plain versions on v3's 25 launches (`gate_ring_step`); per route
    the host ms of 5 steps, the peak device memory of one step and, under
    `torch.profiler`, device busy ms and launches a step with the ring's
    stages.
    (b) The band route's sharded candidate sort: for every band, exactly
    the single-device binning restricted to the band; B1 / B2 against their
    plain versions on the heaviest band's sharded stream (`gate_acc`,
    `gate_rows`); one band-route step with the counts set to 0 (one B1 and
    one B2 a band), and the binning alone both
    ways (the sharded sort, and every rank binning and packing the whole
    image, the route's reference), and the band-route step both ways: the
    same loss, host ms in turns, device busy ms and launches.  Raises on
    any check that fails."""
    from mini3dgs_tpu_torch.ops import binning as B
    from mini3dgs_tpu_torch.parallel import ring, sharded
    from mini3dgs_tpu_torch.parallel.mesh import make_mesh

    n, ts, size = RING_RANKS, 32, VIEW_SIZE
    mesh = make_mesh(1, n, devices=[dev])
    devices = mesh.tile_devices(0)
    band_h, tiles_x = size // n, size // ts
    ntb = band_h // ts * tiles_x
    C = state.gaussians.capacity
    Cs = C // n

    def counts():
        return launched(B1, B2, B3, B4)

    def zero_counts():
        zero_launches(B1, B2, B3, B4)

    # ---- (a) the renders: the same projected sets through each route ----
    with torch.no_grad():
        projs = sharded._project([state.gaussians] * n, [cam] * n, settings,
                                 devices)
        own = [B.slice_rows(p, slice(i * Cs, (i + 1) * Cs))
               for i, p in enumerate(projs)]
        bands = {route: ring.ring_rasterize_bands(
            ps, band_h, size, settings.bg_color, devices, tile_size=ts, **kw)
            for route, ps, kw in (("v1", projs, {}),
                                  ("v2", projs, {"reshard": True}),
                                  ("v3", own, {"gid_sharded": True}))}
    for route in ("v2", "v3"):
        for b in range(n):
            for k in ("image", "alpha", "depth", "seg_live"):
                a, w = bands[route][b][k], bands["v1"][b][k]
                if not (torch.equal(a, w) if torch.is_tensor(a) else a == w):
                    raise AssertionError(f"ring {route} band {b}: {k} is not "
                                         "v1's")

    # ---- (a) one step of each route, then its times and memory ----------
    r_set = settings.replace(ring=True)
    routes = {
        "v1": (sharded.make_sharded_train_step(config, r_set, mesh), state),
        "v2": (sharded.make_sharded_train_step(
            config, r_set.replace(ring_reshard=True), mesh), state),
        "v3": (sharded.make_gauss_sharded_train_step(
            config, r_set.replace(ring_local=True), mesh),
            sharded.shard_train_state(state, mesh))}
    # a CPU rehearsal launches nothing
    on_card = dev.type == "cuda"
    per_step = (0, 0, n * n, n * n) if on_card else (0, 0, 0, 0)
    res = {"routes": {}}
    for route, (step, st0) in routes.items():
        torch.cuda.synchronize()
        zero_counts()
        new, m = step(st0, [cam])
        torch.cuda.synchronize()
        launches = counts()
        if launches != per_step or m["reshard_drops"] != 0:
            raise AssertionError(f"ring {route}: launches {launches} "
                                 f"(expected {per_step}), reshard drops "
                                 f"{m['reshard_drops']}")
        if route == "v3":
            new = sharded.gather_train_state(new, mesh)
        res["routes"][route] = {"launches": launches, "step_ms": [],
                                "loss": float(m["total_loss"]),
                                "xyz": new.gaussians.xyz}
    # Host times in turns (v1 v2 v3 v3 v2 v1 ...), each route training on
    # from its own state.
    states = {route: st0 for route, (_, st0) in routes.items()}
    for rep in range(6):
        for route in (list(routes) if rep % 2 == 0 else list(routes)[::-1]):
            t0 = time.perf_counter()
            states[route], _ = routes[route][0](states[route], [cam])
            torch.cuda.synchronize()
            res["routes"][route]["step_ms"].append(
                (time.perf_counter() - t0) * 1e3)
    for route, (step, st0) in routes.items():
        row = res["routes"][route]
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        step(st0, [cam])
        torch.cuda.synchronize()
        row.update(step_ms_median=float(np.median(row["step_ms"])),
                   peak_bytes=torch.cuda.max_memory_allocated(dev),
                   peak_bytes_above_start=(
                       torch.cuda.max_memory_allocated(dev) - base),
                   **traced(lambda: step(st0, [cam]), 1))
    v1 = res["routes"]["v1"]
    for route in ("v2", "v3"):
        row = res["routes"][route]
        row["loss_rel"] = abs(row["loss"] / v1["loss"] - 1.0)
        row["xyz_max"] = float((row["xyz"] - v1["xyz"]).abs().max())
        if row["loss_rel"] > 1e-5 or row["xyz_max"] > 2e-5:
            raise AssertionError(f"ring {route}'s step against v1's: loss "
                                 f"rel {row['loss_rel']:.3e}, xyz "
                                 f"{row['xyz_max']:.3e}")
    for row in res["routes"].values():
        del row["xyz"]

    # ---- (a) B3 / B4 on v3's 25 launches --------------------------------
    segs, t_in, acc_seg, g_in, _ = ring_step_launches(
        rc, project_with(state.gaussians, cam, settings), cam.image, n, ts,
        size, gid_sharded=True)
    res["fwd_t0_err"], res["bwd_t0_err"] = gate_ring_step(
        rc, segs, t_in, acc_seg, g_in, tiles_x, ts, ntb, tag="v3 ")
    res["v3_instances"] = sum(seg[0].shape[1] for seg in segs.values())

    # ---- (b) the sharded candidate sort ---------------------------------
    with torch.no_grad():
        bins = sharded.bin_gaussians_sharded(projs, band_h, size, ts,
                                             devices)
        single = B.bin_gaussians(projs[0], size, size, ts)
    for i, b in enumerate(bins):
        tiles = slice(i * ntb, (i + 1) * ntb)
        lo = int(single.tile_start[tiles][0])
        want = (single.s_rank[lo:lo + b.n_live],
                single.tile_start[tiles] - lo, single.tile_count[tiles])
        if not (b.n_live == int(single.tile_count[tiles].sum()) and all(
                torch.equal(x, y) for x, y in zip(
                    (b.s_rank, b.tile_start, b.tile_count), want))):
            raise AssertionError(f"sharded sort: band {i} is not the "
                                 "single-device binning's")
    if sum(b.n_live for b in bins) != single.n_live:
        raise AssertionError("sharded sort: the bands do not add up")
    heavy = max(range(n), key=lambda i: bins[i].n_live)
    b = bins[heavy]
    with torch.no_grad():
        stream = B.pack_instances(rc.instance_attrs(projs[heavy]), b)
    fargs = (stream, b.tile_start, b.tile_count, tiles_x, ts)
    kw = dict(tile0=heavy * ntb)
    name = f"sharded band{heavy}"
    acc = rc.raster_fwd(*fargs, **kw)
    res["fwd_err"] = gate_acc(acc, rc.raster_fwd_plain(*fargs, **kw), name)
    bargs = (*fargs, acc, seeded_gout(acc, 1818))
    res["bwd_err"] = gate_rows(rc.raster_bwd(*bargs, **kw),
                               rc.raster_bwd_plain(*bargs, **kw), name)
    res["sort"] = {"band_n_live": [b.n_live for b in bins],
                   "whole_n_live": single.n_live, "heaviest_band": heavy,
                   "ms": (cuda_ms(lambda: rc.raster_fwd(
                       *fargs, **kw, ranges_checked=True)),
                       cuda_ms(lambda: rc.raster_bwd(
                           *bargs, **kw, ranges_checked=True)))}
    sorted_step = sharded.make_sharded_train_step(config, settings, mesh)

    def whole_image_step(st, cams):
        # the band route's reference: no binning handed to
        # `rasterize_tiles`, so every rank bins and packs the whole image
        with mock.patch.object(sharded, "bin_gaussians_sharded",
                               lambda ps, *a: [None] * len(ps)):
            return sorted_step(st, cams)

    band_steps = {"sharded_sort": sorted_step, "whole_image": whole_image_step}
    losses = {}
    for key, band_step in band_steps.items():
        band_step(state, [cam])      # warm-up
        torch.cuda.synchronize()
        zero_counts()
        _, m = band_step(state, [cam])
        torch.cuda.synchronize()
        losses[key] = float(m["total_loss"])
        res["sort"][f"launches_{key}"] = counts()
        if counts() != ((n, n, 0, 0) if on_card else (0,) * 4):
            raise AssertionError(f"the band-route step ({key}) launched "
                                 f"{counts()}")
        # the fullest rank's stream: its band's, or the whole image's
        fullest = {"sharded_sort": max(b.n_live for b in bins),
                   "whole_image": single.n_live}[key]
        if int(m["render_instances"]) != fullest:
            raise AssertionError(f"the band-route step ({key}) streamed "
                                 f"{m['render_instances']} instances on its "
                                 f"fullest rank, not {fullest}")
    res["sort"]["launches"] = res["sort"]["launches_sharded_sort"]
    res["sort"]["loss_rel"] = abs(losses["whole_image"]
                                  / losses["sharded_sort"] - 1.0)
    if res["sort"]["loss_rel"] > 1e-6:
        raise AssertionError(f"the band-route step's loss through the "
                             f"sharded sort: {losses}")
    # Host ms in turns (sorted, whole, whole, sorted, ...), then device
    # busy ms and launches under the profiler.
    host = {key: [] for key in band_steps}
    for rep in range(6):
        for key in (list(band_steps) if rep % 2 == 0
                    else list(band_steps)[::-1]):
            t0 = time.perf_counter()
            band_steps[key](state, [cam])
            torch.cuda.synchronize()
            host[key].append((time.perf_counter() - t0) * 1e3)
    for key, band_step in band_steps.items():
        res["sort"][f"step_{key}"] = {
            "step_ms": host[key],
            "step_ms_median": float(np.median(host[key])),
            **traced(lambda: band_step(state, [cam]), 1)}

    def whole_image_binning():
        for p in projs:
            bw = B.bin_gaussians(p, size, size, ts)
            B.pack_instances(rc.instance_attrs(p), bw)

    def sharded_binning():
        for p, bs in zip(projs, sharded.bin_gaussians_sharded(
                projs, band_h, size, ts, devices)):
            B.pack_instances(rc.instance_attrs(p), bs)

    with torch.no_grad():
        for key, fn in (("binning_sharded", sharded_binning),
                        ("binning_whole_image", whole_image_binning)):
            fn()
            res["sort"][key] = traced(fn, 1)
    return res


DIST_STEPS = 5        # phase 19: timed steps a program, after the first
DIST_TIMEOUT = 300    # phase 19: seconds a child may take


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def nccl_exchange_check() -> dict:
    """Phase 19's NCCL path: a one-process NCCL group on cuda:0 and one
    exchange of the port (`mesh._exchange`: the header lengths, the
    headers, the payload, each an `all_to_all_single` on buffers on the
    card) of a message to itself; the group is taken down after."""
    import torch.distributed as dist
    from mini3dgs_tpu_torch.parallel import distributed as D
    from mini3dgs_tpu_torch.parallel import mesh as M
    D.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                             backend="nccl", timeout=60)
    try:
        x = torch.randn(1000, 3, device="cuda")
        k = torch.arange(17, dtype=torch.int32, device="cuda")
        spec, leaves = [], []
        M._encode((x, 5, [k]), spec, leaves)
        got, _ = M._exchange([(0, 0, 0, spec, leaves)])
        back = got[0][4]
        ok = (dist.get_backend() == "nccl" and len(back) == 2
              and all(t.is_cuda for t in back) and torch.equal(back[0], x)
              and torch.equal(back[1], k))
    finally:
        dist.destroy_process_group()
    if not ok:
        raise AssertionError("19: the NCCL exchange did not return its "
                             "message")
    return {"backend": "nccl", "bytes": x.numel() * 4 + k.numel() * 4}


def run_children(dev, setup_file: Path, out: Path, n: int, *extra) -> tuple:
    """`n` children of scripts/distributed_step_torch.py in one gloo group
    on `dev` (the CUDA tensors staged through the host), on the setup in
    `setup_file`, each with DIST_STEPS timed steps a program and the
    inputs of its heaviest backward launches recorded, and `extra` flags.
    Raises unless every child exits 0 within DIST_TIMEOUT.  Returns
    (reports, results, records) by process; records on the card only."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "scripts" / "distributed_step_torch.py"),
         "--device", dev.type, "--setup", str(setup_file), "--out", str(out),
         "--steps", str(DIST_STEPS), "--record",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
         "--process-id", str(k), "--backend", "gloo", "--timeout", "120",
         *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(REPO)) for k in range(n)]
    texts = []
    try:
        for proc in procs:
            texts.append(proc.communicate(timeout=DIST_TIMEOUT)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, text in zip(procs, texts):
        if proc.returncode != 0:
            raise AssertionError(f"19: a child of {n} exited with "
                                 f"{proc.returncode}:\n{text[-6000:]}")
    reports = {}
    for text in texts:
        r = json.loads(text.strip().splitlines()[-1])
        reports[r["process"]] = r
    results = {k: torch.load(out / f"result.p{k}.pt", weights_only=True)
               for k in range(n)}
    records = {k: torch.load(out / f"kernels.p{k}.pt", weights_only=True,
                             map_location=dev)
               for k in range(n) if dev.type == "cuda"}
    return reports, results, records


def program_rows(dev, reports, results, single, programs) -> dict:
    """Each program of `programs` in the children against this process's
    `single` step on the same inputs: every child that holds a rank bitwise
    child 0, loss rel <= 1e-6, xyz max abs <= 1e-6 for the replicated and
    gauss-sharded steps; those children launched the program's builds (B1 /
    B2, or B3 / B4 on the ring).  Raises on a program that fails."""
    a, rows = results[0], {}
    for key in programs:
        held = [k for k in results if reports[k].get(key) is not None]
        same = all(results[k]["losses"][key] == a["losses"][key]
                   and torch.equal(results[k][key + "_xyz"], a[key + "_xyz"])
                   for k in held)
        loss_rel = abs(a["losses"][key] / single[key]["loss"] - 1.0)
        xyz = float((a[key + "_xyz"].to(dev) - single[key]["xyz"])
                    .abs().max())
        rep = lambda field: [reports[k][key].get(field) for k in held]
        rows[key] = {
            "loss": a["losses"][key], "loss_rel": loss_rel, "xyz_max": xyz,
            "processes_bitwise": same, "processes": held,
            "launches": rep("launches"), "step_ms_median": rep(
                "step_ms_median"),
            "exchange_ms_median": rep("exchange_ms_median"),
            "single_step_ms_median": single[key].get("step_ms_median"),
            "bytes_a_step": rep("bytes"), "calls_a_step": rep("calls")}
        ok = same and loss_rel <= 1e-6 and (
            xyz <= 1e-6 if key in ("p1", "p2", "p7") else np.isfinite(xyz))
        t0_build = key in ("p3_ring", "p4")
        for n in rows[key]["launches"]:
            used = n[2:] if t0_build else n[:2]
            ok &= dev.type == "cpu" or min(used) > 0
        if not ok:
            raise AssertionError(f"19 {key}: {rows[key]}")
    return rows


def render_rows(results, single, keys) -> dict:
    """Program 5: every child's renders bitwise this process's render over
    the same mesh; raises otherwise.  Returns the renders' shapes."""
    out = {}
    for key in keys:
        for layout, want in single[key].items():
            got = [res[key][layout] for res in results.values()]
            if not (bool(torch.isfinite(want).all()) and all(
                    torch.equal(x, want) for x in got)):
                raise AssertionError(f"19 {key} {layout}: the children's "
                                     "render is not the one-process render")
            out[f"{key} {layout}"] = list(want.shape)
    return out


def child_kernel_gates(rc, records, kernels: dict, tag: str,
                       need_t0: bool) -> None:
    """Each child's recorded heaviest backward launch without t0 (B1 on its
    inputs, B2 on its cotangent) and with t0 (B3 / B4), held against the
    plain versions; the worst errors go into `kernels`.  Raises when a
    child recorded no launch without t0, or none with t0 where `need_t0`
    (its programs ran the ring)."""
    for k, rec in records.items():
        if "bwd" not in rec or (need_t0 and "bwd_t0" not in rec):
            raise AssertionError(f"19: child {k} recorded {sorted(rec)}")
        r = rec["bwd"]
        fargs = (r["stream"], r["tile_start"], r["tile_count"], r["tiles_x"],
                 r["tile_size"])
        kw = dict(tile0=r["tile0"])
        name = f"19 {tag}child{k} band tile0={r['tile0']}"
        kernels["fwd_err"] = max(kernels["fwd_err"], gate_acc(
            rc.raster_fwd(*fargs, **kw), rc.raster_fwd_plain(*fargs, **kw),
            name))
        bargs = (*fargs, r["acc"], r["gout"])
        kernels["bwd_err"] = max(kernels["bwd_err"], gate_rows(
            rc.raster_bwd(*bargs, **kw), rc.raster_bwd_plain(*bargs, **kw),
            name))
        if "bwd_t0" in rec:
            r = rec["bwd_t0"]
            band = 1 if r["tile0"] else 0
            seg = (r["stream"], r["tile_start"], r["tile_count"])
            acc = rc.raster_fwd(*seg, r["tiles_x"], r["tile_size"],
                                t0=r["t0"], tile0=r["tile0"])
            e3, e4 = gate_ring_step(
                rc, {(band, 0): seg}, {(band, 0): r["t0"]}, {(band, 0): acc},
                {(band, 0): r["gout"]}, r["tiles_x"], r["tile_size"],
                max(r["tile0"], 1), tag=f"19 {tag}child{k} ")
            kernels["fwd_t0_err"] = max(kernels["fwd_t0_err"], e3)
            kernels["bwd_t0_err"] = max(kernels["bwd_t0_err"], e4)
        kernels["instances"][f"{tag}{k}"] = {
            key: int(v["stream"].shape[1]) for key, v in rec.items()}


def distributed_phase(rc, dev, g, cams, settings, extent: float,
                      size: int = VIEW_SIZE) -> dict:
    """Phase 19: the mesh over several OS processes on the one card, through
    gloo (the CUDA tensors staged through the host), on the state of `g` two
    single-device steps into training, tile 16.

    Two children (`run_children`, 2 ranks each): (a) the replicated step
    over (2, 2), data = the processes, tile = 2 ranks each on the card,
    with the two cameras `cams`; (b) that state split over (2, 2), saved
    and restored bitwise (the child raises otherwise), then one
    gauss-sharded step; (c) the band route, ring v1 and ring v3 over
    (1, 2), one rank a process, so every ring hop crosses the processes,
    on `cams[0]`; the renderers (`make_sharded_render`,
    `make_gauss_sharded_render`) over (2, 2) and over (1, 2) on the band
    route and through ring v1.  Four children of one rank each over
    (2, 2), whose rows and columns each cross two of them through a group
    of their own: (a), (b), both renderers, `verify_shard_grad_parity` in
    both layouts, and a (1, 2) step that leaves two of them without a rank
    (they get None).  Gates: every child exits 0 within DIST_TIMEOUT and
    agrees bit for bit with the others; against this process's
    single-process programs on the same inputs, loss rel <= 1e-6 for every
    step and xyz max abs <= 1e-6 for (a) and (b), renders bitwise, the
    gradient check's deviation within 1e-6 of this process's; ring v3 has
    no reshard drops; each child launched B1 / B2 in (a), (b) and the band
    route, B3 / B4 in the ring steps.  (d) Each child's heaviest backward
    launch without t0 (B1 on its inputs, B2 on its cotangent) and with t0
    (B3 / B4) held against the plain versions (`gate_acc`, `gate_rows`,
    `gate_ring_step`).  (e) Host ms a step (median of DIST_STEPS after the
    first) of each child's programs beside this process's, the host ms of
    it in torch.distributed, and the bytes each step puts through it.
    Then the NCCL path (`nccl_exchange_check`).  Raises on any check that
    fails."""
    from mini3dgs_tpu_torch.config import TrainingConfig
    from mini3dgs_tpu_torch.parallel.mesh import make_mesh
    from mini3dgs_tpu_torch.train import trainer

    ds = load_script("distributed_step_torch")
    t_phase = time.perf_counter()
    config = trainer.scale_position_lr(TrainingConfig(
        image_height=size, image_width=size,
        background_color=[1.0, 1.0, 1.0], tile_size=MESH_TILE_SIZE,
        color_mode="sh", sh_degree=3, capacity=g.capacity), extent)
    state = trainer.create_train_state(g, config)
    for cam in cams:
        state, _ = trainer.train_step(state, cam, config, settings)
    setup = {"mesh": {"config": config, "settings": settings,
                      "state": state, "cameras": list(cams)},
             "ring": {"config": config, "settings": settings,
                      "state": state, "cameras": [cams[0]]}}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        ds.write_setup(work / "setup.pt", setup)
        two = run_children(dev, work / "setup.pt", work / "two", 2,
                           "--ranks", "2", "--ring-ranks", "1")
        t_two = time.perf_counter() - t_phase
        four = run_children(dev, work / "setup.pt", work / "four", 4,
                            "--ranks", "1", "--mesh", "2", "2", "--no-ring",
                            "--partial", "1", "2")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    t_children = time.perf_counter() - t_phase

    m22, m12 = make_mesh(2, 2, [dev]), make_mesh(1, 2, [dev])
    single = {"p1": ds.replicated_step(setup["mesh"], m22, DIST_STEPS),
              "p2": ds.gauss_sharded_step(setup["mesh"], m22, DIST_STEPS),
              "p3_band": ds.replicated_step(setup["ring"], m12, DIST_STEPS),
              "p3_ring": ds.replicated_step(setup["ring"], m12, DIST_STEPS,
                                            ring=True),
              "p4": ds.gauss_sharded_step(setup["ring"], m12, DIST_STEPS,
                                          ring_local=True),
              "p5_mesh": ds.renders(setup["mesh"], m22),
              "p5_ring_mesh_band": ds.renders(setup["ring"], m12),
              "p5_ring_mesh_ring": ds.renders(setup["ring"], m12, ring=True),
              "p6": ds.grad_parity(setup["mesh"], m22),
              "p7": ds.replicated_step(setup["mesh"], m12)}
    rows = program_rows(dev, two[0], two[1], single,
                        ("p1", "p2", "p3_band", "p3_ring", "p4"))
    rows4 = program_rows(dev, four[0], four[1], single, ("p1", "p2", "p7"))
    renders = {
        "two": render_rows(two[1], single, ("p5_mesh", "p5_ring_mesh_band",
                                            "p5_ring_mesh_ring")),
        "four": render_rows(four[1], single, ("p5_mesh",))}
    parity = {k: r["p6"] for k, r in four[0].items()}
    if not (all(abs(v - single["p6"][layout]) <= 1e-6
                for p in list(parity.values())
                + [r["p6"] for r in two[0].values()]
                for layout, v in p.items())
            and [four[0][k]["p7_ranks"] for k in range(4)]
            == [[0], [1], [], []]
            and four[0][2]["p7"] is None and four[0][3]["p7"] is None):
        raise AssertionError(f"19: grad check {parity} against "
                             f"{single['p6']}, or the rankless processes: "
                             f"{four[0]}")
    reports = {**two[0], **{f"four{k}": r for k, r in four[0].items()}}
    if not all(r["p2_checkpoint_bitwise"]
               and r["collectives"]["forward_bitwise"]
               for r in reports.values()) \
            or not all(r["p4"]["reshard_drops"] == 0 for r in two[0].values()):
        raise AssertionError(f"19: {reports}")

    kernels = {"fwd_err": 0.0, "bwd_err": 0.0, "fwd_t0_err": 0.0,
               "bwd_t0_err": 0.0, "instances": {}}
    child_kernel_gates(rc, two[2], kernels, "", need_t0=True)
    child_kernel_gates(rc, four[2], kernels, "four ", need_t0=False)
    nccl = nccl_exchange_check() if dev.type == "cuda" else None
    return {"programs": rows, "programs_four": rows4, "renders": renders,
            "grad_parity": {"single": single["p6"], "four": parity},
            "kernels": kernels, "nccl": nccl,
            "collectives": {k: r["collectives"] for k, r in reports.items()},
            "child_seconds": [r["seconds"] for r in reports.values()],
            "two_s": t_two, "children_s": t_children,
            "seconds": time.perf_counter() - t_phase}


def graft_entry_phase(rc, dev) -> dict:
    """Phase 20: graft_entry_torch.py on the card.  `entry()` renders the
    flagship scene at 256x256 through B1 (one launch, a finite image);
    `dryrun_multichip(8)` takes its six steps on eight ranks of the card
    (its own checks between the losses hold) and each loss lies within
    1e-5 (relative, the bound of tests/test_torch_graft_entry.py) of the
    JAX dryrun's loss on the same scene,
    docs/artifacts/dryrun_multichip_jax.json.  Each of those is the loss
    before its step's update on the same state, so the record checks the
    forward loss of every route, not the updates.  Raises on any check
    that fails."""
    import graft_entry_torch as ge

    t0 = time.perf_counter()
    before = launched(B1)[0]
    fn, args = ge.entry()
    image = fn(*args)
    torch.cuda.synchronize()
    entry = {"shape": list(image.shape), "mean": float(image.mean()),
             "launches": launched(B1)[0] - before,
             "seconds": time.perf_counter() - t0}
    if entry["shape"] != [3, 256, 256] or not bool(
            torch.isfinite(image).all()) or entry["launches"] != 1:
        raise AssertionError(f"20: entry() {entry}")
    t1 = time.perf_counter()
    before = launched(B1, B2, B3, B4)
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        losses = ge.dryrun_multichip(8)
    record = json.loads((REPO / "docs" / "artifacts" /
                         "dryrun_multichip_jax.json").read_text())
    rel = {k: abs(v / record["losses"][k] - 1.0) for k, v in losses.items()}
    dryrun = {"losses": losses, "rel_to_jax": rel,
              "printed": printed.getvalue().strip(),
              "launches": [a - b for a, b in zip(
                  launched(B1, B2, B3, B4),
                  before)],
              "seconds": time.perf_counter() - t1}
    if list(losses) != list(record["losses"]) or not all(
            r <= 1e-5 for r in rel.values()) \
            or min(dryrun["launches"]) == 0:
        raise AssertionError(f"20: dryrun_multichip(8) {dryrun}")
    return {"entry": entry, "dryrun": dryrun}


@contextlib.contextmanager
def recording_launches(rc, keep: list):
    """Append to `keep` (name, arguments, output) of every launch of
    `raster_fwd` and `raster_bwd` without t0 while the block runs.  The
    wrappers stand in for the module's functions."""
    origs = {name: getattr(rc, name) for name in ("raster_fwd", "raster_bwd")}
    wrappers = {}
    for name, orig in origs.items():
        def wrapped(*a, _orig=orig, _name=name,
                    _params=list(inspect.signature(orig).parameters), **k):
            out = _orig(*a, **k)
            call = {n: v.detach() if torch.is_tensor(v) else v
                    for n, v in dict(zip(_params, a), **k).items()}
            if call.get("t0") is None:
                keep.append((_name, call, out.detach()))
            return out

        setattr(rc, name, wrapped)
    try:
        yield
    finally:
        for name, orig in origs.items():
            setattr(rc, name, orig)


def bench_phase(rc, dev, trained_yaml: Path) -> dict:
    """Phase 21: bench_torch.py, the twin of bench.py, on the card.  For the
    headline scene and its anisotropic variant (800^2, 100,000 Gaussians in
    2^17 slots, tile 32, SH 0, black, L1 against zeros), the chain's first
    step, its one B1 and one B2 launch recorded and held against the plain
    versions on the same inputs (`gate_acc`, `gate_rows`).  Then
    `bench_torch.main` with `--trained-config trained_yaml` (phase 14's
    checkpoint): its JSON line, every key finite, one B1 and one B2 launch
    a chain step (and one B1 for the trained line's probe render).  Raises
    on any check that fails."""
    import bench_torch as bt

    res = {"first_step": {}, "fwd_err": 0.0, "bwd_err": 0.0}
    for name, aniso in (("headline", False), ("aniso", True)):
        chain = bt.build(aniso=aniso, device=dev)
        keep = []
        with recording_launches(rc, keep):
            chain(0.5, 1)
        if [k for k, _, _ in keep] != ["raster_fwd", "raster_bwd"]:
            raise AssertionError(f"21 {name}: one chain step launched "
                                 f"{[k for k, _, _ in keep]}")
        (_, f, acc), (_, b, d) = keep
        fargs = (f["stream"], f["tile_start"], f["tile_count"], f["tiles_x"],
                 f["tile_size"])
        fwd_err = gate_acc(acc, rc.raster_fwd_plain(*fargs), f"21 {name} B1")
        bargs = (b["stream"], b["tile_start"], b["tile_count"], b["tiles_x"],
                 b["tile_size"], b["acc"].contiguous(),
                 b["gout"].contiguous())
        bwd_err = gate_rows(d, rc.raster_bwd_plain(*bargs), f"21 {name} B2")
        res["first_step"][name] = {"instances": int(f["stream"].shape[1]),
                                   "fwd_err": fwd_err, "bwd_err": bwd_err}
        res["fwd_err"] = max(res["fwd_err"], fwd_err)
        res["bwd_err"] = max(res["bwd_err"], bwd_err)

    out, err = io.StringIO(), io.StringIO()
    env = {k: v for k, v in os.environ.items() if k not in (
        "BENCH_FULL_GOLDEN", "BENCH_SKIP_TRAINED")}
    zero_launches(B1, B2)
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, env, clear=True), \
            contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = bt.main(["--trained-config", str(trained_yaml)])
    res["main_seconds"] = time.perf_counter() - t0
    res["launches"] = launched(B1, B2)
    res["stderr"] = err.getvalue().strip()
    lines = out.getvalue().strip().splitlines()
    if code != 0 or len(lines) != 1:
        raise AssertionError(f"21: bench_torch.main rc {code}: "
                             f"{out.getvalue()}\n{res['stderr']}")
    line = res["line"] = json.loads(lines[0])
    # time_step: one run of each length, then `reps` pairs; the headline's
    # two profiled steps
    steps = 4 * (2 + 12) + 2 + 3 * (2 + 10) + 4 * (2 + 10)
    if res["launches"] != (steps + 1, steps):
        raise AssertionError(f"21: {steps} chain steps and one probe render "
                             f"launched the kernels {res['launches']} times")
    numbers = ("value", "vs_baseline", "spread", "mgaussians_per_s",
               "device_busy_ms", "device_launches", "host_launch_us",
               "aniso_rotated_mpix_s", "trained_mpix_s", "power_limit_w")
    if line["metric"] != bt.METRIC or line["reps"] != 3 \
            or line["device"] != torch.cuda.get_device_name(dev) \
            or line["checkpoint_iteration"] != 200 \
            or line["trained_n_dropped"] != 0 \
            or not all(np.isfinite(line[k]) and line[k] >= 0
                       for k in numbers) \
            or min(line[k] for k in numbers if k != "spread") <= 0:
        raise AssertionError(f"21: the bench line is off: {line}")
    return res


def heavy_band(tile_count: torch.Tensor, tiles_x: int) -> tuple:
    """(first tile row, rows) of the BAND_ROWS tile rows around the
    heaviest tile of a tile-major image: phase 17's band."""
    rows = tile_count.shape[0] // tiles_x
    n_rows = min(BAND_ROWS, rows)
    heavy_row = int(torch.argmax(tile_count)) // tiles_x
    return min(max(heavy_row - n_rows // 2, 0), rows - n_rows), n_rows


def entry_scripts_phase(dev, workdir: Path, n_points: int = 1_000_000,
                        capacity: int = 2 ** 20) -> dict:
    """Phase 17: scripts/train_1m_torch.py on an 8-view 800^2 Blender scene
    made here (make_synthetic_scene_torch.py, spp 1), 1M seed points in a
    2^20 pool, 40 + 20 iterations: the loss is finite and falls, and on
    the trained state's stream of training view 0 B1 holds against its
    plain version (the gate of phase 3) and B2, on the BAND_ROWS tile rows
    around the heaviest tile, lies within ROWS_REL_L2 of the float64 plain
    version or no farther from it than the float32 plain version does
    (within PRECISION_SLACK);
    then scripts/train_probe_torch.py at 256^2 for 300 steps: the PSNR
    rises.  Raises on any check that fails."""
    from mini3dgs_tpu_torch.ops import raster_cuda as rc
    from mini3dgs_tpu_torch.train.trainer import GaussianTrainer

    scene = workdir / "sdf_scene"
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        code = load_script("make_synthetic_scene_torch").main([
            "--out", str(scene), "--n-train", "8", "--n-test", "1", "--size",
            str(VIEW_SIZE), "--spp", "1", "--device", dev.type])
    gen_s = time.perf_counter() - t0
    if code != 0:
        raise AssertionError("the Blender scene was not written")

    def run_script(name, argv):
        zero_launches(B1, B2)
        buf = io.StringIO()
        with MethodTimes(GaussianTrainer, ["setup"], dev) as mt, \
                contextlib.redirect_stdout(buf):
            code = load_script(name).main(argv)
        lines = buf.getvalue().strip().splitlines()
        if code != 0:
            raise AssertionError(f"{name} failed:\n{buf.getvalue()}")
        return (json.loads(lines[-1]), mt.objects[0],
                launched(B1, B2), lines)

    one, tr, launches_1m, lines = run_script("train_1m_torch", [
        "--scene", str(scene), "--iters", "40", "--steady", "20",
        "--log-interval", "1",
        "--n-points", str(n_points), "--capacity", str(capacity),
        "--device", dev.type])
    losses = one["losses"]
    per = 1 if dev.type == "cuda" else 0  # a CPU rehearsal counts nothing
    # Every step is logged, each under a camera drawn at random: the mean
    # of the last ten against the mean of the first ten.
    if one["iterations"] != 60 or launches_1m != (per * 61, per * 60) or \
            one["n_alive"] != n_points or not (
            np.isfinite(losses).all()
            and np.mean(losses[-10:]) < np.mean(losses[:10])):
        raise AssertionError(f"train_1m_torch: {launches_1m} {one}")
    cam = tr.train_cameras()[0]
    proj = project_with(tr.state.gaussians, cam, tr.settings)
    b, stream = rc.tile_stream(proj, VIEW_SIZE, VIEW_SIZE, 32)
    tiles_x = -(-VIEW_SIZE // 32)
    fargs = (stream, b.tile_start, b.tile_count, tiles_x, 32)
    acc_k = rc.raster_fwd(*fargs)
    bargs = (*fargs, acc_k, seeded_gout(acc_k, 1717))
    ms = (cuda_ms(lambda: rc.raster_fwd(*fargs, ranges_checked=True)),
          cuda_ms(lambda: rc.raster_bwd(*bargs, ranges_checked=True)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd_err = gate_acc(acc_k, rc.raster_fwd_plain(*fargs), "1M train view")
    # B2 on the BAND_ROWS tile rows around the heaviest tile (the tile
    # ranges the kernels take), held to the float64 plain version: each of
    # its ten rows within gate_rows' ROWS_REL_L2 of it (rel-L2), or, where
    # float32 cannot reach that, within PRECISION_SLACK of the float32
    # plain version's own distance from it.  On lists of tens of thousands
    # of instances both float32 computations lie farther from float64 than
    # the gate of phase 3 allows (scripts/raster_precision_torch.py); on
    # rows well inside it the two distances are two float32 roundings of
    # like size, and their ratio is noise.
    row0, n_rows = heavy_band(b.tile_count, tiles_x)
    lo, hi = row0 * tiles_x, (row0 + n_rows) * tiles_x
    band = dict(tile0=lo)
    bf = (stream, b.tile_start[lo:hi], b.tile_count[lo:hi], tiles_x, 32)
    acc_b = rc.raster_fwd(*bf, **band)
    g_b = seeded_gout(acc_b, 1717)
    d_k = rc.raster_bwd(*bf, acc_b, g_b, **band)
    d_32 = rc.raster_bwd_plain(*bf, acc_b, g_b, **band)
    acc64 = rc.raster_fwd_plain(stream.double(), *bf[1:], **band)
    d_64 = rc.raster_bwd_plain(stream.double(), *bf[1:], acc64,
                               g_b.double(), **band)
    rel = lambda a: ((a.double() - d_64).norm(dim=1)
                     / d_64.norm(dim=1).clamp(min=1e-30))
    rel_k, rel_32 = rel(d_k), rel(d_32)
    ratio = rel_k / rel_32.clamp(min=1e-30)
    print(f"    1M band of {n_rows} tile rows from row {row0}: B2 rel-L2 "
          f"from float64 by row {' '.join(f'{x:.2e}' for x in rel_k)}; the "
          f"float32 plain version's {' '.join(f'{x:.2e}' for x in rel_32)}; "
          f"the kernel's over the plain version's by row "
          f"{' '.join(f'{x:.3f}' for x in ratio)}")
    bound = torch.clamp(PRECISION_SLACK * rel_32 + 1e-6, min=ROWS_REL_L2)
    if not bool(torch.isfinite(d_k).all()) or bool((rel_k > bound).any()):
        raise AssertionError("1M band: the backward kernel lies farther from "
                             "float64 than gate_rows' bound and than its "
                             "float32 plain version does")
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    heavy = int(b.tile_count.max())
    mean = float(b.tile_count.float().mean())
    print(f"[17a train_1m_torch.py] Blender scene of 8 + 1 views at "
          f"{VIEW_SIZE}^2 spp 1 made in {gen_s:.2f} s; 1M seed points, pool "
          f"2^20, tile 32, SH 0, {one['iterations']} iterations: launches "
          f"fwd/bwd {launches_1m}, first step {one['first_step_s']:.2f} s, "
          f"window {one['window_ms_per_it']:.1f} ms/it, steady "
          f"{one['steady_ms_per_it']:.1f} ms/it, peak "
          f"{one['peak_gib'] or 0:.2f} GiB of {one['card_gib'] or 0:.1f}, "
          f"n_alive "
          f"{one['n_alive']}, n_live {one['n_live']}, mean loss of the "
          f"first / last 10 steps {np.mean(losses[:10]):.5f} / "
          f"{np.mean(losses[-10:]):.5f}, PSNR {one['psnr']:.2f}\n"
          f"  train view 0: n_live {b.n_live}, heaviest tile {heavy} "
          f"instances against a mean of {mean:.1f} ({heavy / mean:.1f}x); "
          f"raster_fwd {ms[0]:.3f} ms, raster_bwd {ms[1]:.3f} ms; B1 gated "
          f"on the whole stream, B2 against float64 on {BAND_ROWS} tile "
          f"rows; the plain versions {plain_s:.1f} s", flush=True)

    probe, _, launches_probe, _ = run_script("train_probe_torch", [
        "--device", dev.type, "--steps", "300", "--size", "256"])
    psnrs = [e["psnr"] for e in probe["log"]]
    if launches_probe != (per * (300 + len(psnrs) + 1), per * 300) \
            or len(psnrs) != 3 \
            or not psnrs[-1] > psnrs[0]:
        raise AssertionError(f"train_probe_torch: {launches_probe} {probe}")
    print(f"[17b train_probe_torch.py] 256^2, 300 steps: PSNR "
          f"{' -> '.join(f'{p:.2f}' for p in psnrs)} dB, "
          f"{probe['steps_per_s']:.1f} steps/s, alive {probe['alive']} "
          f"(pool {probe['capacity']}), launches fwd/bwd {launches_probe}",
          flush=True)
    return {"one": one, "launches_1m": launches_1m, "n_live_view0": b.n_live,
            "heaviest_over_mean": heavy / mean, "fwd_err": fwd_err,
            "rel_k": rel_k.tolist(), "rel_32": rel_32.tolist(),
            "ratio": ratio.tolist(),
            "kernel_ms": ms, "plain_s": plain_s,
            "generate_s": gen_s, "probe": probe,
            "launches_probe": launches_probe}


def main() -> int:
    # ---- 1. device ----------------------------------------------------
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA device")
    sys.path.insert(0, str(REPO))
    from mini3dgs_tpu_torch import convert
    from mini3dgs_tpu_torch.config import TrainingConfig
    from mini3dgs_tpu_torch.core.gaussians import scene_extent_of
    from mini3dgs_tpu_torch.core.loss import gaussian_loss
    from mini3dgs_tpu_torch.ops import cuda_library as cl
    from mini3dgs_tpu_torch.ops import projection as pj
    from mini3dgs_tpu_torch.ops import raster_cuda as rc
    from mini3dgs_tpu_torch.ops import raster_ref
    from mini3dgs_tpu_torch.ops.binning import bin_gaussians
    from mini3dgs_tpu_torch.ops.projection import project_gaussians
    from mini3dgs_tpu_torch.ops.renderer import RenderSettings, render
    from mini3dgs_tpu_torch.parallel.mesh import make_mesh
    from mini3dgs_tpu_torch.parallel.sharded import (make_sharded_render,
                                                     make_sharded_train_step)
    from mini3dgs_tpu_torch.train import trainer
    from mini3dgs_tpu_torch.train.optimizer import group_lrs, schedule_factor
    from mini3dgs_tpu_torch.utils.gaussian_ply import export_gaussians_ply
    from mini3dgs_tpu_torch.utils.metrics import psnr
    from mini3dgs_tpu_torch.utils.vis import turntable_cameras

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"[1 device] {kind} | nvidia-smi: {smi} | torch {torch.__version__}"
          f" cuda {torch.version.cuda} | nvcc {cl._nvcc()}", flush=True)

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    lib = cl.kernel_library()
    sources = [str(p.relative_to(REPO)) for p in cl.kernel_sources()]
    print(f"[2 build] {lib.path.relative_to(REPO)} from {sources} "
          f"({' '.join(cl.NVCC_FLAGS)}): nvcc {lib.build_seconds:.2f} s, "
          f"load {time.perf_counter() - t0:.2f} s", flush=True)
    for line in lib.build_log.splitlines():
        if "Compiling entry" in line or "registers" in line \
                or "spill" in line:
            print(f"    ptxas: {line.strip()}")
    fwd = lib.lib.raster_fwd_blocks_per_sm
    bwd = lib.lib.raster_bwd_blocks_per_sm
    print("    blocks an SM, without and with t0: raster_fwd tile 16 "
          f"{fwd(16, 0)} {fwd(16, 1)}, tile 32 {fwd(32, 0)} {fwd(32, 1)}; "
          f"raster_bwd tile 16 {bwd(16, 1, 0)} {bwd(16, 1, 1)}, tile 32 at "
          f"one pixel a thread {bwd(32, 1, 0)} {bwd(32, 1, 1)}, at two "
          f"{bwd(32, 2, 0)} {bwd(32, 2, 1)}")

    # ---- 3. forward kernel vs plain on the card -----------------------
    print("[3 forward kernel vs plain]", flush=True)
    launches_before = launched(B1)[0]
    edge = {}
    for ts in rc.KERNEL_TILE_SIZES:
        tiles_x, tiles_y = 800 // ts // 2, 600 // ts // 2
        stream, start, count = edge_stream(ts, tiles_x, tiles_y, ts, dev)
        acc_k = rc.raster_fwd(stream, start, count, tiles_x, ts)
        acc_p = rc.raster_fwd_plain(stream, start, count, tiles_x, ts)
        torch.cuda.synchronize()
        print(f"  edge stream tile {ts}: {tiles_x}x{tiles_y} tiles, "
              f"{stream.shape[1]} instances")
        gate_acc(acc_k, acc_p, f"tile{ts} edge")
        if float(acc_k[6::7, 4].min()) < 0.995:
            raise AssertionError("saturating tiles did not saturate")
        edge[ts] = (stream, start, count, tiles_x, ts, acc_k)
    params, alive, cam = convert.flagship_scene_numpy(8192, 6000, seed=5)
    g_small = convert.gaussians_from_numpy(params, alive, dev)
    Hr, Wr = 250, 333  # a ragged edge at both tile sizes
    cam_r = convert.camera_from_numpy(**cam, width=Wr, height=Hr, device=dev)
    bg = torch.ones(3, device=dev)
    ragged, ragged_binning = {}, {}
    for ts in rc.KERNEL_TILE_SIZES:
        proj = project_gaussians(g_small, cam_r)
        b, stream = rc.tile_stream(proj, Hr, Wr, ts)
        ragged_binning[ts] = (b, stream)
        tiles_x = -(-Wr // ts)
        acc_k = rc.raster_fwd(stream, b.tile_start, b.tile_count, tiles_x, ts)
        acc_p = rc.raster_fwd_plain(stream, b.tile_start, b.tile_count,
                                    tiles_x, ts)
        print(f"  ragged {Wr}x{Hr} tile {ts}: n_live {b.n_live}")
        gate_acc(acc_k, acc_p, f"tile{ts} ragged")
        out_k = rc.rasterize_tiles(proj, Hr, Wr, bg, tile_size=ts)
        out_g = raster_ref.rasterize_image(
            proj.means2d, proj.conic, proj.depth, proj.color, proj.opacity,
            proj.visible, Hr, Wr, bg, radius=proj.radius, tile_size=ts,
            pixel_block=16384)
        gate(out_k["image"], out_g["image"], f"tile{ts} vs golden image")
        gate(out_k["alpha"], out_g["alpha"], f"tile{ts} vs golden alpha")
        ragged[ts] = (stream, b.tile_start, b.tile_count, tiles_x, ts, acc_k)
    fwd_patch_err = max(check_fwd_patch_cases(rc, ts, dev, False, rows)
                        for ts in rc.KERNEL_TILE_SIZES
                        for rows in patch_tile_rows(dev))
    print(f"  launches in phase 3: {launched(B1)[0] - launches_before}")

    # ---- 3b. backward kernel vs plain on the card ---------------------
    print("[3b backward kernel vs plain]", flush=True)
    launches_before = launched(B2)[0]
    for name, cases in (("edge", edge), ("ragged", ragged)):
        for ts, (stream, start, count, tiles_x, _, acc_k) in cases.items():
            args = (stream, start, count, tiles_x, ts, acc_k,
                    seeded_gout(acc_k, 100 + ts))
            d_k = rc.raster_bwd(*args)
            d_again = rc.raster_bwd(*args)
            d_p = rc.raster_bwd_plain(*args)
            torch.cuda.synchronize()
            gate_rows(d_k, d_p, f"tile{ts} {name}")
            if not torch.equal(d_k, d_again):
                raise AssertionError(f"tile{ts} {name}: two launches of the "
                                     "backward kernel differ")
            if name != "edge":
                continue
            # Tiles 6, 13, ... saturate within their first 30 splats: the
            # block leaves its loop, and what lies behind must be exact 0.
            sat = torch.arange(6, start.shape[0], 7, device=dev)
            behind = torch.cat([
                torch.arange(int(start[t]) + 128,
                             int(start[t]) + int(count[t]), device=dev)
                for t in sat.tolist() if int(count[t]) > 128])
            if behind.numel() < 1000:
                raise AssertionError("too few rows behind an early exit")
            if bool((d_k[:, behind] != 0).any()) \
                    or bool((d_p[:, behind] != 0).any()):
                raise AssertionError(f"tile{ts} edge: rows behind an early "
                                     "exit are not exactly 0")
            if not bool((d_k[:, start[sat].long()] != 0).any()):
                raise AssertionError("saturating tiles got no gradient")
            print(f"    tile{ts} edge: {behind.numel()} rows behind an early "
                  "exit exactly 0; two launches bitwise equal")
    patch_err = max(check_patch_cases(rc, ts, dev, False)
                    for ts in rc.KERNEL_TILE_SIZES)
    print(f"  launches in phase 3b: "
          f"{launched(B2)[0] - launches_before}")

    # ---- 3c. render gradients vs the golden's autograd ----------------
    print("[3c render gradients vs golden autograd]", flush=True)
    target_r = torch.rand(3, Hr, Wr, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(3))
    # The flagship scene is isotropic, so its true rotation gradient is 0
    # and its error would be noise over noise: make the splats anisotropic.
    aniso = torch.tensor([0.0, 0.45, -0.5], device=dev)
    g_aniso = g_small.replace(scaling=g_small.scaling + aniso)
    grads = {}
    for raster in ("tiles", "golden"):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in g_aniso.params().items()}
        out = render(g_aniso.with_params(leaves), cam_r, RenderSettings(
            image_height=Hr, image_width=Wr, bg_color=(1.0, 1.0, 1.0),
            tile_size=32, raster=raster))
        loss = (((out["image"] - target_r) ** 2).mean()
                + 0.1 * out["alpha"].mean() + 0.01 * out["depth"].mean())
        names = [k for k in leaves if k != "features_rest"]
        grads[raster] = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names])))
    for k, gt in grads["tiles"].items():
        gg = grads["golden"][k]
        a, b = gt[g_small.alive].double(), gg[g_small.alive].double()
        l2 = float((a - b).norm() / b.norm())
        worst = float((a - b).abs().max() / b.abs().max())
        # the gate of scripts/verify_chip.py: rel-L2 < 3e-3 per group
        ok = bool(torch.isfinite(a).all()) and l2 < 3e-3
        print(f"    grad {k:12s} max={worst:.3e} rel-L2={l2:.3e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"render gradient {k} disagrees with the "
                                 "golden's")

    # ---- 3d. forward kernel with t0 vs plain on the card ---------------
    print("[3d forward kernel with t0 vs plain]", flush=True)
    t0_err, t0_cases = 0.0, {}
    for name, cases in (("edge", edge), ("ragged", ragged)):
        for ts, (stream, start, count, tiles_x, _, acc_b1) in cases.items():
            T, P = start.shape[0], ts * ts
            args = (stream, start, count, tiles_x, ts)
            t0, closed, ones = seeded_t0(T, P, 200 + ts, dev)
            acc_k = rc.raster_fwd(*args, t0=t0)
            acc_p = rc.raster_fwd_plain(*args, t0=t0)
            torch.cuda.synchronize()
            t0_err = max(t0_err, gate_acc(acc_k, acc_p, f"tile{ts} {name} t0",
                                          has_t0=True))
            # A tile that arrives closed adds nothing and hands t0 on.
            if bool((acc_k[closed, :5] != 0).any()) \
                    or not torch.equal(acc_k[closed, 5:6], t0[closed]):
                raise AssertionError(f"tile{ts} {name}: a closed tile moved")
            # t0 == 1 is the single pass: rows 0..4 bitwise, and the
            # transmittance left is 1 - alpha up to the sums' rounding.
            full = rc.raster_fwd(*args, t0=torch.ones_like(t0))
            if not torch.equal(full[:, :5], acc_b1[:, :5]) \
                    or not torch.equal(acc_k[ones, :5], acc_b1[ones, :5]):
                raise AssertionError(f"tile{ts} {name}: t0 == 1 differs from "
                                     "the kernel without t0")
            gate(full[:, 5], 1.0 - acc_b1[:, 4], f"tile{ts} {name} 1-alpha")
            print(f"    tile{ts} {name}: {closed.numel()} closed tiles exactly "
                  f"0, t0 == 1 bitwise equal to raster_fwd on rows 0..4")
            t0_cases[name, ts] = (args, t0, closed, acc_k)
    t0_err = max([t0_err] + [check_fwd_patch_cases(rc, ts, dev, True, rows)
                             for ts in rc.KERNEL_TILE_SIZES
                             for rows in patch_tile_rows(dev)])

    # ---- 3e. the chain: 4 ranges with the transmittance carried --------
    print("[3e chain of 4 ranges vs one pass]", flush=True)
    for ts in rc.KERNEL_TILE_SIZES:
        stream, start, count, tiles_x, _, acc_b1 = edge[ts]
        T = start.shape[0]
        tile = torch.repeat_interleave(torch.arange(T, device=dev),
                                       count.long())
        local = torch.arange(stream.shape[1], device=dev) - start.long()[tile]
        quarter = local * 4 // count.long()[tile]       # by place in the tile
        b_r, stream_r = ragged_binning[ts]
        depth_range = b_r.s_rank * 4 // g_small.capacity  # by depth rank
        for name, (stream, start, count, tiles_x, _, acc_b1), key in (
                ("edge", edge[ts], quarter),
                ("ragged", ragged[ts], depth_range)):
            T, P = start.shape[0], ts * ts
            trans = torch.ones(T, 1, P, device=dev)
            total = torch.zeros(T, 5, P, device=dev)
            sizes = []
            for part in cut_ranges(stream, start, count, key, 4):
                out = rc.raster_fwd(*part, tiles_x, ts, t0=trans)
                total, trans = total + out[:, :5], out[:, 5:6]
                sizes.append(part[0].shape[1])
            chained = torch.cat([total, torch.zeros(T, 3, P, device=dev)], 1)
            print(f"  tile {ts} {name}: ranges of {sizes} instances")
            gate_acc(chained, acc_b1, f"tile{ts} {name} chain")

    # ---- 3f. backward kernel with t0 vs plain on the card --------------
    print("[3f backward kernel with t0 vs plain]", flush=True)
    dt0_err = 0.0
    for (name, ts), (args, t0, closed, acc_k) in t0_cases.items():
        stream, start, count = args[:3]
        gout = seeded_gout(acc_k, 300 + ts, rows=6)
        bargs = (*args, acc_k, gout)
        d_k, dt0_k = rc.raster_bwd(*bargs, t0=t0)
        d_again, dt0_again = rc.raster_bwd(*bargs, t0=t0)
        d_p, dt0_p = rc.raster_bwd_plain(*bargs, t0=t0)
        torch.cuda.synchronize()
        dt0_err = max(dt0_err, gate_rows(d_k, d_p, f"tile{ts} {name} t0"),
                      gate_rows(dt0_k.reshape(1, -1), dt0_p.reshape(1, -1),
                                f"tile{ts} {name} d_t0"))
        if not (torch.equal(d_k, d_again) and torch.equal(dt0_k, dt0_again)):
            raise AssertionError(f"tile{ts} {name}: two launches of the "
                                 "backward kernel with t0 differ")
        # Instances of tiles that arrive closed get exactly 0.
        cols = torch.cat([torch.arange(int(start[t]),
                                       int(start[t]) + int(count[t]),
                                       device=dev) for t in closed.tolist()])
        if cols.numel() < 100 or bool((d_k[:, cols] != 0).any()) \
                or bool((d_p[:, cols] != 0).any()):
            raise AssertionError(f"tile{ts} {name}: instances of closed "
                                 "tiles are not exactly 0")
        msg = f"{cols.numel()} instances of closed tiles exactly 0"
        if name == "edge":
            sat = torch.arange(6, start.shape[0], 7, device=dev)
            behind = torch.cat([
                torch.arange(int(start[t]) + 128,
                             int(start[t]) + int(count[t]), device=dev)
                for t in sat.tolist() if int(count[t]) > 128])
            if behind.numel() < 1000 or bool((d_k[:, behind] != 0).any()) \
                    or bool((d_p[:, behind] != 0).any()):
                raise AssertionError(f"tile{ts} edge t0: rows behind an "
                                     "early exit are not exactly 0")
            msg += f", {behind.numel()} rows behind an early exit exactly 0"
        print(f"    tile{ts} {name}: {msg}; two launches bitwise equal")
    patch_t0_err = max(check_patch_cases(rc, ts, dev, True)
                       for ts in rc.KERNEL_TILE_SIZES)

    # ---- 4. binning on the card == binning on the CPU -----------------
    params, alive, cam = convert.flagship_scene_numpy(CAPACITY, N_GAUSSIANS,
                                                      seed=0)
    rng = np.random.default_rng(1)
    params["features_rest"][:N_GAUSSIANS] = rng.normal(
        0.0, 0.1, (N_GAUSSIANS, 15, 3))
    g = convert.gaussians_from_numpy(params, alive, dev)
    bench_cam = convert.camera_from_numpy(**cam, width=VIEW_SIZE,
                                          height=VIEW_SIZE, device=dev)
    proj = project_gaussians(g, bench_cam, color_mode="sh", sh_degree=3)
    b_gpu = bin_gaussians(proj, VIEW_SIZE, VIEW_SIZE, 32)
    b_cpu = bin_gaussians(type(proj)(*(f.cpu() for f in proj)), VIEW_SIZE,
                          VIEW_SIZE, 32)
    for f in ("tile_start", "tile_count", "s_rank", "order", "counts_gid"):
        if not torch.equal(getattr(b_gpu, f).cpu(), getattr(b_cpu, f)):
            raise AssertionError(f"binning on the card differs: {f}")
    if b_gpu.n_live != b_cpu.n_live:
        raise AssertionError("binning on the card differs: n_live")
    print(f"[4 binning] {VIEW_SIZE}^2 tile 32, {N_GAUSSIANS} Gaussians: "
          f"n_live {b_gpu.n_live}, per-tile lists identical on card and CPU",
          flush=True)

    # ---- 4b. the projection kernel P1 against the plain chain ---------
    # Phase 4's pool (the render slice's rows) from the bench view, through
    # every build of P1 with and without antialias; then the SH-3 build's
    # time against the chain's and against its byte bound at this pool.
    p1_err = 0.0
    with torch.no_grad():
        for mode, deg in (("dc_sigmoid", 0), ("sh", 0), ("sh", 1),
                          ("sh", 2), ("sh", 3)):
            for aa in (False, True):
                kw = dict(color_mode=mode, sh_degree=deg, antialias=aa)
                p1_err = max(p1_err, gate_projection(
                    pj.project_fwd(g, bench_cam, **kw),
                    pj.project_gaussians_plain(g, bench_cam, **kw),
                    g.rotation, f"P1 {mode} {deg} antialias {aa}"))
        kw = dict(color_mode="sh", sh_degree=3)
        p1_ms = cuda_ms(lambda: pj.project_fwd(g, bench_cam, **kw), inner=4)
        p1_plain_ms = cuda_ms(
            lambda: pj.project_gaussians_plain(g, bench_cam, **kw))
    p1_rows = g.capacity
    p1_bound = PROJECT_FWD_BYTES * p1_rows / PEAK_BYTES_PER_S * 1e3
    p1_exact = norm_order_matches(g.rotation)
    print(f"[4b projection kernel P1 vs plain] pool {p1_rows}, "
          f"{VIEW_SIZE}^2, 5 builds x antialias: visible, depth, radius, "
          f"extents {'bitwise' if p1_exact else 'within 1e-6 (norm order)'}"
          f", the rest within {p1_err:.3g} relative; SH 3: kernel "
          f"{p1_ms:.4f} ms, plain {p1_plain_ms:.3f} ms, bound "
          f"{p1_bound:.4f} ms (bytes)", flush=True)
    # P2 on the same pool and view: every build with and without
    # antialias, standard normal cotangents on every row, against the plain
    # VJP; then the SH-3 build's time against the chain's backward alone
    # (its graph built once) and against its byte bound.
    p2_err = 0.0
    cots = seeded_cotangents(g, 3)
    for mode, deg in (("dc_sigmoid", 0), ("sh", 0), ("sh", 1), ("sh", 2),
                      ("sh", 3)):
        for aa in (False, True):
            kw = dict(color_mode=mode, sh_degree=deg, antialias=aa)
            p2_err = max(p2_err, gate_projection_bwd(
                pj.project_bwd(g, bench_cam, cots, **kw), g, bench_cam,
                cots, kw, f"P2 {mode} {deg} antialias {aa}"))
    kw = dict(color_mode="sh", sh_degree=3)
    p2_ms = cuda_ms(lambda: pj.project_bwd(g, bench_cam, cots, **kw),
                    inner=4)
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in g.params().items()}
    chain = pj.project_gaussians_plain(g.with_params(leaves), bench_cam, **kw)
    p2_plain_ms = cuda_ms(lambda: torch.autograd.grad(
        [getattr(chain, f) for f in pj.COTANGENT_FIELDS],
        list(leaves.values()), cots, retain_graph=True))
    del chain, leaves
    p2_bound = PROJECT_BWD_BYTES * p1_rows / PEAK_BYTES_PER_S * 1e3
    print(f"[4b projection kernel P2 vs plain] the same pool and view, 5 "
          f"builds x antialias: every gradient within {p2_err:.3g} of the "
          f"plain VJP by its norm, exactly 0 on the rows the guard drops; "
          f"SH 3: kernel {p2_ms:.4f} ms, the chain's backward "
          f"{p2_plain_ms:.3f} ms, bound {p2_bound:.4f} ms (bytes)",
          flush=True)

    # ---- 5. the render slice: two 800^2 views through render ----------
    settings = RenderSettings(image_height=VIEW_SIZE, image_width=VIEW_SIZE,
                              bg_color=(1.0, 1.0, 1.0), tile_size=32,
                              color_mode="sh", sh_degree=3)
    cams = [bench_cam] + turntable_cameras(3, width=VIEW_SIZE,
                                           image_height=VIEW_SIZE,
                                           device=dev)[1:2]
    with torch.no_grad():
        render(g, cams[0], settings)  # warm-up (allocator, kernel load)
        torch.cuda.synchronize()
        zero_launches(B1, B2, P1, P2)
        outs, render_ms = [], []
        for cam_v in cams:
            t0 = time.perf_counter()
            outs.append(render(g, cam_v, settings))
            torch.cuda.synchronize()
            render_ms.append((time.perf_counter() - t0) * 1e3)
        render_launches = launched(B1)[0]
        p1_render_launches = launched(P1)[0]
        p2_render_launches = launched(P2)[0]
    if render_launches != len(cams) or launched(B2)[0] != 0:
        raise AssertionError(f"render launched the forward kernel "
                             f"{render_launches} times for {len(cams)} views")
    if (p1_render_launches, p2_render_launches) != (len(cams), 0):
        raise AssertionError(f"render launched P1 / P2 {p1_render_launches}"
                             f" / {p2_render_launches} times for "
                             f"{len(cams)} views")
    print(f"[5 render slice] {len(cams)} views {VIEW_SIZE}x{VIEW_SIZE}, "
          f"{N_GAUSSIANS} Gaussians (pool {CAPACITY}), SH 3, tile 32, white "
          f"bg: forward launches {render_launches}, P1 launches "
          f"{p1_render_launches}", flush=True)
    fwd_ms, fwd_plain_ms, fwd_err = [], [], 0.0
    tiles_x = -(-VIEW_SIZE // 32)
    for i, (cam_v, out) in enumerate(zip(cams, outs)):
        img = out["image"]
        finite = torch.isfinite(img).all() & torch.isfinite(out["depth"]).all()
        if img.shape != (3, VIEW_SIZE, VIEW_SIZE) or not bool(finite):
            raise AssertionError(f"view {i}: bad image")
        if not 0.5 < float(out["alpha"].max()) <= 1.0:
            raise AssertionError(f"view {i}: no opaque pixel")
        proj = project_gaussians(g, cam_v, color_mode="sh", sh_degree=3)
        b, stream = rc.tile_stream(proj, VIEW_SIZE, VIEW_SIZE, 32)
        args = (stream, b.tile_start, b.tile_count, tiles_x, 32)
        acc_k, acc_p = rc.raster_fwd(*args), rc.raster_fwd_plain(*args)
        print(f"  view {i}: n_live {b.n_live}, heaviest tile "
              f"{int(b.tile_count.max())} instances against a mean of "
              f"{float(b.tile_count.float().mean()):.1f}")
        fwd_err = max(fwd_err, gate_acc(acc_k, acc_p, f"view{i}"))
        fwd_ms.append(cuda_ms(lambda: rc.raster_fwd(*args,
                                                    ranges_checked=True),
                              inner=4))
        fwd_plain_ms.append(cuda_ms(lambda: rc.raster_fwd_plain(*args)))
        with torch.no_grad():
            plain_img = rc.rasterize_tiles(proj, VIEW_SIZE, VIEW_SIZE,
                                           torch.ones(3, device=dev),
                                           tile_size=32,
                                           fwd=rc.raster_fwd_plain)["image"]
        p = float(psnr(img, plain_img))
        if out["n_live"] != b.n_live or p < 50.0:
            raise AssertionError(f"view {i}: render and plain disagree")
        print(f"  view {i}: n_live {b.n_live}  kernel {fwd_ms[-1]:.3f} ms"
              f"  plain {fwd_plain_ms[-1]:.3f} ms  render {render_ms[i]:.2f} ms"
              f"  PSNR(render, plain) {p:.2f} dB", flush=True)

    # ---- 6. render entry point ---------------------------------------
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        ply = tmp / "flagship.ply"
        export_gaussians_ply(g, str(ply))
        mod = load_script("render_novel_view_torch")
        zero_launches(B1)
        rc_main = mod.main(["--ply", str(ply), "--output", str(tmp / "out"),
                            "--n-frames", "2", "--size", str(VIEW_SIZE),
                            "--sh-degree", "3", "--color-mode", "sh",
                            "--tile-size", "32", "--bg", "1,1,1",
                            "--device", "cuda"])
        if rc_main != 0 or launched(B1)[0] != 2:
            raise AssertionError("entry point did not render 2 frames "
                                 "through the kernel")
        for i in range(2):
            rgba = np.load(tmp / "out" / f"frame_{i:04d}.npy")
            if rgba.shape != (4, VIEW_SIZE, VIEW_SIZE) or \
                    not np.isfinite(rgba).all() or rgba[3].max() <= 0:
                raise AssertionError(f"entry point frame {i} is bad")
        print(f"[6 render entry point] scripts/render_novel_view_torch.py: 2 "
              f"finite {VIEW_SIZE}^2 frames, alpha max "
              f"{float(rgba[3].max()):.3f}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- 7. the train slice at full width -----------------------------
    # The flagship scene (seed 0, zero SH rest) is trained towards a render
    # of the seeded SH-3 set `g` of phase 4 moved to other positions (seed
    # 7), from the bench view.
    t_params, t_alive, _ = convert.flagship_scene_numpy(CAPACITY, N_GAUSSIANS,
                                                        seed=7)
    t_params["features_rest"] = params["features_rest"]
    with torch.no_grad():
        target = render(convert.gaussians_from_numpy(t_params, t_alive, dev),
                        bench_cam, settings)["image"]
    train_cam = bench_cam.replace(image=target)
    s_params, s_alive, _ = convert.flagship_scene_numpy(CAPACITY, N_GAUSSIANS,
                                                        seed=0)
    g0 = convert.gaussians_from_numpy(s_params, s_alive, dev)
    config = TrainingConfig(
        iterations=TRAIN_STEPS, image_height=VIEW_SIZE, image_width=VIEW_SIZE,
        background_color=[1.0, 1.0, 1.0], tile_size=32, color_mode="sh",
        sh_degree=3, capacity=CAPACITY)
    extent = float(scene_extent_of(g0))
    config = trainer.scale_position_lr(config, extent)
    state = trainer.create_train_state(g0, config)
    state, _ = trainer.train_step(state, train_cam, config, settings)  # warm
    state = trainer.create_train_state(g0, config)
    torch.cuda.synchronize()
    zero_launches(B1, B2, P1, P2)
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, train_cam, config,
                                            settings)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["total_loss"]))
    train_launches = launched(B1, B2)
    if train_launches != (TRAIN_STEPS, TRAIN_STEPS):
        raise AssertionError(f"{TRAIN_STEPS} train steps launched the "
                             f"kernels {train_launches} times")
    # A train step records the projection op's graph: one P1 and one P2.
    p1_train_launches = launched(P1)[0]
    p2_train_launches = launched(P2)[0]
    if (p1_train_launches, p2_train_launches) != (TRAIN_STEPS, TRAIN_STEPS):
        raise AssertionError(f"{TRAIN_STEPS} train steps launched P1 / P2 "
                             f"{p1_train_launches} / {p2_train_launches} "
                             "times")
    dead = ~g0.alive
    for k, v in state.gaussians.params().items():
        for what, t in (("parameter", v), ("Adam mu", state.opt_state.mu[k]),
                        ("Adam nu", state.opt_state.nu[k])):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"non-finite {what} {k}")
        if not torch.equal(v[dead], getattr(g0, k)[dead]):
            raise AssertionError(f"dead slots of {k} moved")
        if torch.equal(v, getattr(g0, k)):
            raise AssertionError(f"{k} did not train")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"loss did not fall: {losses}")
    if float(state.gaussians.denom.max()) != TRAIN_STEPS:
        raise AssertionError("the densify statistics were not accumulated")
    print(f"[7 train slice] {TRAIN_STEPS} steps {VIEW_SIZE}x{VIEW_SIZE}, "
          f"{N_GAUSSIANS} Gaussians (pool {CAPACITY}), SH 3, tile 32: "
          f"launches fwd/bwd {train_launches}, P1/P2 {p1_train_launches}/"
          f"{p2_train_launches}, loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}, n_live {metrics['render_instances']}, step ms "
          f"median {np.median(step_ms):.2f} min {min(step_ms):.2f} max "
          f"{max(step_ms):.2f}", flush=True)
    noise = torch.randn(CAPACITY, 3, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    n_before = state.gaussians.num_alive()
    dstate, ds = trainer.densify_step(state, noise, extent, config)
    if ds["n_alive"] != n_before + ds["n_split"] + ds["n_clone"] \
            - ds["n_pruned"] - ds["n_dropped"] or ds["n_alive"] > CAPACITY \
            or ds["n_split"] + ds["n_clone"] == 0 \
            or float(dstate.gaussians.denom.max()) != 0.0:
        raise AssertionError(f"densify_step counts are off: {ds}")
    pstate, n_pruned = trainer.prune_step(state, config)
    if pstate.gaussians.num_alive() != n_before - n_pruned:
        raise AssertionError("prune_step counts are off")
    dstate, _ = trainer.train_step(dstate, train_cam, config, settings)
    if not bool(torch.isfinite(dstate.gaussians.xyz).all()):
        raise AssertionError("a step after densify gave non-finite xyz")
    print(f"  densify_step: {ds}; prune_step: {n_pruned} pruned; one more "
          f"step on the densified state is finite", flush=True)

    # B1 and B2 on the trained state's bench-view stream, with the loss's
    # own cotangent of the accumulators.
    proj = project_gaussians(state.gaussians, bench_cam, color_mode="sh",
                             sh_degree=3)
    b, stream = rc.tile_stream(proj, VIEW_SIZE, VIEW_SIZE, 32)
    fargs = (stream, b.tile_start, b.tile_count, tiles_x, 32)
    acc_leaf = rc.raster_fwd(*fargs).requires_grad_(True)
    image = rc.compose_image(acc_leaf, VIEW_SIZE, VIEW_SIZE, 32,
                             torch.ones(3, device=dev))[0]
    gout, = torch.autograd.grad(gaussian_loss(image, target)[0], acc_leaf)
    if bool((gout[:, 5:] != 0).any()):
        raise AssertionError("the cotangent's pad rows are not zero")
    bargs = (*fargs, acc_leaf.detach(), gout)
    d_k, d_p = rc.raster_bwd(*bargs), rc.raster_bwd_plain(*bargs)
    bwd_err = gate_rows(d_k, d_p, "train view")
    fwd_err = max(fwd_err, gate_acc(acc_leaf.detach(),
                                    rc.raster_fwd_plain(*fargs), "train view"))
    # Without the wrapper's range check, a host wait (as B2 below and the
    # launches of phase 11b); 4 launches a timing.
    t_fwd = cuda_ms(lambda: rc.raster_fwd(*fargs, ranges_checked=True),
                    inner=4)
    t_fwd_plain = cuda_ms(lambda: rc.raster_fwd_plain(*fargs), reps=2)
    # As the step's backward calls it: the forward has held the ranges
    # against the stream, so the launch does not wait for the host.
    t_bwd = cuda_ms(lambda: rc.raster_bwd(*bargs, ranges_checked=True))
    t_bwd_plain = cuda_ms(lambda: rc.raster_bwd_plain(*bargs), reps=2)
    pairs = pair_counts(rc, *fargs)
    n_live, T, P = b.n_live, b.tile_start.shape[0], 32 * 32
    fwd_bound, bwd_bound = raster_bounds(pairs, n_live, T, P, has_t0=False)
    print(f"  train view: n_live {n_live}, heaviest tile "
          f"{int(b.tile_count.max())} instances against a mean of "
          f"{float(b.tile_count.float().mean()):.1f}, n_live x P "
          f"{n_live * P}, pairs "
          f"with the gate open {pairs['open']}, of those w >= 1e-5 "
          f"{pairs['live']}, of those 0 < op*w < 1 {pairs['alpha']}, of "
          f"those w < 1 {pairs['geom']}\n"
          f"  raster_fwd {t_fwd:.3f} ms (plain {t_fwd_plain:.1f}, bound "
          f"{fwd_bound[0]:.4f} by {fwd_bound[1]})\n"
          f"  raster_bwd {t_bwd:.3f} ms (plain {t_bwd_plain:.1f}, bound "
          f"{bwd_bound[0]:.4f} by {bwd_bound[1]})", flush=True)

    # ---- 8. train entry point ----------------------------------------
    mod = load_script("train_torch")
    zero_launches(B1, B2)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_main = mod.main([
            "--iterations", "8", "--size", str(VIEW_SIZE), "--n-gaussians",
            str(N_GAUSSIANS), "--capacity", str(CAPACITY), "--n-cameras", "1",
            "--log-interval", "4", "--densify-from-iter", "8",
            "--densify-interval", "8", "--sh-increase-interval", "2",
            "--device", "cuda"])
    log = [json.loads(x) for x in buf.getvalue().splitlines()]
    final = log[-1]
    if rc_main != 0 or launched(B2)[0] != 8 \
            or "n_clone" not in log[-2] or log[-2]["sh_degree"] != 3 \
            or not final["last_loss"] < final["first_loss"] \
            or not np.isfinite([final["psnr_start"], final["psnr_end"]]).all():
        raise AssertionError(f"the train entry point failed: {final}")
    print(f"[8 train entry point] scripts/train_torch.py: 8 iterations at "
          f"{VIEW_SIZE}^2, SH unlocked to 3, densify {log[-2]['n_split']} split "
          f"{log[-2]['n_clone']} clone, backward launches "
          f"{launched(B2)[0]}: {json.dumps(final)}", flush=True)

    # ---- 9. ring render at full width ---------------------------------
    # Five ranks on the one card: 5 bands of 160 rows, 5 depth-rank ranges
    # of a pool of 131,075 slots holding the same 100,000 Gaussians.
    def zero_counts():
        zero_launches(B1, B2, B3, B4)

    def counts():
        return launched(B1, B2, B3, B4)

    n_rk = RING_RANKS
    r_params, r_alive, _ = convert.flagship_scene_numpy(RING_CAPACITY,
                                                        N_GAUSSIANS, seed=0)
    r_params["features_rest"][:N_GAUSSIANS] = \
        params["features_rest"][:N_GAUSSIANS]
    g_ring = convert.gaussians_from_numpy(r_params, r_alive, dev)
    mesh = make_mesh(data=1, tile=n_rk, devices=[dev])
    ring_settings = settings.replace(ring=True)
    ring_render = make_sharded_render(ring_settings, mesh)
    with torch.no_grad():
        single = render(g_ring, bench_cam, settings)
        ring_render(g_ring, bench_cam)  # warm-up
        torch.cuda.synchronize()
        zero_counts()
        zero_launches(P1)
        ring_ms = []
        t0 = time.perf_counter()
        out = ring_render(g_ring, bench_cam)
        torch.cuda.synchronize()
        ring_ms.append((time.perf_counter() - t0) * 1e3)
        ring_render_launches = counts()
        p1_ring_launches = launched(P1)[0]
        for _ in range(2):
            t0 = time.perf_counter()
            ring_render(g_ring, bench_cam)
            torch.cuda.synchronize()
            ring_ms.append((time.perf_counter() - t0) * 1e3)
    if ring_render_launches != (0, 0, n_rk * n_rk, 0):
        raise AssertionError(f"the ring render launched {ring_render_launches}"
                             f", not {n_rk * n_rk} forward kernels with t0")
    if p1_ring_launches != n_rk:
        raise AssertionError(f"the ring render launched P1 "
                             f"{p1_ring_launches} times, not once a rank")
    # P1 on the slices the ring render projects, one a rank: a block of
    # 26,215 rows, so each block but the first starts off 16 bytes.
    r_block = RING_CAPACITY // n_rk
    misaligned = 0
    kw = dict(color_mode="sh", sh_degree=3)
    with torch.no_grad():
        for r in range(n_rk):
            part = g_ring.slots(r * r_block, (r + 1) * r_block)
            misaligned += part.features_rest.data_ptr() % 16 != 0
            p1_err = max(p1_err, gate_projection(
                pj.project_fwd(part, bench_cam, **kw),
                pj.project_gaussians_plain(part, bench_cam, **kw),
                part.rotation, f"P1 ring block {r}"))
    # P2 on the same blocks, each with its rows' cotangents.
    ring_cots = seeded_cotangents(g_ring, 5)
    for r in range(n_rk):
        rows = slice(r * r_block, (r + 1) * r_block)
        part = g_ring.slots(rows.start, rows.stop)
        part_cots = tuple(t[rows] for t in ring_cots)
        p2_err = max(p2_err, gate_projection_bwd(
            pj.project_bwd(part, bench_cam, part_cots, **kw), part,
            bench_cam, part_cots, kw, f"P2 ring block {r}"))
    if misaligned == 0:
        raise AssertionError("no ring block starts off 16 bytes")
    print(f"[9 ring render] {VIEW_SIZE}^2 tile 32, {N_GAUSSIANS} Gaussians "
          f"(pool {RING_CAPACITY}), SH 3, {n_rk} ranks on {dev}: launches "
          f"(fwd, bwd, fwd t0, bwd t0) {ring_render_launches}, render ms "
          f"{' '.join(f'{t:.2f}' for t in ring_ms)}; P1 launches "
          f"{p1_ring_launches}, on each rank's block ({misaligned} off 16 "
          f"bytes) P1 and P2 as the chain", flush=True)
    raw = lambda o: o["depth"] * (o["alpha"] + 1e-6)
    d_scale = float(raw(single).abs().max())
    ring_render_err = max(
        gate(out["image"], single["image"], "ring vs single image"),
        gate(out["alpha"], single["alpha"], "ring vs single alpha"),
        gate(raw(out) / d_scale, raw(single) / d_scale,
             "ring vs single depth/max"))
    print("  n_live per depth range (rows) and band (columns):")
    for r, row in enumerate(out["seg_live"]):
        print(f"    range {r}: {row}")
    if sum(map(sum, out["seg_live"])) != single["n_live"] \
            or sum(out["n_live"]) != single["n_live"]:
        raise AssertionError("the ring's segments do not add up to the "
                             f"single-device stream of {single['n_live']}")
    print(f"  sum over segments {single['n_live']} == single-device n_live")

    # ---- 10. ring gradients against single-device gradients -----------
    # The anisotropic small scene, 4 bands of 2 tile rows, a ragged right
    # edge; the gradients differ by float32 association at the ranges'
    # borders (measured below; the bound is rel-L2 1e-3 per group).
    Hg, Wg, n_g = 256, 333, 4
    cam_g = convert.camera_from_numpy(**cam, width=Wg, height=Hg, device=dev)
    set_g = RenderSettings(image_height=Hg, image_width=Wg,
                           bg_color=(1.0, 1.0, 1.0), tile_size=32)
    target_g = torch.rand(3, Hg, Wg, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(4))
    ring_g = make_sharded_render(set_g.replace(ring=True),
                                 make_mesh(1, n_g, devices=[dev]))
    grads = {}
    for route, fn in (("ring", ring_g),
                      ("single", lambda gs, c: render(gs, c, set_g))):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in g_aniso.params().items()}
        zero_counts()
        o = fn(g_aniso.with_params(leaves), cam_g)
        loss = (((o["image"] - target_g) ** 2).mean()
                + 0.1 * o["alpha"].mean() + 0.01 * o["depth"].mean())
        names = [k for k in leaves if k != "features_rest"]
        grads[route] = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names])))
        if route == "ring" and counts() != (0, 0, n_g * n_g, n_g * n_g):
            raise AssertionError(f"ring gradients launched {counts()}")
    print(f"[10 ring gradients] {Wg}x{Hg} tile 32, {n_g} ranks, launches "
          f"with t0 {n_g * n_g} forward and {n_g * n_g} backward",
          flush=True)
    ring_grad_err = 0.0
    for k, gr in grads["ring"].items():
        a = gr[g_small.alive].double()
        b = grads["single"][k][g_small.alive].double()
        l2 = float((a - b).norm() / b.norm())
        worst = float((a - b).abs().max() / b.abs().max())
        ok = bool(torch.isfinite(a).all()) and l2 < 1e-3
        ring_grad_err = max(ring_grad_err, l2)
        print(f"    grad {k:12s} max={worst:.3e} rel-L2={l2:.3e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"ring gradient {k} disagrees with the "
                                 "single-device gradient")

    # ---- 11. ring train steps at full width ---------------------------
    r_config = dataclasses.replace(config, capacity=RING_CAPACITY,
                                   iterations=RING_STEPS, mesh_tile=n_rk,
                                   ring_exchange=True)
    s_params, s_alive, _ = convert.flagship_scene_numpy(RING_CAPACITY,
                                                        N_GAUSSIANS, seed=0)
    g0_ring = convert.gaussians_from_numpy(s_params, s_alive, dev)
    ring_step = make_sharded_train_step(r_config, ring_settings, mesh)
    r_state0 = trainer.create_train_state(g0_ring, r_config)
    ring_step(r_state0, [train_cam])  # warm-up
    one_state, one_m = trainer.train_step(r_state0, train_cam, r_config,
                                          settings)
    torch.cuda.synchronize()
    zero_counts()
    r_state, r_losses, r_ms, first = r_state0, [], [], None
    for _ in range(RING_STEPS):
        t0 = time.perf_counter()
        r_state, r_metrics = ring_step(r_state, [train_cam])
        torch.cuda.synchronize()
        r_ms.append((time.perf_counter() - t0) * 1e3)
        r_losses.append(float(r_metrics["total_loss"]))
        first = first or r_state
    ring_train_launches = counts()
    per_step = n_rk * n_rk
    if ring_train_launches != (0, 0, RING_STEPS * per_step,
                               RING_STEPS * per_step):
        raise AssertionError(f"{RING_STEPS} ring steps launched the kernels "
                             f"{ring_train_launches} times")
    dead = ~g0_ring.alive
    for k, v in r_state.gaussians.params().items():
        for what, t in (("parameter", v),
                        ("Adam mu", r_state.opt_state.mu[k]),
                        ("Adam nu", r_state.opt_state.nu[k])):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"ring: non-finite {what} {k}")
        if not torch.equal(v[dead], getattr(g0_ring, k)[dead]):
            raise AssertionError(f"ring: dead slots of {k} moved")
        if torch.equal(v, getattr(g0_ring, k)):
            raise AssertionError(f"ring: {k} did not train")
    if not (np.isfinite(r_losses).all() and r_losses[-1] < r_losses[0]):
        raise AssertionError(f"ring: loss did not fall: {r_losses}")
    if float(r_state.gaussians.denom.max()) != RING_STEPS:
        raise AssertionError("ring: the densify statistics were not "
                             "accumulated")
    print(f"[11 ring train] {RING_STEPS} steps {VIEW_SIZE}^2, {N_GAUSSIANS} "
          f"Gaussians (pool {RING_CAPACITY}), SH 3, tile 32, mesh (1, {n_rk})"
          f": launches (fwd, bwd, fwd t0, bwd t0) {ring_train_launches}, loss "
          f"{r_losses[0]:.5f} -> {r_losses[-1]:.5f}, fullest range "
          f"{r_metrics['render_instances']} instances, step ms median "
          f"{np.median(r_ms):.2f} min {min(r_ms):.2f} max {max(r_ms):.2f}",
          flush=True)
    # The first ring step against the single-device step from the same
    # state.  The loss differs by float32 association (rtol 1e-5).  Adam's
    # first step is lr * g / (|g| + 1e-8): of size 1 in units of the
    # learning rate whatever the gradient's size, so it passes on the
    # gradient's relative error.  Where sqrt(nu) is at least 1e-2 of the
    # tensor's largest the steps agree within 1e-2 of a step; elsewhere a
    # gradient near 0 may flip its sign (at most 2 steps).
    if abs(r_losses[0] - float(one_m["total_loss"])) \
            > 1e-5 * abs(float(one_m["total_loss"])):
        raise AssertionError(f"ring: first loss {r_losses[0]} against "
                             f"{float(one_m['total_loss'])}")
    factor = schedule_factor(r_config, 0)
    stat_ref = one_state.gaussians.xyz_gradient_accum
    stat = float((first.gaussians.xyz_gradient_accum - stat_ref).abs().max()
                 / stat_ref.abs().max())
    # The statistic is a norm of sums over pixels whose S_j now hold the
    # chain term; float32 leaves 1e-4 to 2e-4 of the largest entry at full
    # width (the bound is 1e-3).
    if stat > 1e-3:
        raise AssertionError(f"ring: the densify statistic differs by {stat} "
                             "of its largest entry")
    for k, lr in group_lrs(r_config).items():
        if k in ("features_rest", "rotation"):
            # The start has no SH rest, and its splats are isotropic, so
            # the true rotation gradient is 0: both would compare noise.
            continue
        err = (getattr(first.gaussians, k)
               - getattr(one_state.gaussians, k)).abs().double() / (lr * factor)
        root_nu = one_state.opt_state.nu[k].sqrt()
        firm = root_nu >= 1e-2 * root_nu.max()
        print(f"    first step {k:12s} |ring - single| / lr: firm max "
              f"{float(err[firm].max()):.3e} ({float(firm.float().mean()):.2f}"
              f" of the entries), all max {float(err.max()):.3e}")
        if float(err[firm].max()) > 1e-2 or float(err.max()) > 2.0:
            raise AssertionError(f"ring: first step of {k} differs from the "
                                 "single-device step")
    print(f"    first step: loss {r_losses[0]:.6f} against "
          f"{float(one_m['total_loss']):.6f}; densify statistic within "
          f"{stat:.1e} of its largest entry", flush=True)

    # ---- 11b. the 25 launches of a ring step, one by one --------------
    # The trained ring state's bench-view segments, the transmittance
    # chained forward and the loss's own cotangent chained backward, as
    # the step does: each launch against its plain version, its time and
    # its bound.
    proj = project_gaussians(r_state.gaussians, bench_cam, color_mode="sh",
                             sh_degree=3)
    P = 32 * 32
    segs, t_in, acc_seg, g_in, g_acc = ring_step_launches(
        rc, proj, target, n_rk, 32, VIEW_SIZE)
    ntb = (VIEW_SIZE // 32 // n_rk) * tiles_x
    g5_share = float(torch.stack([g_in[b, 0][:, 5].abs().max()
                                  for b in range(n_rk)]).max()
                     / g_acc[:, :5].abs().max())
    err3, err4 = gate_ring_step(rc, segs, t_in, acc_seg, g_in, tiles_x, 32,
                                ntb)
    t3 = dict(ms=0.0, plain=0.0, bound=0.0, by={}, err=err3, worst=0.0)
    t4 = dict(ms=0.0, plain=0.0, bound=0.0, by={}, err=err4, worst=0.0)
    heaviest = {}
    for (b, r), seg in segs.items():
        fargs = (*seg, tiles_x, 32)
        kw = dict(t0=t_in[b, r], tile0=b * ntb)
        bargs = (*fargs, acc_seg[b, r], g_in[b, r])
        n_seg = seg[0].shape[1]
        heaviest[b, r] = (int(seg[2].max()), float(seg[2].float().mean()))
        pairs = pair_counts(rc, *fargs, **kw)
        bounds = raster_bounds(pairs, n_seg, ntb, P, has_t0=True)
        # Timed as the ring calls them: the ranges were checked at the origin,
        # so a launch does not wait for the host; 4 launches per timing.
        for t, fn, plain, bd in (
                (t3, lambda: rc.raster_fwd(*fargs, **kw, ranges_checked=True),
                 lambda: rc.raster_fwd_plain(*fargs, **kw), bounds[0]),
                (t4, lambda: rc.raster_bwd(*bargs, **kw, ranges_checked=True),
                 lambda: rc.raster_bwd_plain(*bargs, **kw), bounds[1])):
            ms = cuda_ms(fn, inner=4)
            t["ms"] += ms
            t["worst"] = max(t["worst"], ms)
            t["plain"] += cuda_ms(plain, reps=1)
            t["bound"] += bd[0]
            t["by"][bd[1]] = t["by"].get(bd[1], 0.0) + bd[0]
    for t in (t3, t4):
        t["by"] = max(t["by"], key=t["by"].get)
    print(f"[11b the {n_rk * n_rk} launches of a ring step] trained ring "
          f"state, bench view; chained cotangent of the transmittance up to "
          f"{g5_share:.3f} of the largest accumulator cotangent\n"
          f"  raster_fwd_t0 sum {t3['ms']:.3f} ms, slowest launch "
          f"{t3['worst']:.3f} (plain sum {t3['plain']:.1f}, bound sum "
          f"{t3['bound']:.4f} by {t3['by']})\n"
          f"  raster_bwd_t0 sum {t4['ms']:.3f} ms, slowest launch "
          f"{t4['worst']:.3f} (plain sum {t4['plain']:.1f}, bound sum "
          f"{t4['bound']:.4f} by {t4['by']})\n"
          f"  heaviest tile / mean instances a tile, per launch:", flush=True)
    for b in range(n_rk):
        print(f"    band {b}: " + "  ".join(
            f"range {r} {heaviest[b, r][0]}/{heaviest[b, r][1]:.1f}"
            for r in range(n_rk)))

    # ---- 12. the entry points with --tile-shards 5 --ring --------------
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        ply = tmp / "flagship.ply"
        export_gaussians_ply(g, str(ply))
        mod = load_script("render_novel_view_torch")
        zero_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            rc_main = mod.main([
                "--ply", str(ply), "--output", str(tmp / "out"), "--n-frames",
                "2", "--size", str(VIEW_SIZE), "--sh-degree", "3",
                "--color-mode", "sh", "--tile-size", "32", "--bg", "1,1,1",
                "--device", "cuda", "--tile-shards", str(n_rk), "--ring"])
        if rc_main != 0 or counts() != (0, 0, 2 * per_step, 0):
            raise AssertionError("the render entry point did not render 2 "
                                 f"frames through the ring: {counts()}")
        for i in range(2):
            rgba = np.load(tmp / "out" / f"frame_{i:04d}.npy")
            if rgba.shape != (4, VIEW_SIZE, VIEW_SIZE) or \
                    not np.isfinite(rgba).all() or rgba[3].max() <= 0:
                raise AssertionError(f"ring entry point frame {i} is bad")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mod = load_script("train_torch")
    zero_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_main = mod.main([
            "--iterations", "4", "--size", str(VIEW_SIZE), "--n-gaussians",
            str(N_GAUSSIANS), "--capacity", str(RING_CAPACITY), "--n-cameras",
            "1", "--log-interval", "2", "--densify-from-iter", "4",
            "--densify-interval", "4", "--sh-increase-interval", "1",
            "--device", "cuda", "--tile-shards", str(n_rk), "--ring"])
    log = [json.loads(x) for x in buf.getvalue().splitlines()]
    final = log[-1]
    if rc_main != 0 or launched(B4)[0] != 4 * per_step \
            or launched(B2)[0] != 0 or "n_clone" not in log[-2] \
            or not final["last_loss"] < final["first_loss"] \
            or not np.isfinite([final["psnr_start"], final["psnr_end"]]).all():
        raise AssertionError(f"the ring train entry point failed: {final}")
    print(f"[12 ring entry points] render_novel_view_torch.py --tile-shards "
          f"{n_rk} --ring: 2 finite frames, {2 * per_step} forward launches "
          f"with t0; train_torch.py --tile-shards {n_rk} --ring: 4 "
          f"iterations, backward launches with t0 "
          f"{launched(B4)[0]}: {json.dumps(final)}", flush=True)

    # ---- 13. the trainer entry point at full width --------------------
    # main_torch.py on a COLMAP scene of the SH-3 set `g` of phase 4, with
    # configs/sdf_tex_30k.yaml's rendering and pool; then the resume,
    # scripts/evaluate_torch.py and scripts/export_ply_torch.py.
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        tr13 = trainer_entry_phase(dev, g, N_GAUSSIANS, VIEW_SIZE, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[13 trainer entry point] main_torch.py, configs/sdf_tex_30k.yaml "
          f"rendering and pool, {tr13['steps']} steps on a COLMAP scene of "
          f"{tr13['points']} points, 7 train + 1 test views at "
          f"{VIEW_SIZE}^2: launches fwd/bwd {tr13['launches']} (resume "
          f"{tr13['launches_resume']}), {tr13['compaction']}, final PSNR "
          f"{tr13['psnr']:.2f} (evaluate_torch.py {tr13['psnr_eval']:.2f}), "
          f"n_alive {tr13['n_alive']}\n"
          f"  log: {json.dumps(tr13['log'])}\n"
          f"  scene written in {tr13['write_scene_s']:.2f} s; one "
          f"{VIEW_SIZE}^2 PNG with Paeth rows decoded in "
          f"{tr13['png_paeth_decode_s']:.3f} s; setup (PNG "
          f"decode and points3D read included) {tr13['setup_s']:.2f} s; "
          f"trainer step ms median {tr13['step_ms_median']:.2f} min "
          f"{tr13['step_ms_min']:.2f} max {tr13['step_ms_max']:.2f}; "
          f"checkpoint save s {' '.join(f'{t:.3f}' for t in tr13['save_s'])}"
          f"; load s {' '.join(f'{t:.3f}' for t in tr13['load_s'])} | {smi}",
          flush=True)

    # ---- 14. the texture scene built and trained on the card ----------
    # Its work dir stays until phase 21 has benched its checkpoint.
    tmp14 = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    atexit.register(shutil.rmtree, tmp14, True)
    tx = texture_scene_phase(dev, tmp14)
    print(f"[14 texture scene] data/synthetic.py 32^2 view, card vs CPU: "
          f"{json.dumps(tx['card_vs_cpu_32'])}; one {VIEW_SIZE}^2 spp-2 "
          f"view's peak device memory {tx['view_peak_bytes'] / 2**20:.1f} "
          f"MiB\n  make_synthetic_scene_torch.py --texture: 9 views at "
          f"{VIEW_SIZE}^2 spp 2 in {tx['generate_s']:.2f} s (per view "
          f"{' '.join(f'{s:.3f}' for s in tx['view_s'])} s); "
          f"export_colmap_scene_torch.py {tx['export_s']:.2f} s\n"
          f"  main_torch.py, 200 steps, 7 train + {tx['n_test']} test views: "
          f"launches fwd/bwd {tx['launches']}, densify {json.dumps(tx['events'])}"
          f" ({tx['created']} created), {tx['compaction']}, n_alive "
          f"{tx['n_alive']}, losses {json.dumps(tx['losses'])}, final PSNR "
          f"{tx['psnr']:.2f}; setup {tx['setup_s']:.2f} s, trainer step ms "
          f"median {tx['step_ms_median']:.2f} | {smi}", flush=True)

    # ---- 15. train-path parity on the card ----------------------------
    pp = parity_phase(dev)
    print(f"[15 train-path parity] 256^2, 300 iterations: tiles "
          f"{json.dumps(pp['routes']['tiles'])}, golden "
          f"{json.dumps(pp['routes']['golden'])}, JAX record PSNR "
          f"{pp['jax_record']['psnr']:.4f}; gates dB "
          f"{json.dumps(pp['gates_db'])} (each <= {pp['gate_db']}) | {smi}",
          flush=True)

    # ---- 16. the trainer over a (data, tile) mesh at full width --------
    # 4 ranks on the one card at tile 16 (800 / 16 = 50 tile rows: 2 bands
    # of 25); the flagship SH-3 set `g` of phase 4 towards renders of the
    # seed-7 set from the bench view and from the same pose at a 40-degree
    # FoV, which leaves the cube's edges out: its rows are counted by each
    # layout's own rule.
    settings16 = settings.replace(tile_size=MESH_TILE_SIZE)
    t_g = convert.gaussians_from_numpy(t_params, t_alive, dev)
    narrow = convert.camera_from_numpy(
        **{**cam, "FoVx": np.radians(40.0), "FoVy": np.radians(40.0)},
        width=VIEW_SIZE, height=VIEW_SIZE, device=dev)
    with torch.no_grad():
        mesh_cams = [c.replace(image=render(t_g, c, settings16)["image"])
                     for c in (bench_cam, narrow)]
    m16 = mesh_step_phase(dev, g, mesh_cams, settings16,
                          float(scene_extent_of(g)))
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        mesh_runs = [mesh_entry_phase(dev, g, N_GAUSSIANS, VIEW_SIZE, tmp,
                                      ring) for ring in (False, True)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for tag, r in zip("cd", mesh_runs):
        print(f"[16{tag} main_torch.py over a mesh] shard_gauss_state, mesh "
              f"{tuple(r['mesh'])}{', ring_exchange' if r['ring'] else ''}, "
              f"tile {MESH_TILE_SIZE}, {r['steps']} steps on phase 13's "
              f"COLMAP scene: launches fwd/bwd/fwd_t0/bwd_t0 "
              f"{r['launches']}"
              + (f" (resume {r['launches_resume']})" if 'launches_resume'
                 in r else "")
              + f", {r['compaction']}, n_alive {r['n_alive']}, final PSNR "
              f"{r['psnr']:.2f}, validate on the mesh vs one device "
              f"{r['validate_err']:.2e}\n  kernels against their plain "
              f"versions at tile {MESH_TILE_SIZE}: {json.dumps(r['kernels'])}"
              f"\n  log: {json.dumps(r['log'])}\n"
              f"  setup {r['setup_s']:.2f} s; trainer step ms median "
              f"{r['step_ms_median']:.2f} min {r['step_ms_min']:.2f} max "
              f"{r['step_ms_max']:.2f} | {smi}", flush=True)

    # ---- 17. the 1M-Gaussian run and the training probe ----------------
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        e17 = entry_scripts_phase(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- 18. ring v2 / v3 and the band route's sharded sort -------------
    # (a), (b) on phase 11's trained ring state (5 ranks, 800^2, tile 32,
    # pool 131,075) from the bench view; (c) main_torch.py over (1, 2) at
    # tile 16 on phase 13's COLMAP scene, through ring v3 and ring v2.
    t18 = time.perf_counter()
    p18 = ring_routes_phase(rc, dev, r_state, r_config, settings, train_cam)
    for route, row in p18["routes"].items():
        vs = (f" (against v1: loss rel {row['loss_rel']:.2e}, xyz "
              f"{row['xyz_max']:.2e})" if route != "v1" else "")
        print(f"[18a ring {route}] {VIEW_SIZE}^2 tile 32, pool "
              f"{RING_CAPACITY}, {n_rk} ranks on the card"
              f"{', state split over (1, 5)' if route == 'v3' else ''}: "
              f"launches (fwd, bwd, fwd t0, bwd t0) {row['launches']}, loss "
              f"{row['loss']:.6f}{vs}; step ms median "
              f"{row['step_ms_median']:.2f} "
              f"({' '.join(f'{t:.2f}' for t in row['step_ms'])}); device "
              f"busy {row['device_busy_ms']:.3f} ms in "
              f"{row['kernel_launches']:.0f} kernel launches; peak "
              f"{row['peak_bytes'] / 2**20:.1f} MiB allocated "
              f"({row['peak_bytes_above_start'] / 2**20:.1f} above the "
              f"step's start) | {smi}\n  stages a step: "
              f"{json.dumps(row['stages'])}", flush=True)
    print(f"[18a v3's {n_rk * n_rk} launches] {p18['v3_instances']} "
          f"instances: B3 max {p18['fwd_t0_err']:.2e}, B4 worst row "
          f"{p18['bwd_t0_err']:.2e}; renders of v2 and v3 bitwise v1's",
          flush=True)
    srt = p18["sort"]
    print(f"[18b sharded candidate sort] {VIEW_SIZE}^2 tile 32, {n_rk} "
          f"bands, pool {RING_CAPACITY}: band n_live {srt['band_n_live']} "
          f"(whole image {srt['whole_n_live']}), every band exactly the "
          f"single-device binning's; heaviest band {srt['heaviest_band']}: "
          f"B1 max {p18['fwd_err']:.2e}, B2 worst {p18['bwd_err']:.2e}, "
          f"B1 {srt['ms'][0]:.3f} ms, B2 {srt['ms'][1]:.3f} ms\n"
          + "".join(
              f"  band-route step, {key.replace('_', ' ')}: launches "
              f"{srt['launches_' + key]}, host ms median "
              f"{srt['step_' + key]['step_ms_median']:.2f} ("
              f"{' '.join(f'{t:.2f}' for t in srt['step_' + key]['step_ms'])}"
              f"), device busy {srt['step_' + key]['device_busy_ms']:.3f} ms "
              f"in {srt['step_' + key]['kernel_launches']:.0f} kernel "
              f"launches\n" for key in ("sharded_sort", "whole_image"))
          + f"  loss rel between the two {srt['loss_rel']:.2e}; binning + "
          f"pack of the {n_rk} ranks: sharded sort "
          f"{srt['binning_sharded']['device_busy_ms']:.3f} ms in "
          f"{srt['binning_sharded']['kernel_launches']:.0f} launches, whole "
          f"image on every rank "
          f"{srt['binning_whole_image']['device_busy_ms']:.3f} ms in "
          f"{srt['binning_whole_image']['kernel_launches']:.0f} | {smi}\n"
          + "".join(f"  band-route step stages, {key.replace('_', ' ')}: "
                    f"{json.dumps(srt['step_' + key]['stages'])}\n"
                    for key in ("sharded_sort", "whole_image")),
          flush=True)
    t18c = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        local_runs = [mesh_entry_phase(
            dev, g, N_GAUSSIANS, VIEW_SIZE, tmp, True, overrides=o,
            gate_kernels=False) for o in (
                {"ring_local": True},
                {"ring_reshard": True, "shard_gauss_state": False})]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    v1_first = mesh_runs[1]["first_loss"]
    for r in local_runs:
        rel = abs(r["first_loss"] / v1_first - 1.0)
        print(f"[18c main_torch.py over (1, 2), ring_exchange, "
              f"{json.dumps(r['overrides'])}] tile {MESH_TILE_SIZE}, "
              f"{r['steps']} steps: first loss {r['first_loss']:.6f} (phase "
              f"16d's v1 run {v1_first:.6f}, rel {rel:.2e}), launches "
              f"{r['launches']}, final PSNR {r['psnr']:.2f}, validate vs one "
              f"device {r['validate_err']:.2e}, trainer step ms median "
              f"{r['step_ms_median']:.2f} min {r['step_ms_min']:.2f} max "
              f"{r['step_ms_max']:.2f} | {smi}", flush=True)
        if rel > 1e-5 or not np.isfinite(r["psnr"]):
            raise AssertionError(f"18c: {r['overrides']} first loss "
                                 f"{r['first_loss']} against v1's {v1_first}")
    print(f"[18] phase 18 took {time.perf_counter() - t18:.1f} s: (a) and "
          f"(b) {t18c - t18:.1f} ({traced.seconds:.1f} of it under the "
          f"profiler and reading its traces), (c) "
          f"{time.perf_counter() - t18c:.1f}", flush=True)

    # ---- 19. the mesh over two processes on the one card ---------------
    # Two children through gloo on phase 16's set, cameras and tile 16.
    p19 = distributed_phase(rc, dev, g, mesh_cams, settings16,
                            float(scene_extent_of(g)))
    names19 = {"p1": "19a replicated step over (2, 2)",
               "p2": "19b gauss-sharded step over (2, 2)",
               "p3_band": "19c band route over (1, 2)",
               "p3_ring": "19c ring v1 over (1, 2)",
               "p4": "19c ring v3, state split, over (1, 2)"}
    names19["p7"] = "19f replicated step over (1, 2), two rankless"
    ms = lambda v: " / ".join("-" if x is None else f"{x:.2f}" for x in v)
    for group, rows in (("two processes", p19["programs"]),
                        ("four processes of one rank",
                         p19["programs_four"])):
        for key, row in rows.items():
            one = row["single_step_ms_median"]
            print(f"[{names19[key]}, {group}] {VIEW_SIZE}^2 tile "
                  f"{MESH_TILE_SIZE}, {N_GAUSSIANS} Gaussians: loss "
                  f"{row['loss']:.6f}, against one process rel "
                  f"{row['loss_rel']:.2e}, xyz max {row['xyz_max']:.2e}, "
                  f"processes {row['processes']} bitwise "
                  f"{row['processes_bitwise']}; launches (fwd, bwd, fwd t0, "
                  f"bwd t0) {row['launches']}; host ms a step median "
                  f"{ms(row['step_ms_median'])} (one process "
                  f"{'-' if one is None else f'{one:.2f}'}), of it in "
                  f"torch.distributed {ms(row['exchange_ms_median'])}; bytes "
                  f"a step through torch.distributed {row['bytes_a_step']} in "
                  f"{row['calls_a_step']} calls | {smi}", flush=True)
    print(f"[19e renders over processes] bitwise the one-process render: "
          f"{json.dumps(p19['renders'])}; verify_shard_grad_parity worst "
          f"deviation, one process {json.dumps(p19['grad_parity']['single'])}"
          f", the four {json.dumps(p19['grad_parity']['four'])}", flush=True)
    k19 = p19["kernels"]
    print(f"[19d the children's launches against the plain versions] "
          f"instances {json.dumps(k19['instances'])}: B1 max "
          f"{k19['fwd_err']:.2e}, B2 worst {k19['bwd_err']:.2e}, B3 max "
          f"{k19['fwd_t0_err']:.2e}, B4 worst {k19['bwd_t0_err']:.2e}; the "
          f"checkpoint over (2, 2) restored bitwise in both; collectives "
          f"{json.dumps(p19['collectives'])}; NCCL, one process on the card: "
          f"{json.dumps(p19['nccl'])}", flush=True)
    print(f"[19] phase 19 took {p19['seconds']:.1f} s (the children "
          f"{p19['children_s']:.1f} s, the two {p19['two_s']:.1f} s; their "
          f"programs {' / '.join(f'{t:.1f}' for t in p19['child_seconds'])}"
          f" s) | {smi}", flush=True)
    dist19 = lambda i, keys: sum(
        n[i] for rows in (p19["programs"], p19["programs_four"])
        for key, row in rows.items() if key in keys
        for n in row["launches"])
    band19, ring19 = ("p1", "p2", "p3_band", "p7"), ("p3_ring", "p4")

    # ---- 20. the twin of __graft_entry__.py ----------------------------
    p20 = graft_entry_phase(rc, dev)
    d20 = p20["dryrun"]
    print(f"[20 graft_entry_torch.py] entry(): {p20['entry']['shape']} mean "
          f"{p20['entry']['mean']:.6f}, {p20['entry']['launches']} B1 launch, "
          f"{p20['entry']['seconds']:.2f} s; dryrun_multichip(8) on eight "
          f"ranks of the card, {d20['seconds']:.2f} s: "
          f"{d20['printed']}; losses "
          f"{json.dumps({k: round(v, 9) for k, v in d20['losses'].items()})}"
          f", rel to the JAX record "
          f"{' '.join(f'{v:.2e}' for v in d20['rel_to_jax'].values())}; "
          f"launches (fwd, bwd, fwd t0, bwd t0) {d20['launches']} | {smi}",
          flush=True)

    # ---- 21. the twin of bench.py --------------------------------------
    import bench_torch
    t21 = time.perf_counter()
    try:
        p21 = bench_phase(rc, dev, tmp14 / "config.yaml")
    finally:
        shutil.rmtree(tmp14, ignore_errors=True)
    line21 = p21["line"]
    print(f"[21 bench_torch.py] first chain step, B1 / B2 against their "
          f"plain versions: {json.dumps(p21['first_step'])}; a headline "
          f"chain step on the card (bench_torch.device_busy): busy "
          f"{line21['device_busy_ms']:.3f} ms in "
          f"{line21['device_launches']:.0f} launches\n"
          f"  vs_baseline divides FULL_GOLDEN_S = {bench_torch.FULL_GOLDEN_S}"
          f" s, a constant of bench_torch.py, not timed here: the port's "
          f"golden step at 800^2 / 100K, {bench_torch.FULL_GOLDEN_SOURCE}\n"
          f"  main(--trained-config <phase 14's>): {p21['main_seconds']:.1f}"
          f" s, launches fwd/bwd {p21['launches']}; its stderr: "
          f"{' | '.join(p21['stderr'].splitlines())}\n"
          f"  {json.dumps(p21['line'])}\n"
          f"[21] phase 21 took {time.perf_counter() - t21:.1f} s | {smi}",
          flush=True)
    print(f"chip_smoke: phases 1-21 passed in "
          f"{time.perf_counter() - t_start:.1f} s")

    # ---- result -------------------------------------------------------
    print(json.dumps({"kernels": [
        {"name": "raster_fwd", "route": "cuda",
         "source": "mini3dgs_tpu_torch/csrc/raster_fwd.cu",
         "replaces": "mini3dgs_tpu/ops/raster_pallas.py:288",
         "launches": train_launches[0], "launches_render": render_launches,
         "launches_trainer": tr13["launches"][0],
         "launches_texture_scene": tx["launches"][0],
         "launches_parity_tiles": pp["routes"]["tiles"]["launches_fwd"],
         "launches_mesh_trainer": mesh_runs[0]["launches"][0],
         "launches_1m": e17["launches_1m"][0],
         "launches_band_sharded_sort": p18["sort"]["launches"][0],
         "launches_distributed": dist19(0, band19),
         "launches_graft_entry": p20["entry"]["launches"]
         + d20["launches"][0],
         "launches_bench": p21["launches"][0],
         "max_abs_err": max(fwd_err, fwd_patch_err, e17["fwd_err"],
                            mesh_runs[0]["kernels"]["fwd_err"],
                            p18["fwd_err"], k19["fwd_err"], p21["fwd_err"]),
         "ms": t_fwd, "plain_ms": t_fwd_plain, "bound_ms": fwd_bound[0],
         "bound_by": fwd_bound[1], "library_ms": None},
        {"name": "raster_bwd", "route": "cuda",
         "source": "mini3dgs_tpu_torch/csrc/raster_bwd.cu",
         "replaces": "mini3dgs_tpu/ops/raster_pallas.py:377",
         "launches": train_launches[1],
         "launches_trainer": tr13["launches"][1],
         "launches_texture_scene": tx["launches"][1],
         "launches_parity_tiles": pp["routes"]["tiles"]["launches_bwd"],
         "launches_mesh_trainer": mesh_runs[0]["launches"][1],
         "launches_1m": e17["launches_1m"][1],
         "launches_band_sharded_sort": p18["sort"]["launches"][1],
         "launches_distributed": dist19(1, band19),
         "launches_graft_entry": d20["launches"][1],
         "launches_bench": p21["launches"][1],
         "max_abs_err": max(bwd_err, patch_err,
                            mesh_runs[0]["kernels"]["bwd_err"],
                            p18["bwd_err"], k19["bwd_err"], p21["bwd_err"]),
         "ms": t_bwd, "plain_ms": t_bwd_plain, "bound_ms": bwd_bound[0],
         "bound_by": bwd_bound[1], "library_ms": None},
        # The two builds with t0: times, plain times and bounds are sums
        # over the 25 launches of one ring render / step on the trained ring
        # state's bench view; `ms_slowest_launch` is one full-width segment.
        {"name": "raster_fwd_t0", "route": "cuda",
         "source": "mini3dgs_tpu_torch/csrc/raster_fwd.cu",
         "replaces": "mini3dgs_tpu/ops/raster_pallas.py:299",
         "launches": ring_train_launches[2],
         "launches_per_step": per_step,
         "launches_render": ring_render_launches[2],
         "launches_mesh_trainer": mesh_runs[1]["launches"][2],
         **{f"launches_ring_{r}": p18["routes"][r]["launches"][2]
            for r in ("v2", "v3")},
         "launches_distributed": dist19(2, ring19),
         "launches_graft_entry": d20["launches"][2],
         "max_abs_err": max(t0_err, t3["err"],
                            mesh_runs[1]["kernels"]["fwd_t0_err"],
                            p18["fwd_t0_err"], k19["fwd_t0_err"]),
         "ms": t3["ms"],
         "ms_slowest_launch": t3["worst"], "plain_ms": t3["plain"],
         "bound_ms": t3["bound"], "bound_by": t3["by"], "library_ms": None},
        {"name": "raster_bwd_t0", "route": "cuda",
         "source": "mini3dgs_tpu_torch/csrc/raster_bwd.cu",
         "replaces": "mini3dgs_tpu/ops/raster_pallas.py:382",
         "launches": ring_train_launches[3],
         "launches_per_step": per_step,
         "launches_mesh_trainer": mesh_runs[1]["launches"][3],
         **{f"launches_ring_{r}": p18["routes"][r]["launches"][3]
            for r in ("v2", "v3")},
         "launches_distributed": dist19(3, ring19),
         "launches_graft_entry": d20["launches"][3],
         "max_abs_err": max(dt0_err, patch_t0_err, t4["err"],
                            mesh_runs[1]["kernels"]["bwd_t0_err"],
                            p18["bwd_t0_err"], k19["bwd_t0_err"]),
         "ms": t4["ms"],
         "ms_slowest_launch": t4["worst"], "plain_ms": t4["plain"],
         "bound_ms": t4["bound"], "bound_by": t4["by"], "library_ms": None},
        # Times and bound at phase 4's pool, SH 3; the error is the largest
        # relative one of the fields not held bitwise.
        {"name": "project_fwd", "route": "cuda",
         "source": "mini3dgs_tpu_torch/csrc/project_fwd.cu",
         "replaces": None,
         "launches": p1_train_launches, "launches_render": p1_render_launches,
         "launches_ring_render": p1_ring_launches,
         "exact_fields_bitwise": p1_exact, "max_rel_err": p1_err,
         "rows": p1_rows, "ms": p1_ms, "plain_ms": p1_plain_ms,
         "bound_ms": p1_bound, "bound_by": "bytes", "library_ms": None},
        # The same pool and view; plain_ms is the chain's backward alone.
        {"name": "project_bwd", "route": "cuda",
         "source": "mini3dgs_tpu_torch/csrc/project_bwd.cu",
         "replaces": None, "launches": p2_train_launches,
         "launches_render": p2_render_launches, "max_rel_err": p2_err, "rows": p1_rows,
         "ms": p2_ms, "plain_ms": p2_plain_ms, "bound_ms": p2_bound,
         "bound_by": "bytes", "library_ms": None}],
        "ring": {"ranks": n_rk, "render_ms": ring_ms, "step_ms": r_ms,
                 "render_err": ring_render_err,
                 "grad_rel_l2": ring_grad_err},
        "mesh": {"step_vs_replicated": m16,
                 "trainer_step_ms": [r["step_ms_median"] for r in mesh_runs]},
        "ring_routes": {route: {k: row[k] for k in (
            "step_ms_median", "device_busy_ms", "kernel_launches",
            "peak_bytes")} for route, row in p18["routes"].items()},
        "sharded_sort": {
            "step_host_ms": {k: p18["sort"][f"step_{k}"]["step_ms_median"]
                             for k in ("sharded_sort", "whole_image")},
            "step_device_busy_ms": {
                k: p18["sort"][f"step_{k}"]["device_busy_ms"]
                for k in ("sharded_sort", "whole_image")},
            "binning_device_ms": {
                k: p18["sort"][f"binning_{k}"]["device_busy_ms"]
                for k in ("sharded", "whole_image")}},
        "ring_local_reshard_trainer_step_ms": [
            r["step_ms_median"] for r in local_runs],
        "one_million": {k: e17["one"][k] for k in (
            "steady_ms_per_it", "window_ms_per_it", "peak_gib", "n_alive",
            "n_live", "psnr")},
        "one_million_b2_rel_l2_from_float64": {
            "kernel": e17["rel_k"], "plain_float32": e17["rel_32"],
            "kernel_over_plain": e17["ratio"]},
        "probe_psnr": e17["probe"]["psnr"],
        "distributed": {
            key: {k: row[k] for k in (
                "loss_rel", "xyz_max", "step_ms_median", "exchange_ms_median",
                "single_step_ms_median", "bytes_a_step")}
            for key, row in p19["programs"].items()},
        "distributed_four": {
            key: {k: row[k] for k in (
                "loss_rel", "xyz_max", "step_ms_median", "exchange_ms_median",
                "single_step_ms_median", "bytes_a_step")}
            for key, row in p19["programs_four"].items()},
        "graft_entry": {"entry_mean": p20["entry"]["mean"],
                        "dryrun_rel_to_jax": d20["rel_to_jax"]},
        "bench": {k: line21[k] for k in (
            "value", "spread", "mgaussians_per_s", "device_busy_ms",
            "device_launches", "host_launch_us", "aniso_rotated_mpix_s",
            "trained_mpix_s")}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
