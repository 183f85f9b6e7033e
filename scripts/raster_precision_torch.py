"""How far the raster kernels and their float32 plain versions lie from the
float64 plain version on a long instance stream (GPU only).

It makes the procedural Blender scene (`make_synthetic_scene_torch.py`, 8 +
1 views at 800^2, spp 1), seeds a pool with --n-points surface samples,
trains it --iters steps with `scripts/train_1m_torch.py`, and on the
streams of the first --views training views (tile 32) compares, per
instance row of the backward and per accumulator row of the forward:
the kernel (B1 / B2) against the float32 plain version, the kernel
against the float64 plain version, and the float32 plain version against
the float64 one.  The backward's cotangent is N(0, 1) on the five live
accumulator rows (`chip_smoke.seeded_gout`).  With --cuts K it also
gates B2 with `chip_smoke.gate_rows` on each of K position ranges of every
tile's list (`chip_smoke.cut_ranges`).  The last line is one JSON object.

With --band it replays `chip_smoke.py` phase 17 instead: the same scene and
60 iterations (`--iters 40 --steady 20` of `train_1m_torch.py`), the
BAND_ROWS tile rows around the heaviest tile of training view 0
(`chip_smoke.heavy_band`), the cotangent of seed 1717.  Per row it prints
how far B2 and its float32 plain version lie from the float64 plain
version d_64, and splits that distance by where float32 enters, with a
float64 model of the kernel that walks each tile's list one instance at a
time, twice as B2 does (`emulate_bwd`: a first walk sums `total`, the
second forms the gradient), and rounds to float32 only the part named:

  (a) the accumulators: the float64 backward fed B1's float32 accumulators
      (the phase's `acc_b`, which kernel and plain version share) instead
      of the float64 forward's;
  (b) the running transmittance T, rounded to float32 after every
      instance;
  (c) the subtraction S = total - prefix: the running sum `prefix` kept in
      float32 (one rounding an instance, as the kernel's fused multiply-add
      gives) and total and S rounded to float32;
  (d) the exponent lw of each pixel x instance pair, evaluated in float32
      as the kernel's fused multiply-adds do;
  (e) the weight w = exp(lw) and alpha = op * w rounded to float32;
  (f) the gradient's terms of each pair (u, T, S, d_alpha, d_lw and the
      rows' products) rounded to float32 as the kernel forms them;
  (g) the sums of those terms over a tile's pixels taken in float32 (in
      torch's order, not the kernel's);

and the combinations: "defg" models B2 as it is, "adefg" B2 as it was
when it took `total` from B1's accumulators, "abcdefg" the float32
plain version.  `--repeat K` trains the pool K times (on the card no two
trainings give quite the same state, so neither do their bands), prints
each band's distances and whether B2 gave the same bits twice, and splits
the band where B2 lies farthest; for that band it also says, per row, how
much of B2's distance its ten farthest instances hold and where the
farthest lies in its tile's list.  `--other-bwd SOURCE.cu` (the tree's C interface)
and `--other-fwd SOURCE.cu` measure other builds of B2 and B1 on the same
band: each backward on `acc_b`, each forward feeding the tree's B2 and
the float32 plain version.

Usage: python3 scripts/raster_precision_torch.py [--n-points 1000000]
           [--iters 30] [--views 1] [--cuts 8 16]
       python3 scripts/raster_precision_torch.py --band [--repeat 6]
           [--other-bwd build/ab/v.cu ...] [--other-fwd build/ab/f.cu ...]
           [--output build/precision_band.json]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def rel_rows(got: torch.Tensor, want: torch.Tensor) -> list:
    """Per row (dim 0 after flattening the rest): ||got - want|| /
    ||want||."""
    g = got.double().transpose(0, 1).reshape(got.shape[1], -1) \
        if got.dim() == 3 else got.double()
    w = want.double().transpose(0, 1).reshape(want.shape[1], -1) \
        if want.dim() == 3 else want.double()
    return ((g - w).norm(dim=1) / w.norm(dim=1).clamp(min=1e-30)).tolist()


# The parts of emulate_bwd's model: (name, accumulators of B1 in float32,
# T in float32, prefix and S in float32, lw in float32, w and alpha in
# float32, the per-pair gradient terms in float32, the sums over a tile's
# pixels in float32).  "defg" is B2 as it is (T, `prefix` and its own
# `total` in float64, the rest float32), "adefg" B2 before it summed
# `total` itself, "abcdefg" the float32 plain version.
SPLIT = (("exact", False, False, False, False, False, False, False),
         ("a_acc", True, False, False, False, False, False, False),
         ("b_T", False, True, False, False, False, False, False),
         ("c_sub", False, False, True, False, False, False, False),
         ("d_lw", False, False, False, True, False, False, False),
         ("e_w", False, False, False, False, True, False, False),
         ("f_grad", False, False, False, False, False, True, False),
         ("g_sum", False, False, False, False, False, False, True),
         ("defg", False, False, False, True, True, True, True),
         ("adefg", True, False, False, True, True, True, True),
         ("abcdefg", True, True, True, True, True, True, True))


def emulate_bwd(stream, start, count, tiles_x, ts, tile0, acc64, acc32,
                gout, parts=SPLIT):
    """B2's gradient [len(parts), 10, n_live] in float64, one instance of
    every tile's list at a time as the kernel walks it, for each part of
    `parts` at once; a part rounds to float32 what it names (see SPLIT).
    As B2 does, a first walk sums each part's own `total`: the sum of
    u * wgt under that part's own w, alpha and T, in float64, except where
    the part takes B1's accumulators `acc32` (a), as B2 did before it
    walked twice, or rounds `total` to float32 (c), as the plain version
    does.  The second walk forms the gradient."""
    from mini3dgs_tpu_torch.ops import raster_cuda as rc
    from mini3dgs_tpu_torch.ops.raster_ref import EARLY_STOP_A, W_EPS

    f64 = torch.float64
    dev = stream.device
    flag = lambda k: torch.tensor([p[k] for p in parts],
                                  device=dev)[:, None, None]
    use32, t32, p32, lw32, w32, g32 = (flag(k) for k in range(1, 7))
    s32 = flag(7)[:, :, 0]
    n_tiles, P = start.shape[0], ts * ts
    px, py = (c.double() for c in rc._pixel_coords(n_tiles, tiles_x, ts, dev,
                                                   tile0))
    g = gout.double()
    g_r, g_g, g_b, g_d, g_a = (g[:, k] for k in range(5))
    V = len(parts)
    s64 = stream.double()
    start_l, count_l = start.long(), count.long()
    f32 = lambda x: x.float().double()
    r32 = lambda x: torch.where(g32, f32(x), x)   # a float32 gradient term
    # a sum over the tile's pixels [V, T, P] -> [V, T]
    psum = lambda x: torch.where(s32, x.float().sum(-1).double(), x.sum(-1))

    def pair(j, is_open):
        """The terms of instance j of every tile at every pixel."""
        valid = j < count_l                                  # [T]
        idx = (start_l + j).clamp(max=stream.shape[1] - 1)
        x, y, qa, qb, qc, op, cr, cg, cb, cd = s64[:, idx][:, :, None]
        dx, dy = px - x, py - y                              # [T, P]
        lw = dx * dx * qa + dx * dy * qb + dy * dy * qc
        dx32, dy32 = f32(dx), f32(dy)
        lw_32 = f32(f32(dy32 * dy32) * qc + f32(f32(dx32 * dy32) * qb
                                               + f32(f32(dx32 * dx32) * qa)))
        lw = torch.where(lw32, lw_32, lw)                    # [V, T, P]
        w = torch.clamp(torch.exp(lw), max=1.0)
        w = torch.where(w32, f32(w), w)
        a_raw = torch.where(w32, f32(op * w), op * w)
        live = is_open & (w >= W_EPS) & valid[:, None]       # [V, T, P]
        alpha = torch.where(live, torch.clamp(a_raw, max=1.0), 0.0)
        u = g_r * cr + g_g * cg + g_b * cb + g_d * cd + g_a
        return dict(valid=valid, dx=dx, dy=dy, qa=qa, qb=qb, qc=qc, op=op,
                    w=w, a_raw=a_raw, live=live, alpha=alpha, u=u)

    def walk(total=None):
        """The forward's sum of u * wgt ([V, T, P]) without `total`; the
        gradient with it."""
        trans = torch.ones(V, n_tiles, P, dtype=f64, device=dev)
        prefix = torch.zeros(V, n_tiles, P, dtype=f64, device=dev)
        is_open = torch.ones(V, n_tiles, P, dtype=torch.bool, device=dev)
        out = None if total is None else torch.zeros(
            V, 10, stream.shape[1], dtype=f64, device=dev)
        for j in range(int(count.max())):
            if j % 64 == 0 and not bool(is_open.any()):
                break
            m = pair(j, is_open)
            u, w, alpha, op = m["u"], m["w"], m["alpha"], m["op"]
            wgt = trans * alpha
            if total is None:
                prefix = prefix + u * wgt
            else:
                prefix = torch.where(p32 & m["live"], f32(prefix + u * wgt),
                                     prefix + u * wgt)
                S = torch.where(p32 | g32, f32(total - prefix),
                                total - prefix)
                mask = m["live"] & (m["a_raw"] < 1.0) & (m["a_raw"] > 0.0)
                d_alpha = torch.where(
                    mask, r32(r32(r32(u) * r32(trans))
                              - r32(S / r32(1.0 - alpha))), 0.0)
                d_lw = torch.where(w < 1.0, r32(r32(w * d_alpha) * op), 0.0)
                dx, dy, qa, qb, qc = (m[k] for k in
                                      ("dx", "dy", "qa", "qb", "qc"))
                wgt_g = r32(wgt)
                rows = torch.stack([
                    -psum(r32(d_lw * r32(2.0 * dx * qa + dy * qb))),
                    -psum(r32(d_lw * r32(2.0 * dy * qc + dx * qb))),
                    psum(r32(d_lw * r32(dx * dx))),
                    psum(r32(d_lw * r32(dx * dy))),
                    psum(r32(d_lw * r32(dy * dy))),
                    psum(r32(d_alpha * w)),
                    psum(r32(g_r * wgt_g)), psum(r32(g_g * wgt_g)),
                    psum(r32(g_b * wgt_g)), psum(r32(g_d * wgt_g))],
                    dim=1)                                   # [V, 10, T]
                valid = m["valid"]
                out[:, :, start_l[valid] + j] = rows[:, :, valid]
            step = trans * torch.where(t32, f32(1.0 - alpha), 1.0 - alpha)
            trans = torch.where(t32, f32(step), step)
            is_open = (1.0 - trans) < EARLY_STOP_A
        return prefix if total is None else out

    acc = acc32.double()
    total = torch.where(use32, (g[:, :5] * acc[:, :5]).sum(1)[None], walk())
    return walk(torch.where(p32, f32(total), total))


def fwd_runner(lib):
    """B1 of another build (the tree's C interface), with `rc.raster_fwd`'s
    arguments."""
    import ctypes

    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.raster_fwd_launch.argtypes = [ptr, ctypes.c_longlong, ptr, ptr, i32,
                                      i32, i32, i32, ptr, ptr]
    lib.raster_fwd_launch.restype = i32

    def run(stream, start, count, tiles_x, ts, tile0=0):
        out = torch.empty(start.shape[0], 8, ts * ts, device=stream.device)
        code = lib.raster_fwd_launch(
            stream.data_ptr(), stream.shape[1], start.data_ptr(),
            count.data_ptr(), start.shape[0], tiles_x, ts, tile0,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"raster_fwd_launch: CUDA error {code}")
        return out
    return run


def trained_band(C, rc, dev, scene: Path) -> dict:
    """One phase 17 training of the 1M pool on `scene` and its band: the
    stream, the band's tile ranges, B1's accumulators, the cotangent, B2
    twice, the float32 plain version and the float64 one."""
    from mini3dgs_tpu_torch.train.trainer import GaussianTrainer

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), \
            C.MethodTimes(GaussianTrainer, ["setup"], dev) as mt:
        C.load_script("train_1m_torch").main([
            "--scene", str(scene), "--iters", "40", "--steady", "20",
            "--log-interval", "1", "--n-points", "1000000",
            "--capacity", str(2 ** 20), "--device", "cuda"])
    tr = mt.objects[0]
    proj = C.project_with(tr.state.gaussians, tr.train_cameras()[0],
                          tr.settings)
    b, stream = rc.tile_stream(proj, C.VIEW_SIZE, C.VIEW_SIZE, 32)
    tiles_x = -(-C.VIEW_SIZE // 32)
    row0, n_rows = C.heavy_band(b.tile_count, tiles_x)
    lo, hi = row0 * tiles_x, (row0 + n_rows) * tiles_x
    bf = (stream, b.tile_start[lo:hi], b.tile_count[lo:hi], tiles_x, 32)
    acc_b = rc.raster_fwd(*bf, tile0=lo)
    g_b = C.seeded_gout(acc_b, 1717)
    d_k = rc.raster_bwd(*bf, acc_b, g_b, tile0=lo)
    acc64 = rc.raster_fwd_plain(stream.double(), *bf[1:], tile0=lo)
    return dict(
        bf=bf, lo=lo, tiles_x=tiles_x, acc_b=acc_b, g_b=g_b, acc64=acc64,
        d_k=d_k, d_k2=rc.raster_bwd(*bf, acc_b, g_b, tile0=lo),
        d_32=rc.raster_bwd_plain(*bf, acc_b, g_b, tile0=lo),
        d_64=rc.raster_bwd_plain(stream.double(), *bf[1:], acc64,
                                 g_b.double(), tile0=lo),
        band_rows=[row0, n_rows], heaviest_tile=int(b.tile_count.max()),
        n_live_band=int(b.tile_count[lo:hi].sum()),
        setup_s=time.perf_counter() - t0)


def where_it_lies(band: dict, top: int = 10) -> dict:
    """Per row: the share of the kernel's squared distance from float64
    that its `top` farthest instances hold, and for the farthest one its
    place in its tile's list, its tile's length and the three values."""
    d_k, d_32, d_64 = band["d_k"].double(), band["d_32"].double(), \
        band["d_64"]
    start, count = (t.long() for t in band["bf"][1:3])
    tile = torch.repeat_interleave(torch.arange(count.shape[0],
                                                device=count.device), count)
    col = torch.cat([torch.arange(s, s + c, device=count.device)
                     for s, c in zip(start.tolist(), count.tolist())])
    out = []
    for r in range(d_64.shape[0]):
        err = (d_k[r, col] - d_64[r, col]) ** 2
        vals, idx = torch.topk(err, min(top, err.numel()))
        i = int(idx[0])
        t = int(tile[i])
        out.append({
            "top_share": float(vals.sum() / err.sum().clamp(min=1e-300)),
            "place": int(col[i] - start[t]), "tile_count": int(count[t]),
            "kernel": float(d_k[r, col[i]]), "plain32": float(d_32[r, col[i]]),
            "float64": float(d_64[r, col[i]]),
            "row_max_float64": float(d_64[r, col].abs().max())})
    return out


def band_split(args) -> dict:
    """--band: phase 17's band trained --repeat times; each one's distances
    from float64, and the split of the one where B2 lies farthest (module
    docstring)."""
    import chip_smoke as C
    from mini3dgs_tpu_torch.ops import raster_cuda as rc

    ab = C.load_script("ab_raster_bwd_torch")
    dev = torch.device("cuda", 0)
    tmp = Path(tempfile.mkdtemp(prefix="raster_precision_"))
    with contextlib.redirect_stdout(io.StringIO()):
        C.load_script("make_synthetic_scene_torch").main([
            "--out", str(tmp / "scene"), "--n-train", "8", "--n-test", "1",
            "--size", str(C.VIEW_SIZE), "--spp", "1", "--device", "cuda"])
    out = {"card": ab.card(), "runs": []}
    worst = None
    for i in range(args.repeat):
        band = trained_band(C, rc, dev, tmp / "scene")
        rel = lambda a, d_64=band["d_64"]: rel_rows(a, d_64)
        run = {k: band[k] for k in ("band_rows", "n_live_band",
                                    "heaviest_tile", "setup_s")}
        run.update(kernel=rel(band["d_k"]), plain32=rel(band["d_32"]),
                   bitwise_reproducible=bool(torch.equal(band["d_k"],
                                                         band["d_k2"])))
        run["kernel_over_plain32"] = [k / p for k, p in
                                      zip(run["kernel"], run["plain32"])]
        out["runs"].append(run)
        print(f"band {i}: kernel {max(run['kernel']):.2e}, ratio "
              f"{max(run['kernel_over_plain32']):.3f}, reproducible "
              f"{run['bitwise_reproducible']}", file=sys.stderr, flush=True)
        if worst is None or max(run["kernel"]) > max(out["runs"][worst]
                                                     ["kernel"]):
            worst, kept = i, band
        del band
    band, bf, lo = kept, kept["bf"], kept["lo"]
    rel = lambda a: rel_rows(a, band["d_64"])
    out["split_of_run"] = worst
    out["where"] = where_it_lies(band)
    t_split = time.perf_counter()
    em = emulate_bwd(bf[0], *bf[1:3], band["tiles_x"], 32, lo,
                     band["acc64"], band["acc_b"], band["g_b"])
    torch.cuda.synchronize()
    out["split_s"] = time.perf_counter() - t_split
    out["split"] = {name: rel(em[i]) for i, (name, *_) in enumerate(SPLIT)}
    acc_b, g_b = band["acc_b"], band["g_b"]
    for src in args.other_bwd:
        run = ab.runner(ab.build_other(Path(src)), "v3", src)
        d_o = run(*bf, acc_b, g_b, tile0=lo)
        out[f"bwd {Path(src).stem}"] = rel(d_o)
        out[f"bwd {Path(src).stem} over plain32"] = [
            k / p for k, p in zip(rel(d_o), rel(band["d_32"]))]
        out[f"bwd {Path(src).stem} bitwise reproducible"] = bool(torch.equal(
            d_o, run(*bf, acc_b, g_b, tile0=lo)))
    for src in args.other_fwd:
        acc_o = fwd_runner(ab.build_other(Path(src)))(*bf, tile0=lo)
        name = f"fwd {Path(src).stem}"
        out[name + " acc rel to float64"] = rel_rows(acc_o[:, :5],
                                                     band["acc64"][:, :5])
        out[name + " tree acc rel to float64"] = rel_rows(
            acc_b[:, :5], band["acc64"][:, :5])
        out[name + " -> tree bwd"] = rel(rc.raster_bwd(*bf, acc_o, g_b,
                                                        tile0=lo))
        out[name + " -> plain32"] = rel(rc.raster_bwd_plain(*bf, acc_o, g_b,
                                                             tile0=lo))
        for src_b in args.other_bwd:
            run = ab.runner(ab.build_other(Path(src_b)), "v3", src_b)
            out[f"{name} -> bwd {Path(src_b).stem}"] = rel(
                run(*bf, acc_o, g_b, tile0=lo))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-points", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--views", type=int, default=1)
    ap.add_argument("--cuts", type=int, nargs="*", default=[8])
    ap.add_argument("--band", action="store_true",
                    help="replay chip_smoke.py phase 17's band and split "
                    "B2's distance from float64")
    ap.add_argument("--repeat", type=int, default=1,
                    help="--band: train the pool this many times and split "
                    "the band where B2 lies farthest from float64")
    ap.add_argument("--other-bwd", action="append", default=[])
    ap.add_argument("--other-fwd", action="append", default=[])
    ap.add_argument("--output", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("raster_precision_torch: needs a CUDA device")
    if args.band:
        out = band_split(args)
        if args.output is not None:
            args.output.parent.mkdir(parents=True, exist_ok=True)
            args.output.write_text(json.dumps(out, indent=1))
        print(json.dumps(out))
        return 0

    import chip_smoke as C
    from mini3dgs_tpu_torch.ops import raster_cuda as rc
    from mini3dgs_tpu_torch.train.trainer import GaussianTrainer

    dev = torch.device("cuda", 0)
    tmp = Path(tempfile.mkdtemp(prefix="raster_precision_"))
    with contextlib.redirect_stdout(io.StringIO()):
        C.load_script("make_synthetic_scene_torch").main([
            "--out", str(tmp / "scene"), "--n-train", "8", "--n-test", "1",
            "--size", "800", "--spp", "1", "--device", "cuda"])
        with C.MethodTimes(GaussianTrainer, ["setup"], dev) as mt:
            C.load_script("train_1m_torch").main([
                "--scene", str(tmp / "scene"), "--iters", str(args.iters),
                "--steady", "0", "--n-points", str(args.n_points)])
    tr = mt.objects[0]
    views = []
    for v in range(args.views):
        proj = C.project_with(tr.state.gaussians, tr.train_cameras()[v],
                              tr.settings)
        b, stream = rc.tile_stream(proj, 800, 800, 32)
        fargs = (stream, b.tile_start, b.tile_count, 25, 32)
        acc_k = rc.raster_fwd(*fargs)
        gout = C.seeded_gout(acc_k, 1717)
        d_k = rc.raster_bwd(*fargs, acc_k, gout)
        torch.cuda.synchronize()
        t = time.perf_counter()
        acc32 = rc.raster_fwd_plain(*fargs)
        d32 = rc.raster_bwd_plain(*fargs, acc_k, gout)
        torch.cuda.synchronize()
        plain32_s = time.perf_counter() - t
        acc64 = rc.raster_fwd_plain(stream.double(), *fargs[1:])
        d64 = rc.raster_bwd_plain(stream.double(), *fargs[1:], acc64,
                                  gout.double())
        rows = slice(0, 5)
        out = {"view": v, "n_live": b.n_live,
               "heaviest_tile": int(b.tile_count.max()),
               "mean_tile": float(b.tile_count.float().mean()),
               "plain32_s": plain32_s,
               "fwd_rel_l2": {
                   "kernel_vs_plain32": rel_rows(acc_k[:, rows],
                                                 acc32[:, rows]),
                   "kernel_vs_plain64": rel_rows(acc_k[:, rows],
                                                 acc64[:, rows]),
                   "plain32_vs_plain64": rel_rows(acc32[:, rows],
                                                  acc64[:, rows])},
               "bwd_rel_l2": {"kernel_vs_plain32": rel_rows(d_k, d32),
                              "kernel_vs_plain64": rel_rows(d_k, d64),
                              "plain32_vs_plain64": rel_rows(d32, d64)},
               "cuts": {}}
        T = b.tile_start.shape[0]
        tile = torch.repeat_interleave(torch.arange(T, device=dev),
                                       b.tile_count.long())
        pos = torch.arange(b.n_live, device=dev) - b.tile_start.long()[tile]
        for k in args.cuts:
            key = pos * k // b.tile_count.long()[tile]
            ok = True
            for part in C.cut_ranges(stream, b.tile_start, b.tile_count, key,
                                     k):
                pa = (*part, 25, 32)
                acc_p = rc.raster_fwd(*pa)
                g_p = C.seeded_gout(acc_p, 1717)
                d_kp = rc.raster_bwd(*pa, acc_p, g_p)
                d_pp = rc.raster_bwd_plain(*pa, acc_p, g_p)
                with contextlib.redirect_stdout(io.StringIO()):
                    try:
                        C.gate_rows(d_kp, d_pp, "part")
                    except AssertionError:
                        ok = False
                out["cuts"].setdefault(str(k), []).append(
                    max(rel_rows(d_kp, d_pp)))
            out["cuts"][f"{k}_pass"] = ok
        views.append(out)
        print(json.dumps(out), flush=True)
    print(json.dumps({"points": args.n_points, "iters": args.iters,
                      "views": views}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
