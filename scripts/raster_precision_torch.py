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

Usage: python3 scripts/raster_precision_torch.py [--n-points 1000000]
           [--iters 30] [--views 1] [--cuts 8 16]
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-points", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--views", type=int, default=1)
    ap.add_argument("--cuts", type=int, nargs="*", default=[8])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("raster_precision_torch: needs a CUDA device")

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
