"""How often the backward raster kernel's per-patch reject can skip work.

Counts, for the flagship scene's bench view (100,000 Gaussians, SH 3,
800x800, untrained; `chip_smoke.py`'s phase 4), over every instance of
every tile's list: the half-extent in x of its footprint w >= 1e-5, and
the share of patch x instance pairs that `raster_cuda.patch_missed` does
not reject, for several patch shapes.  These are counts, not times: it
runs on the card by default, and `--device cpu` counts on the CPU (about
half a minute).

Usage: python3 scripts/patch_hits_torch.py [--device cuda|cpu] [--size 800]
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from mini3dgs_tpu_torch import convert  # noqa: E402
from mini3dgs_tpu_torch.ops import binning as B  # noqa: E402
from mini3dgs_tpu_torch.ops import raster_cuda as rc  # noqa: E402
from mini3dgs_tpu_torch.ops.projection import project_gaussians  # noqa: E402

N, CAPACITY = 100_000, 2 ** 17
PATCHES = ((8, 4), (8, 8), (16, 8), (16, 16), (32, 1))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--size", type=int, default=800)
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    params, alive, cam = convert.flagship_scene_numpy(CAPACITY, N, seed=0)
    params["features_rest"][:N] = np.random.default_rng(1).normal(
        0.0, 0.1, (N, 15, 3))
    g = convert.gaussians_from_numpy(params, alive, dev)
    camera = convert.camera_from_numpy(**cam, width=args.size,
                                       height=args.size, device=dev)
    proj = project_gaussians(g, camera, color_mode="sh", sh_degree=3)
    result = {"device": str(dev), "size": args.size, "tiles": {}}
    for ts in rc.KERNEL_TILE_SIZES:
        b, stream = rc.tile_stream(proj, args.size, args.size, ts)
        tiles_x = -(-args.size // ts)
        tile = torch.repeat_interleave(
            torch.arange(b.tile_start.shape[0], device=dev),
            b.tile_count.long())
        ox, oy = (tile % tiles_x) * ts, (tile // tiles_x) * ts
        A, Bq, C = (-stream[r].double() for r in (B.ROW_QA, B.ROW_QB,
                                                  B.ROW_QC))
        reach = torch.sqrt(-np.log(1e-5) * C / (A * C - Bq * Bq / 4))
        row = {"n_live": b.n_live,
               "median_tile_count": float(b.tile_count.float().median()),
               "max_tile_count": int(b.tile_count.max()),
               "half_extent_x_median": float(reach.median()),
               "half_extent_x_p90": float(reach.quantile(0.9)),
               "hit_share": {}}
        for w, h in PATCHES:
            if w > ts or h > ts:
                continue
            hits = 0
            for py in range(0, ts, h):
                for px in range(0, ts, w):
                    hits += int((~rc.patch_missed(stream, ox + px, oy + py,
                                                  w, h)).sum())
            row["hit_share"][f"{w}x{h}"] = hits / (
                b.n_live * (ts // w) * (ts // h))
        result["tiles"][str(ts)] = row
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
