"""Generate the procedural SDF benchmark scene in the NeRF-synthetic layout
with the PyTorch port (counterpart of scripts/make_synthetic_scene.py, with
the same flags plus --device).

Each view is ray-marched on the card (`data/synthetic.render_view`) and
written as an RGBA PNG through the port's own codec, beside
`transforms_{train,test}.json`: train views on a deterministic spiral over
the upper hemisphere, test views drawn from default_rng(0).  --points-only
writes the seed point cloud `points3d.ply` and renders nothing.  The
texture scene of configs/sdf_tex_30k.yaml takes both calls, then the
COLMAP export:

    python scripts/make_synthetic_scene_torch.py --texture --out data/sdf_tex_scene
    python scripts/make_synthetic_scene_torch.py --texture --points-only --out data/sdf_tex_scene
    python scripts/export_colmap_scene_torch.py --src data/sdf_tex_scene --out data/sdf_tex_colmap

Usage:
    python scripts/make_synthetic_scene_torch.py --out data/sdf_scene
        [--n-train 64] [--n-test 8] [--size 800] [--spp 2] [--texture]
        [--points-only] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=str, default="data/sdf_scene")
    ap.add_argument("--n-train", type=int, default=64)
    ap.add_argument("--n-test", type=int, default=8)
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--radius", type=float, default=3.6)
    ap.add_argument("--points-only", action="store_true",
                    help="only (re)write points3d.ply, no rendering")
    ap.add_argument("--n-points", type=int, default=30000,
                    help="surface samples for the seed point cloud")
    ap.add_argument("--points-name", type=str, default="points3d.ply")
    ap.add_argument("--texture", action="store_true",
                    help="texture-dense albedos (5-15px procedural cells): "
                         "the canonical-densification benchmark variant")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from mini3dgs_tpu_torch.data import synthetic
    from mini3dgs_tpu_torch.train.trainer import resolve_device
    from mini3dgs_tpu_torch.utils import png
    from mini3dgs_tpu_torch.utils.io import save_ply

    out = Path(args.out)
    if args.points_only:
        out.mkdir(parents=True, exist_ok=True)
        pts, cols = synthetic.sample_surface_points(n=args.n_points,
                                                    texture=args.texture)
        save_ply(pts, cols, str(out / args.points_name))
        print(f"wrote {len(pts)} surface points to {out/args.points_name}")
        return 0

    device = resolve_device(args.device)
    (out / "train").mkdir(parents=True, exist_ok=True)
    (out / "test").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)

    def make_split(name, n, stratified):
        frames = []
        for i in range(n):
            if stratified:  # deterministic spiral over the upper hemisphere
                theta = 2 * math.pi * (i * 0.618034 % 1.0)
                phi = math.radians(10 + 60 * ((i * 0.381966) % 1.0))
            else:
                theta = float(rng.uniform(0, 2 * math.pi))
                phi = float(rng.uniform(math.radians(15), math.radians(65)))
            R, T = synthetic.camera_pose(theta, phi, args.radius)
            t0 = time.perf_counter()
            img = synthetic.render_view(R, T, args.size, args.spp,
                                        texture=args.texture,
                                        device=device).cpu().numpy()
            seconds = time.perf_counter() - t0
            # A pixel whose subsamples both hit and miss the scene carries
            # NaN colour (a missed ray's normal is inf - inf, and NaN * 0 is
            # NaN), as in the JAX renderer; it is written as 0, as numpy's
            # cast writes it there.
            rgba = (np.clip(np.nan_to_num(img, nan=0.0), 0, 1)
                    * 255).astype(np.uint8)
            fname = f"{name}/r_{i}"
            (out / f"{fname}.png").write_bytes(png.encode(rgba))
            frames.append({"file_path": f"./{fname}",
                           "rotation": 0.0,
                           "transform_matrix":
                               synthetic.to_blender_c2w(R, T).tolist()})
            print(f"  {fname}: alpha={img[..., 3].mean():.3f} "
                  f"({seconds:.3f} s)", flush=True)
        meta = {"camera_angle_x": synthetic.FOVX, "frames": frames}
        with open(out / f"transforms_{name}.json", "w") as f:
            json.dump(meta, f, indent=1)

    print(f"rendering {args.n_train} train views at {args.size}^2 on "
          f"{device} ...", flush=True)
    make_split("train", args.n_train, stratified=True)
    print(f"rendering {args.n_test} test views ...", flush=True)
    make_split("test", args.n_test, stratified=False)
    print(f"scene written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
