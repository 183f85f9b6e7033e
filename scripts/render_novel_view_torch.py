"""Render a turntable of novel views from a Gaussian PLY with the PyTorch
port (counterpart of scripts/render_novel_view.py).

Frames are written as float32 .npy arrays [4, H, W]: RGB composited over
the background, then alpha.  The last line of standard output is one JSON
object with the per-frame render times.

With --tile-shards N the frames come from the band-sharded renderer
(parallel/sharded.make_sharded_render) over a mesh of N ranks spread over
the visible CUDA devices (on one card they all share it); --ring makes the
bands exchange depth-rank-range segments around the ring, which needs a
PLY whose point count divides by N.

Usage: python scripts/render_novel_view_torch.py --ply model.ply \
           --output out/ [--n-frames 60] [--size 512] [--device cuda]
           [--tile-shards 1] [--ring]
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mini3dgs_tpu_torch.ops.renderer import RenderSettings, render  # noqa: E402
from mini3dgs_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from mini3dgs_tpu_torch.parallel.sharded import make_sharded_render  # noqa: E402
from mini3dgs_tpu_torch.utils.gaussian_ply import import_gaussians_ply  # noqa: E402
from mini3dgs_tpu_torch.utils.vis import turntable_cameras  # noqa: E402


def _bg(text: str):
    bg = tuple(float(v) for v in text.split(","))
    if len(bg) != 3:
        raise argparse.ArgumentTypeError("--bg takes three comma-separated "
                                         "values, e.g. 1,1,1")
    return bg


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ply", required=True, help="canonical 3DGS PLY")
    p.add_argument("--output", default="output/novel_views_torch")
    p.add_argument("--n-frames", type=int, default=60)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--sh-degree", type=int, default=0)
    p.add_argument("--color-mode", default="dc_sigmoid",
                   choices=("dc_sigmoid", "sh"))
    p.add_argument("--tile-size", type=int, default=16)
    p.add_argument("--bg", type=_bg, default=(0.0, 0.0, 0.0))
    p.add_argument("--device", default="cuda")
    p.add_argument("--tile-shards", type=int, default=1,
                   help="ranks of the mesh's tile axis (image bands)")
    p.add_argument("--ring", action="store_true",
                   help="ring exchange between the bands (parallel/ring.py)")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch.cuda.is_available() is "
                           "False; pass --device cpu to render on the CPU")
    g = import_gaussians_ply(args.ply, device=device)
    cams = turntable_cameras(args.n_frames, width=args.size,
                             image_height=args.size, device=device)
    settings = RenderSettings(image_height=args.size, image_width=args.size,
                              bg_color=args.bg, tile_size=args.tile_size,
                              color_mode=args.color_mode,
                              sh_degree=args.sh_degree, ring=args.ring)
    render_view = lambda cam: render(g, cam, settings)
    if args.tile_shards > 1 or args.ring:
        mesh = make_mesh(1, args.tile_shards,
                         devices=None if device.type == "cuda" else [device])
        sharded = make_sharded_render(settings, mesh)
        render_view = lambda cam: sharded(g, cam)
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    frame_ms = []
    with torch.no_grad():
        for i, cam in enumerate(cams):
            t0 = time.perf_counter()
            out = render_view(cam)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            rgba = torch.cat([out["image"], out["alpha"]], dim=0)
            np.save(out_dir / f"frame_{i:04d}.npy", rgba.cpu().numpy())
    print(json.dumps({"frames": len(cams), "size": args.size,
                      "device": (torch.cuda.get_device_name(device)
                                 if device.type == "cuda" else "cpu"),
                      "output": str(out_dir), "frame_ms": frame_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
