"""Time the tree's forward raster kernel against other builds of it.

Runs on a CUDA device.  The forward's counterpart of
scripts/ab_raster_bwd_torch.py, whose helpers and cases it uses: each
`--other SOURCE.cu` (a copy of an earlier `csrc/raster_fwd.cu`, say from
`git show HEAD~1:...`, or a variant of the tree's) is built on its own with
the tree's nvcc flags, ptxas' report printed, and timed in turns with the
tree's kernel within this one process on this one card: others, tree, tree,
others reversed.  Every kernel, the tree's too, is launched through the same
thin runner (an empty output, one ctypes call); every source since the
first has the same C interface.  The cases are those of `chip_smoke.py`:

- B1: the build without `t0` on the bench-view stream of the flagship scene
  (100,000 Gaussians, SH 3, 800x800) after 6 train steps, at tile 32 and
  tile 16;
- B3: the build with `t0` as the 25 launches of one ring step with 5 ranks
  on the card (pool 131,075, after 4 ring steps), summed, and the slowest
  launch, at tile 32 and tile 16.

Each case also says what the tree's kernel is given to do: the heaviest
tile's instance count over the mean (for B3 the largest such ratio of a
launch), and the patch x instance pairs of its warps that the reject rule
lets through: of all pairs, and of the pairs in chunks where the warp still
has an open pixel (from the plain version's transmittance).

A time is the median of 5 CUDA-event timings (`chip_smoke.cuda_ms`), each
spanning 4 launches back to back.  The first `--other` is also held against
the tree's kernel (largest |difference| of the accumulators).

Prints one JSON object that names the card and its power limit; --output
also writes it to a file.

Usage: python3 scripts/ab_raster_fwd_torch.py --other build/ab/old_fwd.cu
           [--other build/ab/variant.cu ...] [--output build/ab_fwd.json]
"""

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

import ab_raster_bwd_torch as ab

chip_smoke, cl, rc = ab.chip_smoke, ab.cl, ab.rc
SIZE, RANKS = ab.SIZE, ab.RANKS


def runner(lib: ctypes.CDLL, name: str):
    """A function with `rc.raster_fwd`'s arguments that launches `lib`'s
    forward kernel."""
    for entry in ("raster_fwd_launch", "raster_fwd_t0_launch"):
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = cl.SIGNATURES[entry], ctypes.c_int

    def run(stream, start, count, tiles_x, ts, t0=None, tile0=0):
        T = start.shape[0]
        out = torch.empty(T, rc.N_ACC, ts * ts, device=stream.device)
        head = (stream.data_ptr(), stream.shape[1], start.data_ptr(),
                count.data_ptr(), T, tiles_x, ts, tile0)
        cuda_stream = torch.cuda.current_stream().cuda_stream
        if t0 is None:
            code = lib.raster_fwd_launch(*head, out.data_ptr(), cuda_stream)
        else:
            code = lib.raster_fwd_t0_launch(*head, t0.data_ptr(),
                                            out.data_ptr(), cuda_stream)
        if code != 0:
            raise RuntimeError(f"{name}: launch failed, CUDA error {code}")
        return out
    return run


def warp_hits(stream, start, count, tiles_x, ts, t0=None, tile0=0) -> dict:
    """Patch x instance pairs of the kernel's warps (one pixel a thread,
    `rc.thread_pixels`): `pairs` all of them, `hits` those the reject rule
    lets through; `open_pairs` and `open_hits` the same in the chunks of 64
    where the warp still has an open pixel."""
    T, P = start.shape[0], ts * ts
    n = dict(pairs=0, hits=0, open_pairs=0, open_hits=0)
    if stream.shape[1] == 0:
        return n
    dev = stream.device
    # [patches, 32] pixels of each warp's patch, and its origin.
    patches = torch.cat([rc.thread_pixels(ts, 1, q).reshape(8, -1)
                         for q in range(P // 256)]).to(dev)
    x0 = (patches % ts).amin(1).float()
    y0 = torch.div(patches, ts, rounding_mode="floor").amin(1).float()
    tile = tile0 + torch.arange(T, device=dev)
    ox = ((tile % tiles_x) * ts).float()[:, None, None]
    oy = (torch.div(tile, tiles_x, rounding_mode="floor") * ts).float()[
        :, None, None]
    px, py = rc._pixel_coords(T, tiles_x, ts, dev, tile0)
    trans = torch.ones(T, P, device=dev) if t0 is None else t0.reshape(T, P)
    lanes = torch.arange(64, device=dev)[None, :]
    st, ct = start.long()[:, None], count.long()[:, None]
    for base in range(0, int(count.max()), 64):
        warp_open = ((1.0 - trans) < rc.EARLY_STOP_A)[:, patches].any(-1)
        m = rc._slice_terms(stream, st, ct, px, py, trans, base, lanes)
        hit = ~rc.patch_missed(stream[:, m["idx"]][:, :, None, :],
                               ox + x0[None, :, None], oy + y0[None, :, None],
                               rc.PATCH_W, rc.LANE_ROWS)  # [T, W, G]
        valid = m["valid"][:, None, :].expand_as(hit)
        opened = valid & warp_open[:, :, None]
        n["pairs"] += int(valid.sum())
        n["hits"] += int((hit & valid).sum())
        n["open_pairs"] += int(opened.sum())
        n["open_hits"] += int((hit & opened).sum())
        trans = m["trans"]
    return n


def heaviest_over_mean(count: torch.Tensor) -> float:
    return float(count.max()) / max(float(count.float().mean()), 1e-30)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", action="append", default=[],
                   help="SOURCE.cu")
    p.add_argument("--output", type=Path, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_raster_fwd_torch: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = ab.card()

    built = cl.kernel_library()
    print("the tree's kernels:")
    for line in ab.ptxas_lines(built.build_log):
        print(f"    ptxas: {line}")
    blocks = {f"tile{ts}{'_t0' if t0 else ''}":
              built.lib.raster_fwd_blocks_per_sm(ts, t0)
              for ts in (16, 32) for t0 in (0, 1)}
    kernels = {"tree": runner(built.lib, "tree")}
    for other in args.other:
        kernels[Path(other).stem] = runner(ab.build_other(Path(other)), other)
    first_other = next((k for k in kernels if k != "tree"), None)

    target, proj_one, proj_ring = ab.trained_projections(dev)
    result = {"card": smi, "device": torch.cuda.get_device_name(0),
              "blocks_per_sm": blocks, "cases": {}}
    for ts in (32, 16):
        tiles_x = SIZE // ts
        # B1: one launch over the whole image.
        b, stream = rc.tile_stream(proj_one, SIZE, SIZE, ts)
        fargs = (stream, b.tile_start, b.tile_count, tiles_x, ts)
        T = b.tile_start.shape[0]
        case = {"n_live": b.n_live, "tiles": T,
                "heaviest_over_mean": heaviest_over_mean(b.tile_count),
                "warp_hits": warp_hits(*fargs),
                "ms": ab.in_turns(kernels, lambda fn: chip_smoke.cuda_ms(
                    lambda: fn(*fargs), inner=4))}
        if first_other:
            case["tree_vs_" + first_other] = float(
                (kernels["tree"](*fargs) - kernels[first_other](*fargs))
                .abs().max())
        result["cases"][f"B1 tile{ts}"] = case
        print(f"B1 tile {ts}: {json.dumps(case)}", flush=True)

        # B3: the 25 launches of a ring step.
        segs, t_in, _, _, _ = chip_smoke.ring_step_launches(
            rc, proj_ring, target, RANKS, ts, SIZE)
        ntb = (SIZE // ts // RANKS) * tiles_x
        launch = {key: (*seg, tiles_x, ts) for key, seg in segs.items()}
        kw = {key: dict(t0=t_in[key], tile0=key[0] * ntb) for key in segs}

        def ring_ms(fn):
            times = [chip_smoke.cuda_ms(lambda: fn(*launch[key], **kw[key]),
                                        inner=4) for key in segs]
            return {"sum": float(np.sum(times)), "slowest": max(times)}
        hits = dict(pairs=0, hits=0, open_pairs=0, open_hits=0)
        for key in segs:
            for k, v in warp_hits(*launch[key], **kw[key]).items():
                hits[k] += v
        case = {"n_live": sum(seg[0].shape[1] for seg in segs.values()),
                "tiles": ntb,
                "heaviest_over_mean": max(
                    heaviest_over_mean(seg[2]) for seg in segs.values()
                    if seg[0].shape[1]),
                "warp_hits": hits, "ms": ab.in_turns(kernels, ring_ms)}
        if first_other:
            case["tree_vs_" + first_other] = max(
                float((kernels["tree"](*launch[key], **kw[key])
                       - kernels[first_other](*launch[key], **kw[key]))
                      .abs().max()) for key in segs)
        result["cases"][f"B3 tile{ts}"] = case
        print(f"B3 tile {ts}: {json.dumps(case)}", flush=True)

    if args.output is not None:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        args.output.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
