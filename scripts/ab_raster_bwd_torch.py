"""Time the tree's backward raster kernel against other builds of it.

Runs on a CUDA device.  Each `--other SOURCE.cu` (a copy of an earlier
`csrc/raster_bwd.cu`, say from `git show HEAD~1:...`, or a variant cut down
to see where its time goes) is built on its own with the tree's nvcc flags,
ptxas' report printed, and timed in turns with the tree's kernel within this
one process on this one card: others, tree, tree, others reversed.  Every
kernel, the tree's too, is launched through the same thin runner (zero fill
of the gradient, scratch, one ctypes call), so that the host's share of a
timing is the same for all.  The cases are those of `chip_smoke.py`:

- B2: the build without `t0` on the bench-view stream of the flagship scene
  (100,000 Gaussians, SH 3, 800x800) after 6 train steps, with the loss's
  own cotangent, at tile 32 and tile 16;
- B4: the build with `t0` as the 25 launches of one ring step with 5 ranks
  on the card (pool 131,075, after 4 ring steps), summed, and the slowest
  launch, at tile 32 and tile 16.

A time is the median of 5 CUDA-event timings (`chip_smoke.cuda_ms`), each
spanning 4 launches back to back so that the card, not the host, sets it.
Every timing includes the zero fill of the gradient, as the wrapper makes
it.  An `--other` source has the C interface `--other-abi` names, or the
one after a colon (`old.cu:v1`): `v1` is (..., oraw, gout, [t0,] d_inst,
[dt0,] stream), `v2` that with the scratch buffers before the stream, `v3`
the tree's, `v2` without `oraw`.  The first `--other` is also held against the tree's kernel
(largest difference of a row over the row's largest entry).

Prints one JSON object that names the card and its power limit; --output
also writes it to a file.

Usage: python3 scripts/ab_raster_bwd_torch.py --other build/ab/old.cu
           [--other build/ab/variant.cu:v2 ...] [--other-abi v1]
           [--output build/ab_raster_bwd.json]
"""

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from mini3dgs_tpu_torch import convert  # noqa: E402
from mini3dgs_tpu_torch.config import TrainingConfig  # noqa: E402
from mini3dgs_tpu_torch.core.gaussians import scene_extent_of  # noqa: E402
from mini3dgs_tpu_torch.core.loss import gaussian_loss  # noqa: E402
from mini3dgs_tpu_torch.ops import cuda_library as cl  # noqa: E402
from mini3dgs_tpu_torch.ops import raster_cuda as rc  # noqa: E402
from mini3dgs_tpu_torch.ops.projection import project_gaussians  # noqa: E402
from mini3dgs_tpu_torch.ops.renderer import RenderSettings, render  # noqa: E402
from mini3dgs_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from mini3dgs_tpu_torch.parallel.sharded import make_sharded_train_step  # noqa: E402
from mini3dgs_tpu_torch.train import trainer  # noqa: E402

SIZE, N = chip_smoke.VIEW_SIZE, chip_smoke.N_GAUSSIANS
RANKS = chip_smoke.RING_RANKS


def card() -> str:
    """nvidia-smi's name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def ptxas_lines(log: str):
    return [line.strip() for line in log.splitlines()
            if "Compiling entry" in line or "registers" in line
            or "spill" in line]


def build_other(source: Path) -> ctypes.CDLL:
    """Compile `source` alone into a library of its own; its includes are
    looked up in the tree's `csrc/` too."""
    out = cl.BUILD_DIR / "ab" / f"{source.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    done = subprocess.run([cl._nvcc(), *cl.NVCC_FLAGS, "-I", str(cl.CSRC_DIR),
                           "-shared", "-o", str(out), str(source)],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{done.stdout}"
                           f"{done.stderr}")
    print(f"built {source}:")
    for line in ptxas_lines(done.stdout + done.stderr):
        print(f"    ptxas: {line}")
    return ctypes.CDLL(str(out))


def runner(lib: ctypes.CDLL, abi: str, name: str):
    """A function with `rc.raster_bwd`'s arguments that launches `lib`'s
    backward kernel through its C interface `abi`."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    head = [ptr, ctypes.c_longlong, ptr, ptr, i32, i32, i32, i32]
    oraw = abi in ("v1", "v2")
    n = 3 + oraw + (0 if abi == "v1" else 2)
    lib.raster_bwd_launch.argtypes = head + [ptr] * n
    lib.raster_bwd_t0_launch.argtypes = head + [ptr] * (n + 2)
    lib.raster_bwd_launch.restype = lib.raster_bwd_t0_launch.restype = i32

    def run(stream, start, count, tiles_x, ts, acc, gout, t0=None, tile0=0):
        d = torch.zeros_like(stream)
        T = start.shape[0]
        tail = [torch.cuda.current_stream().cuda_stream]
        if abi != "v1":
            quads = (ts // rc.SUB_TILE) ** 2
            part = torch.empty(quads, *stream.shape, device=stream.device)
            sync = torch.zeros((1 + quads) * T, dtype=torch.int32,
                               device=stream.device)
            tail = [part.data_ptr(), sync.data_ptr()] + tail
        head = (stream.data_ptr(), stream.shape[1], start.data_ptr(),
                count.data_ptr(), T, tiles_x, ts, tile0,
                *([acc.data_ptr()] if oraw else []), gout.data_ptr())
        if t0 is None:
            code = lib.raster_bwd_launch(*head, d.data_ptr(), *tail)
            result = d
        else:
            d_t0 = torch.empty_like(t0)
            code = lib.raster_bwd_t0_launch(*head, t0.data_ptr(), d.data_ptr(),
                                            d_t0.data_ptr(), *tail)
            result = (d, d_t0)
        if code != 0:
            raise RuntimeError(f"{name}: launch failed, CUDA error {code}")
        return result
    return run


def row_error(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    return float(((got - want).abs() / scale).max())


def in_turns(kernels: dict, measure) -> dict:
    """`measure(fn)` for every kernel, the tree's in the middle: others,
    tree, tree, others reversed.  Returns name -> list of two readings."""
    others = [k for k in kernels if k != "tree"]
    out = {k: [] for k in kernels}
    for name in (*others, "tree", "tree", *reversed(others)):
        out[name].append(measure(kernels[name]))
    return out


def trained_projections(dev):
    """The states of chip_smoke.py's phases 7 and 11 (the flagship scene
    trained for 6 steps on one device, and for 4 ring steps with 5 ranks
    on the card, towards a render of the seed-7 scene), projected into the
    bench view: (target image, single-device projection, ring projection).
    """
    settings = RenderSettings(image_height=SIZE, image_width=SIZE,
                              bg_color=(1.0, 1.0, 1.0), tile_size=32,
                              color_mode="sh", sh_degree=3)
    t_params, t_alive, cam = convert.flagship_scene_numpy(
        chip_smoke.CAPACITY, N, seed=7)
    t_params["features_rest"][:N] = np.random.default_rng(1).normal(
        0.0, 0.1, (N, 15, 3))
    camera = convert.camera_from_numpy(**cam, width=SIZE, height=SIZE,
                                       device=dev)
    with torch.no_grad():
        target = render(convert.gaussians_from_numpy(t_params, t_alive, dev),
                        camera, settings)["image"]
    camera = camera.replace(image=target)

    def trained(capacity, steps, sharded):
        params, alive, _ = convert.flagship_scene_numpy(capacity, N, seed=0)
        g = convert.gaussians_from_numpy(params, alive, dev)
        config = trainer.scale_position_lr(TrainingConfig(
            iterations=steps, image_height=SIZE, image_width=SIZE,
            tile_size=32, color_mode="sh", sh_degree=3, capacity=capacity,
            background_color=[1.0, 1.0, 1.0]), float(scene_extent_of(g)))
        if sharded:
            config = dataclasses.replace(config, mesh_tile=RANKS,
                                         ring_exchange=True)
            ring_step = make_sharded_train_step(
                config, settings.replace(ring=True),
                make_mesh(data=1, tile=RANKS, devices=[dev]))
            step = lambda st: ring_step(st, [camera])
        else:
            step = lambda st: trainer.train_step(st, camera, config, settings)
        state = trainer.create_train_state(g, config)
        for _ in range(steps):
            state, _ = step(state)
        return project_gaussians(state.gaussians, camera, color_mode="sh",
                                 sh_degree=3)

    proj_one = trained(chip_smoke.CAPACITY, chip_smoke.TRAIN_STEPS, False)
    proj_ring = trained(chip_smoke.RING_CAPACITY, chip_smoke.RING_STEPS, True)
    return target, proj_one, proj_ring


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", action="append", default=[],
                   help="SOURCE.cu or SOURCE.cu:ABI")
    p.add_argument("--other-abi", choices=("v1", "v2", "v3"), default="v1")
    p.add_argument("--output", type=Path, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_raster_bwd_torch: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = card()

    built = cl.kernel_library()
    print("the tree's kernels:")
    for line in ptxas_lines(built.build_log):
        print(f"    ptxas: {line}")
    blocks = {f"tile{ts}_pix{pix}{'_t0' if t0 else ''}":
              built.lib.raster_bwd_blocks_per_sm(ts, pix, t0)
              for ts, pix in ((16, 1), (32, 1), (32, 2)) for t0 in (0, 1)}
    kernels = {"tree": runner(built.lib, "v3", "tree")}
    for other in args.other:
        source, _, abi = other.partition(":")
        kernels[Path(source).stem] = runner(build_other(Path(source)),
                                            abi or args.other_abi, source)

    target, proj_one, proj_ring = trained_projections(dev)
    result = {"card": smi, "device": torch.cuda.get_device_name(0),
              "blocks_per_sm": blocks, "cases": {}}
    first_other = next((k for k in kernels if k != "tree"), None)

    for ts in (32, 16):
        tiles_x = SIZE // ts
        # B2: one launch over the whole image.
        b, stream = rc.tile_stream(proj_one, SIZE, SIZE, ts)
        fargs = (stream, b.tile_start, b.tile_count, tiles_x, ts)
        acc = rc.raster_fwd(*fargs).requires_grad_(True)
        image = rc.compose_image(acc, SIZE, SIZE, ts,
                                 torch.ones(3, device=dev))[0]
        gout, = torch.autograd.grad(gaussian_loss(image, target)[0], acc)
        bargs = (*fargs, acc.detach(), gout)
        case = {"n_live": b.n_live, "ms": in_turns(
            kernels, lambda fn: chip_smoke.cuda_ms(lambda: fn(*bargs), inner=4))}
        if first_other:
            case["tree_vs_" + first_other] = row_error(
                kernels["tree"](*bargs), kernels[first_other](*bargs))
        result["cases"][f"B2 tile{ts}"] = case
        print(f"B2 tile {ts}: {json.dumps(case)}", flush=True)

        # B4: the 25 launches of a ring step.
        segs, t_in, acc_seg, g_in, _ = chip_smoke.ring_step_launches(
            rc, proj_ring, target, RANKS, ts, SIZE)
        ntb = (SIZE // ts // RANKS) * tiles_x

        def ring_ms(fn):
            times = [chip_smoke.cuda_ms(
                lambda: fn(*seg, tiles_x, ts, acc_seg[key], g_in[key],
                           t0=t_in[key], tile0=key[0] * ntb), inner=4)
                for key, seg in segs.items()]
            return {"sum": float(np.sum(times)), "slowest": max(times)}
        case = {"n_live": sum(seg[0].shape[1] for seg in segs.values()),
                "ms": in_turns(kernels, ring_ms)}
        if first_other:
            errs = []
            for key, seg in segs.items():
                if seg[0].shape[1] == 0:
                    continue
                a = (*seg, tiles_x, ts, acc_seg[key], g_in[key])
                kw = dict(t0=t_in[key], tile0=key[0] * ntb)
                (d_a, t_a), (d_b, t_b) = (kernels["tree"](*a, **kw),
                                          kernels[first_other](*a, **kw))
                errs.append(max(row_error(d_a, d_b), row_error(
                    t_a.reshape(1, -1), t_b.reshape(1, -1))))
            case["tree_vs_" + first_other] = max(errs)
        result["cases"][f"B4 tile{ts}"] = case
        print(f"B4 tile {ts}: {json.dumps(case)}", flush=True)

    if args.output is not None:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        args.output.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
