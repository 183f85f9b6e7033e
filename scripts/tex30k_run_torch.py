"""The texture scene's full training run with the PyTorch port, end to end:
make the scene on the card (scripts/make_synthetic_scene_torch.py
--texture, then --points-only --texture), export it as a COLMAP model
(scripts/export_colmap_scene_torch.py), then train it with
`main_torch.py --config configs/sdf_tex_30k.yaml`.

What it records, into --out: `train.log` (main_torch's output, each line
prefixed by the seconds since training began), `summary.json` (rewritten
at every evaluation, so a run cut by a time limit keeps what it reached:
the generator's seconds per view and one view's peak device memory, PSNR
and SSIM at each evaluation, peak and last n_alive, the mean step ms of
each log interval without the evaluations in it, the wall time, the
launches of the forward (B1) and backward (B2) raster kernels, nvidia-smi's
name and power limit, and on the card B1 and B2 on the trained scene's
first test view: times, bounds, the warps' hit share and the heaviest
tile), and `population.csv`
(scripts/population_curve.py of the log).  A scene already on disk is
reused.

Usage (on the card):
    python3 scripts/tex30k_run_torch.py [--out runs/tex30k_report]
        [--scene data/sdf_tex_scene] [--colmap data/sdf_tex_colmap]
        [--iterations N] [--size 800 --n-train 64 --n-test 8]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))


class StampedLog:
    """A stdout that copies each line to a file, prefixed by the seconds
    since `t0`, and keeps the (seconds, line) pairs."""

    def __init__(self, path: Path, t0: float):
        self.f, self.t0, self.buf, self.lines = open(path, "w"), t0, "", []

    def write(self, s: str) -> int:
        self.buf += s
        while "\n" in self.buf:
            line, self.buf = self.buf.split("\n", 1)
            t = time.perf_counter() - self.t0
            self.lines.append((t, line))
            self.f.write(f"{t:10.3f} {line}\n")
            self.f.flush()
        return len(s)

    def flush(self):
        self.f.flush()

    def close(self):
        self.f.close()


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"


def make_scene(args, summary: dict) -> None:
    import torch
    import export_colmap_scene_torch
    import make_synthetic_scene_torch
    from mini3dgs_tpu_torch.data import synthetic
    from mini3dgs_tpu_torch.train.trainer import resolve_device
    scene, colmap_dir = Path(args.scene), Path(args.colmap)
    if not (scene / "transforms_test.json").exists():
        common = ["--texture", "--out", str(scene)]
        t0 = time.perf_counter()
        make_synthetic_scene_torch.main(common + [
            "--size", str(args.size), "--n-train", str(args.n_train),
            "--n-test", str(args.n_test), "--device", args.device])
        summary["generate_s"] = time.perf_counter() - t0
        summary["generate_s_per_view"] = summary["generate_s"] / (
            args.n_train + args.n_test)
        make_synthetic_scene_torch.main(common + ["--points-only"])
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        R, T = synthetic.camera_pose(0.3, 0.6, 3.6)
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        synthetic.render_view(R, T, args.size, 2, texture=True, device=dev)
        summary["view_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                      - base)
    if not (colmap_dir / "sparse" / "0" / "points3D.bin").exists():
        t0 = time.perf_counter()
        export_colmap_scene_torch.main(["--src", str(scene), "--out",
                                        str(colmap_dir)])
        summary["export_s"] = time.perf_counter() - t0


def kernel_census(trainer, dev) -> dict:
    """B1 and B2 on the trained scene's first test view (tile 32, the
    active SH degree): n_live, the heaviest tile against the mean, the
    warps' patch x instance hits (scripts/ab_raster_fwd_torch.py), both
    kernels' ms (CUDA events, chip_smoke.cuda_ms) and bounds
    (chip_smoke.raster_bounds over this stream's pair classes)."""
    import torch
    import ab_raster_fwd_torch
    import chip_smoke
    from mini3dgs_tpu_torch.core.loss import gaussian_loss
    from mini3dgs_tpu_torch.ops import raster_cuda as rc
    from mini3dgs_tpu_torch.ops.projection import project_gaussians
    cam = trainer.dataset.get_test_cameras()[0]
    st = trainer.settings
    H, W, ts = cam.height, cam.width, st.tile_size
    with torch.no_grad():
        proj = project_gaussians(trainer.state.gaussians, cam,
                                 color_mode=st.color_mode,
                                 sh_degree=trainer.active_sh_degree())
        b, stream = rc.tile_stream(proj, H, W, ts)
    tiles_x = -(-W // ts)
    fargs = (stream, b.tile_start, b.tile_count, tiles_x, ts)
    acc = rc.raster_fwd(*fargs).requires_grad_(True)
    image = rc.compose_image(acc, H, W, ts, torch.tensor(
        st.bg_color, dtype=torch.float32, device=dev))[0]
    gout, = torch.autograd.grad(gaussian_loss(image, cam.image)[0], acc)
    bargs = (*fargs, acc.detach(), gout)
    pairs = chip_smoke.pair_counts(rc, *fargs)
    fwd_bound, bwd_bound = chip_smoke.raster_bounds(
        pairs, b.n_live, b.tile_start.shape[0], ts * ts, has_t0=False)
    return {
        "view": cam.image_name, "n_live": b.n_live,
        "heaviest_tile": int(b.tile_count.max()),
        "mean_tile": float(b.tile_count.float().mean()),
        "warp_hits": ab_raster_fwd_torch.warp_hits(*fargs), "pairs": pairs,
        "b1_ms": chip_smoke.cuda_ms(
            lambda: rc.raster_fwd(*fargs, ranges_checked=True), inner=4),
        "b1_bound_ms": fwd_bound,
        "b2_ms": chip_smoke.cuda_ms(
            lambda: rc.raster_bwd(*bargs, ranges_checked=True)),
        "b2_bound_ms": bwd_bound}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="runs/tex30k_report")
    ap.add_argument("--scene", default="data/sdf_tex_scene")
    ap.add_argument("--colmap", default="data/sdf_tex_colmap")
    ap.add_argument("--config", default="configs/sdf_tex_30k.yaml")
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--n-train", type=int, default=64)
    ap.add_argument("--n-test", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--output", default=None,
                    help="the trainer's output directory (default: the "
                         "config's)")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    summary = {"card": card_line(), "config": args.config}

    def dump():
        (out / "summary.json").write_text(json.dumps(summary, indent=1))

    make_scene(args, summary)
    dump()

    import main_torch
    from mini3dgs_tpu_torch.ops.cuda_library import LAUNCHES
    from mini3dgs_tpu_torch.train.trainer import GaussianTrainer

    argv_main = ["--config", args.config, "--data", args.colmap,
                 "--device", args.device]
    if args.iterations:
        argv_main += ["--iterations", str(args.iterations)]
    if args.output:
        argv_main += ["--output", args.output]
    t0 = time.perf_counter()
    log = StampedLog(out / "train.log", t0)
    evals = summary["evals"] = []
    trainers = []
    validate = GaussianTrainer.validate

    def timed_validate(self):
        trainers[:] = [self]
        v0 = time.perf_counter()
        m = validate(self)
        evals.append({"iteration": self.iteration, "psnr": m.get("psnr"),
                      "ssim": m.get("ssim"), "at_s": v0 - t0,
                      "seconds": time.perf_counter() - v0,
                      "n_alive": self.state.gaussians.num_alive(),
                      "launches_fwd": LAUNCHES["raster_fwd.launches"],
                      "launches_bwd": LAUNCHES["raster_bwd.launches"]})
        dump()
        return m

    LAUNCHES.update({"raster_fwd.launches": 0, "raster_bwd.launches": 0})
    GaussianTrainer.validate = timed_validate
    try:
        with contextlib.redirect_stdout(log):
            code = main_torch.main(argv_main)
    finally:
        GaussianTrainer.validate = validate
        log.close()
    summary.update(wall_s=time.perf_counter() - t0, rc=code,
                   launches_fwd=LAUNCHES["raster_fwd.launches"],
                   launches_bwd=LAUNCHES["raster_bwd.launches"])

    # mean step ms of each log interval, the evaluations inside it taken out
    steps = [(t, int(line[1:line.index("]")]), line) for t, line in log.lines
             if line.startswith("[") and line[1:line.index("]")].strip()
             .isdigit()]
    per, alive = [], []
    for (ta, ia, _), (tb, ib, _) in zip(steps, steps[1:]):
        ev = sum(e["seconds"] for e in evals if ta <= e["at_s"] < tb)
        per.append((tb - ta - ev) / (ib - ia) * 1e3)
    for _, _, line in steps:
        kv = dict(p.split("=") for p in line.split("]", 1)[1].split()
                  if "=" in p)
        if "n_alive" in kv:
            alive.append(int(float(kv["n_alive"])))
    summary.update(
        step_ms_median=float(np.median(per)) if per else None,
        step_ms_min=min(per) if per else None,
        step_ms_max=max(per) if per else None,
        log_intervals=len(per),
        n_alive_peak=max(alive) if alive else None,
        n_alive_last_densify=alive[-1] if alive else None,
        n_alive_final=evals[-1]["n_alive"] if evals else None,
        card_after=card_line())
    if trainers and trainers[0].device.type == "cuda":
        summary["kernels_on_trained_view"] = kernel_census(
            trainers[0], trainers[0].device)
    dump()
    plain = out / "train_plain.log"
    plain.write_text("".join(line + "\n" for _, line in log.lines))
    subprocess.run([sys.executable, str(REPO / "scripts" /
                                        "population_curve.py"),
                    str(plain), "--csv", str(out / "population.csv")],
                   check=True)
    print(json.dumps(summary))
    return code


if __name__ == "__main__":
    sys.exit(main())
