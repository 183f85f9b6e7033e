"""Training-quality parity gate for the PyTorch port (counterpart of
scripts/train_path_parity.py): two training runs of the port's
`GaussianTrainer` on the same scene, camera schedule and initial
Gaussians, one through the hand-written tile kernels (`tiles`: B1 forward,
B2 backward) and one through the golden compositor and its autograd
(`golden`, ops/raster_ref.py), must end at the same validation PSNR within
--gate-db.  Per-step float32 differences (early-stop flips between exp
implementations, summation order) random-walk under Adam, so the gate is on
the final metric, not the trajectory.

The setting is the JAX script's: RandomDataset(n_cameras=6, seed=3) at
--size^2, --iters iterations, a pool of 4096, seed 7, tile 32, SH 0
(dc_sigmoid), densify every 100 from 500 to iters/2, prune every 1000, no
opacity reset.  With --against FILE the `tiles` route is also held
against a record of the JAX package's golden route at the same setting
(docs/artifacts/train_path_parity_jax{,_256}.json, written on a CPU host
by scripts/train_path_record_jax.py).  That setting (`--setting optimum`)
starts at its optimum (the targets are renders of the initial Gaussians),
so the final PSNR is one draw of a noise-driven walk: at 64^2 it moves by
several dB between two runs of the same code on the card, at 256^2 by
about 0.1 dB.  `--setting other_targets` keeps the start (seed 3's cloud,
trainer seed 7) and trains towards golden renders of other Gaussians,
RandomDataset(seed TARGET_SEED)'s cloud, from the same cameras: render
and target differ by far more than float32 noise, so the runs can be
compared step by step: with --against a record that holds every loss
(docs/artifacts/train_path_parity_jax_other_targets.json) the tiles
route's largest relative distance from those losses is reported.

Each route prints its PSNR, SSIM, n_alive, seconds and the launches of B1
and B2; the last line is one JSON object with all of it and the verdict.
Exit code 0 when the gate passes.

Usage:  python scripts/train_path_parity_torch.py [--iters 1000] [--size 256]
            [--device cuda|cpu] [--setting optimum|other_targets]
            [--against docs/artifacts/train_path_parity_jax_256.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SETTINGS = ("optimum", "other_targets")
# The seed of the cloud whose renders are the targets of `other_targets`.
TARGET_SEED = 11


def parity_config(args, route: str):
    """The JAX script's TrainingConfig (train_path_parity.py:35-46) in the
    port's fields, on --device."""
    from mini3dgs_tpu_torch.config import TrainingConfig
    return TrainingConfig(
        capacity=args.capacity, iterations=args.iters,
        image_height=args.size, image_width=args.size,
        eval_interval=10 ** 9, save_interval=10 ** 9, log_interval=200,
        densify_from_iter=500, densify_until_iter=args.iters // 2,
        densify_interval=100, opacity_reset_interval=0,
        prune_interval=1000, position_lr_max_steps=args.iters,
        tile_size=32, sh_degree=0, color_mode="dc_sigmoid",
        use_pallas=route == "tiles", seed=7, device=args.device)


def make_trainer(args, route: str):
    """A set-up `GaussianTrainer` of `route` on RandomDataset(6 cameras):
    targets rendered from seed 3's cloud (`optimum`) or from seed
    TARGET_SEED's (`other_targets`); either way the trainer starts from
    seed 3's cloud, which the dataset's point cloud is once its targets
    are rendered."""
    from mini3dgs_tpu_torch.data.dataset import RandomDataset
    from mini3dgs_tpu_torch.train.trainer import GaussianTrainer
    tr = GaussianTrainer(parity_config(args, route))
    ds = RandomDataset(n_cameras=6, width=args.size, height=args.size,
                       seed=TARGET_SEED if args.setting == "other_targets"
                       else 3, device=tr.device)
    ds.load_cameras()
    ds.seed = 3
    tr.setup(dataset=ds)
    return tr


def run_route(route: str, args, log=print, every_loss: bool = False) -> dict:
    """Train one route; its final validation metrics, n_alive, seconds of
    training (host clock up to a synchronise) and the kernels' launches
    in training and validation; with `every_loss` also every iteration's
    loss (logged every iteration, which leaves the run as it is)."""
    import dataclasses

    import torch
    from mini3dgs_tpu_torch.ops.cuda_library import LAUNCHES
    tr = make_trainer(args, route)
    if every_loss:
        tr.config = dataclasses.replace(tr.config, log_interval=1)
    losses = {}

    def log_fn(it, m):
        losses[it] = m["total_loss"]
        if it % 200 == 0:
            log(f"  [{route} {it:5d}] loss={m['total_loss']:.5f}")

    LAUNCHES.update({"raster_fwd.launches": 0, "raster_bwd.launches": 0})
    t0 = time.perf_counter()
    tr.train(log_fn=log_fn)
    if tr.device.type == "cuda":
        torch.cuda.synchronize(tr.device)
    seconds = time.perf_counter() - t0
    m = tr.validate()
    res = {"psnr": m["psnr"], "ssim": m["ssim"], "seconds": seconds,
           "n_alive": int(tr.state.gaussians.num_alive()),
           "launches_fwd": LAUNCHES["raster_fwd.launches"],
           "launches_bwd": LAUNCHES["raster_bwd.launches"]}
    if every_loss:
        res["losses"] = [losses[it] for it in sorted(losses)]
    return res


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--gate-db", type=float, default=0.5)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--setting", choices=SETTINGS, default="optimum",
                    help="optimum: the targets are renders of the initial "
                         "Gaussians; other_targets: of seed TARGET_SEED's")
    ap.add_argument("--against", type=str, default=None,
                    help="a JAX record (JSON); the tiles route is gated "
                         "against its PSNR")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    record = None
    if args.against:
        record = json.loads(Path(args.against).read_text())
        setting = record.get("setting", "optimum")
        if (record["size"], record["iters"], setting) != (
                args.size, args.iters, args.setting):
            raise SystemExit(f"{args.against} is a record at "
                             f"{record['size']}^2 / {record['iters']} "
                             f"iterations; pass --size {record['size']} "
                             f"--iters {record['iters']} --setting "
                             f"{setting}")
    res = {}
    for route in ("tiles", "golden"):
        print(f"--- training {route} route ({args.iters} it, "
              f"{args.size}^2, {args.device}, {args.setting}) ---",
              flush=True)
        r = res[route] = run_route(
            route, args, log=lambda s: print(s, flush=True),
            every_loss=route == "tiles" and record is not None
            and "losses" in record)
        print(f"{route}: psnr={r['psnr']:.4f} ssim={r['ssim']:.4f} "
              f"alive={r['n_alive']} ({r['seconds']:.1f} s) launches "
              f"fwd/bwd {r['launches_fwd']}/{r['launches_bwd']}", flush=True)
    gates = {"tiles_vs_golden": abs(res["tiles"]["psnr"]
                                    - res["golden"]["psnr"])}
    if record is not None:
        gates["tiles_vs_jax"] = abs(res["tiles"]["psnr"] - record["psnr"])
    ok = all(d <= args.gate_db for d in gates.values())
    for name, d in gates.items():
        print(f"{name}: PSNR delta {d:.4f} dB (gate {args.gate_db})")
    if "losses" in res["tiles"]:
        # A record of every loss (the other_targets setting): how far the
        # tile route's losses lie from JAX's, step by step (reported).
        rel = [abs(a / b - 1.0) for a, b in zip(res["tiles"]["losses"],
                                                record["losses"])]
        res["tiles"]["loss_rel_to_jax"] = {"max": max(rel),
                                           "first_five": rel[:5]}
        print(f"tiles_vs_jax losses: largest relative distance "
              f"{max(rel):.2e} over {len(rel)} iterations")
    print(json.dumps({"size": args.size, "iters": args.iters,
                      "setting": args.setting,
                      "device": args.device, "routes": res,
                      "jax_record": record, "gates_db": gates,
                      "gate_db": args.gate_db, "pass": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
