"""Write the JAX package's record for the port's training-quality gate:
the final validation PSNR, SSIM and n_alive of
scripts/train_path_parity.py's golden route (`run_path(False, ...)`) at
one setting, with the commit and the command, as JSON.  It runs the JAX
package on the CPU and is not part of the PyTorch port;
scripts/train_path_parity_torch.py --against FILE reads the record.

At the default 64^2 / 300 iterations the densify window of the setting
(every 100 from iteration 500 to iters/2) never opens: the record covers
the optimizer and the renderer, not density control.

`--setting other_targets` keeps run_path's start, config and camera
schedule but trains towards golden renders of seed TARGET_SEED's cloud
(scripts/train_path_parity_torch.py's setting of that name: the
dataset's targets are rendered from that seed's cloud, then its point
cloud, which the trainer starts from, is seed 3's).  run_path builds its
own dataset and cannot take those targets, so this script drives the JAX
package's GaussianTrainer the way run_path does, with run_path's config,
logging every iteration; the record holds every iteration's loss beside
the final metrics.

Usage:  python scripts/train_path_record_jax.py [--size 64] [--iters 300]
            [--out docs/artifacts/train_path_parity_jax.json]
        (the 256^2 record, about half an hour on a CPU host:
         --size 256 --out docs/artifacts/train_path_parity_jax_256.json;
         the other setting's, about a minute: --setting other_targets
         --iters 20 --out docs/artifacts/train_path_parity_jax_other_targets.json)
"""

from __future__ import annotations

import argparse
import json
import platform
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
DEFAULT_OUT = REPO / "docs" / "artifacts" / "train_path_parity_jax.json"
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))


def run_other_targets(args) -> dict:
    """run_path(False, args) towards renders of seed TARGET_SEED's cloud,
    every iteration logged: run_path's config (log_interval 1 aside, which
    leaves the run bitwise as it is), the dataset of
    train_path_parity_torch.make_trainer, run_path's trainer."""
    import jax
    from mini3dgs_tpu.config import TrainingConfig
    from mini3dgs_tpu.data.dataset import RandomDataset
    from mini3dgs_tpu.train.trainer import GaussianTrainer
    from train_path_parity_torch import TARGET_SEED

    cfg = TrainingConfig(
        capacity=args.capacity, iterations=args.iters,
        image_height=args.size, image_width=args.size,
        eval_interval=10 ** 9, save_interval=10 ** 9, log_interval=1,
        densify_from_iter=500, densify_until_iter=args.iters // 2,
        densify_interval=100, opacity_reset_interval=0,
        prune_interval=1000,
        position_lr_max_steps=args.iters,
        tile_size=32, sh_degree=0, color_mode="dc_sigmoid",
        use_pallas=False, max_instances=args.max_instances,
        gaussian_chunk=256, seed=7)
    ds = RandomDataset(n_cameras=6, width=args.size, height=args.size,
                       seed=TARGET_SEED)
    ds.load_cameras()
    ds.seed = 3
    tr = GaussianTrainer(cfg)
    tr.setup(dataset=ds)
    losses = {}
    t0 = time.perf_counter()
    tr.train(log_fn=lambda it, m: losses.__setitem__(
        it, float(m["total_loss"])))
    jax.block_until_ready(tr.state.gaussians.xyz)
    dt = time.perf_counter() - t0
    m = tr.validate()
    m["seconds"] = dt
    m["n_alive"] = int(tr.state.gaussians.num_alive())
    m["losses"] = [losses[it] for it in range(1, args.iters + 1)]
    m["target_seed"] = TARGET_SEED
    return m


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--setting", choices=("optimum", "other_targets"),
                    default="optimum")
    ap.add_argument("--out", type=str, default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import train_path_parity

    # the defaults of train_path_parity.main's other flags
    run_args = argparse.Namespace(iters=args.iters, size=args.size,
                                  capacity=4096, max_instances=2 ** 17)
    command = ("python scripts/train_path_record_jax.py --size "
               f"{args.size} --iters {args.iters}")
    if args.setting != "optimum":
        command += f" --setting {args.setting}"
    if Path(args.out).resolve() != DEFAULT_OUT.resolve():
        command += f" --out {args.out}"
    t0 = time.perf_counter()
    if args.setting == "optimum":
        m = train_path_parity.run_path(False, run_args)
    else:
        m = run_other_targets(run_args)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                            capture_output=True, text=True).stdout.strip()
    record = {
        "route": "golden (train_path_parity.run_path(False, ...))",
        "setting": args.setting,
        "size": args.size, "iters": args.iters,
        "psnr": float(m["psnr"]), "ssim": float(m["ssim"]),
        "n_alive": int(m["n_alive"]),
        "train_seconds": float(m["seconds"]),
        "wall_seconds": time.perf_counter() - t0,
        "commit": commit or None,
        "command": command,
        "host": f"{platform.machine()} CPU, jax {jax.__version__}",
        "note": ("densify window (every 100 from iteration 500 to "
                 f"{args.iters // 2}) never opens" if args.iters // 2 < 500
                 else "densify every 100 from iteration 500 to "
                      f"{args.iters // 2}"),
    }
    if args.setting == "other_targets":
        record["route"] = ("golden (train_path_parity.run_path(False, ...)'s"
                           " config and trainer, towards renders of seed "
                           f"{m['target_seed']}'s cloud)")
        record["target_seed"] = m["target_seed"]
        record["losses"] = m["losses"]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(record, indent=1) + "\n")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
