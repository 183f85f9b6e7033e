"""Train 3D Gaussian Splatting with the PyTorch/CUDA port (counterpart of
main.py): load the config -> GaussianTrainer (dataset, Gaussians from its
point cloud) -> optionally resume -> train -> validate -> save a
checkpoint.  It runs on the card unless the config's `system: device` or
--device says cpu.  With --mesh-data D --mesh-tile T (or the config's
`tpu: mesh_data / mesh_tile`) it trains over a (data, tile) mesh of D x T
ranks, spread over the visible cards (on one card all ranks share it):
D cameras a step, each image in T bands of whole tile rows; the config's
`shard_gauss_state: true` splits the pool and its Adam state over the
ranks, `ring_exchange: true` runs the bands' ring.

Usage:
    python3 main_torch.py --config configs/default.yaml [--data PATH]
        [--output DIR] [--iterations N] [--resume IT] [--no-pallas]
        [--mesh-data D] [--mesh-tile T] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="3D Gaussian Splatting on PyTorch/CUDA")
    p.add_argument("--config", type=str, default=None,
                   help="YAML (or JSON) config path")
    p.add_argument("--data", type=str, default=None, help="dataset root")
    p.add_argument("--output", type=str, default=None, help="output dir")
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--resume", type=int, default=None,
                   help="checkpoint iteration to resume from")
    p.add_argument("--no-pallas", action="store_true",
                   help="render through the golden compositor, not the "
                        "tile kernels")
    p.add_argument("--mesh-data", type=int, default=None,
                   help="cameras trained side by side (data axis)")
    p.add_argument("--mesh-tile", type=int, default=None,
                   help="image bands of whole tile rows (tile axis)")
    p.add_argument("--device", type=str, default=None,
                   help="cuda or cpu (default: the config's; the card "
                        "unless it says cpu)")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from mini3dgs_tpu_torch.config import ConfigManager, TrainingConfig
    from mini3dgs_tpu_torch.train.trainer import GaussianTrainer

    if args.config:
        config = ConfigManager.load_from_yaml(args.config)
    else:
        config = TrainingConfig()
    overrides = {}
    if args.data:
        overrides["data_path"] = args.data
    if args.output:
        overrides["output_path"] = args.output
    if args.iterations:
        overrides["iterations"] = args.iterations
    if args.no_pallas:
        overrides["use_pallas"] = False
    if args.mesh_data:
        overrides["mesh_data"] = args.mesh_data
    if args.mesh_tile:
        overrides["mesh_tile"] = args.mesh_tile
    if args.device:
        overrides["device"] = args.device
    config = dataclasses.replace(config, **overrides)

    trainer = GaussianTrainer(config)
    trainer.setup()
    if args.resume is not None:
        trainer.load_checkpoint(args.resume)

    def log(it, metrics):
        parts = " ".join(f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
                         for k, v in metrics.items())
        print(f"[{it:6d}] {parts}", flush=True)

    trainer.train(log_fn=log)
    final = trainer.validate()
    if final:
        print(f"final: psnr={final['psnr']:.2f} ssim={final['ssim']:.4f}")
    trainer.save_checkpoint(trainer.iteration)
    return 0


if __name__ == "__main__":
    sys.exit(main())
