"""Evaluate a model trained by the PyTorch/CUDA port: PSNR and SSIM over
the test split (counterpart of scripts/evaluate.py).  The checkpoint's
pool is compacted on load, so the renders pay for live slots only.

Usage: python3 scripts/evaluate_torch.py --data PATH [--config YAML]
           [--output DIR] [--checkpoint IT] [--save-images]
           [--device cuda|cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None, help="training YAML (render/"
                   "color settings must match the checkpoint)")
    p.add_argument("--data", required=True)
    p.add_argument("--output", default="output")
    p.add_argument("--checkpoint", type=int, default=None,
                   help="iteration to load (default: latest)")
    p.add_argument("--save-images", action="store_true")
    p.add_argument("--device", default=None,
                   help="cuda or cpu (default: the config's)")
    args = p.parse_args(argv)

    import dataclasses

    import numpy as np
    import torch

    from mini3dgs_tpu_torch.config import ConfigManager, TrainingConfig
    from mini3dgs_tpu_torch.core.gaussians import compact
    from mini3dgs_tpu_torch.core.loss import ssim as ssim_fn
    from mini3dgs_tpu_torch.ops.renderer import render
    from mini3dgs_tpu_torch.train.checkpoint import latest_checkpoint_iteration
    from mini3dgs_tpu_torch.train.trainer import GaussianTrainer
    from mini3dgs_tpu_torch.utils.io import save_image
    from mini3dgs_tpu_torch.utils.metrics import psnr as psnr_fn

    config = (ConfigManager.load_from_yaml(args.config) if args.config
              else TrainingConfig())
    over = dict(data_path=args.data, output_path=args.output)
    if args.device:
        over["device"] = args.device
    config = dataclasses.replace(config, **over)
    trainer = GaussianTrainer(config)
    trainer.setup()
    it = args.checkpoint or latest_checkpoint_iteration(args.output)
    if it is not None:
        trainer.load_checkpoint(it)
        print(f"loaded checkpoint at iteration {it}")
    gaussians = compact(trainer.state.gaussians)
    psnrs, ssims = [], []
    with torch.no_grad():
        for i, cam in enumerate(trainer.dataset.get_test_cameras()):
            image = render(gaussians, cam, trainer.settings)["image"]
            if cam.image is not None:
                psnrs.append(float(psnr_fn(image, cam.image)))
                ssims.append(float(ssim_fn(image, cam.image)))
                print(f"view {i:3d} ({cam.image_name}): "
                      f"psnr={psnrs[-1]:.2f} ssim={ssims[-1]:.4f}")
            if args.save_images:
                save_image(image, f"{args.output}/eval/render_{i:04d}.png")
    if psnrs:
        print(f"mean: psnr={np.mean(psnrs):.2f} ssim={np.mean(ssims):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
