"""Export a checkpoint of the PyTorch/CUDA port as a canonical 3DGS PLY
(counterpart of scripts/export_ply.py).  A checkpoint of the port holds
whole tensors, so it loads at its own capacity (a pool that grew or was
compacted during the run loads as it was) with no dataset to set up.

Usage: python3 scripts/export_ply_torch.py --output runs/NAME
           [--config YAML] [--checkpoint IT] [--out model.ply]
           [--device cuda|cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None,
                   help="training YAML (read for its device)")
    p.add_argument("--output", required=True, help="training output dir")
    p.add_argument("--checkpoint", type=int, default=None)
    p.add_argument("--out", default=None, help="PLY path (default: "
                   "<output>/point_cloud.ply)")
    p.add_argument("--device", default=None,
                   help="cuda or cpu (default: the config's)")
    args = p.parse_args(argv)

    from mini3dgs_tpu_torch.config import ConfigManager, TrainingConfig
    from mini3dgs_tpu_torch.train.checkpoint import (
        latest_checkpoint_iteration, load_checkpoint)
    from mini3dgs_tpu_torch.train.trainer import resolve_device
    from mini3dgs_tpu_torch.utils.gaussian_ply import export_gaussians_ply

    config = (ConfigManager.load_from_yaml(args.config) if args.config
              else TrainingConfig())
    device = resolve_device(args.device or config.device)
    it = args.checkpoint or latest_checkpoint_iteration(args.output)
    if it is None:
        print(f"no checkpoint found under {args.output}", file=sys.stderr)
        return 1
    state, _ = load_checkpoint(args.output, it, device)
    out = args.out or str(Path(args.output) / "point_cloud.ply")
    n = export_gaussians_ply(state.gaussians, out)
    print(f"wrote {n} gaussians (checkpoint it {it}) to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
