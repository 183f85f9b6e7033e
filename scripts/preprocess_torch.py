"""Dataset preprocessing with the PyTorch port (counterpart of
scripts/preprocess.py): load a COLMAP or Blender dataset through the
port's `load_dataset`, print its cameras, rig and point cloud, and
optionally write the point cloud as .ply or .npz.

Usage: python scripts/preprocess_torch.py --data PATH [--export-ply out.ply]
           [--export-npz out.npz] [--device cuda|cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True)
    p.add_argument("--export-ply", default=None)
    p.add_argument("--export-npz", default=None)
    p.add_argument("--device", default="cuda",
                   help="where the images go: cuda (default) or cpu")
    args = p.parse_args(argv)

    import numpy as np
    from mini3dgs_tpu_torch.config import TrainingConfig
    from mini3dgs_tpu_torch.data.dataset import load_dataset
    from mini3dgs_tpu_torch.train.trainer import resolve_device
    from mini3dgs_tpu_torch.utils.io import save_point_cloud

    config = TrainingConfig(data_path=args.data)
    ds = load_dataset(config, resolve_device(args.device))
    info = ds.get_scene_info()
    print(f"cameras: {info['num_cameras']} "
          f"(train {len(ds.get_train_cameras())}, "
          f"test {len(ds.get_test_cameras())})")
    print(f"rig center: {np.round(info['center'], 3)} radius: {info['radius']:.3f}")
    pts, cols = ds.get_point_cloud()
    print(f"point cloud: {len(pts)} points "
          f"({'with' if cols is not None else 'no'} colors)")
    missing = [c.image_name for c in ds.cameras if c.image is None]
    if missing:
        print(f"warning: {len(missing)} cameras without images "
              f"(e.g. {missing[:3]})")
    for path in (args.export_ply, args.export_npz):
        if path:
            save_point_cloud(pts, cols, path)
            print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
