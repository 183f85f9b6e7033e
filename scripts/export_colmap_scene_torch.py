"""Export a Blender/NeRF-synthetic-format scene as a COLMAP sparse model
with the PyTorch port (counterpart of scripts/export_colmap_scene.py).

The scene of scripts/make_synthetic_scene_torch.py (both splits and its
points3d.ply) becomes `images/im_NNNN.png` + `sparse/0/{cameras,images,
points3D}.bin`, which `COLMAPDataset` reads (every 8th view held out):
  * Blender c2w -> the port's (R, T): R = c2w[:3,:3] @ diag(1,-1,-1),
    T = c2w[:3,3];
  * -> COLMAP world->camera: R_wc = R^T (as a wxyz quaternion),
    tvec = -R^T T;
  * PINHOLE intrinsics from camera_angle_x: fx = fy = 0.5 W / tan(fovx/2);
  * RGBA composited onto white (COLMAP images carry no alpha), so the
    training config keeps background_color [1,1,1].
PNG is read and written by the port's own codec.  The first three poses
are read back and must give the source's (R, T) to 1e-6.

Usage:
    python scripts/export_colmap_scene_torch.py [--src data/sdf_scene]
        [--out data/sdf_colmap]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mini3dgs_tpu_torch.data import colmap  # noqa: E402
from mini3dgs_tpu_torch.utils import png  # noqa: E402
from mini3dgs_tpu_torch.utils.io import load_point_cloud  # noqa: E402


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> wxyz quaternion (Shepperd's method: the branch of
    the largest diagonal term, for numerical stability)."""
    m00, m01, m02 = R[0]
    m10, m11, m12 = R[1]
    m20, m21, m22 = R[2]
    tr = m00 + m11 + m22
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        q = [0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s]
    elif m00 > m11 and m00 > m22:
        s = math.sqrt(1.0 + m00 - m11 - m22) * 2
        q = [(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s]
    elif m11 > m22:
        s = math.sqrt(1.0 + m11 - m00 - m22) * 2
        q = [(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s]
    else:
        s = math.sqrt(1.0 + m22 - m00 - m11) * 2
        q = [(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s]
    q = np.asarray(q, np.float64)
    return q / np.linalg.norm(q)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=str, default="data/sdf_scene")
    ap.add_argument("--out", type=str, default="data/sdf_colmap")
    args = ap.parse_args(argv)

    src, out = Path(args.src), Path(args.out)
    (out / "images").mkdir(parents=True, exist_ok=True)
    (out / "sparse" / "0").mkdir(parents=True, exist_ok=True)

    # one list over both splits; COLMAPDataset re-splits with llff_hold=8
    frames = []
    for split in ("train", "test"):
        with open(src / f"transforms_{split}.json") as f:
            meta = json.load(f)
        fovx = float(meta["camera_angle_x"])
        frames += [(split, fr) for fr in meta["frames"]]

    def read_png(fr):
        return png.decode((src / (fr["file_path"] + ".png")).read_bytes())

    H, W = read_png(frames[0][1]).shape[:2]
    fx = 0.5 * W / math.tan(fovx / 2)

    cams = {1: colmap.ColmapCamera(
        1, "PINHOLE", W, H, np.array([fx, fx, W / 2.0, H / 2.0]))}
    imgs = {}
    for i, (split, fr) in enumerate(frames):
        c2w = np.array(fr["transform_matrix"], np.float64)
        R = c2w[:3, :3] @ np.diag([1.0, -1.0, -1.0])
        T = c2w[:3, 3]
        qvec = rotmat_to_qvec(R.T)
        tvec = -R.T @ T
        name = f"im_{i:04d}.png"
        rgba = read_png(fr).astype(np.float64)
        rgba /= 255.0
        if rgba.shape[-1] == 4:
            rgb = rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])
        else:
            rgb = rgba[..., :3]
        (out / "images" / name).write_bytes(
            png.encode((np.clip(rgb, 0, 1) * 255).astype(np.uint8)))
        imgs[i + 1] = colmap.ColmapImage(i + 1, qvec, tvec, 1, name)

    colmap.write_cameras_binary(cams, str(out / "sparse/0/cameras.bin"))
    colmap.write_images_binary(imgs, str(out / "sparse/0/images.bin"))
    pts, cols = load_point_cloud(str(src / "points3d.ply"))
    colmap.write_points3d_binary(pts, cols, str(out / "sparse/0/points3D.bin"))
    print(f"wrote {len(imgs)} images + {len(pts)} points to {out}")

    # round-trip check: the poses give back the source's (R, T)
    for iid, im in list(imgs.items())[:3]:
        Rb, Tb = colmap.image_c2w(im)
        c2w = np.array(frames[iid - 1][1]["transform_matrix"], np.float64)
        R0 = c2w[:3, :3] @ np.diag([1.0, -1.0, -1.0])
        assert np.allclose(Rb, R0, atol=1e-6), "rotation round trip"
        assert np.allclose(Tb, c2w[:3, 3], atol=1e-6), "center round trip"
    print("pose round-trip OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
