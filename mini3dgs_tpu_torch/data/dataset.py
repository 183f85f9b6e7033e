"""Datasets: camera collections + scene point clouds (counterpart of
mini3dgs_tpu/data/dataset.py).

`CameraDataset` (load_cameras / split_train_test / get_train_cameras /
get_test_cameras / get_scene_info), `COLMAPDataset` (text or binary sparse
model + PNG images), `BlenderDataset` (NeRF-synthetic `transforms_*.json`)
and `RandomDataset` (a synthetic scene that renders its own ground truth).
Every dataset puts its cameras and target images on its `device`.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import TrainingConfig
from ..core.camera import Camera, fov_from_focal
from ..core.gaussians import create_from_pcd
from ..ops.renderer import RenderSettings, render
from ..utils.io import load_image, load_point_cloud
from . import colmap


class CameraDataset:
    """Base dataset."""

    def __init__(self, data_path: str, device="cpu"):
        self.data_path = Path(data_path)
        self.device = torch.device(device)
        self.cameras: List[Camera] = []
        self.train_cameras: List[Camera] = []
        self.test_cameras: List[Camera] = []

    def load_cameras(self) -> None:
        raise NotImplementedError

    def split_train_test(self, split_ratio: float = 0.9,
                         llff_hold: Optional[int] = None) -> None:
        """Deterministic split; llff_hold=8 reproduces the standard every-8th
        test-view protocol for COLMAP scenes."""
        if llff_hold:
            self.train_cameras = [c for i, c in enumerate(self.cameras)
                                  if i % llff_hold != 0]
            self.test_cameras = [c for i, c in enumerate(self.cameras)
                                 if i % llff_hold == 0]
        else:
            n_train = max(1, int(len(self.cameras) * split_ratio))
            self.train_cameras = self.cameras[:n_train]
            self.test_cameras = self.cameras[n_train:] or self.cameras[-1:]

    def get_train_cameras(self) -> List[Camera]:
        return self.train_cameras

    def get_test_cameras(self) -> List[Camera]:
        return self.test_cameras

    def get_scene_info(self) -> Dict:
        """Bounds, center and radius of the camera rig."""
        centers = np.stack([c.camera_center.cpu().numpy()
                            for c in self.cameras])
        center = centers.mean(0)
        radius = float(np.linalg.norm(centers - center, axis=1).max())
        return {"center": center, "radius": radius,
                "bounds": (centers.min(0), centers.max(0)),
                "num_cameras": len(self.cameras)}

    def get_point_cloud(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        raise NotImplementedError


def _scale_intrinsics(cc, w: int, h: int) -> np.ndarray:
    """COLMAP camera params rescaled to a resized image (focal and principal
    point scale; distortion coefficients act on normalized coords)."""
    sx, sy = w / cc.width, h / cc.height
    p = np.asarray(cc.params, dtype=np.float64).copy()
    if cc.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
        p[0] *= sx
        p[1] *= sx
        p[2] *= sy
    else:
        p[0] *= sx
        p[1] *= sy
        p[2] *= sx
        p[3] *= sy
    return p


class COLMAPDataset(CameraDataset):
    """COLMAP sparse-model dataset (text or binary model; optional on-load
    undistortion of SIMPLE_RADIAL / RADIAL / OPENCV models onto ideal
    pinhole cameras)."""

    def __init__(self, data_path: str, images_path: str = "images",
                 sparse_path: str = "sparse/0", downscale: int = 1,
                 llff_hold: int = 8, undistort: bool = False, device="cpu"):
        super().__init__(data_path, device)
        self.images_path = self.data_path / images_path
        self.sparse_path = self.data_path / sparse_path
        self.downscale = downscale
        self.llff_hold = llff_hold
        self.undistort = undistort

    def _read_model(self):
        sp = self.sparse_path
        if (sp / "cameras.bin").exists():
            cams = colmap.read_cameras_binary(str(sp / "cameras.bin"))
            imgs = colmap.read_images_binary(str(sp / "images.bin"))
        else:
            cams = colmap.read_cameras_text(str(sp / "cameras.txt"))
            imgs = colmap.read_images_text(str(sp / "images.txt"))
        return cams, imgs

    def load_cameras(self) -> None:
        cams, imgs = self._read_model()
        cameras = []
        for iid in sorted(imgs):
            im = imgs[iid]
            cc = cams[im.camera_id]
            fx, fy = cc.focal()
            R, T = colmap.image_c2w(im)
            img_file = self.images_path / im.name
            image = load_image(str(img_file)) if img_file.exists() else None
            w, h = cc.width, cc.height
            if image is not None:
                h, w = image.shape[-2], image.shape[-1]
                # focal scales with any resize baked into the image files
                fx = fx * w / cc.width
                fy = fy * h / cc.height
                if self.undistort and cc.has_distortion:
                    hwc = np.transpose(image, (1, 2, 0))
                    scaled = colmap.ColmapCamera(
                        cc.id, cc.model, w, h,
                        _scale_intrinsics(cc, w, h))
                    hwc, _ = colmap.undistort_image(hwc, scaled)
                    image = np.ascontiguousarray(
                        np.transpose(hwc, (2, 0, 1)))
            cameras.append(Camera.create(
                uid=iid, R=R, T=T,
                FoVx=fov_from_focal(fx, w), FoVy=fov_from_focal(fy, h),
                image=image, image_name=im.name, width=w, height=h,
                device=self.device))
        self.cameras = cameras
        self.split_train_test(llff_hold=self.llff_hold)

    def get_point_cloud_path(self) -> str:
        for name in ("points3D.bin", "points3D.txt"):
            p = self.sparse_path / name
            if p.exists():
                return str(p)
        raise FileNotFoundError(f"no points3D in {self.sparse_path}")

    def get_point_cloud(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        path = self.get_point_cloud_path()
        if path.endswith(".bin"):
            return colmap.read_points3d_binary(path)
        return colmap.read_points3d_text(path)


class BlenderDataset(CameraDataset):
    """NeRF-synthetic `transforms_{split}.json` dataset.

    Blender convention: transform_matrix is C2W with the camera looking down
    -z, y up.  The renderer expects camera +z forward, y down, so the y and
    z basis vectors of the rotation are flipped.
    """

    def __init__(self, data_path: str, white_background: bool = True,
                 half_res: bool = False, device="cpu"):
        super().__init__(data_path, device)
        self.white_background = white_background
        # render background the trainer must use so GT/bg stay consistent
        self.bg_color = [1.0, 1.0, 1.0] if white_background else [0.0, 0.0, 0.0]
        self.half_res = half_res

    def _load_split(self, split: str, uid0: int = 0) -> List[Camera]:
        tf = self.data_path / f"transforms_{split}.json"
        if not tf.exists():
            return []
        with open(tf) as f:
            meta = json.load(f)
        fovx = float(meta["camera_angle_x"])
        out = []
        for i, frame in enumerate(meta["frames"]):
            c2w = np.array(frame["transform_matrix"], np.float32)
            # flip y and z axes: blender (-z fwd, y up) -> ours (+z fwd, y down)
            R = c2w[:3, :3] @ np.diag([1.0, -1.0, -1.0]).astype(np.float32)
            T = c2w[:3, 3]
            img_file = self.data_path / (frame["file_path"] + ".png")
            if not img_file.exists():
                img_file = self.data_path / frame["file_path"]
            image = (load_image(str(img_file),
                                bg=1.0 if self.white_background else 0.0)
                     if img_file.exists() else None)
            if image is not None:
                h, w = image.shape[-2], image.shape[-1]
            else:
                w = h = int(meta.get("w", 800))
            fovy = 2.0 * math.atan(math.tan(fovx / 2) * h / w)
            out.append(Camera.create(uid=uid0 + i, R=R, T=T, FoVx=fovx,
                                     FoVy=fovy, image=image,
                                     image_name=str(frame["file_path"]),
                                     width=w, height=h, device=self.device))
        return out

    def load_cameras(self) -> None:
        self.train_cameras = self._load_split("train")
        self.test_cameras = self._load_split("test", uid0=10000) or \
            self._load_split("val", uid0=10000)
        self.cameras = self.train_cameras + self.test_cameras

    def get_point_cloud(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        ply = self.data_path / "points3d.ply"
        if ply.exists():
            return load_point_cloud(str(ply))
        # standard 3DGS practice for synthetic scenes: random init in the
        # [-1.3, 1.3]^3 NeRF-synthetic bounding box
        rng = np.random.default_rng(0)
        n = 100_000
        pts = (rng.random((n, 3), dtype=np.float32) * 2.6 - 1.3)
        cols = rng.random((n, 3), dtype=np.float32)
        return pts, cols


class RandomDataset(CameraDataset):
    """Synthetic scene for examples and tests: random Gaussians viewed by
    cameras on a circle looking at the origin; the ground truth is the
    point cloud itself rendered as small Gaussians through the golden
    compositor."""

    def __init__(self, n_cameras: int = 4, width: int = 256, height: int = 256,
                 radius: float = 4.0, fov_deg: float = 60.0, seed: int = 0,
                 device="cpu"):
        super().__init__("<random>", device)
        self.n_cameras = n_cameras
        self.width, self.height = width, height
        self.radius = radius
        self.fov = math.radians(fov_deg)
        self.seed = seed

    def load_cameras(self) -> None:
        cams = []
        for i in range(self.n_cameras):
            theta = 2 * math.pi * i / self.n_cameras
            center = np.array([self.radius * math.sin(theta), 0.0,
                               -self.radius * math.cos(theta)], np.float32)
            # camera +z looks at origin
            fwd = -center / np.linalg.norm(center)
            up = np.array([0.0, 1.0, 0.0], np.float32)
            right = np.cross(up, fwd)
            right /= np.linalg.norm(right)
            upv = np.cross(fwd, right)
            R = np.stack([right, upv, fwd], axis=1)  # columns = camera basis
            cams.append(Camera.create(uid=i, R=R, T=center, FoVx=self.fov,
                                      FoVy=self.fov, width=self.width,
                                      height=self.height, device=self.device))
        pts, cols = self.get_point_cloud()
        cap = 1 << int(math.ceil(math.log2(max(len(pts), 2))))
        g = create_from_pcd(pts, cols, capacity=cap, device=self.device)
        st = RenderSettings(image_height=self.height, image_width=self.width,
                            raster="golden")
        with torch.no_grad():
            cams = [c.replace(image=render(g, c, st)["image"]) for c in cams]
        self.cameras = cams
        self.split_train_test(1.0)
        self.test_cameras = cams[:1]

    def get_point_cloud(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        n = 2000
        return (rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                rng.uniform(0, 1, (n, 3)).astype(np.float32))


def load_dataset(config: TrainingConfig, device="cpu") -> CameraDataset:
    """Dispatch on the on-disk layout: Blender if `transforms_train.json`
    exists, COLMAP if the sparse model's directory does, else the random
    scene at the config's image size."""
    root = Path(config.data_path)
    if (root / "transforms_train.json").exists():
        # honor a configured black background; anything else follows the
        # NeRF-synthetic white convention (GT compositing must match)
        white = list(config.background_color) != [0.0, 0.0, 0.0]
        ds = BlenderDataset(str(root), white_background=white, device=device)
    elif (root / config.sparse_path).exists():
        ds = COLMAPDataset(str(root), images_path=config.images_path,
                           sparse_path=config.sparse_path, device=device)
    else:
        ds = RandomDataset(width=config.image_width,
                           height=config.image_height, device=device)
    ds.load_cameras()
    return ds
