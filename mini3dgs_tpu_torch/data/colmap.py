"""COLMAP model parsers: cameras / images / points3D, text and binary
(counterpart of mini3dgs_tpu/data/colmap.py: pure numpy, the same readers,
writers and undistorter, with the points3D.bin reader and writer working
on the whole file at once).

Formats follow the public COLMAP sparse-model layout (cameras.txt/bin,
images.txt/bin, points3D.txt/bin).

Camera conventions: COLMAP stores world->camera as (qvec wxyz, tvec); the
camera center is C = -R(q)^T t and the camera->world rotation is R(q)^T —
those are exactly the (R, T) that Camera.create (C2W) expects.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

# COLMAP camera model ids -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # model-specific

    def focal(self) -> Tuple[float, float]:
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
            return float(self.params[0]), float(self.params[0])
        return float(self.params[0]), float(self.params[1])

    def principal_point(self) -> Tuple[float, float]:
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
            return float(self.params[1]), float(self.params[2])
        return float(self.params[2]), float(self.params[3])

    def distortion(self) -> np.ndarray:
        """(k1, k2, p1, p2) radial/tangential coefficients; zeros where the
        model has none.  Fisheye/FOV models distort through a different
        formula — use `distort_normalized`, which handles every model."""
        p = self.params
        if self.model in ("SIMPLE_PINHOLE", "PINHOLE"):
            return np.zeros(4)
        if self.model == "SIMPLE_RADIAL":
            return np.array([p[3], 0.0, 0.0, 0.0])
        if self.model == "RADIAL":
            return np.array([p[3], p[4], 0.0, 0.0])
        if self.model == "OPENCV":
            return np.array([p[4], p[5], p[6], p[7]])
        raise ValueError(f"{self.model!r} does not reduce to (k1,k2,p1,p2)")

    @property
    def has_distortion(self) -> bool:
        if self.model in ("SIMPLE_PINHOLE", "PINHOLE"):
            return False
        if self.model in ("SIMPLE_RADIAL", "RADIAL", "OPENCV",
                          "FULL_OPENCV"):
            return bool(np.any(self.distortion_params() != 0.0))
        return True  # fisheye/FOV always remap (theta/atan warp even at k=0)

    def distortion_params(self) -> np.ndarray:
        """The model's distortion coefficients (whatever follows the
        focal/principal-point block in COLMAP's parameter layout)."""
        skip = 3 if self.model.startswith("SIMPLE_") or self.model in (
            "RADIAL", "RADIAL_FISHEYE", "FOV") else 4
        return np.asarray(self.params[skip:], np.float64)


def distort_normalized(cam: ColmapCamera, xy: np.ndarray) -> np.ndarray:
    """Apply the camera's distortion to NORMALIZED image coords [N,2].

    Implements the full COLMAP model family (camera_models.h semantics):
    polynomial radial (+tangential) for the pinhole-family models, the
    rational FULL_OPENCV model, equidistant fisheye (OPENCV_FISHEYE and the
    SIMPLE_RADIAL/RADIAL fisheye variants), and the FOV model."""
    x, y = xy[:, 0].astype(np.float64), xy[:, 1].astype(np.float64)
    r2 = x * x + y * y
    model = cam.model
    d = cam.distortion_params()

    if model in ("SIMPLE_PINHOLE", "PINHOLE"):
        return xy.astype(np.float64)

    if model in ("SIMPLE_RADIAL", "RADIAL", "OPENCV"):
        k1, k2, p1, p2 = cam.distortion()
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        return np.stack([xd, yd], axis=-1)

    if model == "FULL_OPENCV":
        k1, k2, p1, p2, k3, k4, k5, k6 = d
        r4, r6 = r2 * r2, r2 * r2 * r2
        radial = ((1.0 + k1 * r2 + k2 * r4 + k3 * r6)
                  / (1.0 + k4 * r2 + k5 * r4 + k6 * r6))
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        return np.stack([xd, yd], axis=-1)

    if model in ("OPENCV_FISHEYE", "SIMPLE_RADIAL_FISHEYE",
                 "RADIAL_FISHEYE"):
        ks = np.zeros(4)
        ks[:len(d)] = d
        r = np.sqrt(r2)
        theta = np.arctan(r)
        t2 = theta * theta
        theta_d = theta * (1.0 + ks[0] * t2 + ks[1] * t2 ** 2
                           + ks[2] * t2 ** 3 + ks[3] * t2 ** 4)
        scale = np.where(r > 1e-12, theta_d / np.maximum(r, 1e-12), 1.0)
        return np.stack([x * scale, y * scale], axis=-1)

    if model == "FOV":
        omega = float(d[0]) if len(d) else 0.0
        r = np.sqrt(r2)
        if abs(omega) < 1e-8:
            return xy.astype(np.float64)
        rd = np.arctan(2.0 * r * math.tan(omega / 2.0)) / omega
        scale = np.where(r > 1e-12, rd / np.maximum(r, 1e-12), 1.0)
        return np.stack([x * scale, y * scale], axis=-1)

    raise ValueError(f"unsupported distortion model {model!r}")


def undistort_image(image: np.ndarray, cam: ColmapCamera
                    ) -> Tuple[np.ndarray, "ColmapCamera"]:
    """Resample `image` [H,W,C] (or [H,W]) onto an ideal PINHOLE camera with
    the same focal/principal point (the standard 3DGS preprocessing step the
    reference leaves to COLMAP's image_undistorter; scripts/preprocess.py
    exposes it).  Inverse mapping: for every undistorted pixel, distort its
    normalized coordinate and bilinearly sample the source."""
    H, W = image.shape[:2]
    fx, fy = cam.focal()
    cx, cy = cam.principal_point()
    if not cam.has_distortion:
        pin = ColmapCamera(cam.id, "PINHOLE", cam.width, cam.height,
                           np.array([fx, fy, cx, cy]))
        return image, pin
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    xn = (xs + 0.5 - cx) / fx
    yn = (ys + 0.5 - cy) / fy
    xy = distort_normalized(cam, np.stack([xn.ravel(), yn.ravel()], -1))
    sx = (xy[:, 0] * fx + cx - 0.5).reshape(H, W)
    sy = (xy[:, 1] * fy + cy - 0.5).reshape(H, W)
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    wx = (sx - x0)[..., None] if image.ndim == 3 else (sx - x0)
    wy = (sy - y0)[..., None] if image.ndim == 3 else (sy - y0)
    inside = ((x0 >= 0) & (x0 + 1 <= W - 1) & (y0 >= 0) & (y0 + 1 <= H - 1))
    x0c = np.clip(x0, 0, W - 2)
    y0c = np.clip(y0, 0, H - 2)
    img = image.astype(np.float64)
    out = ((1 - wy) * ((1 - wx) * img[y0c, x0c] + wx * img[y0c, x0c + 1])
           + wy * ((1 - wx) * img[y0c + 1, x0c] + wx * img[y0c + 1, x0c + 1]))
    mask = inside if image.ndim == 2 else inside[..., None]
    out = np.where(mask, out, 0.0).astype(image.dtype
                                          if image.dtype != np.uint8
                                          else np.float64)
    if image.dtype == np.uint8:
        out = np.clip(np.round(out), 0, 255).astype(np.uint8)
    pin = ColmapCamera(cam.id, "PINHOLE", cam.width, cam.height,
                       np.array([fx, fy, cx, cy]))
    return out, pin


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray   # [4] wxyz, world->camera rotation
    tvec: np.ndarray   # [3] world->camera translation
    camera_id: int
    name: str


def qvec_to_rotmat(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float64)


def image_c2w(img: ColmapImage) -> Tuple[np.ndarray, np.ndarray]:
    """(R_c2w, camera_center) from a COLMAP world->camera pose."""
    R_wc = qvec_to_rotmat(img.qvec)
    center = -R_wc.T @ img.tvec
    return R_wc.T.astype(np.float32), center.astype(np.float32)


# ----------------------------- text readers -----------------------------

def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    with open(path, "r", encoding="utf-8", errors="ignore") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cid = int(parts[0])
            cams[cid] = ColmapCamera(cid, parts[1], int(parts[2]), int(parts[3]),
                                     np.array([float(v) for v in parts[4:]]))
    return cams


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    imgs: Dict[int, ColmapImage] = {}
    with open(path, "r", encoding="utf-8", errors="ignore") as f:
        lines = [l.rstrip("\n") for l in f]
    # images.txt alternates: pose line, then a 2D-point line (possibly empty).
    expecting_pose = True
    for line in lines:
        s = line.strip()
        if s.startswith("#"):
            continue
        if expecting_pose:
            if not s:
                continue  # blank lines before any pose are ignorable
            parts = s.split()
            iid = int(parts[0])
            qvec = np.array([float(v) for v in parts[1:5]])
            tvec = np.array([float(v) for v in parts[5:8]])
            imgs[iid] = ColmapImage(iid, qvec, tvec, int(parts[8]), parts[9])
            expecting_pose = False
        else:
            expecting_pose = True  # consumed the (possibly empty) points line
    return imgs


def read_points3d_text(path: str) -> Tuple[np.ndarray, np.ndarray]:
    points, colors = [], []
    with open(path, "r", encoding="utf-8", errors="ignore") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 7:
                continue
            points.append([float(v) for v in parts[1:4]])
            colors.append([float(v) / 255.0 for v in parts[4:7]])
    return (np.asarray(points, np.float32), np.asarray(colors, np.float32))


# ---------------------------- binary readers ----------------------------

def _read(f, fmt: str):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "<iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{num_params}d"))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    imgs: Dict[int, ColmapImage] = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            (camera_id,) = _read(f, "<i")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = _read(f, "<Q")
            f.seek(24 * n2d, 1)  # skip 2D points (x, y double + point3D id)
            imgs[iid] = ColmapImage(iid, qvec, tvec, camera_id, name.decode())
    return imgs


# A points3D.bin record before its track: id, xyz, rgb, error, track length.
_POINT3D = np.dtype([("id", "<u8"), ("xyz", "<f8", (3,)), ("rgb", "u1", (3,)),
                     ("error", "<f8"), ("track_len", "<u8")])


def read_points3d_binary(path: str) -> Tuple[np.ndarray, np.ndarray]:
    data = Path(path).read_bytes()
    (n,) = struct.unpack_from("<Q", data, 0)
    head = struct.Struct("<Q3d3BdQ")
    recs, pos = [], 8
    for _ in range(n):
        rec = head.unpack_from(data, pos)
        recs.append(rec[1:7])
        pos += head.size + 8 * rec[8]  # skip the track (image id, point2D)
    arr = np.array(recs, np.float64).reshape(n, 6)
    return (arr[:, :3].astype(np.float32),
            (arr[:, 3:] / 255.0).astype(np.float32))


# ---------------------------- binary writers (for tests/preprocess) ----------

def write_cameras_binary(cams: Dict[int, ColmapCamera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams.values():
            f.write(struct.pack("<iiQQ", c.id, CAMERA_MODEL_IDS[c.model],
                                c.width, c.height))
            f.write(struct.pack(f"<{len(c.params)}d", *c.params))


def write_images_binary(imgs: Dict[int, ColmapImage], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for im in imgs.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<4d", *im.qvec))
            f.write(struct.pack("<3d", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_binary(pts: np.ndarray, cols: np.ndarray, path: str) -> None:
    """Points with empty tracks and zero error, ids 0..n-1."""
    rec = np.zeros(len(pts), _POINT3D)
    rec["id"] = np.arange(len(pts))
    rec["xyz"] = np.asarray(pts).astype(np.float64)
    rec["rgb"] = (np.clip(cols, 0, 1) * 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        f.write(rec.tobytes())
