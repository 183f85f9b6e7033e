"""Image and point-cloud IO (counterpart of mini3dgs_tpu/utils/io.py).

Images go through the package's own PNG codec (`utils/png.py`), point
clouds through numpy, the COLMAP readers and a minimal binary PLY reader
and writer: nothing here needs Pillow or plyfile.  Images come back as
numpy arrays on the host; the datasets move them to their device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.colmap import read_points3d_binary
from . import png


def save_image(image, path: str) -> None:
    """image: [3,H,W] float in [0,1] (a numpy array or a tensor on any
    device), written as an 8-bit RGB PNG."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    arr = np.asarray(image)
    arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
    Path(path).write_bytes(png.encode(arr))


def load_image(path: str, bg: float = 1.0) -> np.ndarray:
    """Returns [3,H,W] float32 in [0,1].  RGBA alpha is composited onto `bg`
    (scalar or [3]); grey is repeated over the three channels."""
    img = png.decode(Path(path).read_bytes()).astype(np.float32) / 255.0
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] == 4:
        rgb, a = img[..., :3], img[..., 3:4]
        img = rgb * a + (1.0 - a) * np.asarray(bg, np.float32)
    return img.transpose(2, 0, 1)


def save_point_cloud(points: np.ndarray, colors: Optional[np.ndarray],
                     path: str) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    points = np.asarray(points, np.float32)
    if p.suffix == ".npz":
        if colors is None:
            np.savez(p, points=points)
        else:
            np.savez(p, points=points, colors=np.asarray(colors, np.float32))
    elif p.suffix == ".npy":
        if colors is None:
            colors = np.ones_like(points)
        np.save(p, np.concatenate([points, np.asarray(colors, np.float32)],
                                  axis=1))
    elif p.suffix == ".ply":
        save_ply(points, colors, str(p))
    else:
        cols = colors if colors is not None else np.ones_like(points)
        np.savetxt(p, np.concatenate([points, cols], axis=1), fmt="%.6f")


def load_point_cloud(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """npz (points, colors), npy [N, >=6], ply, COLMAP points3D.bin / .txt,
    or whitespace text `x y z [r g b]`."""
    p = Path(path)
    suffix = p.suffix.lower()
    if suffix == ".npz":
        data = np.load(str(p))
        pts = data["points"] if "points" in data else np.zeros((0, 3), np.float32)
        cols = data["colors"] if "colors" in data else None
        return pts.astype(np.float32), (None if cols is None else cols.astype(np.float32))
    if suffix == ".npy":
        arr = np.load(str(p))
        if arr.ndim == 2 and arr.shape[1] >= 6:
            return arr[:, :3].astype(np.float32), arr[:, 3:6].astype(np.float32)
        return arr[:, :3].astype(np.float32), None
    if suffix == ".ply":
        return load_ply(str(p))
    if suffix == ".bin" and p.name == "points3D.bin":
        return read_points3d_binary(str(p))
    if suffix == ".txt" and p.name == "points3D.txt":
        points, colors = [], []
        with open(p, "r", encoding="utf-8", errors="ignore") as f:
            for line in f:
                if not line or line.startswith("#"):
                    continue
                parts = line.strip().split()
                if len(parts) < 10:
                    continue
                points.append([float(v) for v in parts[1:4]])
                colors.append([float(v) / 255.0 for v in parts[4:7]])
        return (np.asarray(points, np.float32), np.asarray(colors, np.float32))
    pts, cols = [], []
    with open(p, "r", encoding="utf-8", errors="ignore") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                parts = [float(v) for v in line.split()]
            except ValueError:
                continue
            if len(parts) >= 3:
                pts.append(parts[:3])
                if len(parts) >= 6:
                    cols.append(parts[3:6])
    pts_arr = np.asarray(pts, np.float32)
    cols_arr = np.asarray(cols, np.float32) if cols else None
    return pts_arr, cols_arr


# ---- PLY point clouds: binary little-endian x, y, z [, red, green, blue] --

_PLY_TYPES = {"float": "<f4", "float32": "<f4", "double": "<f8",
              "float64": "<f8", "uchar": "u1", "uint8": "u1", "char": "i1",
              "int8": "i1", "short": "<i2", "int16": "<i2", "ushort": "<u2",
              "uint16": "<u2", "int": "<i4", "int32": "<i4", "uint": "<u4",
              "uint32": "<u4"}


def save_ply(points: np.ndarray, colors: Optional[np.ndarray],
             path: str) -> None:
    n = len(points)
    cols = (np.clip(colors if colors is not None else np.ones_like(points),
                    0, 1) * 255).astype(np.uint8)
    header = (b"ply\nformat binary_little_endian 1.0\n"
              + f"element vertex {n}\n".encode()
              + b"property float x\nproperty float y\nproperty float z\n"
              + b"property uchar red\nproperty uchar green\nproperty uchar blue\n"
              + b"end_header\n")
    rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                             ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    rec["x"], rec["y"], rec["z"] = np.asarray(points, np.float32).T
    rec["red"], rec["green"], rec["blue"] = cols.T
    with open(path, "wb") as f:
        f.write(header)
        f.write(rec.tobytes())


def load_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """The vertex element of a binary little-endian PLY whose first element
    is `vertex`: (xyz float32, rgb / 255 or None)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no PLY end_header")
            header += line
        lines = header.decode().splitlines()
        if "format binary_little_endian 1.0" not in lines:
            raise ValueError(f"{path}: only binary little-endian PLY is read")
        elements = [l for l in lines if l.startswith("element")]
        if not elements or elements[0].split()[1] != "vertex":
            raise ValueError(f"{path}: the first PLY element is not vertex")
        n = int(elements[0].split()[-1])
        props = []
        for l in lines[lines.index(elements[0]) + 1:]:
            if l.startswith("element"):
                break
            if l.startswith("property list"):
                raise ValueError(f"{path}: list properties on vertices")
            if l.startswith("property"):
                _, t, name = l.split()
                props.append((name, _PLY_TYPES[t]))
        dtype = np.dtype(props)
        rec = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
    pts = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float32)
    if all(c in rec.dtype.names for c in ("red", "green", "blue")):
        cols = np.stack([rec["red"], rec["green"], rec["blue"]],
                        axis=1).astype(np.float32) / 255.0
        return pts, cols
    return pts, None
