"""Camera model (counterpart of mini3dgs_tpu/core/camera.py).

A `Camera` holds float32 tensors on one device.  FoV is kept as a float32
scalar tensor, as in the JAX package, so the focal lengths the projection
derives from it are float32 too: a float64 focal moves the projected means
by ~1e-7 relative, enough to flip the toward-zero truncation in binning.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


def build_world_view_matrix(R, T, from_c2w: bool = True) -> torch.Tensor:
    """Build the 4x4 world->camera view matrix (float32, on the CPU).

    With C2W input ``R`` is the camera->world rotation R_cw and ``T`` the
    camera center C_w, so R_wc = R_cw^T and t_wc = -R_cw^T @ C_w.  With W2C
    input the pair is used directly."""
    R = np.asarray(R, dtype=np.float32).reshape(3, 3)
    T = np.asarray(T, dtype=np.float32).reshape(3)
    if from_c2w:
        R_wc = R.T
        t_wc = -(R_wc @ T)
    else:
        R_wc = R
        t_wc = T
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = R_wc
    view[:3, 3] = t_wc
    return torch.from_numpy(view)


def build_projection_matrix_v1(znear: float, zfar: float, fovX,
                               fovY) -> torch.Tensor:
    """OpenGL-style perspective matrix from the two FoVs (floats or float32
    scalar tensors; the matrix is on the FoVs' device)."""
    fovX = torch.as_tensor(fovX, dtype=torch.float32)
    fovY = torch.as_tensor(fovY, dtype=torch.float32, device=fovX.device)
    tx, ty = torch.tan(fovX * 0.5), torch.tan(fovY * 0.5)
    A = 1.0 / torch.where(tx.abs() < 1e-6, 1e-6, tx)
    B = 1.0 / torch.where(ty.abs() < 1e-6, 1e-6, ty)
    P = torch.zeros(4, 4, dtype=torch.float32, device=fovX.device)
    P[0, 0], P[1, 1] = A, B
    P[2, 2] = -(zfar + znear) / (zfar - znear)
    P[2, 3] = -(2.0 * zfar * znear) / (zfar - znear)
    P[3, 2] = -1.0
    return P


def build_projection_matrix_v2(znear: float, zfar: float, fovX: float,
                               fovY: float, width: int,
                               height: int) -> torch.Tensor:
    """The focal-length form of the same matrix (equal to v1)."""
    focal_x = (width / 2.0) / math.tan(float(fovX) / 2.0)
    focal_y = (height / 2.0) / math.tan(float(fovY) / 2.0)
    P = torch.zeros(4, 4, dtype=torch.float32)
    P[0, 0] = 2.0 * focal_x / width
    P[1, 1] = 2.0 * focal_y / height
    P[2, 2] = -(zfar + znear) / (zfar - znear)
    P[2, 3] = -2.0 * zfar * znear / (zfar - znear)
    P[3, 2] = -1.0
    return P


def focal_from_fov(fov, pixels: int) -> torch.Tensor:
    """f = 0.5 * pixels / tan(fov/2), in float32."""
    fov = torch.as_tensor(fov, dtype=torch.float32)
    return 0.5 * pixels / torch.tan(fov * 0.5)


def fov_from_focal(focal: float, pixels: int) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


@dataclass(frozen=True)
class Camera:
    """A single view.  `R` is the camera->world rotation, `T` the camera
    center in the world frame; `view_matrix` is the derived W2C matrix."""

    R: torch.Tensor             # [3,3]
    T: torch.Tensor             # [3]
    view_matrix: torch.Tensor   # [4,4]
    FoVx: torch.Tensor          # float32 scalar
    FoVy: torch.Tensor          # float32 scalar
    width: int = 0
    height: int = 0
    uid: int = 0
    image_name: str = ""
    znear: float = 0.1
    zfar: float = 1000.0
    image: Optional[torch.Tensor] = None  # [3,H,W] target image or None

    def replace(self, **changes) -> "Camera":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "Camera":
        """The same view with its tensors on `device`."""
        return self.replace(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    @classmethod
    def create(cls, uid: int, R, T, FoVx: float, FoVy: float, width: int,
               height: int, image_name: str = "", znear: float = 0.1,
               zfar: float = 1000.0, device="cpu", image=None) -> "Camera":
        R = np.asarray(R, dtype=np.float32).reshape(3, 3)
        T = np.asarray(T, dtype=np.float32).reshape(3)
        view = build_world_view_matrix(R, T, from_c2w=True)
        f32 = dict(dtype=torch.float32, device=device)
        if image is not None:
            image = torch.as_tensor(image, **f32)
        return cls(image=image, R=torch.as_tensor(R, **f32), T=torch.as_tensor(T, **f32),
                   view_matrix=view.to(device),
                   FoVx=torch.tensor(np.float32(FoVx), **f32),
                   FoVy=torch.tensor(np.float32(FoVy), **f32),
                   width=int(width), height=int(height), uid=int(uid),
                   image_name=image_name, znear=float(znear),
                   zfar=float(zfar))

    @property
    def world_view_transform(self) -> torch.Tensor:
        return self.view_matrix

    @property
    def projection_matrix(self) -> torch.Tensor:
        return build_projection_matrix_v1(self.znear, self.zfar, self.FoVx,
                                          self.FoVy)

    @property
    def full_proj_transform(self) -> torch.Tensor:
        return self.projection_matrix @ self.view_matrix

    @property
    def camera_center(self) -> torch.Tensor:
        """Camera position in the world frame, recovered from the view
        matrix."""
        R_wc = self.view_matrix[:3, :3]
        t_wc = self.view_matrix[:3, 3]
        return -(R_wc.T @ t_wc)

    @property
    def fx(self) -> torch.Tensor:
        return focal_from_fov(self.FoVx, self.width)

    @property
    def fy(self) -> torch.Tensor:
        return focal_from_fov(self.FoVy, self.height)


def project_points(points_3d: torch.Tensor, camera: Camera) -> torch.Tensor:
    """[N,3] world points -> [N,2] pixel coordinates, with the renderer's
    pinhole convention: x = fx X/Z + W/2, y = -fy Y/Z + H/2 (y down)."""
    V = camera.view_matrix
    Xc = points_3d @ V[:3, :3].T + V[:3, 3]
    X, Y, Z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    x = camera.fx * X / Z + 0.5 * camera.width
    y = -camera.fy * Y / Z + 0.5 * camera.height
    return torch.stack([x, y], dim=-1)


def project_points_ndc(points_3d: torch.Tensor,
                       camera: Camera) -> torch.Tensor:
    """[N,3] world points -> [N,3] NDC through the full 4x4 chain."""
    ones = torch.ones(points_3d.shape[0], 1, dtype=points_3d.dtype,
                      device=points_3d.device)
    clip = torch.cat([points_3d, ones], dim=-1) @ camera.full_proj_transform.T
    return clip[:, :3] / clip[:, 3:4]
