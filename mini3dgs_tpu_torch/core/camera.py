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
