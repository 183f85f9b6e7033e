"""EWA projection and spherical harmonics, plain (frozen copy of the
measured package's projection, SH and quaternion code, written against
plain tensors).

Pinhole x = fx X/Z + W/2, y = -fy Y/Z + H/2 (y down); Sigma_2D =
J Rv Sigma Rv^T J^T + 1e-6 I, written out component by component (no
matmul, so no TF32 path); radius 3 sqrt(lambda_max) clamped; cull Z > 0
and the radius-padded viewport; colour clamp(SH + 0.5, min=0); opacity
sigmoid.  Every tensor takes the dtype of the Gaussians it is given.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
# Pixels with a weight below W_EPS are skipped; a tile whose pixels all lie
# beyond the weight's W_EPS contour gets nothing from the Gaussian.
W_EPS = 1e-5


@dataclass(frozen=True)
class Camera:
    """A view: `view` the 4x4 world->camera matrix, the two fields of view
    as scalar tensors, the image size."""

    view: torch.Tensor
    fovx: torch.Tensor
    fovy: torch.Tensor
    width: int
    height: int

    @classmethod
    def from_pose(cls, R, T, fovx: float, fovy: float, width: int,
                  height: int, device, dtype=torch.float32) -> "Camera":
        """From the camera->world rotation R and the centre T, as float32
        numpy (R_wc = R^T, t = -R_wc T), then cast to `dtype`."""
        R = np.asarray(R, np.float32).reshape(3, 3)
        T = np.asarray(T, np.float32).reshape(3)
        view = np.eye(4, dtype=np.float32)
        view[:3, :3] = R.T
        view[:3, 3] = -(R.T @ T)
        f32 = dict(dtype=torch.float32, device=device)
        return cls(view=torch.as_tensor(view, **f32).to(dtype),
                   fovx=torch.tensor(np.float32(fovx), **f32).to(dtype),
                   fovy=torch.tensor(np.float32(fovy), **f32).to(dtype),
                   width=int(width), height=int(height))

    @property
    def center(self) -> torch.Tensor:
        R_wc, t_wc = self.view[:3, :3], self.view[:3, 3]
        return -(R_wc.T @ t_wc)


class Projected(NamedTuple):
    means2d: torch.Tensor   # [n, 2]
    conic: torch.Tensor     # [n, 3] (a, b, c) of the inverse 2D covariance
    depth: torch.Tensor     # [n]
    radius: torch.Tensor    # [n]
    visible: torch.Tensor   # [n] bool
    color: torch.Tensor     # [n, 3]
    opacity: torch.Tensor   # [n]
    ext_x: torch.Tensor     # [n] half-extents of the W_EPS contour (+1 px)
    ext_y: torch.Tensor


def _dot3(u, v):
    return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]


def rotmat_components(q: torch.Tensor):
    """[n, 4] wxyz quaternion (normalised here) -> the 9 entries r00..r22."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy))


def eval_sh(degree: int, coeffs: torch.Tensor,
            dirs: torch.Tensor) -> torch.Tensor:
    """Real SH of degree 0..3: coeffs [n, 16, 3], unit dirs [n, 3]."""
    result = SH_C0 * coeffs[..., 0, :]
    if degree < 1:
        return result
    x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
    result = (result - SH_C1 * y * coeffs[..., 1, :]
              + SH_C1 * z * coeffs[..., 2, :] - SH_C1 * x * coeffs[..., 3, :])
    if degree < 2:
        return result
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    result = (result + SH_C2[0] * xy * coeffs[..., 4, :]
              + SH_C2[1] * yz * coeffs[..., 5, :]
              + SH_C2[2] * (2.0 * zz - xx - yy) * coeffs[..., 6, :]
              + SH_C2[3] * xz * coeffs[..., 7, :]
              + SH_C2[4] * (xx - yy) * coeffs[..., 8, :])
    if degree < 3:
        return result
    return (result + SH_C3[0] * y * (3.0 * xx - yy) * coeffs[..., 9, :]
            + SH_C3[1] * xy * z * coeffs[..., 10, :]
            + SH_C3[2] * y * (4.0 * zz - xx - yy) * coeffs[..., 11, :]
            + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy)
            * coeffs[..., 12, :]
            + SH_C3[4] * x * (4.0 * zz - xx - yy) * coeffs[..., 13, :]
            + SH_C3[5] * z * (xx - yy) * coeffs[..., 14, :]
            + SH_C3[6] * x * (xx - 3.0 * yy) * coeffs[..., 15, :])


def project(params: dict, cam: Camera, *, sh_degree: int,
            radius_min: float, radius_max: float) -> Projected:
    """Project the Gaussians `params` (xyz, features_dc, features_rest,
    scaling as log-sigma, rotation wxyz, opacity logit) into `cam`."""
    W, H = cam.width, cam.height
    fx = 0.5 * W / torch.tan(cam.fovx * 0.5)
    fy = 0.5 * H / torch.tan(cam.fovy * 0.5)
    cx, cy = 0.5 * W, 0.5 * H
    Rv, Tv = cam.view[:3, :3], cam.view[:3, 3]
    Xw = params["xyz"]
    X, Y, Z = (_dot3(Rv[i], (Xw[:, 0], Xw[:, 1], Xw[:, 2])) + Tv[i]
               for i in range(3))
    front = Z > 1e-6
    invZ = 1.0 / torch.where(front, Z, torch.ones_like(Z))
    invZ2 = invZ * invZ
    xpix = fx * X * invZ + cx
    ypix = -fy * Y * invZ + cy

    sigma = torch.exp(params["scaling"])
    s0, s1, s2 = sigma[:, 0], sigma[:, 1], sigma[:, 2]
    r = rotmat_components(params["rotation"])
    rows = []
    for i in range(3):
        m0, m1, m2 = Rv[i, 0], Rv[i, 1], Rv[i, 2]
        rows.append(((m0 * r[0] + m1 * r[3] + m2 * r[6]) * s0,
                     (m0 * r[1] + m1 * r[4] + m2 * r[7]) * s1,
                     (m0 * r[2] + m1 * r[5] + m2 * r[8]) * s2))
    j00, j02 = fx * invZ, -fx * X * invZ2
    j11, j12 = -fy * invZ, fy * Y * invZ2
    c00, c01, c02 = (_dot3(rows[0], rows[0]), _dot3(rows[0], rows[1]),
                     _dot3(rows[0], rows[2]))
    c11, c12, c22 = (_dot3(rows[1], rows[1]), _dot3(rows[1], rows[2]),
                     _dot3(rows[2], rows[2]))
    a = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22) + 1e-6
    b = j11 * (j00 * c01 + j02 * c12) + j12 * (j00 * c02 + j02 * c22)
    c = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22) + 1e-6

    det = a * c - b * b
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    inv_det = 1.0 / det
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)
    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(0.25 * (a - c) ** 2 + b * b, min=0.0))
    lam_max = torch.clamp(mid + disc, min=1e-12)
    radius = torch.clamp(3.0 * torch.sqrt(lam_max), radius_min, radius_max)
    visible = (front & (xpix >= -radius) & (xpix < W + radius)
               & (ypix >= -radius) & (ypix < H + radius) & (radius > 0))

    dirs = Xw - cam.center[None, :]
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    coeffs = torch.cat([params["features_dc"], params["features_rest"]], 1)
    color = torch.clamp(eval_sh(sh_degree, coeffs, dirs) + 0.5, min=0.0)
    opacity = torch.sigmoid(params["opacity"][:, 0])

    cull_sigma = math.sqrt(2.0 * math.log(1.0 / W_EPS))
    ext_x = cull_sigma * torch.sqrt(torch.clamp(a, min=0.0)) + 1.0
    ext_y = cull_sigma * torch.sqrt(torch.clamp(c, min=0.0)) + 1.0
    return Projected(torch.stack([xpix, ypix], -1), conic, Z, radius,
                     visible, color, opacity, ext_x, ext_y)
