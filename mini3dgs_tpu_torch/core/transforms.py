"""Rotation and covariance math (counterpart of
mini3dgs_tpu/core/transforms.py).

`ops/projection.py` inlines the covariance chain component by component;
`quat_to_rotmat`, `build_covariance_3d` and `project_covariance_2d` are the
same math as matrices, for callers and tests that want the whole matrix.
"""

from __future__ import annotations

import torch


def quat_to_rotmat_components(q: torch.Tensor):
    """[..., 4] wxyz quaternion -> the 9 rotation-matrix entries as a tuple
    of [...] tensors (row-major r00..r22).  Normalizes first."""
    q = normalize_quat(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] wxyz quaternion -> [..., 3, 3] rotation.  Normalizes first."""
    R = torch.stack(quat_to_rotmat_components(q), dim=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def build_covariance_3d(scaling: torch.Tensor,
                        rotation_q: torch.Tensor) -> torch.Tensor:
    """Sigma = R diag(sigma^2) R^T, [..., 3, 3]; scaling holds sigma (not
    log)."""
    R = quat_to_rotmat(rotation_q)
    RS = R * (scaling[..., None, :] ** 2)
    return torch.einsum("...ij,...kj->...ik", RS, R)


def project_covariance_2d(cov3d: torch.Tensor, view_rot: torch.Tensor,
                          J: torch.Tensor) -> torch.Tensor:
    """The EWA projection Sigma2D = J (Rv Sigma Rv^T) J^T: cov3d [..., 3, 3],
    view_rot [3, 3], J [..., 2, 3] -> [..., 2, 2]."""
    cov_cam = torch.einsum("ij,...jk,lk->...il", view_rot, cov3d, view_rot)
    return torch.einsum("...ij,...jk,...lk->...il", J, cov_cam, J)


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def normalize_quat(q: torch.Tensor) -> torch.Tensor:
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
