"""Per-camera exposure compensation (counterpart of
mini3dgs_tpu/train/exposure.py): one learnable 3x4 affine colour transform
per training camera, applied to the rendered image before the loss,

    image' = M[:, :3] @ image + M[:, 3]

initialised to the identity and trained with its own Adam
(`config.exposure_lr`).
"""

from __future__ import annotations

import torch


def init_exposure(n_cameras: int, device="cpu") -> torch.Tensor:
    """[n, 3, 4] identity affine colour transforms."""
    eye = torch.cat([torch.eye(3, dtype=torch.float32, device=device),
                     torch.zeros(3, 1, dtype=torch.float32, device=device)],
                    dim=1)
    return eye[None].repeat(n_cameras, 1, 1)


def apply_exposure(M: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """Apply one [3,4] affine colour transform to a [3,H,W] image.  Written
    per channel in float32 (no matmul, so no TF32 path on the GPU)."""
    return (M[:, 0, None, None] * image[0] + M[:, 1, None, None] * image[1]
            + M[:, 2, None, None] * image[2] + M[:, 3, None, None])
