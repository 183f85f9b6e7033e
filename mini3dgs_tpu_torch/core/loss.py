"""Photometric loss: (1 - lambda) * L1 + lambda * D-SSIM (counterpart of
mini3dgs_tpu/core/loss.py; the band-sharded loss is not ported yet).

SSIM uses a separable Gaussian blur with window K = 11, sigma = K/6,
C1 = 0.01^2, C2 = 0.03^2 and zero 'same' padding; the SSIM map is clamped
to [0, 1].  As in the JAX package the blur is an unrolled stencil of 11
shifted views per direction, summed in the same order, not a convolution:
a float32 `conv2d` on the GPU goes through cuDNN in TF32 by default, which
keeps three digits; the stencil stays in float32 and autograd gives its
transpose.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

C1 = 0.01 ** 2
C2 = 0.03 ** 2


def _gaussian_window(window_size: int, device=None) -> torch.Tensor:
    x = torch.arange(window_size, dtype=torch.float32, device=device) \
        - (window_size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2.0 * (window_size / 6.0) ** 2))
    return g / g.sum()


def _blur1d(img: torch.Tensor, g1d: torch.Tensor, axis: int) -> torch.Tensor:
    """out[x] = sum_k g[k] * in[x + k - K//2] along `axis` (2 or 3 of
    [B,C,H,W]), zero padding."""
    K = g1d.shape[0]
    pad = K // 2
    src = F.pad(img, (pad, pad, 0, 0) if axis == 3 else (0, 0, pad, pad))
    n_out = img.shape[axis]
    out = None
    for k in range(K):
        term = g1d[k] * src.narrow(axis, k, n_out)
        out = term if out is None else out + term
    return out


def _blur(img: torch.Tensor, g1d: torch.Tensor) -> torch.Tensor:
    """Separable depthwise blur of [B,C,H,W] with 'same' zero padding."""
    return _blur1d(_blur1d(img, g1d, axis=3), g1d, axis=2)


def ssim(pred: torch.Tensor, target: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over the image.  Inputs [C,H,W] or [B,C,H,W]."""
    if pred.ndim == 3:
        pred, target = pred[None], target[None]
    g1d = _gaussian_window(window_size, pred.device).to(pred.dtype)
    # The five blurs as one batch: the same per-element sums in a fifth of
    # the kernel launches.
    mu_x, mu_y, xx, yy, xy = _blur(
        torch.cat([pred, target, pred ** 2, target ** 2, pred * target]),
        g1d).chunk(5)
    sigma_x = xx - mu_x ** 2
    sigma_y = yy - mu_y ** 2
    sigma_xy = xy - mu_x * mu_y
    ssim_map = ((2 * mu_x * mu_y + C1) * (2 * sigma_xy + C2)) / (
        (mu_x ** 2 + mu_y ** 2 + C1) * (sigma_x + sigma_y + C2))
    return torch.clamp(ssim_map, 0.0, 1.0).mean()


def dssim(pred: torch.Tensor, target: torch.Tensor,
          window_size: int = 11) -> torch.Tensor:
    return 1.0 - ssim(pred, target, window_size)


def gaussian_loss(rendered: torch.Tensor, target: torch.Tensor,
                  lambda_dssim: float = 0.2
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss and its components."""
    l1 = (rendered - target).abs().mean()
    d = dssim(rendered, target)
    total = (1.0 - lambda_dssim) * l1 + lambda_dssim * d
    return total, {"l1": l1, "dssim": d, "total_loss": total}
