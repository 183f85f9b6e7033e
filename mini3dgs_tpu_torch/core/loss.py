"""Photometric loss: (1 - lambda) * L1 + lambda * D-SSIM (counterpart of
mini3dgs_tpu/core/loss.py), over a whole image and over an image sharded
into bands with a halo exchange.

SSIM uses a separable Gaussian blur with window K = 11, sigma = K/6,
C1 = 0.01^2, C2 = 0.03^2 and zero 'same' padding; the SSIM map is clamped
to [0, 1].  As in the JAX package the blur is an unrolled stencil of 11
shifted views per direction, summed in the same order, not a convolution:
a float32 `conv2d` on the GPU goes through cuDNN in TF32 by default, which
keeps three digits; the stencil stays in float32 and autograd gives its
transpose.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..parallel import mesh as M

C1 = 0.01 ** 2
C2 = 0.03 ** 2


def _gaussian_window(window_size: int, device=None) -> torch.Tensor:
    x = torch.arange(window_size, dtype=torch.float32, device=device) \
        - (window_size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2.0 * (window_size / 6.0) ** 2))
    return g / g.sum()


def _blur1d(img: torch.Tensor, g1d: torch.Tensor, axis: int,
            mode: str = "same") -> torch.Tensor:
    """out[x] = sum_k g[k] * in[x + k - K//2] along `axis` (2 or 3 of
    [B,C,H,W]).  "same" pads with zeros; "valid" keeps only the outputs
    whose window lies inside the input (K - 1 fewer)."""
    K = g1d.shape[0]
    if mode == "same":
        pad = K // 2
        src = F.pad(img, (pad, pad, 0, 0) if axis == 3 else (0, 0, pad, pad))
        n_out = img.shape[axis]
    else:
        src = img
        n_out = img.shape[axis] - K + 1
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


# ---------------------------------------------------------------------------
# Band-sharded loss with halo exchange (the `tile` axis of parallel/mesh.py).
#
# The 11 x 11 SSIM window has radius 5, so a band can compute its rows of the
# SSIM map exactly from a 5-row halo of (pred, target) exchanged with its
# neighbours: 5 * W * 3 * 2 floats per border instead of the whole image.
# `ppermute` hands zeros to a rank with no sender, which is the zero 'same'
# padding at the image's top and bottom.
# ---------------------------------------------------------------------------

HALO = 5  # window_size // 2 for the fixed K = 11 window


def _halo_extend(bands: Sequence[torch.Tensor],
                 devices: Sequence) -> List[torch.Tensor]:
    """Each [C, bh, W] band -> [C, bh + 2 * HALO, W] with its neighbours'
    border rows (zeros at the image's ends); None for the bands of other
    processes."""
    n = len(bands)
    tops = [None if b is None else b[:, :HALO] for b in bands]
    bots = [None if b is None else b[:, -HALO:] for b in bands]
    # the previous band's bottom rows become my top halo, the next band's
    # top rows my bottom halo
    prev_bot = M.ppermute(bots, [(i, i + 1) for i in range(n - 1)], devices)
    next_top = M.ppermute(tops, [(i + 1, i) for i in range(n - 1)], devices)
    return [None if b is None else torch.cat([p, b, t], dim=1)
            for p, b, t in zip(prev_bot, bands, next_top)]


def gaussian_loss_banded(band_preds: Sequence[torch.Tensor],
                         band_targets: Sequence[torch.Tensor],
                         devices: Sequence, lambda_dssim: float = 0.2,
                         window_size: int = 11
                         ) -> List[Tuple[torch.Tensor,
                                         Dict[str, torch.Tensor]]]:
    """`gaussian_loss` over an image sharded into equal bands of rows:
    `band_preds[i]` / `band_targets[i]` are rank i's [3, bh, W] rows on
    `devices[i]`.  Returns, per rank, the loss of the WHOLE image (summed
    over the ranks) and its components: equal to `gaussian_loss` on the
    assembled image up to the order of the final sums.  The bands of
    other processes' ranks are None, and so are their entries of the
    result; the gradient of a rank's loss reaches its own process's bands
    (`mesh.psum`)."""
    if window_size != 2 * HALO + 1:
        raise ValueError("the halo is derived for the K = 11 window")
    C, bh, W = band_preds[M.local_ranks(devices)[0]].shape
    if bh < HALO:
        raise ValueError(f"bands of {bh} rows are thinner than the halo")
    denom = C * bh * len(devices) * W
    preds = _halo_extend(band_preds, devices)
    targets = _halo_extend(band_targets, devices)
    l1_sums, ssim_sums = [], []
    for p_band, t_band, pred, target in zip(band_preds, band_targets, preds,
                                            targets):
        if pred is None:
            l1_sums.append(None)
            ssim_sums.append(None)
            continue
        pred, target = pred[None], target[None]
        g1d = _gaussian_window(window_size, pred.device).to(pred.dtype)
        # 'same' along x, 'valid' along y: on a band extended by its halo
        # this is the whole image's 'same' blur restricted to the band's
        # rows, summed in the same order.
        stack = torch.cat([pred, target, pred ** 2, target ** 2,
                           pred * target])
        mu_x, mu_y, xx, yy, xy = _blur1d(
            _blur1d(stack, g1d, axis=3), g1d, axis=2, mode="valid").chunk(5)
        sigma_x = xx - mu_x ** 2
        sigma_y = yy - mu_y ** 2
        sigma_xy = xy - mu_x * mu_y
        ssim_map = ((2 * mu_x * mu_y + C1) * (2 * sigma_xy + C2)) / (
            (mu_x ** 2 + mu_y ** 2 + C1) * (sigma_x + sigma_y + C2))
        ssim_sums.append(torch.clamp(ssim_map, 0.0, 1.0).sum())
        l1_sums.append((p_band - t_band).abs().sum())
    out = []
    for l1_sum, ssim_sum in zip(M.psum(l1_sums, devices),
                                M.psum(ssim_sums, devices)):
        if l1_sum is None:
            out.append(None)
            continue
        l1 = l1_sum / denom
        d = 1.0 - ssim_sum / denom
        total = (1.0 - lambda_dssim) * l1 + lambda_dssim * d
        out.append((total, {"l1": l1, "dssim": d, "total_loss": total}))
    return out
