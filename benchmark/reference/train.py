"""The plain reference's train step and frame: projection -> binning ->
compositing -> L1 + D-SSIM -> autograd -> Adam.  The loss is a frozen copy
of the measured package's (a separable 11-tap Gaussian blur as a stencil of
shifted views, C1 = 0.01^2, C2 = 0.03^2, zero padding, the SSIM map clamped
to [0, 1]).  Adam follows the 3DGS paper (Kerbl et al. 2023, section 7.1,
and the code published with it): b1 0.9, b2 0.999, eps 1e-8 outside the
square root; the position rate decays exponentially ("a standard
exponential decay scheduling technique ... for positions only"), every
other group keeps its constant rate.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import raster
from .projection import Camera, project

PARAMS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")
B1, B2, EPS = 0.9, 0.999, 1e-8
SSIM_C1, SSIM_C2 = 0.01 ** 2, 0.03 ** 2


@dataclass(frozen=True)
class Settings:
    """What the recipe and the configuration fix for a step or a frame."""

    tile_size: int
    bg: Tuple[float, float, float]
    sh_degree: int
    radius_min: float
    radius_max: float
    lambda_dssim: float = 0.2
    # Adam: the constant rates of the groups other than xyz, and the
    # exponential schedule of the position rate (already times the extent).
    lrs: Tuple[Tuple[str, float], ...] = ()
    position_lr_init: float = 0.0
    position_lr_final: float = 0.0
    position_lr_delay_steps: int = 0
    position_lr_delay_mult: float = 1.0
    position_lr_max_steps: int = 1


@dataclass
class AdamState:
    count: int
    sched_count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def _blur1d(img: torch.Tensor, g: torch.Tensor, axis: int) -> torch.Tensor:
    K = g.shape[0]
    pad = K // 2
    src = F.pad(img, (pad, pad, 0, 0) if axis == 3 else (0, 0, pad, pad))
    out = None
    for k in range(K):
        term = g[k] * src.narrow(axis, k, img.shape[axis])
        out = term if out is None else out + term
    return out


def ssim(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    x = torch.arange(11, dtype=pred.dtype, device=pred.device) - 5.0
    g = torch.exp(-(x ** 2) / (2.0 * (11 / 6.0) ** 2))
    g = g / g.sum()
    pred, target = pred[None], target[None]
    mu_x, mu_y, xx, yy, xy = _blur1d(_blur1d(
        torch.cat([pred, target, pred ** 2, target ** 2, pred * target]),
        g, 3), g, 2).chunk(5)
    sx, sy, sxy = xx - mu_x ** 2, yy - mu_y ** 2, xy - mu_x * mu_y
    m = ((2 * mu_x * mu_y + SSIM_C1) * (2 * sxy + SSIM_C2)) / (
        (mu_x ** 2 + mu_y ** 2 + SSIM_C1) * (sx + sy + SSIM_C2))
    return torch.clamp(m, 0.0, 1.0).mean()


def photometric_loss(image, target, lambda_dssim: float) -> torch.Tensor:
    l1 = (image - target).abs().mean()
    return (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim(image,
                                                                   target))


def render(params: dict, cam: Camera, st: Settings,
           count_pairs: bool = False):
    """(image [3, H, W], bins, pair counts or None) of one frame."""
    with torch.no_grad():
        proj = project(params, cam, sh_degree=st.sh_degree,
                       radius_min=st.radius_min, radius_max=st.radius_max)
        bg = torch.tensor(st.bg, dtype=proj.depth.dtype,
                          device=proj.depth.device)
        return raster.render(proj, cam.height, cam.width, st.tile_size, bg,
                             count_pairs)


def loss_and_grads(params: dict, cam: Camera, target: torch.Tensor,
                   st: Settings, loss_fn=photometric_loss):
    """(loss, {name: gradient}) of one view: the forward walk without a
    graph, the loss's gradient with respect to the accumulators, then the
    walk again under autograd in blocks of tiles, and autograd through
    the projection of the Gaussians that reach a tile.  A Gaussian that
    reaches none contributes nothing, so its gradient is exactly 0 (its
    projection may not be finite: a centre just in front of the camera's
    plane overflows the 2D covariance)."""
    H, W, ts = cam.height, cam.width, st.tile_size
    with torch.no_grad():
        bins = raster.bin_tiles(project(
            params, cam, sh_degree=st.sh_degree, radius_min=st.radius_min,
            radius_max=st.radius_max), H, W, ts)
    ids, inst = torch.unique(bins.gid, return_inverse=True)
    leaves = {k: params[k].detach().requires_grad_(True) for k in PARAMS}
    proj = project({k: v[ids] for k, v in leaves.items()}, cam,
                   sh_degree=st.sh_degree, radius_min=st.radius_min,
                   radius_max=st.radius_max)
    rows = raster.stream_rows(proj)
    stream = rows.detach()[:, inst]
    acc, used, _ = raster.composite(stream, bins, ts)
    acc = acc.requires_grad_(True)
    bg = torch.tensor(st.bg, dtype=acc.dtype, device=acc.device)
    image = raster.compose_image(acc, bins, ts, H, W, bg)
    loss = loss_fn(image, target.to(acc.dtype), st.lambda_dssim)
    gout, = torch.autograd.grad(loss, acc)
    d_stream = raster.composite_backward(stream, bins, ts, used, gout)
    d_rows = torch.zeros_like(rows).index_add_(1, inst, d_stream)
    grads = torch.autograd.grad(rows, [leaves[k] for k in PARAMS], d_rows,
                                allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(params[k]) if g is None else g
                           for k, g in zip(PARAMS, grads)}


def position_lr(st: Settings, iteration: int) -> float:
    """The paper's position rate at `iteration` (1 at the first step): the
    log-linear path from init to final over max_steps, times a sine ramp
    from delay_mult over delay_steps where those are set (the published
    code's get_expon_lr_func)."""
    if st.position_lr_delay_steps > 0:
        delay = st.position_lr_delay_mult + (
            1.0 - st.position_lr_delay_mult) * math.sin(0.5 * math.pi * min(
                max(iteration / st.position_lr_delay_steps, 0.0), 1.0))
    else:
        delay = 1.0
    t = min(max(iteration / st.position_lr_max_steps, 0.0), 1.0)
    return delay * math.exp(math.log(st.position_lr_init) * (1.0 - t)
                            + math.log(st.position_lr_final) * t)


@torch.no_grad()
def adam(params: dict, grads: dict, state: AdamState, st: Settings):
    count = state.count + 1
    c1, c2 = 1.0 - B1 ** count, 1.0 - B2 ** count
    # sched_count steps are done: this one is iteration sched_count + 1
    lrs = dict(st.lrs, xyz=position_lr(st, state.sched_count + 1))
    new, mu, nu = {}, {}, {}
    for k in PARAMS:
        g = grads[k]
        mu[k] = B1 * state.mu[k] + (1.0 - B1) * g
        nu[k] = B2 * state.nu[k] + (1.0 - B2) * g * g
        step = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + EPS)
        new[k] = params[k] - step * lrs[k]
    return new, AdamState(count, state.sched_count + 1, mu, nu)


def train_steps(params: dict, state: AdamState, views, st: Settings,
                loss_fn=photometric_loss):
    """Follow len(views) steps, `views` a list of (Camera, target).
    Returns (losses, the first step's gradients, the parameters after the
    last step)."""
    losses, first = [], None
    for cam, target in views:
        loss, grads = loss_and_grads(params, cam, target, st, loss_fn)
        losses.append(float(loss))
        if first is None:
            first = grads
        params, state = adam(params, grads, state, st)
    return losses, first, params


def scene_extent(centers) -> float:
    """1.1 times the largest distance of a camera centre from the rig's
    mean centre: the unit the position rate is scaled by."""
    c = torch.stack([x.float() for x in centers])
    return 1.1 * float(torch.linalg.vector_norm(c - c.mean(0), dim=1).max())
