"""Adaptive density control on the fixed slot pool (counterpart of
mini3dgs_tpu/train/density.py).

  * split: candidates with mean accumulated gradient > tau and mean sigma >
    percent_dense_split * extent are replaced by two children offset
    +-0.5 * mean(sigma) along the rotated first axis, child scale 0.75 *
    sigma, opacity logit clamped to +-6; the parent dies.
  * clone: candidates with gradient > tau and mean sigma <
    percent_dense_clone * extent get one copy jittered by
    N(0,1) * 0.5 * mean(sigma); the original stays.
  * prune: keep sigmoid(opacity) > threshold (and, when `size_prune`, the
    screen-size and world-size bounds).

Children go into the free slots in ascending order, splits' first children
first, then their second children, then clones, exactly as in the JAX
package, so slots match one for one; children beyond the pool's capacity
are dropped and counted.  The clone jitter's N(0,1) draw is an argument:
the two frameworks' generators give different numbers from one seed.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import TrainingConfig
from ..core.gaussians import Gaussians
from ..core.transforms import quat_to_rotmat_components


class DensifyResult(NamedTuple):
    gaussians: Gaussians
    changed_slots: torch.Tensor  # [C] bool: slots whose Adam state resets
    n_split: int
    n_clone: int
    n_pruned: int
    n_dropped: int               # children lost to capacity overflow


def should_densify(iteration: int, config: TrainingConfig) -> bool:
    return (config.densify_from_iter <= iteration <= config.densify_until_iter
            and iteration % config.densify_interval == 0)


def should_prune(iteration: int, config: TrainingConfig) -> bool:
    """Standalone prune cadence; a densify pass at the same iteration
    already prunes."""
    return (config.prune_interval > 0
            and iteration % config.prune_interval == 0
            and not should_densify(iteration, config))


def accumulate_grad_stats(g: Gaussians, grad_norm: torch.Tensor,
                          radii: torch.Tensor,
                          visible: torch.Tensor) -> Gaussians:
    """Add a per-Gaussian gradient norm [C] into the statistic buffers,
    on the steps the Gaussian was visible."""
    vis = visible.float()
    return g.replace(
        xyz_gradient_accum=g.xyz_gradient_accum + grad_norm * vis,
        denom=g.denom + vis,
        max_radii2D=torch.maximum(g.max_radii2D, radii * vis))


def densify_stat_norm(config: TrainingConfig, xyz_grad: torch.Tensor,
                      vs_grad: torch.Tensor, height: int,
                      width: int) -> torch.Tensor:
    """The densification statistic [C]: "viewspace" (default) is
    ||dL/d means2D|| scaled by 0.5 * max(H, W) to NDC units; "world" is
    ||dL/d xyz||."""
    if config.densify_grad_space == "world":
        return torch.linalg.norm(xyz_grad, dim=-1)
    return torch.linalg.norm(vs_grad, dim=-1) * (0.5 * float(max(height,
                                                                  width)))


def size_mask_quantile(g: Gaussians, percent_dense: float) -> torch.Tensor:
    """Alive Gaussians whose mean sigma exceeds the `percent_dense`
    quantile of the alive mean sigmas."""
    size = g.get_scaling.mean(dim=-1)
    th = torch.quantile(size[g.alive], percent_dense)
    return g.alive & (size > th)


def prune_only(g: Gaussians,
               config: TrainingConfig) -> Tuple[Gaussians, int]:
    """Opacity-only prune.  Returns (gaussians, n_pruned)."""
    keep = torch.sigmoid(g.opacity[:, 0]) > config.prune_opacity_threshold
    n_pruned = int((g.alive & ~keep).sum())
    return g.replace(alive=g.alive & keep), n_pruned


def densify_and_prune(g: Gaussians, noise: torch.Tensor, scene_extent: float,
                      config: TrainingConfig,
                      size_prune: bool = False) -> DensifyResult:
    """`noise` [C,3]: standard normal draws for the clone jitter."""
    C = g.capacity
    dev = g.device
    scene_extent = float(scene_extent)
    grad = g.xyz_gradient_accum / torch.clamp(g.denom, min=1.0)
    sigma = g.get_scaling
    size = sigma.mean(dim=-1)
    tau = config.densify_grad_threshold

    hot = g.alive & (grad > tau)
    split_mask = hot & (size > config.percent_dense_split * scene_extent)
    clone_mask = hot & (size < config.percent_dense_clone * scene_extent)

    # Parents of splits die; their slots are reusable at once.
    alive_after_kill = g.alive & ~split_mask
    free_idx = torch.nonzero(~alive_after_kill)[:, 0]  # ascending
    split_src = torch.nonzero(split_mask)[:, 0]
    clone_src = torch.nonzero(clone_mask)[:, 0]
    n_split, n_clone = split_src.shape[0], clone_src.shape[0]
    n_free = free_idx.shape[0]

    def take_free(first: int, src: torch.Tensor):
        """(source rows, slots) of the children allocated from rank `first`
        on; children past the last free slot are dropped."""
        n = max(0, min(src.shape[0], n_free - first))
        return src[:n], free_idx[first:first + n]

    src1, slot1 = take_free(0, split_src)
    src2, slot2 = take_free(n_split, split_src)
    src3, slot3 = take_free(2 * n_split, clone_src)

    r = quat_to_rotmat_components(g.rotation)
    mean_sig = sigma.mean(dim=-1, keepdim=True)
    offset = torch.stack([r[0], r[3], r[6]], dim=-1) * (mean_sig * 0.5)
    split_scaling = torch.log(torch.clamp(sigma * 0.75, min=1e-12))
    split_opacity = torch.clamp(g.opacity, -6.0, 6.0)
    clone_xyz = g.xyz + noise * (mean_sig * 0.5)

    new = {k: v.clone() for k, v in g.params().items()}
    alive = alive_after_kill.clone()
    newly = torch.zeros(C, dtype=torch.bool, device=dev)
    for src, slots, xyz_src, scaling_src, opacity_src in (
            (src1, slot1, g.xyz - offset, split_scaling, split_opacity),
            (src2, slot2, g.xyz + offset, split_scaling, split_opacity),
            (src3, slot3, clone_xyz, g.scaling, g.opacity)):
        new["xyz"][slots] = xyz_src[src]
        new["features_dc"][slots] = g.features_dc[src]
        new["features_rest"][slots] = g.features_rest[src]
        new["scaling"][slots] = scaling_src[src]
        new["rotation"][slots] = g.rotation[src]
        new["opacity"][slots] = opacity_src[src]
        alive[slots] = True
        newly[slots] = True

    keep = torch.sigmoid(new["opacity"][:, 0]) > config.prune_opacity_threshold
    if size_prune:
        # Screen size uses the window's max radius from before the surgery
        # and exempts slots just written (their buffer rows belong to the
        # previous occupant); world size uses the new scales.
        if config.prune_max_screen_size > 0:
            keep &= newly | (g.max_radii2D <= config.prune_max_screen_size)
        if config.prune_max_world_size > 0:
            sig_new = torch.exp(new["scaling"]).max(dim=-1).values
            keep &= sig_new <= config.prune_max_world_size * scene_extent
    n_pruned = int((alive & ~keep).sum())
    alive_final = alive & keep

    g_new = g.replace(
        **new, alive=alive_final,
        xyz_gradient_accum=torch.zeros_like(g.xyz_gradient_accum),
        denom=torch.zeros_like(g.denom),
        max_radii2D=torch.zeros_like(g.max_radii2D))
    n_alloc = slot1.shape[0] + slot2.shape[0] + slot3.shape[0]
    return DensifyResult(g_new, (alive_final != g.alive) | newly, n_split,
                         n_clone, n_pruned, 2 * n_split + n_clone - n_alloc)
