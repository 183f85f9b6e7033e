"""The single-device training step and the density-control steps around it
(counterpart of mini3dgs_tpu/train/trainer.py's `make_step_body`,
`make_densify_step`, `make_prune_step` and the opacity reset).

State is functional, as in the JAX package: every step takes a `TrainState`
and returns a new one, leaving its argument untouched.  PyTorch runs
eagerly, so there is nothing to jit and a step is a plain function of
(state, camera).  The step over a mesh of ranks is
parallel/sharded.make_sharded_train_step, which shares `apply_gradients`.
`GaussianTrainer` (datasets, checkpoints, capacity growth, compaction) is
not ported yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from ..config import TrainingConfig
from ..core.camera import Camera
from ..core.gaussians import Gaussians, reset_opacity
from ..core.loss import gaussian_loss
from ..ops.renderer import RenderSettings, render
from . import density
from .exposure import apply_exposure, init_exposure
from .optimizer import (AdamState, adam_update, group_lrs, init_adam,
                        reset_adam_slots, schedule_factor)


@dataclass
class TrainState:
    gaussians: Gaussians
    opt_state: AdamState
    step: int
    # optional per-camera exposure compensation (train/exposure.py)
    exposure: Optional[torch.Tensor] = None       # [n_cams, 3, 4]
    exp_opt_state: Optional[AdamState] = None

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def create_train_state(gaussians: Gaussians, config: TrainingConfig,
                       n_cameras: int = 0) -> TrainState:
    exposure = exp_opt = None
    if config.use_exposure and n_cameras > 0:
        exposure = init_exposure(n_cameras, gaussians.device)
        exp_opt = init_adam({"exposure": exposure})
    return TrainState(gaussians=gaussians,
                      opt_state=init_adam(gaussians.params()), step=0,
                      exposure=exposure, exp_opt_state=exp_opt)


def scale_position_lr(config: TrainingConfig,
                      scene_extent: float) -> TrainingConfig:
    """Canonical 3DGS: the position learning rates times the scene extent.
    Applied once; the returned config has the flag cleared."""
    if not config.scale_position_lr_by_extent:
        return config
    return dataclasses.replace(
        config, position_lr_init=config.position_lr_init * scene_extent,
        position_lr_final=config.position_lr_final * scene_extent,
        scale_position_lr_by_extent=False)


def train_step(state: TrainState, camera: Camera, config: TrainingConfig,
               settings: RenderSettings, cam_idx: int = 0,
               sh_degree: Optional[int] = None
               ) -> Tuple[TrainState, Dict[str, float]]:
    """One step: render with the viewspace probe -> L1 + D-SSIM against
    `camera.image` -> gradients -> masked Adam -> densify statistics.
    `sh_degree` overrides the settings' degree (progressive SH unlock).
    The metrics are tensors on the state's device (and the stream counters
    ints); reading one waits for the device."""
    if sh_degree is not None:
        settings = settings.replace(sh_degree=sh_degree)
    g0 = state.gaussians
    params = {k: v.detach().requires_grad_(True)
              for k, v in g0.params().items()}
    # A zero probe on the projected means: its gradient is the viewspace
    # densification statistic.
    probe = torch.zeros(g0.capacity, 2, dtype=torch.float32,
                        device=g0.device, requires_grad=True)
    exposure = None
    if state.exposure is not None:
        exposure = state.exposure.detach().requires_grad_(True)

    out = render(g0.with_params(params), camera, settings,
                 means2d_probe=probe)
    with record_function("3dgs:loss"):
        image = out["image"]
        if exposure is not None:
            image = apply_exposure(exposure[cam_idx], image)
        total, parts = gaussian_loss(image, camera.image, config.lambda_dssim)
    wrt = list(params.values()) + [probe]
    if exposure is not None:
        wrt.append(exposure)
    with record_function("3dgs:backward"):
        grads_all = torch.autograd.grad(total, wrt, allow_unused=True)
    new_state = apply_gradients(state, params, probe, exposure, grads_all,
                                config, settings, out["radii"].detach(),
                                out["visibility_filter"])
    metrics = {k: v.detach() for k, v in parts.items()}
    metrics.update(render_drops=out["n_dropped"],
                   render_drops_large=out["n_dropped_large"],
                   render_instances=out["n_live"],
                   render_n_large=out["n_large"],
                   n_visible=out["visibility_filter"].sum())
    return new_state, metrics


def mask_dead_gradients(params: Dict[str, torch.Tensor], grads_all,
                        alive: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-parameter gradients with the dead slots' rows (and a parameter
    the loss does not reach) set to 0."""
    grads = {}
    for (k, p), gr in zip(params.items(), grads_all):
        mask = alive.reshape((-1,) + (1,) * (p.ndim - 1))
        grads[k] = torch.where(mask, torch.zeros_like(p) if gr is None else gr,
                               torch.zeros_like(p))
    return grads


def apply_gradients(state: TrainState, params: Dict[str, torch.Tensor],
                    probe: torch.Tensor, exposure: Optional[torch.Tensor],
                    grads_all, config: TrainingConfig,
                    settings: RenderSettings, radii: torch.Tensor,
                    visible: torch.Tensor) -> TrainState:
    """The second half of a step, shared by the single-device and the
    sharded step: `grads_all` are the gradients of the leaves `params`,
    `probe` and (when not None) `exposure`, in that order -> masked Adam ->
    densify statistics with the forward pass's `radii` and `visible`."""
    g0 = state.gaussians
    zero_if_none = lambda gr, ref: torch.zeros_like(ref) if gr is None else gr
    with record_function("3dgs:adam"):
        # Dead slots must not drift: zero their gradients (their Adam
        # moments are zeroed when the slot dies, so their updates stay
        # exactly 0).
        grads = mask_dead_gradients(params, grads_all, g0.alive)
        vs_grads = zero_if_none(grads_all[len(params)], probe)

        detached = {k: v.detach() for k, v in params.items()}
        new_params, opt_state = adam_update(
            detached, grads, state.opt_state, group_lrs(config),
            schedule_factor(config, state.opt_state.sched_count))
        new_exposure, exp_opt = state.exposure, state.exp_opt_state
        if exposure is not None:
            upd, exp_opt = adam_update(
                {"exposure": exposure.detach()},
                {"exposure": zero_if_none(grads_all[-1], exposure)}, exp_opt,
                {"exposure": config.exposure_lr})
            new_exposure = upd["exposure"]
    with record_function("3dgs:statistics"):
        stat = density.densify_stat_norm(config, grads["xyz"], vs_grads,
                                         settings.image_height,
                                         settings.image_width)
        g = density.accumulate_grad_stats(
            g0.with_params(new_params), stat, radii, visible)
    return TrainState(gaussians=g, opt_state=opt_state, step=state.step + 1,
                      exposure=new_exposure, exp_opt_state=exp_opt)


def densify_step(state: TrainState, noise: torch.Tensor, scene_extent: float,
                 config: TrainingConfig, size_prune: bool = False
                 ) -> Tuple[TrainState, Dict[str, int]]:
    """Split, clone and prune; the Adam moments of every slot whose identity
    changed are zeroed.  `noise` [C,3] are the clone jitter's N(0,1) draws."""
    result = density.densify_and_prune(state.gaussians, noise, scene_extent,
                                       config, size_prune=size_prune)
    stats = {"n_split": result.n_split, "n_clone": result.n_clone,
             "n_pruned": result.n_pruned, "n_dropped": result.n_dropped,
             "n_alive": result.gaussians.num_alive()}
    return state.replace(
        gaussians=result.gaussians,
        opt_state=reset_adam_slots(state.opt_state,
                                   result.changed_slots)), stats


def prune_step(state: TrainState,
               config: TrainingConfig) -> Tuple[TrainState, int]:
    """Standalone opacity prune; newly dead slots get their Adam moments
    zeroed so that their (masked, zero) gradients give zero updates."""
    g, n_pruned = density.prune_only(state.gaussians, config)
    newly_dead = state.gaussians.alive & ~g.alive
    return state.replace(
        gaussians=g,
        opt_state=reset_adam_slots(state.opt_state, newly_dead)), n_pruned


def reset_opacity_step(state: TrainState) -> TrainState:
    return state.replace(gaussians=reset_opacity(state.gaussians, 0.01))
