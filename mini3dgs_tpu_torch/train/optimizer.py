"""Optimizer: multi-group Adam with a cosine or the 3DGS paper's
learning-rate schedule (counterpart of mini3dgs_tpu/train/optimizer.py).

The JAX package chains optax's `scale_by_adam` (b1 0.9, b2 0.999, eps 1e-8,
eps outside the square root of the bias-corrected second moment), a static
per-group learning rate, and one shared schedule factor
-(sched(t) / position_lr_init).  `AdamState` keeps the same slots: `count`
(the Adam step, 1 at the first update's bias correction), `mu`, `nu` per
parameter, and `sched_count` (the schedule's step, 0 at the first update).
After densification the moments are zeroed only at the slots whose
identity changed (`reset_adam_slots`).

`step_lrs` gives a step's rates under `config.lr_schedule`: "cosine" (the
default) is the JAX package's; "3dgs" is the code published with the 3DGS
paper (`get_expon_lr_func` for the position rate alone, every other group
at its constant rate, the SH rest terms at feature_lr / 20).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch

from ..config import TrainingConfig

B1, B2, EPS = 0.9, 0.999, 1e-8


def cosine_delay_lr(step, lr_init: float, lr_final: float,
                    lr_delay_steps: int, lr_delay_mult: float,
                    max_steps: int) -> float:
    """Cosine decay from lr_init to lr_final over max_steps, times an
    optional linear warm-up from lr_delay_mult over lr_delay_steps."""
    if max_steps <= 0:
        return float(lr_final)
    t = min(step, max_steps) / max_steps
    lr = lr_final + (lr_init - lr_final) * 0.5 * (1.0 + math.cos(math.pi * t))
    if lr_delay_steps > 0:
        lr *= lr_delay_mult + (1 - lr_delay_mult) * min(
            step / lr_delay_steps, 1.0)
    return lr


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int,
             lr_delay_mult: float, max_steps: int) -> float:
    """The 3DGS code's `get_expon_lr_func`: the log-linear path from lr_init
    to lr_final over max_steps, times a sine ramp from lr_delay_mult over
    lr_delay_steps where those are set; 0 before step 0 or where both rates
    are 0."""
    if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
        return 0.0
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1.0 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
    else:
        delay = 1.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return delay * math.exp(math.log(lr_init) * (1.0 - t)
                            + math.log(lr_final) * t)


def group_lrs(config: TrainingConfig) -> dict:
    """Static per-parameter base learning rates."""
    return {
        "xyz": config.position_lr_init,
        "features_dc": config.feature_lr,
        "features_rest": config.feature_lr,
        "opacity": config.opacity_lr,
        "scaling": config.scaling_lr,
        "rotation": config.rotation_lr,
    }


@dataclass
class AdamState:
    count: int                      # Adam updates taken
    sched_count: int                # schedule steps taken
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def init_adam(params: Dict[str, torch.Tensor]) -> AdamState:
    return AdamState(count=0, sched_count=0,
                     mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()})


def schedule_factor(config: TrainingConfig, sched_count: int) -> float:
    """sched(count) / position_lr_init: what every group's LR is scaled by."""
    base = cosine_delay_lr(sched_count, config.position_lr_init,
                           config.position_lr_final,
                           config.position_lr_delay_steps,
                           config.position_lr_delay_mult,
                           config.position_lr_max_steps)
    return base / config.position_lr_init


def step_lrs(config: TrainingConfig, sched_count: int):
    """(per-group rates, factor) of the step taken after `sched_count`
    schedule steps, for `adam_update`: parameter k moves by its Adam step
    times `lrs[k] * factor`."""
    if config.lr_schedule == "cosine":
        return group_lrs(config), schedule_factor(config, sched_count)
    if config.lr_schedule == "3dgs":
        lrs = group_lrs(config)
        lrs["features_rest"] = config.feature_lr / 20.0
        # sched_count steps are done: this one is iteration sched_count + 1
        lrs["xyz"] = expon_lr(sched_count + 1, config.position_lr_init,
                              config.position_lr_final,
                              config.position_lr_delay_steps,
                              config.position_lr_delay_mult,
                              config.position_lr_max_steps)
        return lrs, 1.0
    raise ValueError(f"unknown lr_schedule {config.lr_schedule!r}: "
                     "'cosine' or '3dgs'")


@torch.no_grad()
def adam_update(params: Dict[str, torch.Tensor],
                grads: Dict[str, torch.Tensor], state: AdamState,
                lrs: Dict[str, float], factor: float = 1.0):
    """One Adam step: returns (new params, new state); inputs are left
    untouched.  `lrs[k] * factor` is parameter k's learning rate."""
    count = state.count + 1
    c1 = 1.0 - B1 ** count
    c2 = 1.0 - B2 ** count
    new_p, mu, nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        mu[k] = B1 * state.mu[k] + (1.0 - B1) * g
        nu[k] = B2 * state.nu[k] + (1.0 - B2) * g * g
        step = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + EPS)
        new_p[k] = p + (step * lrs[k]) * (-factor)
    return new_p, AdamState(count=count, sched_count=state.sched_count + 1,
                            mu=mu, nu=nu)


def reset_adam_slots(state: AdamState, slot_mask: torch.Tensor) -> AdamState:
    """Zero the first and second moments at the rows of `slot_mask` (new or
    killed Gaussian slots after densify or prune)."""
    def zero_rows(x):
        mask = slot_mask.reshape((-1,) + (1,) * (x.ndim - 1))
        return torch.where(mask, torch.zeros_like(x), x)

    return AdamState(count=state.count, sched_count=state.sched_count,
                     mu={k: zero_rows(v) for k, v in state.mu.items()},
                     nu={k: zero_rows(v) for k, v in state.nu.items()})
