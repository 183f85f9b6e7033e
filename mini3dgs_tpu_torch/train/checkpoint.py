"""Checkpoint / resume (counterpart of mini3dgs_tpu/train/checkpoint.py).

A checkpoint is one `torch.save` file of plain tensors and ints at
`<output>/checkpoints/it%07d/state.pt` (the JAX package's directory layout,
so `latest_checkpoint_iteration` reads both): the Gaussian pool (parameters,
`alive`, statistic buffers), the Adam state (`count`, `sched_count`, `mu`,
`nu`), the step, and the exposure state when there is one.  It is read
with `weights_only=True`.  Resume is exact: on the same device every
tensor comes back bit for bit.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

from ..core.gaussians import PARAM_NAMES, STAT_NAMES, Gaussians
from .optimizer import AdamState

_FILE = "state.pt"
_POOL = PARAM_NAMES + STAT_NAMES + ("alive",)


def _ckpt_dir(output_path: str, iteration: int) -> Path:
    return Path(output_path).absolute() / "checkpoints" / f"it{iteration:07d}"


def _adam_dict(s: Optional[AdamState]):
    if s is None:
        return None
    return {"count": s.count, "sched_count": s.sched_count,
            "mu": s.mu, "nu": s.nu}


def _adam_state(d) -> Optional[AdamState]:
    if d is None:
        return None
    return AdamState(count=int(d["count"]), sched_count=int(d["sched_count"]),
                     mu=d["mu"], nu=d["nu"])


def save_checkpoint(output_path: str, iteration: int, state,
                    extra: Optional[dict] = None) -> str:
    """Write `state` (a train.trainer.TrainState) and the ints of `extra`."""
    path = _ckpt_dir(output_path, iteration)
    path.mkdir(parents=True, exist_ok=True)
    g = state.gaussians
    blob = {"step": int(state.step),
            "gaussians": {k: getattr(g, k) for k in _POOL},
            "opt_state": _adam_dict(state.opt_state),
            "exposure": state.exposure,
            "exp_opt_state": _adam_dict(state.exp_opt_state),
            "extra": dict(extra or {})}
    tmp = path / (_FILE + ".tmp")
    torch.save(blob, tmp)
    tmp.replace(path / _FILE)
    return str(path)


def load_checkpoint(output_path: str, iteration: int, device="cpu"):
    """(TrainState on `device`, the `extra` ints saved with it)."""
    from .trainer import TrainState
    blob = torch.load(_ckpt_dir(output_path, iteration) / _FILE,
                      map_location=device, weights_only=True)
    state = TrainState(
        gaussians=Gaussians(**blob["gaussians"]),
        opt_state=_adam_state(blob["opt_state"]), step=int(blob["step"]),
        exposure=blob["exposure"],
        exp_opt_state=_adam_state(blob["exp_opt_state"]))
    return state, blob["extra"]


def checkpoint_capacity(output_path: str, iteration: int) -> Optional[int]:
    """The slot-pool capacity recorded in a checkpoint, or None if there is
    no such checkpoint (the file is memory-mapped, not read)."""
    path = _ckpt_dir(output_path, iteration) / _FILE
    if not path.exists():
        return None
    blob = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    return int(blob["gaussians"]["xyz"].shape[0])


def latest_checkpoint_iteration(output_path: str) -> Optional[int]:
    root = Path(output_path) / "checkpoints"
    if not root.exists():
        return None
    its = sorted(int(p.name[2:]) for p in root.iterdir()
                 if p.name.startswith("it"))
    return its[-1] if its else None
