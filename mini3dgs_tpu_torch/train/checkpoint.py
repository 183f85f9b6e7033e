"""Checkpoint / resume (counterpart of mini3dgs_tpu/train/checkpoint.py).

A checkpoint is one `torch.save` file of plain tensors and ints at
`<output>/checkpoints/it%07d/state.pt` (the JAX package's directory layout,
so `latest_checkpoint_iteration` reads both): the Gaussian pool (parameters,
`alive`, statistic buffers), the Adam state (`count`, `sched_count`, `mu`,
`nu`), the step, and the exposure state when there is one.  It is read
with `weights_only=True`.  Resume is exact: on the same device every
tensor comes back bit for bit.

A gauss-sharded state (parallel/sharded.py `GaussShardedState`) over the
ranks of several processes is saved as the JAX package saves its sharded
arrays, each process writing only what it holds: `state.p<k>.pt` holds
process k's ranks' shards (each a file's worth of the above) and
`layout.json` the mesh they lie on.  It restores into a template of the
same layout, each process reading its own file.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

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
    _write(path / _FILE, {**_blob(state), "extra": dict(extra or {})})
    return str(path)


def _blob(state) -> dict:
    g = state.gaussians
    return {"step": int(state.step),
            "gaussians": {k: getattr(g, k) for k in _POOL},
            "opt_state": _adam_dict(state.opt_state),
            "exposure": state.exposure,
            "exp_opt_state": _adam_dict(state.exp_opt_state)}


def _write(file: Path, blob: dict) -> None:
    tmp = file.with_name(file.name + ".tmp")
    torch.save(blob, tmp)
    tmp.replace(file)


def _state(blob: dict):
    from .trainer import TrainState
    return TrainState(
        gaussians=Gaussians(**blob["gaussians"]),
        opt_state=_adam_state(blob["opt_state"]), step=int(blob["step"]),
        exposure=blob["exposure"],
        exp_opt_state=_adam_state(blob["exp_opt_state"]))


def load_checkpoint(output_path: str, iteration: int, device="cpu"):
    """(TrainState on `device`, the `extra` ints saved with it)."""
    blob = torch.load(_ckpt_dir(output_path, iteration) / _FILE,
                      map_location=device, weights_only=True)
    return _state(blob), blob["extra"]


def _layout(mesh) -> dict:
    from ..parallel import mesh as M
    me = dist.get_rank() if dist.is_initialized() else 0
    return {"data": mesh.data, "tile": mesh.tile,
            "processes": [me if M.is_local(d) else d.process
                          for d in mesh.devices]}


def save_sharded_checkpoint(output_path: str, iteration: int, state,
                            mesh, extra: Optional[dict] = None) -> str:
    """Write a `GaussShardedState` over `mesh`: this process's ranks'
    shards to `state.p<k>.pt` (k its process index), and from process 0
    the layout to `layout.json`.  Every process of the group calls it; it
    returns when all have written."""
    path = _ckpt_dir(output_path, iteration)
    path.mkdir(parents=True, exist_ok=True)
    layout = _layout(mesh)
    me = dist.get_rank() if dist.is_initialized() else 0
    _write(path / f"state.p{me}.pt",
           {"layout": layout, "extra": dict(extra or {}),
            "shards": {r: _blob(s) for r, s in enumerate(state.shards)
                       if s is not None}})
    if me == 0:
        tmp = path / "layout.json.tmp"
        tmp.write_text(json.dumps({**layout, "capacity": state.capacity,
                                   "step": int(state.step)}))
        tmp.replace(path / "layout.json")
    if dist.is_initialized():
        dist.barrier()
    return str(path)


def load_sharded_checkpoint(output_path: str, iteration: int, template,
                            mesh):
    """(the `GaussShardedState` saved by `save_sharded_checkpoint`, the
    `extra` ints): this process reads its own file and places each shard
    on its rank's device.  `template` is a state of the same layout over
    `mesh` (its values are not read); raises ValueError on another
    layout."""
    from ..parallel.sharded import GaussShardedState
    path = _ckpt_dir(output_path, iteration)
    me = dist.get_rank() if dist.is_initialized() else 0
    blob = torch.load(path / f"state.p{me}.pt", map_location="cpu",
                      weights_only=True)
    record = json.loads((path / "layout.json").read_text())
    mine = [r for r, s in enumerate(template.shards) if s is not None]
    if blob["layout"] != _layout(mesh) \
            or record["capacity"] != template.capacity \
            or sorted(blob["shards"]) != mine:
        raise ValueError(f"{path}: saved over {record} (ranks "
                         f"{sorted(blob['shards'])} here), restoring into a "
                         f"({mesh.data}, {mesh.tile}) mesh of capacity "
                         f"{template.capacity} (ranks {mine})")
    shards = [None] * len(template.shards)
    for r in mine:
        shards[r] = _state(_to_device(blob["shards"][r], mesh.devices[r]))
    return GaussShardedState(shards), blob["extra"]


def _to_device(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to_device(v, device) for k, v in x.items()}
    return x


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
