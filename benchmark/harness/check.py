"""The numbers that decide `correct`, each held against its limit.

Training (the first steps of the timed trainer, followed by the plain
reference from the same Gaussians and views):
- `loss_gap`: the largest relative gap of a step's loss;
- `grad_gap`: of the first step's gradient as Adam receives it, by the
  worst leaf, the gap between the two norms of the leaf over the larger of
  the reference's norm of that leaf and of the median leaf;
- `change_gap`: the same of each leaf's change over the checked steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (rounding alone moves them under Adam).

Frames: `image_gap`, the largest relative L2 distance of a checked frame
from the reference's frame of the same view, and `image_max_gap`, the
largest difference of one pixel's channel (what a single wrong pixel
moves, which the L2 distance of a million pixels hides).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

NOUGHT_SHARE = 1e-3


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keys=None) -> float:
    keys = list(ref) if keys is None else list(keys)
    med = statistics.median(ref.values())
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """`prog` / `ref`: {"losses": [...], "grad": {leaf: norm}, "change":
    {leaf: norm}}."""
    med = statistics.median(ref["grad"].values())
    moved = [k for k, v in ref["grad"].items() if v >= NOUGHT_SHARE * med]
    return {
        "loss_gap": max(abs(p - r) / abs(r)
                        for p, r in zip(prog["losses"], ref["losses"])),
        "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
        "change_gap": leaf_gap(prog["change"], ref["change"], moved),
    }


def render_numbers(prog: List[torch.Tensor],
                   ref: List[torch.Tensor]) -> Dict[str, float]:
    """Over the frames: the largest relative L2 distance, and the largest
    difference of one pixel's channel."""
    if not prog:
        raise ValueError("no frame to compare")
    d = [p.double() - r.double() for p, r in zip(prog, ref)]
    return {"image_gap": max(float(torch.linalg.vector_norm(x)
                                   / torch.linalg.vector_norm(r.double()))
                             for x, r in zip(d, ref)),
            "image_max_gap": max(float(x.abs().max()) for x in d)}


def judge(numbers: Dict[str, float], limits: dict):
    """(correct, {name: {"value", "limit"}}): every number finite and at
    most its limit; a number without a limit is never correct."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = float(limits[name]["limit"]) if name in limits else None
        out[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and math.isfinite(value) \
            and value <= limit
    return ok, out
