"""The driver of the `steps` traffic mixes: the `train` mixes' driver
(`drivers/train.py`, loaded from this driver's own folder, so that the
stage recorder's process, which loads a cell's driver from the folder the
cell came from, gets this same class), with the window's ms a step
reported under the benchmark's `frame_ms`: a step is one frame rendered,
scored against its target, back-propagated and applied."""

from __future__ import annotations

from pathlib import Path

from harness.spec import load_driver

Train = load_driver("train", Path(__file__).resolve().parents[1])


class Driver(Train):
    """GaussianTrainer.train from `start_iteration` of the recipe; its
    window reads `frame_ms`."""

    def window(self, seconds: float) -> dict:
        out = super().window(seconds)
        out["metrics"] = {"frame_ms": out["metrics"]["train_step_ms"]}
        return out
