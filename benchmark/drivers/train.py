"""The driver of the `train` traffic mixes: the measured package's
`GaussianTrainer`, set up from the recipe and the configuration's settings
on the benchmark's views and Gaussians, resumed at `start_iteration`
(iteration counter, learning-rate schedule and SH degree where the recipe
has them there; Adam's moments fresh), then driven through
`GaussianTrainer.train`: the checked steps, warm-up, the window, and with a
trace a few steps under the profiler.  The plain reference follows the
checked steps with the paper's optimizer."""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from harness import check, counting, profile, scene, windows
from harness.context import ReadContext
from harness.spec import Cell
from harness.windows import (pair_needs, recipe_config, ref_camera,
                             ref_settings, sync)

ADAM_B1 = 0.9  # the first moment after one step from zero is (1 - b1) g


class Driver:
    """GaussianTrainer.train from `start_iteration` of the recipe."""

    PASS_STEPS = 40  # a recorder pass's steps, at least

    def __init__(self, cell: Cell, seed: int, device: torch.device,
                 out_dir: Path):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.out_dir = out_dir
        self.mix = cell.traffic

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from mini3dgs_tpu_torch.core.camera import Camera
        from mini3dgs_tpu_torch.data.dataset import CameraDataset
        from mini3dgs_tpu_torch.train.trainer import GaussianTrainer

        dev = self.device
        self.cfg = recipe_config(self.cell, dev, self.out_dir)
        self.params = scene.make_gaussians(self.cell.config, self.seed, dev)
        self.views = scene.train_views(self.cell.config, self.seed, dev)
        v = self.views
        cams = [Camera.create(i, R, T, v.fovx, v.fovy, v.width, v.height,
                              device=dev, image=img)
                for i, ((R, T), img) in enumerate(zip(v.poses, v.targets))]
        data = CameraDataset(str(self.out_dir), dev)
        data.cameras = data.train_cameras = cams
        data.bg_color = list(self.cfg.background_color)
        points = self.params["xyz"].cpu().numpy()
        data.get_point_cloud = lambda: (points, None)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        trainer = GaussianTrainer(self.cfg)
        trainer.setup(dataset=data)
        # The pool the recipe's capacity rule made for these points, with
        # the benchmark's Gaussians in its first n slots, resumed at
        # start_iteration.
        start = int(self.mix["start_iteration"])
        g = trainer.state.gaussians
        n = self.params["xyz"].shape[0]
        new = {}
        for k, t in g.params().items():
            t = t.clone()
            t[:n] = self.params[k]
            new[k] = t
        opt = dataclasses.replace(trainer.state.opt_state, sched_count=start)
        trainer.state = trainer.state.replace(
            gaussians=g.with_params(new), opt_state=opt, step=start)
        trainer.iteration = start
        self.trainer, self.n, self.start = trainer, n, start
        k = int(self.mix["checked_steps"])
        self.checked_views = self._draws(start, k)
        if len(set(self.checked_views)) != k:
            raise ValueError(f"the checked steps draw views "
                             f"{self.checked_views}: not all different")
        degrees = {_sh_degree(self.cfg, start + i) for i in range(k)}
        if len(degrees) != 1:
            raise ValueError("the SH degree changes within the checked "
                             "steps")
        self.sh_degree = degrees.pop()
        self._checked_steps()
        self.step_estimate_s = self._warm_up()

    def _draws(self, after: int, k: int) -> List[int]:
        """The views the trainer draws for its steps after + 1 .. after + k
        (its generator: default_rng(config.seed), one draw a step)."""
        rng = np.random.default_rng(self.cfg.seed)
        n_views = len(self.views.poses)
        draws = [int(rng.integers(n_views)) for _ in range(after + k)]
        return draws[after:]

    def _alive(self, tensors: Dict[str, torch.Tensor]):
        return {k: v[:self.n] for k, v in tensors.items()}

    def _checked_steps(self) -> None:
        t = self.trainer
        losses, grad = [], None
        for i in range(len(self.checked_views)):
            metrics = t.train(1)
            losses.append(float(metrics["total_loss"]))
            if i == 0:
                mu = self._alive(t.state.opt_state.mu)
                grad = check.norms({k: v / (1.0 - ADAM_B1)
                                    for k, v in mu.items()})
        after = self._alive(t.state.gaussians.params())
        change = check.norms({k: after[k] - self.params[k]
                              for k in self.params})
        self.program = {"losses": losses, "grad": grad, "change": change}
        # The reference starts from these same Gaussians: keep them on the
        # host, off the card the program measures on.
        self.params = {k: v.cpu() for k, v in self.params.items()}

    def _warm_up(self):
        """Calls of `train` of doubling length until one lasts
        `warmup_chunk_s`.  A call first replays its generator's draws up
        to the iteration, then takes its steps: returns (seconds a step,
        seconds of that replay), the replay timed as the harness's own
        replay of the same draws."""
        k = 1
        while True:
            sync(self.device)
            t0 = time.perf_counter()
            self.trainer.train(k)
            sync(self.device)
            dt = time.perf_counter() - t0
            if dt >= float(self.mix["warmup_chunk_s"]):
                break
            k *= 2
        t0 = time.perf_counter()
        self._draws(self.trainer.iteration, 0)
        replay = time.perf_counter() - t0
        return max(dt - replay, 0.5 * dt) / k, replay

    # -- the window -----------------------------------------------------
    def window(self, seconds: float) -> dict:
        """Two calls of `train`: the first for about half the window from
        the warm-up's estimate, the second for the rest at the rate the
        first measured."""
        step, replay = self.step_estimate_s
        bad = []
        log = lambda it, m: bad.append(not math.isfinite(m["total_loss"]))
        sync(self.device)
        t0 = time.perf_counter()
        n_steps = max(1, int(0.5 * seconds / step))
        self.trainer.train(n_steps, log_fn=log)
        sync(self.device)
        done = time.perf_counter() - t0
        rate = max(done - replay, 1e-9) / n_steps
        rest = int((seconds - done - replay) / rate)
        if rest > 0:
            self.trainer.train(rest, log_fn=log)
            sync(self.device)
            n_steps += rest
        elapsed = time.perf_counter() - t0
        self.step_s = elapsed / n_steps
        return {"metrics": {"train_step_ms": 1e3 * self.step_s},
                "attempted": n_steps, "failed": sum(bad),
                "window_s": elapsed}

    def trace(self) -> ReadContext:
        """`trace_steps` more steps under the profiler, each through
        GaussianTrainer.train_step on the view `train` would draw: a call
        of `train` itself would first replay its generator's draws up to
        the iteration, host time that a run pays once and a few traced
        steps would show many times over."""
        k = int(self.mix["trace_steps"])
        t = self.trainer
        before = t.state.gaussians
        draws = self._draws(t.iteration, k)
        cams = t.train_cameras()
        tr = profile.trace(lambda: [t.train_step(cams[i], i) for i in draws],
                           k)
        params = self._alive(before.params())
        st = ref_settings(self.cfg, t.active_sh_degree())
        cams = [ref_camera(self.views, i, self.device) for i in draws]
        fwd, bwd, ops = pair_needs(params, cams, st, counting.train_ops,
                                   self.views.width * self.views.height)
        return ReadContext("train", tr, self.step_s,
                           {"raster_fwd": fwd, "raster_bwd": bwd,
                            "step_ops": ops})

    # -- the stage recorder's passes (harness/recorded.py) ----------------
    def traced_views(self) -> List[int]:
        """The views of the steps the profiled sub-window ran: the
        latest."""
        k = int(self.mix["trace_steps"])
        return self._draws(self.trainer.iteration - k, k)

    def replay(self, views: List[int]):
        """A call that takes train steps on the views `rounds` times over,
        back to back."""
        t = self.trainer
        cams = t.train_cameras()

        def steps(rounds):
            for _ in range(rounds):
                for i in views:
                    t.train_step(cams[i], i)
            sync(self.device)
        return steps

    def release(self) -> None:
        self.trainer = None
        windows.release(self.device)

    # -- the reference --------------------------------------------------
    def reference(self, dtype=torch.float32, loss_fn=None) -> dict:
        """The plain reference's readings over the checked steps, from the
        benchmark's Gaussians and views, computed in `dtype`."""
        from reference import train as ref
        dev = self.device
        p0 = {k: v.to(dev, dtype) for k, v in self.params.items()}
        cams = [ref_camera(self.views, i, dev, dtype)
                for i in self.checked_views]
        extent = ref.scene_extent(
            [ref_camera(self.views, i, dev).center
             for i in range(len(self.views.poses))])
        # The paper's constant rates; its code gives the SH rest terms a
        # twentieth of the feature rate.
        lrs = (("features_dc", self.cfg.feature_lr),
               ("features_rest", self.cfg.feature_lr / 20.0),
               ("opacity", self.cfg.opacity_lr),
               ("scaling", self.cfg.scaling_lr),
               ("rotation", self.cfg.rotation_lr))
        st = ref_settings(self.cfg, self.sh_degree, lrs, extent)
        zeros = {k: torch.zeros_like(v) for k, v in p0.items()}
        state = ref.AdamState(0, self.start, zeros,
                              {k: torch.zeros_like(v) for k, v in p0.items()})
        views = [(c, self.views.targets[i])
                 for c, i in zip(cams, self.checked_views)]
        kw = {} if loss_fn is None else {"loss_fn": loss_fn}
        losses, grads, p3 = ref.train_steps(p0, state, views, st, **kw)
        return {"losses": losses, "grad": check.norms(grads),
                "change": check.norms({k: p3[k] - p0[k] for k in p0})}

    def numbers(self, ref: dict) -> dict:
        return check.train_numbers(self.program, ref)

    # -- calibration (calibrate.py) --------------------------------------
    def check_run(self, seconds: float) -> None:
        """Nothing: set-up took the checked steps."""

    def controls(self, ref: dict) -> Dict[str, dict]:
        """The numbers of the control, the reference in the program's place
        computed in bfloat16, and of the fault of half the batch left out
        (the loss's mean taken over the image's top half of rows, in the
        reference put in the program's place)."""
        return {"control": check.train_numbers(
                    self.reference(torch.bfloat16), ref),
                "half_batch": check.train_numbers(
                    self.reference(loss_fn=half_batch_loss), ref)}

    def calibration(self, ref: dict) -> dict:
        """Each leaf's change over the checked steps, the program's over the
        reference's: a rate that departs shows as its ratio."""
        return {"change_ratio": {k: self.program["change"][k] / v
                                 for k, v in ref["change"].items()}}

    def scene_line(self) -> str:
        p = {k: v.to(self.device) for k, v in self.params.items()}
        return windows.scene_line(p, [ref_camera(self.views, i, self.device)
                              for i in self.checked_views],
                          ref_settings(self.cfg, self.sh_degree))


def half_batch_loss(image, target, lambda_dssim):
    """The loss over the image's top half of rows only."""
    from reference.train import photometric_loss
    h = image.shape[1] // 2
    return photometric_loss(image[:, :h], target[:, :h], lambda_dssim)


def _sh_degree(cfg, done: int) -> int:
    """The recipe's progressive SH degree of a step taken after `done`
    steps (one band each `sh_increase_interval` steps)."""
    if cfg.color_mode != "sh" or cfg.sh_increase_interval <= 0:
        return cfg.sh_degree
    return min(done // cfg.sh_increase_interval, cfg.sh_degree)
