"""The driver of the `render` traffic mixes: one viewer,
`ops.renderer.render` under `torch.no_grad()` along the orbit in a closed
loop, each frame ending in a synchronisation."""

from __future__ import annotations

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


class Driver:
    """One viewer in a closed loop over the orbit."""

    PASS_STEPS = 240  # a recorder pass's frames, at least

    def __init__(self, cell: Cell, seed: int, device: torch.device,
                 out_dir: Path):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.out_dir = out_dir
        self.mix = cell.traffic

    def setup(self) -> None:
        from mini3dgs_tpu_torch.core.camera import Camera
        from mini3dgs_tpu_torch.core.gaussians import Gaussians
        from mini3dgs_tpu_torch.ops.renderer import RenderSettings, render

        dev = self.device
        self.cfg = recipe_config(self.cell, dev, self.out_dir)
        self.params = scene.make_gaussians(self.cell.config, self.seed, dev)
        self.views = scene.orbit_views(self.cell.config, self.mix)
        v = self.views
        n = self.params["xyz"].shape[0]
        self.gaussians = Gaussians(
            **self.params, alive=torch.ones(n, dtype=torch.bool, device=dev))
        self.settings = RenderSettings(
            image_height=v.height, image_width=v.width,
            bg_color=tuple(float(c) for c in self.cfg.background_color),
            tile_size=self.cfg.tile_size, radius_min=self.cfg.radius_min,
            radius_max=self.cfg.radius_max, color_mode=self.cfg.color_mode,
            sh_degree=self.cfg.sh_degree, raster="tiles")
        self.cams = [Camera.create(i, R, T, v.fovx, v.fovy, v.width,
                                   v.height, device=dev)
                     for i, (R, T) in enumerate(v.poses)]
        self._render = render
        rng = np.random.default_rng(self.seed)
        self.checked = sorted(int(i) for i in rng.choice(
            len(self.cams), int(self.mix["checked_frames"]), replace=False))
        self.kept: Dict[int, torch.Tensor] = {}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        # Warm-up: the whole orbit once.
        self.frame = 0
        for _ in self.cams:
            self._frame()

    @torch.no_grad()
    def _frame(self, keep: bool = False):
        k = self.frame % len(self.cams)
        image = self._render(self.gaussians, self.cams[k],
                             self.settings)["image"]
        if keep and k in self.checked and k not in self.kept:
            self.kept[k] = image
        self.frame += 1
        return image

    def window(self, seconds: float) -> dict:
        timing = self.device.type == "cuda"
        marks = []
        n = 0
        sync(self.device)
        t0 = time.perf_counter()
        while True:
            if timing:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            self._frame(keep=True)
            if timing:
                ev[1].record()
                marks.append(ev)
            sync(self.device)
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        self.step_s = elapsed / n
        metrics = {"frame_ms": 1e3 * self.step_s}
        if timing:
            times = sorted(a.elapsed_time(b) for a, b in marks)
            metrics["frame_ms_p95"] = times[min(len(times) - 1,
                                                math.ceil(0.95 * len(times))
                                                - 1)]
        failed = sum(not bool(torch.isfinite(img).all())
                     for img in self.kept.values())
        return {"metrics": metrics, "attempted": n, "failed": failed,
                "window_s": elapsed}

    def trace(self) -> ReadContext:
        k = int(self.mix["trace_frames"])
        first = self.frame
        tr = profile.trace(lambda: [self._frame() for _ in range(k)], k)
        st = ref_settings(self.cfg, self.cfg.sh_degree)
        cams = [ref_camera(self.views, (first + j) % len(self.cams),
                            self.device) for j in range(k)]
        fwd, _, ops = pair_needs(self.params, cams, st, counting.render_ops,
                                 self.views.width * self.views.height)
        return ReadContext("render", tr, self.step_s,
                           {"raster_fwd": fwd, "step_ops": ops})

    # -- the stage recorder's passes (harness/recorded.py) ----------------
    def traced_views(self) -> List[int]:
        """The views of the frames the profiled sub-window ran: the
        latest."""
        k, n = int(self.mix["trace_frames"]), len(self.views.poses)
        return [(self.frame - k + j) % n for j in range(k)]

    def replay(self, views: List[int]):
        """A call that renders the views `rounds` times over as the window
        does, each frame ending in a synchronisation."""
        def frames(rounds):
            for _ in range(rounds):
                for i in views:
                    self.frame = i
                    self._frame()
                    sync(self.device)
        return frames

    def release(self) -> None:
        self.gaussians = None
        self.cams = None
        windows.release(self.device)

    def reference(self, dtype=torch.float32) -> dict:
        from reference.train import render
        st = ref_settings(self.cfg, self.cfg.sh_degree)
        p = {k: v.to(dtype) for k, v in self.params.items()}
        return {k: render(p, ref_camera(self.views, k, self.device, dtype),
                          st)[0].float() for k in sorted(self.kept)}

    # -- calibration (calibrate.py) --------------------------------------
    def check_run(self, seconds: float) -> None:
        """A window at the cell's own load, long enough to keep every
        checked frame: what the checked frames need after set-up."""
        self.window(seconds)

    def controls(self, ref: dict) -> Dict[str, dict]:
        """The numbers of the control: the reference in the program's
        place, computed in bfloat16."""
        low = self.reference(torch.bfloat16)
        return {"control": check.render_numbers(
            [low[k] for k in sorted(ref)], [ref[k] for k in sorted(ref)])}

    def calibration(self, ref: dict) -> dict:
        """Readings of the program beyond the numbers compared: none."""
        return {}

    def scene_line(self) -> str:
        return windows.scene_line(self.params, [ref_camera(self.views, k,
                                                    self.device)
                                        for k in sorted(self.kept)],
                          ref_settings(self.cfg, self.cfg.sh_degree))

    def numbers(self, ref: dict) -> dict:
        if not self.kept:
            raise RuntimeError("the window ended before any checked frame "
                               f"({self.checked}) of the orbit")
        keys = sorted(self.kept)
        return check.render_numbers([self.kept[k] for k in keys],
                                    [ref[k] for k in keys])
