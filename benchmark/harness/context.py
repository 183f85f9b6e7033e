"""What a per-layer reader (`metrics/<name>.py`) is handed: the traced
sub-window, the window's unprofiled time a step or frame, and what the
traced steps need (from the benchmark's own counts)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from . import counting
from .profile import Trace


@dataclass
class ReadContext:
    kind: str             # the traffic mix's kind
    trace: Trace
    step_s: float         # the window's seconds a step or frame
    need: dict            # {"raster_fwd": [least seconds of each traced
                          #  launch], "raster_bwd": [...], "step_ops": the
                          #  mean operations of a traced step}

    def launches(self) -> float:
        return self.trace.launches / self.trace.steps

    def idle_pct(self) -> float:
        """1 - the traced steps' busy seconds a step over the window's
        unprofiled seconds a step, in %."""
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.steps
                        / self.step_s)

    def device_ms(self, *stages: str) -> Optional[float]:
        """Device ms a step of the kernels launched inside the `3dgs:`
        ranges `stages`, or None when none of them ran."""
        found = [self.trace.stage_s[s] for s in stages
                 if s in self.trace.stage_s]
        return 1e3 * sum(found) / self.trace.steps if found else None

    def roofline_pct(self, kernel: str) -> Optional[float]:
        """The kernel's share of its roofline over the traced launches:
        the least time their needs allow over their device time; None
        when the kernel did not run once a traced step."""
        times = self.trace.raster_s.get(kernel, [])
        bounds = self.need.get(kernel, [])
        if not times or len(times) != len(bounds):
            return None
        return 100.0 * sum(bounds) / sum(times)

    def mfu_pct(self) -> float:
        """The step's float32 operations over the unprofiled step time, as
        a share of the card's float32 peak."""
        return 100.0 * self.need["step_ops"] / (
            self.step_s * counting.PEAK_FP32_OPS_PER_S)
