"""The driver of a traffic mix of a kind that the benchmark does not run,
`two_views`, for the test that such a mix is added by files alone: one
viewer in a closed loop that renders two views of the orbit a call, half
an orbit apart, through `ops.renderer.render` under `torch.no_grad()`,
each call ending in a synchronisation.  It is the `render` driver of the
folder it is copied into (`drivers/two_views.py`), its frame widened to
two views; the recorder's passes and calibration take what that driver
offers them."""

from pathlib import Path

import torch

from harness import counting, profile
from harness.context import ReadContext
from harness.spec import load_driver
from harness.windows import pair_needs, ref_camera, ref_settings

Render = load_driver("render", Path(__file__).resolve().parents[1])


class Driver(Render):
    """Two views a call."""

    PASS_STEPS = 4  # a recorder pass's calls, at least

    def _pair(self, k: int):
        return k, (k + len(self.views.poses) // 2) % len(self.views.poses)

    @torch.no_grad()
    def _frame(self, keep: bool = False):
        for i in self._pair(self.frame % len(self.cams)):
            image = self._render(self.gaussians, self.cams[i],
                                 self.settings)["image"]
            if keep and i in self.checked and i not in self.kept:
                self.kept[i] = image
        self.frame += 1
        return image

    def trace(self) -> ReadContext:
        k = int(self.mix["trace_frames"])
        first = self.frame
        tr = profile.trace(lambda: [self._frame() for _ in range(k)], k)
        st = ref_settings(self.cfg, self.cfg.sh_degree)
        cams = [ref_camera(self.views, i, self.device) for j in range(k)
                for i in self._pair((first + j) % len(self.cams))]
        fwd, _, ops = pair_needs(self.params, cams, st, counting.render_ops,
                                 self.views.width * self.views.height)
        return ReadContext(self.mix["kind"], tr, self.step_s,
                           {"raster_fwd": fwd, "step_ops": 2 * ops})
