"""Tracing and timing (counterpart of mini3dgs_tpu/utils/profiling.py).

`trace` captures a `torch.profiler` trace (host ranges and, with a card,
its kernels) as a Chrome trace; `timer` times a block with CUDA events on
the card or `perf_counter` on the CPU; `ThroughputCounters` turns counts
and seconds into rates against the H100's peaks; `ScalarLogger` keeps a
scalar history and writes it as JSON lines.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the block with CPU activities (and CUDA ones where a card
    is present); the trace is written to `<log_dir>/trace.json`, viewable in
    Perfetto or chrome://tracing.  Yields the profiler."""
    log_dir = Path(log_dir or os.path.join(tempfile.gettempdir(),
                                           "mini3dgs_trace"))
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


@contextlib.contextmanager
def timer(name: str, sink: Optional[Dict[str, float]] = None, device=None):
    """Seconds the block takes: between two CUDA events on a CUDA device
    (the card's by default, where there is one), on the host clock on the
    CPU.  Stored as sink[name], else printed in ms."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(device))
        yield
        end.record(torch.cuda.current_stream(device))
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
    if sink is not None:
        sink[name] = dt
    else:
        print(f"[timer] {name}: {dt * 1000:.2f} ms")


@dataclass
class ThroughputCounters:
    """Rates of a render or train step, with the card's published peaks
    (NVIDIA H100 SXM data sheet: HBM3 bytes/s and float32 operations/s
    outside the tensor cores, at its 700 W limit) beside them."""

    pixels: int = 0
    gaussians: int = 0
    instances: int = 0
    seconds: float = 0.0
    hbm_bw_gbs: float = 3350.0
    peak_tflops_fp32: float = 67.0

    def report(self) -> Dict[str, float]:
        s = max(self.seconds, 1e-9)
        return {
            "Mpixels_per_s": self.pixels / s / 1e6,
            "Mgaussians_per_s": self.gaussians / s / 1e6,
            "Minstances_per_s": self.instances / s / 1e6,
            "ms_per_step": s * 1e3,
        }

    def json_line(self) -> str:
        return json.dumps(self.report())


class ScalarLogger:
    """In-memory scalar history, optionally appended to a JSON-lines
    file."""

    def __init__(self, path: Optional[str] = None):
        self.history: Dict[str, list] = {}
        self.path = path
        if path:
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def log(self, step: int, **scalars):
        rec = {"step": step}
        for k, v in scalars.items():
            v = float(v)
            rec[k] = v
            self.history.setdefault(k, []).append((step, v))
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def close(self):
        if self._f:
            self._f.close()
