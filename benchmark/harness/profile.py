"""The traced sub-window: a few steady steps or frames under
`torch.profiler`, read into what the per-layer readers take.

Device work is every kernel, copy and fill on the card's timeline (the
`3dgs:*` ranges the profiler also draws there are no work).  A stage's
device time is that of the kernels launched inside its `3dgs:<stage>`
range on the host, its children's included.  Busy time is the union of
the device's intervals; the window is the host's wall time of the traced
call, from its first launch to the synchronisation after it.  An idle gap
of the device is named by what the host was doing at its middle: the
innermost `3dgs:*` range and the innermost operation then open.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List

import torch

RASTER_KERNELS = {"raster_fwd": "raster_fwd_kernel",
                  "raster_bwd": "raster_bwd_kernel"}
TOP = 10
NAME_CHARS = 160  # a kernel's name is cut to this many characters


@dataclass
class Trace:
    steps: int
    window_s: float
    busy_s: float
    launches: int
    stage_s: Dict[str, float]               # summed over the steps
    raster_s: Dict[str, List[float]]        # each launch, in order
    device_ops: List[list]                  # [[name, seconds]], top TOP
    idle_gaps: List[list]                   # [[host activity, seconds]]


def _launched(event):
    yield from event.kernels
    for child in event.cpu_children:
        yield from _launched(child)


def _union(intervals):
    """Merged [start, end] intervals (us) of sorted `intervals`."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _name_gaps(gaps, cpu_events):
    """{label: idle seconds} of the gaps [(start, end)], each named by the
    innermost range and operation open on the host at its middle."""
    cpu = sorted(cpu_events, key=lambda e: e.time_range.start)
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0] + gaps[i][1])
    active, j, out = [], 0, {}
    for i in order:
        s, e = gaps[i]
        mid = 0.5 * (s + e)
        while j < len(cpu) and cpu[j].time_range.start <= mid:
            active.append(cpu[j])
            j += 1
        active = [a for a in active if a.time_range.end >= mid]
        ranges = [a for a in active if a.name.startswith("3dgs:")]
        ops = [a for a in active if not a.name.startswith("3dgs:")]
        inner = lambda xs: min(xs, key=lambda a: a.time_range.end
                               - a.time_range.start).name if xs else None
        label = " > ".join(x for x in (inner(ranges), inner(ops)) if x) \
            or "no host range open"
        out[label] = out.get(label, 0.0) + (e - s) / 1e6
    return out


def trace(fn: Callable[[], None], steps: int) -> Trace:
    """Run `fn` (which does `steps` steps or frames) under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if torch.cuda.is_available() else \
        (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    events = prof.events()
    work = sorted((e for e in events if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("3dgs:")),
                  key=lambda e: e.time_range.start)
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    merged = _union([(e.time_range.start, e.time_range.end) for e in work])
    busy_s = sum(e - s for s, e in merged) / 1e6
    by_name: Dict[str, float] = {}
    for e in work:
        name = e.name[:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) \
            + (e.time_range.end - e.time_range.start) / 1e6
    stage_s: Dict[str, float] = {}
    for e in cpu:
        if e.name.startswith("3dgs:"):
            stage = e.name[5:]
            stage_s[stage] = stage_s.get(stage, 0.0) + sum(
                k.duration for k in _launched(e)) / 1e6
    raster_s = {k: [(e.time_range.end - e.time_range.start) / 1e6
                    for e in work if name in e.name]
                for k, name in RASTER_KERNELS.items()}
    gaps = []
    if merged:
        host = [e.time_range for e in cpu]
        lead = min((r.start for r in host), default=merged[0][0])
        tail = max((r.end for r in host), default=merged[-1][1])
        edges = [lead] + [x for m in merged for x in m] + [tail]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
    named = _name_gaps(gaps, cpu)
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:TOP]]
    return Trace(steps=steps, window_s=window_s, busy_s=busy_s,
                 launches=len(work), stage_s=stage_s, raster_s=raster_s,
                 device_ops=top(by_name), idle_gaps=top(named))
