"""Tracing and timing (counterpart of mini3dgs_tpu/utils/profiling.py).

`trace` captures a `torch.profiler` trace (host ranges and, with a card,
its kernels) as a Chrome trace; `timer` times a block with CUDA events on
the card or `perf_counter` on the CPU.

The stages of a step are marked with `stage("3dgs:<name>")`: it opens the
`torch.profiler` range of that name, which profilers and
scripts/profile_step_torch.py read, and, inside `recording()`, keeps a span
of it as well.  `step` marks a function whose every call is one step (a
render, a train step): the spans inside a call carry its id.  `count` adds
to a counter of the recording.  With no recording active, a stage costs its
profiler range and one test, a step one test, a count one test.

    with recording() as rec:              # recording(count_syncs=True)
        for cam in cams:
            render(gaussians, cam, settings)
    rec.summary()    # {span: wall, host and self ms a step}
    rec.counters()   # {counter: a step}
    rec.write_chrome_trace("spans.json")

A span holds its name, its parent, its step, its thread, its host entry and
exit (`time.perf_counter_ns`) and, on the card, a CUDA event recorded at
each on its thread's current stream (as the thread's first span in the
recording found it).  Its parent is the innermost span open on its
thread or, where that has none (autograd runs the backward on a thread of
its own), on the thread that opened the step.  The recording ends with one
synchronisation; then each span's device wall is the time between its
events: from the card finishing the work enqueued before the span to the
card finishing the span, its kernels and the card's waits on the host
inside it.  An anchor event recorded on the empty stream at the start,
beside a host timestamp, puts the card's intervals on the host clock, late
by the anchor's launch latency (a few microseconds) at most.

Counters: what `count` adds (`instances`: the stream length binning
emits), the raster launches (`raster_fwd.launches`, ...) and
`parallel/mesh.TRAFFIC`, read as differences over the recording, and with
`count_syncs=True` on a card `host_syncs`: the "synchronizing CUDA
operation" warnings of `torch.cuda.set_sync_debug_mode("warn")`, each
counted against the innermost stage open on the thread that synced, or
`(none)`, and the line of Python that called the operation
(`sync_sites`; `syncs()` sums them by stage).  The warning costs host time
at each sync, so syncs are counted in a recording of their own, whose
walls are not the program's.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import tempfile
import threading
import time
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch.profiler import record_function

NO_STAGE = "(none)"
SYNC_WARNING = "synchronizing CUDA operation"

_active: Optional["Recording"] = None  # the recording in progress
READY_EVENTS = 512  # timing events a recording on a card makes beforehand


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


class stage:
    """`with stage("3dgs:binning"):` the profiler range of that name, and a
    span of the active recording, if any."""

    __slots__ = ("_range", "_span")

    def __init__(self, name: str):
        self._range = record_function(name)
        self._span = None

    def __enter__(self):
        self._range.__enter__()
        if _active is not None:
            self._span = _active._open(self._range.name, True)
        return self

    def __exit__(self, *exc):
        if self._span is not None and self._span.rec is _active:
            _active._close(self._span)
        self._range.__exit__(*exc)
        return False


def step(name: str):
    """Decorator: each call of the function is one step of the active
    recording, a span `name` with no profiler range that the spans inside
    share the id of.  A call inside another step is a plain span of it."""
    def wrap(fn):
        @functools.wraps(fn)
        def stepped(*args, **kw):
            rec = _active
            if rec is None:
                return fn(*args, **kw)
            span = rec._open(name, False, step=True)
            try:
                return fn(*args, **kw)
            finally:
                if rec is _active:
                    rec._close(span)
        return stepped
    return wrap


def count(name: str, value) -> None:
    """Add `value` to the counter `name` of the active recording, if any."""
    if _active is not None:
        _active.counts[name] = _active.counts.get(name, 0) + value


@dataclass(eq=False)
class Span:
    rec: "Recording"
    name: str
    is_stage: bool
    parent: Optional["Span"]
    step: int                  # the step's id; -1 outside any step
    thread: int
    stack: list                # the open spans of its thread
    t0: int                    # host perf_counter_ns at entry
    t1: int = 0                # and at exit
    events: Optional[tuple] = None   # CUDA events at entry and exit
    d0: Optional[float] = None       # the card's entry and exit (ns), on
    d1: Optional[float] = None       # the host clock, once resolved


def _watched() -> Dict[str, float]:
    """The program's running totals that a recording reads as
    differences: raster launches and the mesh's exchange traffic."""
    from ..ops import raster_cuda as RC
    from ..parallel import mesh as M
    out = {f"{f}.{a}": getattr(getattr(RC, f), a)
           for f in ("raster_fwd", "raster_bwd")
           for a in ("launches", "launches_t0")}
    out.update({f"traffic.{k}": v for k, v in M.TRAFFIC.items()})
    return out


def _covered(start, end, intervals) -> float:
    """The length of [start, end] that the union of `intervals` covers."""
    total, reach = 0.0, start
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, end)
        if e > s:
            total += e - s
            reach = e
    return total


class Recording:
    """Spans and counters kept while active; see the module's docstring.
    `device` (the card where there is one) decides whether spans carry
    CUDA events."""

    def __init__(self, device=None, count_syncs: bool = False):
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.count_syncs = count_syncs
        self.spans: List[Span] = []
        self.counts: Dict[str, float] = {}
        # syncs by "stage file:line", once counted
        self.sync_sites: Optional[Dict[str, int]] = None
        self.steps = 0
        self._local = threading.local()
        self._step = -1                      # the open step's id
        self._step_span: Optional[Span] = None
        self._step_stack: Optional[list] = None  # its thread's open spans
        self._anchor = None
        self._ready: list = []       # created timing events, not yet used
        self._origin = 0
        self._base: Dict[str, float] = {}
        self._diff: Dict[str, float] = {}
        self._restore = None

    # -- while active ----------------------------------------------------
    def _open(self, name: str, is_stage: bool, step: bool = False) -> Span:
        stack = self._local.__dict__.setdefault("stack", [])
        parent = stack[-1] if stack else (
            self._step_stack[-1] if self._step_stack else None)
        first = step and self._step < 0
        if first:
            self._step, self._step_stack = self.steps, stack
            self.steps += 1
        span = Span(self, name, is_stage, parent, self._step,
                    threading.get_ident(), stack, time.perf_counter_ns())
        if first:
            self._step_span = span
        if self.cuda:
            span.events = (self._recorded(),)
        stack.append(span)
        self.spans.append(span)
        return span

    def _close(self, span: Span) -> None:
        if self.cuda:
            span.events += (self._recorded(),)
        span.t1 = time.perf_counter_ns()
        span.stack.remove(span)
        if span is self._step_span:
            self._step, self._step_span, self._step_stack = -1, None, None

    def _recorded(self, stream=None):
        """A ready timing event, recorded on `stream` or else on the
        thread's current stream as its first span in the recording found
        it.  An event is created at its first record, and looking the
        stream up costs more than a record."""
        if stream is None:
            stream = getattr(self._local, "stream", None)
            if stream is None:
                stream = self._local.stream = torch.cuda.current_stream(
                    self.device)
        ev = self._ready.pop() if self._ready else \
            torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def _on_warning(self, message, category, filename, lineno, file=None,
                    line=None):
        if SYNC_WARNING not in str(message):
            return self._restore[2](message, category, filename, lineno,
                                    file, line)
        stack = getattr(self._local, "stack", None) or self._step_stack or []
        name = next((s.name for s in reversed(stack) if s.is_stage),
                    NO_STAGE)
        site = f"{name} {os.path.basename(filename)}:{lineno}"
        self.sync_sites[site] = self.sync_sites.get(site, 0) + 1

    def __enter__(self) -> "Recording":
        global _active
        if _active is not None:
            raise RuntimeError("a recording is already active")
        if self.cuda:
            stream = torch.cuda.current_stream(self.device)
            for _ in range(READY_EVENTS):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(stream)
                self._ready.append(ev)
            torch.cuda.synchronize(self.device)
            self._anchor = self._recorded(stream)
        self._origin = time.perf_counter_ns()
        self._base = _watched()
        if self.count_syncs and torch.cuda.is_available():
            self.sync_sites = {}
            caught = warnings.catch_warnings()
            caught.__enter__()
            self._restore = (caught, torch.cuda.get_sync_debug_mode(),
                             warnings.showwarning)
            warnings.filterwarnings("always", message=f".*{SYNC_WARNING}")
            warnings.showwarning = self._on_warning
            torch.cuda.set_sync_debug_mode("warn")
        _active = self
        return self

    def __exit__(self, *exc) -> bool:
        global _active
        _active = None
        if self._restore is not None:
            caught, mode, _ = self._restore
            self._restore = None
            try:
                torch.cuda.set_sync_debug_mode(mode)
            finally:
                caught.__exit__(*exc)
        now = _watched()
        self._diff = {k: now[k] - v for k, v in self._base.items()}
        if self.cuda:
            torch.cuda.synchronize(self.device)
            ns = lambda ev: self._origin + 1e6 * self._anchor.elapsed_time(ev)
            for s in self.spans:
                if s.events is not None and len(s.events) == 2:
                    s.d0, s.d1 = ns(s.events[0]), ns(s.events[1])
                s.events = None
            self._anchor, self._ready = None, []
        return False

    # -- after it --------------------------------------------------------
    def syncs(self) -> Optional[Dict[str, int]]:
        """The syncs by stage (or `(none)`); None where not counted."""
        if self.sync_sites is None:
            return None
        out: Dict[str, int] = {}
        for site, c in self.sync_sites.items():
            name = site.split(" ", 1)[0]
            out[name] = out.get(name, 0) + c
        return out

    def summary(self, steps: Optional[int] = None) -> Dict[str, dict]:
        """For each span name: `calls`, `host_ms` and `host_self_ms`, the
        device `wall_ms` and `self_ms` (None without a card), and with
        syncs counted `syncs`, each a step (`steps`: the recorded steps by
        default).  Self time is the span's less what its children cover."""
        n = max(steps if steps is not None else self.steps, 1)
        children: Dict[int, List[Span]] = {}
        for s in self.spans:
            if s.parent is not None:
                children.setdefault(id(s.parent), []).append(s)
        out: Dict[str, dict] = {}
        for s in self.spans:
            if not s.t1:
                continue  # still open when the recording ended
            kids = [k for k in children.get(id(s), []) if k.t1]
            row = out.setdefault(s.name, {
                "calls": 0, "host_ms": 0.0, "host_self_ms": 0.0,
                "wall_ms": 0.0 if self.cuda else None,
                "self_ms": 0.0 if self.cuda else None})
            row["calls"] += 1 / n
            host = s.t1 - s.t0
            row["host_ms"] += host / 1e6 / n
            row["host_self_ms"] += (host - _covered(
                s.t0, s.t1, [(k.t0, k.t1) for k in kids])) / 1e6 / n
            if self.cuda and s.d0 is not None:
                wall = s.d1 - s.d0
                row["wall_ms"] += wall / 1e6 / n
                row["self_ms"] += (wall - _covered(
                    s.d0, s.d1, [(k.d0, k.d1) for k in kids
                                 if k.d0 is not None])) / 1e6 / n
        for name, c in (self.syncs() or {}).items():
            out.setdefault(name, {})["syncs"] = c / n
        return out

    def counters(self, steps: Optional[int] = None) -> Dict[str, float]:
        """Each counter a step: the counts, the watched totals' differences
        and, where counted, `host_syncs`."""
        n = max(steps if steps is not None else self.steps, 1)
        out = {k: v / n for k, v in {**self._diff, **self.counts}.items()}
        if self.sync_sites is not None:
            out["host_syncs"] = sum(self.sync_sites.values()) / n
        return out

    def write_chrome_trace(self, path) -> None:
        """The spans as a Chrome trace (Perfetto, chrome://tracing): a host
        track a thread and, on a card, a device track, on the one clock;
        the counters under `otherData`."""
        us = lambda ns: (ns - self._origin) / 1e3
        threads = {t: i for i, t in enumerate(
            dict.fromkeys(s.thread for s in self.spans))}
        ev = [{"ph": "M", "name": "process_name", "pid": p,
               "args": {"name": name}}
              for p, name in ((0, "host"), (1, f"device {self.device}"))]
        for s in self.spans:
            if not s.t1:
                continue
            args = {"step": s.step}
            ev.append({"ph": "X", "name": s.name, "pid": 0,
                       "tid": threads[s.thread], "ts": us(s.t0),
                       "dur": (s.t1 - s.t0) / 1e3, "args": args})
            if s.d0 is not None:
                ev.append({"ph": "X", "name": s.name, "pid": 1, "tid": 0,
                           "ts": us(s.d0), "dur": (s.d1 - s.d0) / 1e3,
                           "args": args})
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(
            {"traceEvents": ev,
             "otherData": {"counters": self.counters(),
                           "sync_sites": self.sync_sites}}))


def recording(device=None, count_syncs: bool = False) -> Recording:
    """A new recording, to use as `with recording() as rec:`."""
    return Recording(device, count_syncs)
