"""The stage recorder of utils/profiling.py: `stage` opens the same
`3dgs:` profiler ranges as before, a recording changes no output and
nothing is kept without one, spans nest with their parents, steps and self
times, and the counters read what the program holds.  Tiny sizes on the
CPU; one test, marked `cuda`, counts syncs and walls on the card.

This file imports no JAX, so on a GPU host that has none it runs without
the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py
"""

import contextlib
import threading
import time
import types
import warnings

import numpy as np
import pytest
import torch

from mini3dgs_tpu_torch import convert
from mini3dgs_tpu_torch.config import TrainingConfig
from mini3dgs_tpu_torch.ops import cuda_library
from mini3dgs_tpu_torch.ops.renderer import RenderSettings, render
from mini3dgs_tpu_torch.parallel import mesh
from mini3dgs_tpu_torch.train.trainer import create_train_state, train_step
from mini3dgs_tpu_torch.utils import profiling

RENDER_STAGES = {"3dgs:projection", "3dgs:binning", "3dgs:pack",
                 "3dgs:raster_fwd", "3dgs:epilogue"}
TRAIN_STAGES = RENDER_STAGES | {"3dgs:loss", "3dgs:backward",
                                "3dgs:raster_bwd", "3dgs:adam",
                                "3dgs:statistics"}
W, H = 48, 32


def _scene(device="cpu"):
    params, alive, cam = convert.flagship_scene_numpy(128, 96, seed=3)
    params["scaling"][:96] = np.log(0.08)
    g = convert.gaussians_from_numpy(params, alive, device)
    target = np.random.default_rng(4).random((3, H, W)).astype(np.float32)
    camera = convert.camera_from_numpy(width=W, height=H, device=device,
                                       image=target, **cam)
    settings = RenderSettings(image_height=H, image_width=W, tile_size=16)
    return g, camera, settings


def _render(device="cpu"):
    g, camera, settings = _scene(device)
    with torch.no_grad():
        return render(g, camera, settings)


def _train_step(device="cpu"):
    g, camera, settings = _scene(device)
    config = TrainingConfig(tile_size=16, color_mode="dc_sigmoid")
    state = create_train_state(g, config)
    return train_step(state, camera, config, settings)


def _stages_under_profiler(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events() if e.name.startswith("3dgs:")}


@pytest.mark.parametrize("fn, names", [(_render, RENDER_STAGES),
                                       (_train_step, TRAIN_STAGES)])
def test_profiler_sees_the_same_ranges(fn, names):
    assert _stages_under_profiler(fn) == names
    # and so with a recording active: it adds no range of its own
    with profiling.recording():
        assert _stages_under_profiler(fn) == names


def test_outputs_the_same_with_and_without_a_recording():
    plain = _render()
    assert profiling._active is None
    with profiling.recording() as rec:
        recorded = _render()
    for k, v in plain.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, recorded[k]), k
        else:
            assert v == recorded[k], k
    s0, m0 = _train_step()
    with profiling.recording():
        s1, m1 = _train_step()
    for k, v in s0.gaussians.params().items():
        assert torch.equal(v, s1.gaussians.params()[k]), k
    assert all(torch.equal(torch.as_tensor(m0[k]), torch.as_tensor(m1[k]))
               for k in m0)
    # nothing is kept outside a recording, not even by a finished one
    n = len(rec.spans)
    _render()
    assert profiling._active is None and len(rec.spans) == n


def _sleep_ms(ms):
    t = time.perf_counter() + ms / 1e3
    while time.perf_counter() < t:
        pass


def test_spans_nest_with_parent_and_self_time():
    def in_other_thread():
        with profiling.stage("3dgs:other"):
            pass

    @profiling.step("step")
    def work():
        with profiling.stage("3dgs:outer"):
            _sleep_ms(2)
            with profiling.stage("3dgs:inner"):
                _sleep_ms(3)
            with profiling.stage("3dgs:inner"):
                _sleep_ms(1)
            other = threading.Thread(target=in_other_thread)
            other.start()
            other.join()
        with profiling.stage("3dgs:after"):
            pass

    with profiling.recording(device="cpu") as rec:
        work()
    by = {}
    for s in rec.spans:
        by.setdefault(s.name, []).append(s)
    top, = by["step"]
    outer, = by["3dgs:outer"]
    assert top.parent is None and not top.is_stage
    assert outer.parent is top and by["3dgs:after"][0].parent is top
    assert all(s.parent is outer for s in by["3dgs:inner"])
    # another thread with nothing open nests under the step's thread
    assert by["3dgs:other"][0].parent is outer
    assert by["3dgs:other"][0].thread != outer.thread
    assert {s.step for s in rec.spans} == {0} and rec.steps == 1
    row = rec.summary()
    kids = sum(s.t1 - s.t0 for s in by["3dgs:inner"] + by["3dgs:other"])
    assert row["3dgs:outer"]["host_self_ms"] == pytest.approx(
        (outer.t1 - outer.t0 - kids) / 1e6)
    assert row["3dgs:outer"]["host_self_ms"] >= 1.9
    assert row["3dgs:inner"]["calls"] == 2
    assert row["3dgs:inner"]["host_ms"] >= 3.9
    assert row["3dgs:inner"]["host_ms"] == row["3dgs:inner"]["host_self_ms"]
    assert row["3dgs:outer"]["wall_ms"] is None  # no card


def test_spans_of_a_render_carry_its_step():
    with profiling.recording(device="cpu") as rec:
        _render()
        _render()
    assert rec.steps == 2
    for step in (0, 1):
        spans = [s for s in rec.spans if s.step == step]
        top = [s for s in spans if s.parent is None]
        assert [s.name for s in top] == ["render"]
        assert {s.name for s in spans} == RENDER_STAGES | {"render"}
    # a render inside a train step is a span of that step
    with profiling.recording(device="cpu") as rec:
        _train_step()
    assert rec.steps == 1 and {s.step for s in rec.spans} == {0}
    assert [s.name for s in rec.spans if s.parent is None] == ["train_step"]


def test_instances_counter_is_n_live():
    with profiling.recording(device="cpu") as rec:
        out = _render()
    assert out["n_live"] > 0
    assert rec.counters()["instances"] == out["n_live"]
    with profiling.recording(device="cpu") as rec:
        a, b = _render(), _render()
    assert rec.counters(steps=1)["instances"] == a["n_live"] + b["n_live"]


def test_projection_kernel_counter_only_where_it_launches():
    """On CPU tensors the projection runs the plain chain: the recording
    holds no `projection_kernel` or `projection_bwd_kernel` count (the
    card's tests hold 1 P1 a render, and 1 P1 and 1 P2 a train step)."""
    with profiling.recording(device="cpu") as rec:
        _render()
        _train_step()
    assert "projection_kernel" not in rec.counters()
    assert "projection_bwd_kernel" not in rec.counters()
    assert rec.counters()["instances"] > 0


def test_launches_and_traffic_are_counted_where_they_happen(monkeypatch):
    """Each launch through `cuda_library.launch` and each exchange of the
    mesh adds to its running total and to the active recording, a step;
    the raster's and the traffic's counters read 0 where nothing counted
    them, and a launch that fails counts nothing.  The CPU has no library:
    a stand-in's launchers record their arguments (a tensor goes as its
    data pointer) and return 0, or a CUDA error."""
    calls = []
    lib = types.SimpleNamespace(
        raster_fwd_launch=lambda *a: calls.append(a) or 0,
        raster_bwd_t0_launch=lambda *a: calls.append(a) or 0,
        raster_bwd_launch=lambda *a: 700)
    monkeypatch.setattr(cuda_library, "kernel_library",
                        lambda: types.SimpleNamespace(lib=lib))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=9))
    monkeypatch.setattr(cuda_library, "LAUNCHES",
                        dict.fromkeys(cuda_library.LAUNCHES, 40))
    monkeypatch.setattr(mesh, "TRAFFIC",
                        dict(mesh.TRAFFIC, calls=0, bytes=1000))
    t = torch.zeros(3)
    cuda_library.launch("raster_fwd_launch", t.device, t, 5)  # no recording
    with profiling.recording(device="cpu") as rec:
        for _ in range(3):
            cuda_library.launch("raster_fwd_launch", t.device, t, 5)
        cuda_library.launch("raster_bwd_t0_launch", t.device, None, t)
        with pytest.raises(RuntimeError, match="raster_bwd_launch failed: "
                                               "CUDA error 700"):
            cuda_library.launch("raster_bwd_launch", t.device, t)
        mesh._traffic(3, 64, time.perf_counter())
        profiling.step("step")(lambda: None)()
        profiling.step("step")(lambda: None)()
    assert calls[0] == (t.data_ptr(), 5, 9) and calls[-1] == (
        None, t.data_ptr(), 9)
    c = rec.counters()
    assert c["raster_fwd.launches"] == 1.5 and c["raster_bwd.launches"] == 0
    assert c["raster_bwd.launches_t0"] == 0.5
    assert c["raster_fwd.launches_t0"] == 0
    assert c["traffic.bytes"] == 32 and c["traffic.calls"] == 1.5
    assert c["traffic.seconds"] >= 0
    assert "projection_kernel" not in c
    assert "host_syncs" not in c  # not counted
    assert cuda_library.LAUNCHES["raster_fwd.launches"] == 44
    assert cuda_library.LAUNCHES["raster_bwd.launches"] == 40
    assert cuda_library.LAUNCHES["raster_bwd.launches_t0"] == 41
    assert mesh.TRAFFIC["bytes"] == 1064 and mesh.TRAFFIC["calls"] == 3


def test_count_syncs_restores_mode_and_filters(monkeypatch):
    """The sync-debug mode and the warning filters come back even when the
    block raises; each sync warning counts against the innermost stage of
    its thread.  The CPU has no sync-debug mode: a stand-in records it."""
    mode = {"now": 0, "set": []}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: mode["now"])

    def set_mode(m):
        mode["set"].append(m)
        mode["now"] = {"warn": 1}.get(m, m)

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    filters, show = list(warnings.filters), warnings.showwarning
    sync = lambda: warnings.warn("called a synchronizing CUDA operation")
    rec = profiling.recording(device="cpu", count_syncs=True)
    with pytest.raises(KeyError):
        with rec:
            assert mode["now"] == 1
            sync()
            with profiling.stage("3dgs:binning"):
                for _ in range(3):
                    sync()
                with profiling.stage("3dgs:inner"):
                    sync()
            raise KeyError("inside")
    assert mode == {"now": 0, "set": ["warn", 0]}
    assert warnings.filters == filters and warnings.showwarning is show
    assert rec.syncs() == {"(none)": 1, "3dgs:binning": 3, "3dgs:inner": 1}
    assert sorted(rec.sync_sites.values()) == [1, 1, 3]
    assert all(s.split()[1].startswith("test_torch_tracing.py:")
               for s in rec.sync_sites)
    assert rec.counters(steps=1)["host_syncs"] == 5
    assert profiling._active is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_syncs_and_walls_on_the_card(card):
    """A small render syncs where the code says it does (the background's
    copy, binning's repeat_interleave, masks and bincounts, the raster's
    range check), and its stages' device walls fit inside its own."""
    g, camera, settings = _scene(card)
    with torch.no_grad():
        for _ in range(2):  # builds the kernels, warms the allocator
            render(g, camera, settings)
        torch.cuda.synchronize()
        with profiling.recording(count_syncs=True) as rec:
            out = render(g, camera, settings)
        assert rec.syncs() == {"(none)": 1, "3dgs:binning": 9,
                             "3dgs:raster_fwd": 1}
        assert torch.cuda.get_sync_debug_mode() == 0
        with profiling.recording() as rec:
            out = render(g, camera, settings)
    assert rec.counters()["instances"] == out["n_live"]
    assert rec.counters()["raster_fwd.launches"] == 1
    assert rec.counters()["projection_kernel"] == 1
    frame, = [s for s in rec.spans if s.name == "render"]
    stages = [s for s in rec.spans if s.parent is frame]
    assert {s.name for s in stages} == RENDER_STAGES
    wall = lambda s: s.d1 - s.d0
    assert all(frame.d0 <= s.d0 <= s.d1 <= frame.d1 for s in stages)
    assert sum(map(wall, stages)) <= wall(frame)
    # the host enters each stage before the card reaches it
    assert all(s.t0 <= s.d1 for s in stages)


@pytest.mark.cuda
def test_train_step_keeps_the_projection_chain_on_the_card(card):
    """A train step needs the projection's graph: its one op records it,
    and its recording counts one P1 (`projection_kernel`) and one P2
    (`projection_bwd_kernel`) launch; a render counts no P2."""
    _train_step(card)  # builds the kernels
    with profiling.recording() as rec:
        _train_step(card)
    assert rec.counters()["projection_kernel"] == 1
    assert rec.counters()["projection_bwd_kernel"] == 1
    with profiling.recording() as rec:
        _render(card)
    assert "projection_bwd_kernel" not in rec.counters()
    assert rec.counters()["raster_fwd.launches"] == 1
