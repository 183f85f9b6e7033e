"""The pair classes, operations and bytes on hand-made streams: one tile,
one instance, and a gate that closes; and the shares built on them."""

import pytest
import torch

from harness import counting
from harness.context import ReadContext
from harness.profile import Trace
from reference import raster

P = 32 * 32


def _bins(count):
    c = torch.tensor([count])
    return raster.Bins(gid=torch.arange(count), tile_start=torch.zeros(1,
                       dtype=torch.long), tile_count=c, tiles_x=1, tiles_y=1)


def _stream(ops, conic=(0.0, 0.0, 0.0), x=15.5, y=15.5):
    cols = [[x, y, -0.5 * conic[0], -conic[1], -0.5 * conic[2], op,
             0.2, 0.4, 0.6] for op in ops]
    return torch.tensor(cols, dtype=torch.float32).T.contiguous()


def test_one_instance_flat():
    """w = 1 at every pixel: all pairs open and live, 0 < op w < 1, none
    with w < 1."""
    _, used, pairs = raster.composite(_stream([0.5]), _bins(1), 32, True)
    assert pairs == {"open": P, "live": P, "alpha": P, "geom": 0}
    assert int(used[0]) == 1


def test_one_instance_round():
    """A round Gaussian: w < 1 away from its centre, below W_EPS far
    off."""
    s = _stream([0.5], conic=(0.05, 0.0, 0.05), x=16.0, y=16.0)
    _, _, pairs = raster.composite(s, _bins(1), 32, True)
    yy, xx = torch.meshgrid(torch.arange(32.0), torch.arange(32.0),
                            indexing="ij")
    w = torch.exp(-0.5 * 0.05 * ((xx - 16) ** 2 + (yy - 16) ** 2))
    live = int((w >= 1e-5).sum())
    assert pairs["open"] == P and pairs["live"] == live
    assert pairs["alpha"] == live and pairs["geom"] == live - 1


def test_closed_gate_counts_nothing_behind():
    """An instance of opacity 0.999 closes every pixel's gate: the two
    behind it get no open pair."""
    acc, used, pairs = raster.composite(_stream([0.999, 0.5, 0.5]),
                                        _bins(3), 32, True)
    assert pairs["open"] == P and pairs["live"] == P
    assert torch.allclose(acc[0, 3], torch.full((P,), 0.999))


def test_needs_by_hand():
    pairs = {"open": 10, "live": 6, "alpha": 4, "geom": 2}
    ops, b = counting.raster_fwd_need(pairs, 3, 1, P)
    assert ops == 22 * 10 + 14 * 6
    assert b == 40 * 3 + 8 + 4 * 8 * P
    ops, b = counting.raster_bwd_need(pairs, 3, 1, P)
    assert ops == 22 * 10 + 25 * 6 + 16 * 4 + 22 * 2
    assert b == 80 * 3 + 8 + 2 * 4 * 5 * P


def _ctx(times, bounds, step_s=1.0, step_ops=0.0):
    tr = Trace(steps=len(times), window_s=1.0, busy_s=0.5, launches=10,
               stage_s={"loss": 0.002}, raster_s={"raster_fwd": times},
               device_ops=[], idle_gaps=[])
    return ReadContext("train", tr, step_s, {"raster_fwd": bounds,
                                             "step_ops": step_ops})


def test_shares():
    ctx = _ctx([2e-3, 2e-3], [1e-3, 5e-4])
    assert ctx.roofline_pct("raster_fwd") == pytest.approx(37.5)
    assert ctx.roofline_pct("raster_bwd") is None
    # busy 0.25 s a traced step against the window's unprofiled 1 s a
    # step; the profiled wall (1 s for two steps) does not enter
    assert ctx.idle_pct() == pytest.approx(75.0)
    assert ctx.launches() == 5
    assert ctx.device_ms("loss") == pytest.approx(1.0)
    assert ctx.device_ms("adam") is None
    full = _ctx([1.0], [1.0], step_s=1.0,
                step_ops=counting.PEAK_FP32_OPS_PER_S)
    assert full.mfu_pct() == pytest.approx(100.0)
    assert full.roofline_pct("raster_fwd") == pytest.approx(100.0)


def test_a_kernel_at_its_bound_reads_100():
    """A launch that took exactly the least time its counted pairs allow
    reads 100 %; counting each pair twice would read 200 %."""
    _, _, pairs = raster.composite(_stream([0.01] * 64), _bins(64), 32,
                                   True)
    assert pairs["open"] == 64 * P   # the gate stays open: 0.99^64 > 0.005
    t = counting.bound_s(*counting.raster_fwd_need(pairs, 64, 1, P))
    double = {k: 2 * v for k, v in pairs.items()}
    t2 = counting.bound_s(*counting.raster_fwd_need(double, 64, 1, P))
    assert _ctx([t], [t]).roofline_pct("raster_fwd") == pytest.approx(100)
    assert _ctx([t], [t2]).roofline_pct("raster_fwd") > 105
