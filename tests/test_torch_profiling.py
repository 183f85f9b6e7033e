"""The port's utils/profiling.py: the timer's sink and its printed line, and
a torch.profiler trace written on the CPU (the stage recorder:
test_torch_tracing.py)."""

import json

import torch

from mini3dgs_tpu_torch.utils import profiling as tprof


def test_timer_fills_its_sink():
    sink = {}
    with tprof.timer("matmul", sink, device="cpu"):
        torch.randn(64, 64) @ torch.randn(64, 64)
    with tprof.timer("default", sink):
        pass
    assert set(sink) == {"matmul", "default"}
    assert all(isinstance(v, float) and v >= 0 for v in sink.values())


def test_timer_prints_without_a_sink(capsys):
    with tprof.timer("block", device="cpu"):
        pass
    assert capsys.readouterr().out.startswith("[timer] block: ")


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with tprof.trace(str(tmp_path / "trace")) as prof:
        with torch.profiler.record_function("3dgs:test_range"):
            torch.randn(128, 128).sum()
    assert prof is not None
    data = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in data["traceEvents"]}
    assert "3dgs:test_range" in names

