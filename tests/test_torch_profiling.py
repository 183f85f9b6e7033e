"""The port's utils/profiling.py against the JAX package's: the timer's
sink, the throughput report's keys and values (and the H100's peaks in
place of the v5e's), a torch.profiler trace written on the CPU, and the
scalar logger's lines.  Rates and times compare exactly (the same Python
arithmetic on both sides)."""

import json

import torch

import chip_smoke
from mini3dgs_tpu.utils import profiling as jprof
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


def test_throughput_report_matches_jax():
    counts = dict(pixels=800 * 800, gaussians=100_000, instances=374_264,
                  seconds=0.017)
    t, j = tprof.ThroughputCounters(**counts), jprof.ThroughputCounters(
        **counts)
    assert t.report() == j.report()
    assert json.loads(t.json_line()) == json.loads(j.json_line())
    # the H100's published peaks, as chip_smoke.py's bounds use them
    assert t.hbm_bw_gbs * 1e9 == chip_smoke.PEAK_BYTES_PER_S
    assert t.peak_tflops_fp32 * 1e12 == chip_smoke.PEAK_FP32_OPS_PER_S
    assert tprof.ThroughputCounters().report()["ms_per_step"] == \
        jprof.ThroughputCounters().report()["ms_per_step"]


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with tprof.trace(str(tmp_path / "trace")) as prof:
        with torch.profiler.record_function("3dgs:test_range"):
            torch.randn(128, 128).sum()
    assert prof is not None
    data = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in data["traceEvents"]}
    assert "3dgs:test_range" in names


def test_scalar_logger_writes_jax_lines(tmp_path):
    loggers = (tprof.ScalarLogger(str(tmp_path / "t" / "log.jsonl")),
               jprof.ScalarLogger(str(tmp_path / "j" / "log.jsonl")))
    for lg in loggers:
        lg.log(1, loss=0.5, psnr=torch.tensor(21.25).item())
        lg.log(2, loss=0.25)
        lg.close()
    assert (tmp_path / "t" / "log.jsonl").read_text() == \
        (tmp_path / "j" / "log.jsonl").read_text()
    assert loggers[0].history == loggers[1].history
    mem = tprof.ScalarLogger()
    mem.log(3, x=1)
    assert mem.history == {"x": [(3, 1.0)]} and mem.path is None
