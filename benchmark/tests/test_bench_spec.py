"""BENCHMARK.json against the rules of its format, and every configuration,
mix, driver, limit and reader found by name, an added one included."""

import json
import re
import shutil

import pytest
from conftest import BENCH, ROOT

from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
# what run.py and calibrate.py call on a driver
RUN_CALLS = ("setup", "window", "trace", "release", "reference", "numbers",
             "scene_line")
CALIBRATE_CALLS = ("check_run", "controls", "calibration")


def test_keys_names_and_units():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["benchmark"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCHMARK[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCHMARK["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCHMARK["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCHMARK["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  BENCHMARK["workloads"]])
def test_cell_loads_by_name(cell):
    c = spec.load_cell(cell)
    assert c.chips == 1
    assert (BENCH / "drivers" / f"{c.traffic['kind']}.py").is_file()
    for method in RUN_CALLS + CALIBRATE_CALLS:
        assert callable(getattr(c.driver, method, None)), method
    assert (ROOT / c.config["recipe"]).is_file()
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
    assert set(c.readers) == {m["name"] for m in c.per_layer}
    assert c.limits
    assert c.driver.__name__ == "Driver"


@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (BENCH / "held_out.json").read_text())["workloads"]])
def test_held_out_cell_loads_without_limits(cell):
    """A cell out for a fault of the program loads with its entries, and
    without limits is never correct."""
    assert cell not in {w["name"] for w in BENCHMARK["workloads"]}
    c = spec.load_cell(cell, spec.with_held_out())
    assert c.limits == {} and c.per_layer and c.readers
    assert (ROOT / c.config["recipe"]).is_file()


def test_config_files_match_benchmark():
    for c in spec.with_held_out()["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert set(data["reduced"]) <= set(data["published"])


def test_an_added_cell_needs_no_edit(tmp_path):
    """A new configuration, mix of a new kind with its driver, limit and
    reader, each a file of its own, are found by the name a new entry gives
    them; a metric with a suffix takes its stem's reader, or its own where
    it has one; the files that were there are left as they were."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(BENCHMARK))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs" / "mipnerf360_outdoor.json")
                     .read_text())
    cfg["n_gaussians"] = 500000
    (bench / "configs" / "extra_cfg.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "extra_mix.json").write_text(json.dumps(
        {"kind": "extra_kind", "viewers": 4}))
    (bench / "drivers" / "extra_kind.py").write_text(
        "class Driver:\n    kind = 'extra_kind'\n")
    (bench / "limits" / "extra_cfg.extra_mix.json").write_text(json.dumps(
        {"image_gap": {"limit": 1e-3}}))
    (bench / "metrics" / "extra_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    (bench / "metrics" / "mfu.extra.py").write_text(
        "def read(ctx):\n    return 7.0\n")
    b = json.loads(json.dumps(BENCHMARK))
    b["workloads"].append({"name": "extra_cfg.extra_mix",
                           "config": "extra_cfg", "traffic": "extra_mix",
                           "chips": 1, "why": "an added cell"})
    b["end_to_end"].append({"name": "extra_ms", "unit": "ms",
                            "better": "lower", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["extra_cfg.extra_mix"]})
    for name in ("extra_metric.extra", "mfu.extra", "launches.extra"):
        b["per_layer"].append({"name": name, "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "whole step", "moves": "extra_ms",
                               "workloads": ["extra_cfg.extra_mix"]})
    c = spec.load_cell("extra_cfg.extra_mix", b, bench)
    assert c.config["n_gaussians"] == 500000
    assert c.traffic["viewers"] == 4
    assert c.driver.kind == "extra_kind"
    assert c.limits == {"image_gap": {"limit": 1e-3}}
    assert c.readers["extra_metric.extra"](None) == 42.0
    assert c.readers["mfu.extra"](None) == 7.0
    assert c.readers["launches.extra"].__module__.endswith("launches")
    assert {m["name"] for m in c.end_to_end} == {"extra_ms", "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data
