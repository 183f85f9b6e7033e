"""The port's two training-run scripts at toy size on the CPU:
scripts/train_probe_torch.py (random-init Gaussians fit one target; its
PSNR must rise) and scripts/train_1m_torch.py (a pool seeded with surface
samples of the procedural scene trains on a Blender scene written by
scripts/make_synthetic_scene_torch.py).  Both run through their `main`,
print their lines, and end with a JSON line of their numbers."""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread while this module runs: its tensors are small,
    and the test run's other workers need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(name, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = load_script(name).main(argv)
    lines = buf.getvalue().strip().splitlines()
    return code, lines, json.loads(lines[-1])


def test_train_probe_psnr_rises():
    """24 steps at 32x32 logged every 8: the PSNR of the model against the
    target rises from the first log to the last, and the loss falls."""
    code, lines, out = run_main("train_probe_torch", [
        "--device", "cpu", "--steps", "24", "--size", "32",
        "--log-interval", "8"])
    assert code == 0
    assert [e["it"] for e in out["log"]] == [8, 16, 24]
    psnrs = [e["psnr"] for e in out["log"]]
    assert np.isfinite(psnrs).all() and psnrs[-1] > psnrs[0] + 0.5, psnrs
    assert out["log"][-1]["loss"] < out["log"][0]["loss"]
    assert out["alive"] == 2000 and out["capacity"] == 4096
    assert any(l.startswith("final: psnr=") for l in lines)
    assert any(l.startswith("TRAIN PROBE") for l in lines)
    assert sum(l.startswith("[") for l in lines) == 3


def test_train_1m_runs_on_a_generated_blender_scene(tmp_path):
    """A 4-view 32x32 Blender scene, 3,000 seed points in a 4,096-slot pool,
    10 + 5 steps: the first step, both windows, the memory line and the
    final evaluation are printed; the loss is finite and falls; nothing is
    densified."""
    scene = tmp_path / "scene"
    gen = load_script("make_synthetic_scene_torch")
    with contextlib.redirect_stdout(io.StringIO()):
        assert gen.main(["--out", str(scene), "--n-train", "4", "--n-test",
                         "1", "--size", "32", "--spp", "1", "--device",
                         "cpu"]) == 0
    code, lines, out = run_main("train_1m_torch", [
        "--scene", str(scene), "--device", "cpu", "--iters", "10",
        "--steady", "5", "--n-points", "3000", "--capacity", "4096",
        "--log-interval", "5"])
    assert code == 0
    for head in ("4 train cameras at 32x32", "3000 seed points",
                 "first step:", "window 1:", "steady-state:",
                 "device memory: not measured", "eval after 15 it:"):
        assert any(l.startswith(head) for l in lines), head
    assert out["iterations"] == 15 and out["n_alive"] == 3000
    assert out["size"] == [32, 32] and out["peak_gib"] is None
    assert 0 < out["n_live"] and np.isfinite(out["psnr"])
    losses = out["losses"]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
