"""The port's trainer entry points on the CPU: `main_torch.py` on the
zero-data smoke config, then `scripts/evaluate_torch.py` and
`scripts/export_ply_torch.py` on its checkpoint.  PSNR as printed (two
decimals) must be equal; the PLY must read back with every alive
Gaussian."""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

import main_torch
from mini3dgs_tpu_torch.train import checkpoint as tckpt
from mini3dgs_tpu_torch.utils.gaussian_ply import import_gaussians_ply

REPO = Path(__file__).resolve().parent.parent
SMOKE = str(REPO / "configs" / "synthetic_smoke.yaml")


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_main_evaluate_and_export(tmp_path, capsys):
    out = str(tmp_path / "run")
    assert main_torch.main(["--config", SMOKE, "--iterations", "5",
                            "--output", out, "--device", "cpu"]) == 0
    log = capsys.readouterr().out
    # the smoke config logs and densifies every 5 steps
    assert re.search(r"^\[\s+5\] l1=.* total_loss=.* n_clone=", log, re.M)
    final = re.search(r"^final: psnr=([\d.]+) ssim=([\d.]+)$", log, re.M)
    assert final and float(final.group(1)) > 10.0
    assert tckpt.latest_checkpoint_iteration(out) == 5
    state, _ = tckpt.load_checkpoint(out, 5)
    assert state.step == 5 and state.opt_state.count == 5

    evaluate = load_script("evaluate_torch")
    assert evaluate.main(["--config", SMOKE, "--data", "<random>",
                          "--output", out, "--device", "cpu"]) == 0
    mean = re.search(r"^mean: psnr=([\d.]+) ssim=([\d.]+)$",
                     capsys.readouterr().out, re.M)
    assert mean.groups() == final.groups()

    export = load_script("export_ply_torch")
    ply = str(tmp_path / "model.ply")
    assert export.main(["--config", SMOKE, "--output", out, "--out", ply,
                        "--device", "cpu"]) == 0
    assert f"wrote {state.gaussians.num_alive()} gaussians" in \
        capsys.readouterr().out
    g = import_gaussians_ply(ply)
    assert g.num_alive() == state.gaussians.num_alive()
    alive = state.gaussians.alive
    assert torch.equal(g.xyz, state.gaussians.xyz[alive])
    assert torch.equal(g.features_rest, state.gaussians.features_rest[alive])


def test_entry_points_default_to_the_card():
    """Without a config's `device: cpu` or --device cpu the entry points
    ask for the card and raise on a host without one."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="cpu"):
        main_torch.main(["--iterations", "1"])
    with pytest.raises(RuntimeError, match="cpu"):
        load_script("export_ply_torch").main(["--output", "unused"])


@pytest.fixture
def one_torch_thread():
    """Torch on one thread for a test whose tensors are small: the test
    run's other workers need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_main_over_a_mesh(tmp_path, capsys, one_torch_thread):
    """`--mesh-data 2 --mesh-tile 2` with a config that sets
    `shard_gauss_state: true` trains (the setup's gradient self-check
    included), writes a single-device checkpoint, and resumes from it
    (the smoke config at 64x64)."""
    cfg = tmp_path / "mesh.yaml"
    cfg.write_text(Path(SMOKE).read_text().replace(
        "  use_pallas: true\n", "  use_pallas: true\n"
        "  shard_gauss_state: true\n").replace(
        "image_height: 128\n  image_width: 128", "image_height: 64\n"
        "  image_width: 64"))
    out = str(tmp_path / "run")
    argv = ["--config", str(cfg), "--output", out, "--device", "cpu",
            "--mesh-data", "2", "--mesh-tile", "2"]
    assert main_torch.main(argv + ["--iterations", "5"]) == 0
    log = capsys.readouterr().out
    assert re.search(r"^\[\s+5\] l1=.* total_loss=.* n_clone=", log, re.M)
    assert re.search(r"^final: psnr=([\d.]+) ssim=([\d.]+)$", log, re.M)
    state, _ = tckpt.load_checkpoint(out, 5)
    assert state.step == 5 and state.gaussians.capacity % 4 == 0
    assert main_torch.main(argv + ["--resume", "5", "--iterations", "1"]) == 0
    assert tckpt.latest_checkpoint_iteration(out) == 6
