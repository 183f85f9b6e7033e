"""The port's training-quality parity route against the JAX package's, on
the CPU: scripts/train_path_parity_torch.py's `golden` route against
scripts/train_path_parity.py's `run_path(False, ...)` at the parity
setting (RandomDataset(6 cameras, seed 3), pool 4096, seed 7, tile 32,
SH 0, dc_sigmoid), cut to 64^2 and 20 iterations.  The densify window
(from 500) does not open; the pool's compaction when the window's end
(iteration 10) passes is the one event.

Checked: the same initial Gaussians (1e-6) and targets (1e-5: each
package's golden render, measured 4.6e-6 apart), the same event and
n_alive, the loss of the first iteration (rtol 1e-3; measured 9.4e-5),
every loss finite and of the same size, and the final validation PSNR
within 2 dB (measured 0.36 dB at 20 iterations: JAX 46.83, the port
47.18; 1.08 dB at 10) and SSIM within 1e-3.

The losses after the first are not held step by step, nor the PSNR to
0.05 dB: the setting starts at its optimum.  The targets are renders of
the very Gaussians the trainer starts from, so render and target differ
by float32 noise (L1 6e-4, mostly at the tile cutoff), the L1 gradient's
sign() turns that noise into gradients of full size, and Adam into steps
of full size: after one step, 80 % of the Gaussians of the two packages
have moved in opposite directions (measured on the CPU host; JAX's run
is bitwise the same whether it logs every step or every 200).  From there
the two runs are independent random walks, and only the final metric can
be compared, as the script's own gate does; after 20 iterations that
metric is still one draw of the walk, hence 2 dB here and the script's
0.5 dB only after its 300 or 1000.
"""

import argparse
import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

from mini3dgs_tpu import config as jconfig
from mini3dgs_tpu.train import trainer as jtrainer
from tests.test_torch_core import t2n

REPO = Path(__file__).resolve().parent.parent
SIZE, ITERS = 64, 20
PARAMS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_run():
    """run_path(False, ...) with every iteration logged; its initial
    Gaussians, targets, per-iteration metrics, compaction and result."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        jscript = _script("train_path_parity")
    finally:
        sys.path.remove(str(REPO / "scripts"))
    mp = pytest.MonkeyPatch()
    seen = {"log": {}}
    real_cfg, real_train = jconfig.TrainingConfig, jtrainer.GaussianTrainer.train
    mp.setattr(jconfig, "TrainingConfig",
               lambda **kw: real_cfg(**{**kw, "log_interval": 1}))

    def train(self, iterations=None, log_fn=None):
        seen["init"] = {k: np.asarray(getattr(self.state.gaussians, k))
                        for k in PARAMS + ("alive",)}
        seen["targets"] = [np.asarray(c.image)
                           for c in self.dataset.cameras]
        out = real_train(self, iterations, log_fn=lambda it, m: seen[
            "log"].__setitem__(it, dict(m)))
        seen["capacity"] = self.state.gaussians.capacity
        return out

    mp.setattr(jtrainer.GaussianTrainer, "train", train)
    try:
        seen["result"] = jscript.run_path(False, argparse.Namespace(
            iters=ITERS, size=SIZE, capacity=4096, max_instances=2 ** 17))
    finally:
        mp.undo()
    return seen


@pytest.fixture(scope="module")
def port_run():
    script = _script("train_path_parity_torch")
    args = script.build_argparser().parse_args(
        ["--size", str(SIZE), "--iters", str(ITERS), "--device", "cpu"])
    tr = script.make_trainer(args, "golden")
    tr.config = dataclasses.replace(tr.config, log_interval=1)
    seen = {"init": {k: t2n(getattr(tr.state.gaussians, k))
                     for k in PARAMS + ("alive",)},
            "targets": [t2n(c.image) for c in tr.dataset.cameras],
            "log": {}}
    tr.train(log_fn=lambda it, m: seen["log"].__setitem__(it, m))
    seen["capacity"] = tr.state.gaussians.capacity
    seen["result"] = dict(tr.validate(),
                          n_alive=tr.state.gaussians.num_alive())
    seen["trainer"] = tr
    return seen


def test_setup_starts_from_jax_gaussians_and_targets(jax_run, port_run):
    assert port_run["trainer"].settings.raster == "golden"
    for k in PARAMS + ("alive",):
        np.testing.assert_allclose(port_run["init"][k], jax_run["init"][k],
                                   rtol=0, atol=1e-6, err_msg=k)
    assert len(port_run["targets"]) == len(jax_run["targets"]) == 6
    # each package's golden compositor, float32 sums in its own order
    for a, b in zip(port_run["targets"], jax_run["targets"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_golden_route_trains_like_jax(jax_run, port_run):
    jl, tl = jax_run["log"], port_run["log"]
    assert sorted(tl) == sorted(jl) == list(range(1, ITERS + 1))
    np.testing.assert_allclose(float(tl[1]["total_loss"]),
                               jl[1]["total_loss"], rtol=1e-3)
    losses = np.array([[float(tl[it]["total_loss"]), jl[it]["total_loss"]]
                       for it in jl])
    assert np.isfinite(losses).all()
    assert 0.25 < losses[:, 0].mean() / losses[:, 1].mean() < 4.0
    # the one event: the pool's compaction once the window's end passes
    assert port_run["capacity"] == jax_run["capacity"] == 2304
    jr, tr = jax_run["result"], port_run["result"]
    assert tr["n_alive"] == jr["n_alive"] == 2000
    assert abs(tr["psnr"] - jr["psnr"]) < 2.0
    assert abs(tr["ssim"] - jr["ssim"]) < 1e-3


def test_parity_script_gates_against_a_record(tmp_path, capsys):
    """--against checks the record's setting and gates the tiles route
    against its PSNR beside the golden route; the last line is the JSON
    verdict."""
    script = _script("train_path_parity_torch")
    rec = tmp_path / "rec.json"
    rec.write_text('{"size": 32, "iters": 4, "psnr": 1000.0}')
    with pytest.raises(SystemExit, match="--size 32 --iters 4"):
        script.main(["--against", str(rec), "--device", "cpu"])
    code = script.main(["--against", str(rec), "--size", "32", "--iters",
                        "4", "--device", "cpu"])
    import json
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 1 and last["pass"] is False
    assert set(last["gates_db"]) == {"tiles_vs_jax", "tiles_vs_golden"}
    assert last["gates_db"]["tiles_vs_jax"] > 900
    assert last["routes"]["tiles"]["n_alive"] == 2000


def test_parity_script_refuses_cuda_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    script = _script("train_path_parity_torch")
    with pytest.raises(RuntimeError, match="cuda"):
        script.main(["--size", "32", "--iters", "2"])


@pytest.mark.parametrize("name,size", [
    ("train_path_parity_jax.json", 64),
    ("train_path_parity_jax_256.json", 256)])
def test_jax_records_name_their_setting(name, size):
    """The JAX records scripts/train_path_record_jax.py wrote: the setting,
    the command, and a finite result of all 2,000 Gaussians (the densify
    window never opens at 300 iterations)."""
    import json
    rec = json.loads((REPO / "docs" / "artifacts" / name).read_text())
    assert (rec["size"], rec["iters"]) == (size, 300)
    assert rec["command"].startswith(
        f"python scripts/train_path_record_jax.py --size {size} --iters 300")
    assert np.isfinite(rec["psnr"]) and rec["n_alive"] == 2000
    assert "never opens" in rec["note"]


def test_other_targets_first_losses_follow_the_jax_record():
    """`--setting other_targets` (the start of the parity setting, targets
    rendered from seed TARGET_SEED's cloud) at 64^2 / 20 iterations: the
    port's tile route's first five losses, step by step, against the JAX
    golden route's record of the same setting
    (scripts/train_path_record_jax.py --setting other_targets), rtol 1e-4;
    measured 4e-7 to 9e-7 (the golden route's lie as close, and the tile
    route's all 20 within 2.3e-6).  Render and target differ by far more
    than float32 noise here, so L1's sign() agrees between the packages
    and so do the Adam steps.  The record names its setting and holds
    every iteration's loss.  Torch on one thread: the tensors are small,
    and the test run's other workers need the cores."""
    import json

    import torch
    rec = json.loads((REPO / "docs" / "artifacts"
                      / "train_path_parity_jax_other_targets.json").read_text())
    script = _script("train_path_parity_torch")
    assert (rec["setting"], rec["size"], rec["iters"], rec["target_seed"]) \
        == ("other_targets", SIZE, ITERS, script.TARGET_SEED)
    assert len(rec["losses"]) == ITERS and np.isfinite(rec["losses"]).all()
    args = script.build_argparser().parse_args(
        ["--size", str(SIZE), "--iters", str(ITERS), "--device", "cpu",
         "--setting", "other_targets"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr = script.make_trainer(args, "tiles")
        tr.config = dataclasses.replace(tr.config, log_interval=1)
        losses = {}
        tr.train(iterations=5, log_fn=lambda it, m: losses.__setitem__(
            it, float(m["total_loss"])))
    finally:
        torch.set_num_threads(threads)
    assert sorted(losses) == [1, 2, 3, 4, 5]
    got = np.array([losses[it] for it in range(1, 6)])
    np.testing.assert_allclose(got, rec["losses"][:5], rtol=1e-4)
