"""graft_entry_torch.py, the port's twin of __graft_entry__.py, on the CPU.

`dryrun_multichip(8)` on 8 CPU ranks of this process is held against the
JAX package's own `dryrun_multichip(8)` on 8 virtual CPU devices (Pallas in
interpret mode), whose six losses scripts/dryrun_record_jax.py recorded at
full precision in docs/artifacts/dryrun_multichip_jax.json: the JAX run
takes about a minute and a half, too long to repeat here.  `entry()` is
checked for its shapes on the CPU, and neither the twin nor the package
imports JAX.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import graft_entry_torch as G

REPO = Path(__file__).resolve().parent.parent
RECORD = REPO / "docs" / "artifacts" / "dryrun_multichip_jax.json"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread while this module runs: its tensors are small,
    and the test run's other workers need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dryrun_multichip_matches_the_jax_record(capsys):
    """The six steps over (data 2, tile 4) on CPU ranks: each loss within
    1e-5 (relative) of the JAX dryrun's on the same scene (measured 5.3e-6:
    the port's plain raster against the interpret-mode Pallas kernels), and
    the printed line the JAX dryrun's."""
    record = json.loads(RECORD.read_text())
    assert record["devices"] == 8 and len(record["losses"]) == 6
    losses = G.dryrun_multichip(8, device="cpu")
    assert list(losses) == list(G.STEPS) == list(record["losses"])
    for step, want in record["losses"].items():
        assert np.isfinite(losses[step])
        assert abs(losses[step] / want - 1.0) <= 1e-5, (step, losses[step],
                                                        want)
    assert capsys.readouterr().out.strip().splitlines()[-1] \
        == record["printed"]


def test_entry_renders_the_flagship_scene_on_the_cpu():
    """entry(device="cpu"): the flagship scene of 1,024 Gaussians in 2,048
    slots and a 256x256 camera; fn renders a finite [3, 256, 256] image
    that is not empty.  Without a card, entry() raises: it does not fall
    back to the CPU."""
    fn, (g, cam) = G.entry(device="cpu")
    assert g.capacity == 2048 and int(g.alive.sum()) == 1024
    assert (cam.height, cam.width) == (256, 256)
    out = fn(g, cam)
    assert out.shape == (3, 256, 256) and out.device.type == "cpu"
    assert bool(torch.isfinite(out).all()) and float(out.mean()) > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            G.entry()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            G.main()


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_twin_imports_no_jax():
    """Neither graft_entry_torch.py nor any module of the port imports
    jax or the JAX package."""
    files = [REPO / "graft_entry_torch.py",
             *sorted((REPO / "mini3dgs_tpu_torch").rglob("*.py"))]
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib",
                                              "mini3dgs_tpu"), (path, name)
