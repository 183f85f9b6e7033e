"""Shared set-up of the benchmark's own tests (run them with
`python -m pytest benchmark/tests -q`): the import paths, the `cuda`
marker, and cells cut to a size the CPU runs in seconds."""

import copy
import os
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for _p in (str(BENCH), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)
# Few threads in the test processes and in those they start (the
# recorder's passes): OpenMP's spinning workers, more than the cores under
# pytest-xdist, slow the tiny windows past their checked frames.
os.environ.setdefault("OMP_NUM_THREADS", "2")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _small_blocks(monkeypatch):
    """The reference's chunks sized for tiny images."""
    from reference import raster
    monkeypatch.setattr(raster, "PAIR_BUDGET", 1 << 18)


def tiny_cell(name: str, **size):
    """The cell `name` of BENCHMARK.json or `held_out.json` at a size the
    CPU runs (see `shrink`)."""
    from harness import spec
    return shrink(spec.load_cell(name, spec.with_held_out()), **size)


def shrink(cell, n: int = 2000, width: int = 64, height: int = 48,
           views: int = 6):
    """`cell` at a size the CPU runs: its own configuration, mix and
    limits, with fewer Gaussians, smaller images, fewer views and a
    shorter orbit."""
    c = copy.deepcopy(cell.config)
    c["n_gaussians"], c["n_train_views"] = n, views
    c["settings"]["image_width"] = width
    c["settings"]["image_height"] = height
    c["scene"]["spp"], c["scene"]["march_steps"] = 1, 32
    cell.config = c
    cell.traffic = dict(cell.traffic, warmup_chunk_s=0.02, orbit_frames=8,
                        trace_steps=2, trace_frames=2)
    return cell


SEED = 2 ** 31 + 4099  # larger than 32 signed bits hold
