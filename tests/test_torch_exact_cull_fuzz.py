"""Randomized fuzz of the port's exact ellipse-vs-tile cull
(`mini3dgs_tpu_torch/ops/binning._exact_tile_keep`, with its one-pixel
`_EXACT_MARGIN`), the twin of tests/test_exact_cull_fuzz.py.

The cull's safety property: a candidate tile it removes holds NO pixel
whose weight, as the port's raster computes it, reaches the skip cutoff
(w >= W_EPS = 1e-5); otherwise binning with the cull would change the
image.  The weight is the port's own float32 formula
(`ops/raster_cuda._slice_terms`, which the CUDA kernels compute too): the
stream's pre-scaled conic rows (`instance_attrs`: -qa/2, -qb, -qc/2),
lw = dx*dx*QA + dx*dy*QB + dy*dy*QC, w = min(exp(lw), 1), at every pixel of
every culled tile, for 10,000 seeded random conics over the JAX fuzz's
conditioning sweep (`_random_conics`: sigma 0.3-60 px, eccentricity to
1e3, random rotation, the projection's 1e-6 stabilizer).
"""

import numpy as np
import pytest
import torch

from mini3dgs_tpu_torch.ops.binning import _exact_tile_keep
from mini3dgs_tpu_torch.ops.raster_ref import W_EPS
from tests.test_exact_cull_fuzz import (N_BATCHES, N_PER_BATCH, TILE, TILES,
                                        _random_conics)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread while this module runs: the test run's other
    workers need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conics(seed: int, n: int):
    return [torch.from_numpy(a) for a in _random_conics(
        np.random.default_rng(seed), n)]


def _keep(mx, my, qa, qb, qc) -> torch.Tensor:
    """[n, T, T]: the cull's verdict on every tile of the 8x8 grid."""
    ty, tx = torch.meshgrid(torch.arange(TILES), torch.arange(TILES),
                            indexing="ij")
    ex = tuple(v[:, None, None] for v in (mx, my, qa, qb, qc))
    return _exact_tile_keep(tx[None], ty[None], ex, TILE)


def _w_max_per_tile(mx, my, qa, qb, qc) -> torch.Tensor:
    """[n, T, T]: the largest weight over each tile's pixels, in the
    port's float32 arithmetic."""
    n = mx.shape[0]
    px = torch.arange(TILES * TILE, dtype=torch.float32)
    dx = (px[None, :] - mx[:, None])[:, None, :]        # [n, 1, W]
    dy = (px[None, :] - my[:, None])[:, :, None]        # [n, H, 1]
    QA, QB, QC = (v[:, None, None] for v in (-0.5 * qa, -qb, -0.5 * qc))
    lw = dx * dx * QA + dx * dy * QB + dy * dy * QC     # [n, H, W]
    w = torch.clamp(torch.exp(lw), max=1.0)
    return w.reshape(n, TILES, TILE, TILES, TILE).amax(dim=(2, 4))


@pytest.mark.parametrize("batch", range(N_BATCHES))
def test_exact_cull_never_removes_live_tiles(batch):
    conics = _conics(100 + batch, N_PER_BATCH)
    live_culled = ~_keep(*conics) & (_w_max_per_tile(*conics) >= W_EPS)
    if bool(live_culled.any()):
        i, a, b = (int(v) for v in torch.nonzero(live_culled)[0])
        mx, my, qa, qb, qc = (float(v[i]) for v in conics)
        raise AssertionError(
            f"conic #{i} (qa={qa:.6g}, qb={qb:.6g}, qc={qc:.6g}, mean="
            f"({mx:.3f}, {my:.3f})): tile ({a}, {b}) culled but holds "
            f"w = {float(_w_max_per_tile(*conics)[i, a, b]):.3e} >= "
            f"{W_EPS}: the one-pixel margin is too thin here")


def test_exact_cull_margin_is_not_vacuous():
    """The cull removes a real share of the candidate tiles of this sweep
    (a cull that kept every tile would pass the fuzz trivially)."""
    assert float(_keep(*_conics(7, 500)).float().mean()) < 0.9
