"""The CUDA raster kernels against their plain PyTorch versions, on the
card.

Marked `cuda`: these tests skip on a host without a CUDA device (a CUDA
kernel has no CPU mode).  This file imports no JAX, so on a GPU host that
has no JAX it runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mini3dgs_tpu_torch.ops import raster_cuda as rc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _stream(tile_size, tiles_x, tiles_y, device, seed=0):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 600, tiles_x * tiles_y)
    counts[:4] = [0, 1, 256, 257]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    n = int(counts.sum())
    tile = np.repeat(np.arange(len(counts)), counts)
    s = np.zeros((10, n), np.float32)
    s[0] = (tile % tiles_x) * tile_size + rng.uniform(-4, tile_size + 4, n)
    s[1] = (tile // tiles_x) * tile_size + rng.uniform(-4, tile_size + 4, n)
    s[2] = s[4] = -0.5 / rng.uniform(1.0, tile_size, n) ** 2
    s[5] = rng.uniform(0.05, 1.0, n)
    s[6:] = rng.random((4, n))
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return (as_t(s, torch.float32), as_t(starts, torch.int32),
            as_t(counts, torch.int32))


@pytest.mark.parametrize("tile_size", rc.KERNEL_TILE_SIZES)
def test_kernel_matches_plain_on_card(cuda, tile_size):
    args = (*_stream(tile_size, 9, 7, cuda), 9, tile_size)
    before = rc.raster_fwd.launches
    got = rc.raster_fwd(*args)
    assert rc.raster_fwd.launches == before + 1
    want = rc.raster_fwd_plain(*args)
    torch.cuda.synchronize()
    d = (got - want).abs()
    # isolated early-stop flips move a pixel by at most 5e-3 (see PERF.md)
    assert float(d.max()) < 5.5e-3 and float(d.mean()) < 2e-5
    assert bool((got[:, 5:] == 0).all())


def _normalised_row_error(got, want):
    scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1e-20)
    return float(((got - want).abs() / scale).max())


@pytest.mark.parametrize("tile_size", rc.KERNEL_TILE_SIZES)
def test_backward_kernel_matches_plain_on_card(cuda, tile_size):
    """Each of the 10 gradient rows within 1e-3 of the plain row's largest
    entry (float32 sums over a tile's pixels in another order; S_j is a
    difference of nearly equal sums), two launches bitwise equal, and the
    launch counted."""
    stream, start, count = _stream(tile_size, 9, 7, cuda)
    args = (stream, start, count, 9, tile_size)
    acc = rc.raster_fwd(*args)
    gen = torch.Generator(device=cuda).manual_seed(1)
    gout = torch.zeros_like(acc)
    gout[:, :5] = torch.randn(acc[:, :5].shape, generator=gen, device=cuda)
    before = rc.raster_bwd.launches
    got = rc.raster_bwd(*args, acc, gout)
    again = rc.raster_bwd(*args, acc, gout)
    assert rc.raster_bwd.launches == before + 2
    want = rc.raster_bwd_plain(*args, acc, gout)
    torch.cuda.synchronize()
    assert got.shape == stream.shape and bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    assert _normalised_row_error(got, want) < 1e-3


def test_kernel_pair_differentiates_a_stream_on_card(cuda):
    """`raster_op` on a stream that requires grad launches both kernels, and
    the gradient equals the plain backward's; other tile sizes are refused."""
    s, start, count = _stream(16, 4, 4, cuda)
    leaf = s.clone().requires_grad_(True)
    fwd, bwd = rc.raster_fwd.launches, rc.raster_bwd.launches
    acc = rc.raster_op(leaf, start, count, 4, 16)
    weights = torch.linspace(0.5, 1.5, acc[:, :5].numel(),
                             device=cuda).reshape(acc[:, :5].shape)
    (acc[:, :5] * weights).sum().backward()
    assert (rc.raster_fwd.launches, rc.raster_bwd.launches) == (fwd + 1,
                                                                bwd + 1)
    gout = torch.zeros_like(acc)
    gout[:, :5] = weights
    want = rc.raster_bwd_plain(s, start, count, 4, 16, acc.detach(), gout)
    assert _normalised_row_error(leaf.grad, want) < 1e-3
    with pytest.raises(ValueError, match="tile sizes"):
        rc.raster_fwd(s, start, count, 4, 8)
