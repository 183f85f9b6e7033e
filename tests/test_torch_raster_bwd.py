"""What the backward raster kernel's design rests on, checked on the CPU:
the rule by which a warp rejects an instance before any lane computes, the
decomposition of a tile into sub-tiles whose partial rows are added in a
fixed order, and the transposed butterfly that reduces the ten rows of an
instance over a warp's lanes (a model of it in numpy).

The kernel itself runs only on a card (tests/test_torch_cuda.py); these
tests import no JAX.
"""

import numpy as np
import pytest
import torch

from mini3dgs_tpu_torch.ops import binning as B
from mini3dgs_tpu_torch.ops import raster_cuda as rc
from mini3dgs_tpu_torch.ops.raster_ref import W_EPS


def _conics(kind: str, n: int, rng) -> np.ndarray:
    """[3, n] pre-scaled conic rows (qa, qb, qc) of one family."""
    if kind in ("random", "anisotropic", "tiny"):
        lo, hi = {"random": (0.7, 16.0), "anisotropic": (0.3, 60.0),
                  "tiny": (0.05, 0.5)}[kind]
        sig = np.exp(rng.uniform(np.log(lo), np.log(hi), (2, n)))
        rho = rng.uniform(-0.7, 0.7, n) if kind != "anisotropic" \
            else rng.choice([-1.0, 1.0], n) * rng.uniform(0.9, 0.9999, n)
        det = (1 - rho ** 2) * sig[0] ** 2 * sig[1] ** 2
        return np.stack([-0.5 * sig[1] ** 2 / det,
                         rho * sig[0] * sig[1] / det,
                         -0.5 * sig[0] ** 2 / det])
    if kind == "huge":  # the saturating splats of chip_smoke.py's streams
        q = np.full((3, n), -1e-4)
        q[1] = rng.uniform(-1.5e-4, 1.5e-4, n)
        return q
    if kind == "degenerate":
        # Six forms that are not positive definite (flat directions, zero,
        # of the wrong sign, indefinite), then four extreme ones that are.
        base = np.array([[-0.1, 0.2, -0.1], [-0.1, 0.0, 0.0],
                         [0.0, 0.0, -0.1], [0.0, 0.0, 0.0],
                         [0.01, 0.0, 0.01], [-0.1, 0.3, -0.1],
                         [-1e-30, 0.0, -1e-30], [-1e20, 0.0, -1e20],
                         [-0.5, 0.99999, -0.5], [-1e-3, 0.0, -50.0]]).T
        return np.tile(base, (1, -(-n // base.shape[1])))[:, :n]
    assert kind == "non-finite"
    q = _conics("random", n, rng)
    bad = np.array([np.nan, np.inf, -np.inf])
    for k in range(n):
        q[k % 3, k] = bad[(k // 3) % 3]
    return q


def _patch_pixels(x0, y0, w, h):
    """[T, w * h] pixel coordinates of the patches at (x0[t], y0[t])."""
    i = torch.arange(w * h)
    return (x0[:, None] + (i % w)[None, :]).float(), \
        (y0[:, None] + (i // w)[None, :]).float()


@pytest.mark.parametrize("height", [4, 8])
@pytest.mark.parametrize("kind", ["random", "anisotropic", "huge", "tiny",
                                  "degenerate", "non-finite"])
def test_no_live_pair_lies_in_a_missed_patch(kind, height):
    """No pixel of a patch that `patch_missed` rejects has w >= 1e-5, w as
    `_slice_terms` computes it in float32: a warp loses nothing by skipping
    the instance.  Patches of 8 x 4 (one pixel a thread) and 8 x 8 (two)."""
    rng = np.random.default_rng(len(kind) + height)
    n, n_patches, width = 60, 500, 8
    s = np.zeros((B.STREAM_ROWS, n), np.float32)
    reach = {"huge": 700, "anisotropic": 260, "tiny": 6}.get(kind, 90)
    s[B.ROW_X] = rng.uniform(-0.5, 0.5, n) * 8 + reach
    s[B.ROW_Y] = rng.uniform(-0.5, 0.5, n) * 8 + reach
    s[B.ROW_QA:B.ROW_QC + 1] = _conics(kind, n, rng)
    s[B.ROW_OP] = 0.5
    stream = torch.as_tensor(s)
    x0 = torch.as_tensor(rng.integers(0, 2 * reach, n_patches))
    y0 = torch.as_tensor(rng.integers(0, 2 * reach, n_patches))
    px, py = _patch_pixels(x0, y0, width, height)
    m = rc._slice_terms(stream, torch.zeros(n_patches, 1, dtype=torch.long),
                        torch.full((n_patches, 1), n), px, py,
                        torch.ones(n_patches, width * height), 0,
                        torch.arange(n)[None, :])
    live = (torch.nan_to_num(m["w"], nan=1.0) >= W_EPS).any(dim=1)  # [T, n]
    missed = rc.patch_missed(stream, x0[:, None], y0[:, None], width, height)
    assert missed.shape == (n_patches, n) and missed.dtype == torch.bool
    assert not bool((live & missed).any())
    if kind in ("random", "huge"):
        # The rule is tight where the conic is well conditioned: of the
        # patches without a live pixel it rejects nearly all.
        dead = ~live
        assert int(dead.sum()) > 1000
        assert int((missed & dead).sum()) > 0.9 * int(dead.sum())
    if kind == "non-finite":
        assert not bool(missed.any())
    if kind == "degenerate":
        # The first six of every ten are not positive definite.
        assert not bool(missed[:, torch.arange(n) % 10 < 6].any())


def test_reject_rule_on_a_packed_scene_stream():
    """On the stream of a projected scene no live pair of any tile lies in
    a patch the rule rejects, and the rule does reject: a fair share of the
    patch x instance pairs of the tiles' lists are misses."""
    from mini3dgs_tpu_torch import convert
    from mini3dgs_tpu_torch.ops.projection import project_gaussians
    params, alive, cam = convert.flagship_scene_numpy(2048, 1500, seed=3)
    g = convert.gaussians_from_numpy(params, alive, "cpu")
    camera = convert.camera_from_numpy(**cam, width=96, height=64,
                                       device="cpu")
    ts, tiles_x, w, h = 32, 3, 8, 8
    b, stream = rc.tile_stream(project_gaussians(g, camera), 64, 96, ts)
    T = b.tile_start.shape[0]
    px, py = rc._pixel_coords(T, tiles_x, ts, stream.device)
    # The patch of every pixel of a tile, and the patches' origins.
    i = torch.arange(ts * ts)
    patch_of = (i // ts // h) * (ts // w) + i % ts // w          # [P]
    n_patch = (ts // w) * (ts // h)
    first = torch.stack([(patch_of == k).nonzero()[0, 0]
                         for k in range(n_patch)])
    lanes = torch.arange(64)[None, :]
    start, count = b.tile_start.long()[:, None], b.tile_count.long()[:, None]
    n_live = n_missed = n_pairs = 0
    for base in range(0, int(b.tile_count.max()), 64):
        m = rc._slice_terms(stream, start, count, px, py,
                            torch.ones(T, ts * ts), base, lanes)
        missed = rc.patch_missed(
            stream[:, m["idx"]][:, :, None, :], px[:, first][:, :, None],
            py[:, first][:, :, None], w, h)                # [T, patches, G]
        assert not bool((m["live"] & missed[:, patch_of, :]).any())
        n_live += int(m["live"].sum())
        n_missed += int((missed & m["valid"][:, None, :]).sum())
        n_pairs += int(m["valid"].sum()) * n_patch
    assert n_live > 1000 and n_missed > 0.2 * n_pairs


def _tile_case(ts, with_t0, seed=0):
    rng = np.random.default_rng(seed)
    tiles_x, tiles_y = 3, 2
    counts = rng.integers(0, 90, tiles_x * tiles_y)
    counts[:3] = [0, 1, 70]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    n = int(counts.sum())
    tile = np.repeat(np.arange(len(counts)), counts)
    s = np.zeros((B.STREAM_ROWS, n), np.float32)
    s[0] = (tile % tiles_x) * ts + rng.uniform(-4, ts + 4, n)
    s[1] = (tile // tiles_x) * ts + rng.uniform(-4, ts + 4, n)
    sig = rng.uniform(1.0, 0.4 * ts, (2, n))
    rho = rng.uniform(-0.6, 0.6, n)
    det = (1 - rho ** 2) * sig[0] ** 2 * sig[1] ** 2
    s[2] = -0.5 * sig[1] ** 2 / det
    s[3] = rho * sig[0] * sig[1] / det
    s[4] = -0.5 * sig[0] ** 2 / det
    s[5] = rng.uniform(0.05, 0.99, n)
    s[6:] = rng.random((4, n))
    args = (torch.as_tensor(s), torch.as_tensor(starts, dtype=torch.int32),
            torch.as_tensor(counts, dtype=torch.int32), tiles_x, ts)
    T, P = len(counts), ts * ts
    t0 = None
    if with_t0:
        t0 = rng.uniform(0.006, 1.0, (T, 1, P))
        t0[rng.random((T, 1, P)) < 0.1] = 0.002
        # Three quadrants of tile 4 arrive closed, one open.
        closed = np.concatenate([rc.sub_tile_pixels(ts, 1, q).numpy()
                                 for q in (0, 1, 3)])
        t0[4, 0, closed] = 0.001
        t0 = torch.as_tensor(t0, dtype=torch.float32)
    acc = rc.raster_fwd_plain(*args, t0=t0)
    gout = torch.zeros_like(acc)
    rows = 6 if with_t0 else 5
    gout[:, :rows] = torch.as_tensor(rng.normal(size=(T, rows, P)),
                                     dtype=torch.float32)
    return args, acc, gout, t0


@pytest.mark.parametrize("pix", [1, 2])
@pytest.mark.parametrize("with_t0", [False, True])
def test_sub_tile_partials_add_up_to_the_tile(with_t0, pix):
    """The plain backward over each sub-tile's pixels (four quadrants at one
    pixel a thread, two halves at two), the partial rows added in the
    kernel's order q = 0, 1, ..., equals the plain backward over the whole
    tile (rtol 1e-6 of a row's largest entry: a float32 sum in another
    order), and each sub-tile's d_t0 is the tile's on its pixels."""
    ts = 32
    args, acc, gout, t0 = _tile_case(ts, with_t0)
    whole = rc.raster_bwd_plain(*args, acc, gout, t0=t0)
    total = torch.zeros_like(args[0])
    for q in range(4 // pix):
        pixels = rc.sub_tile_pixels(ts, pix, q)
        part = rc.raster_bwd_plain(*args, acc, gout, t0=t0, pixels=pixels)
        if with_t0:
            part, part_t0 = part
            assert torch.equal(part_t0, whole[1][:, :, pixels])
        total = total + part
    want = whole[0] if with_t0 else whole
    scale = want.abs().amax(dim=1, keepdim=True)
    assert float(((total - want).abs() / scale).max()) < 1e-6
    assert bool((want != 0).any())
    if with_t0 and pix == 1:
        # Tile 4's closed quadrants give exactly nothing.
        cols = slice(int(args[1][4]), int(args[1][4]) + int(args[2][4]))
        for q in (0, 1, 3):
            part, _ = rc.raster_bwd_plain(
                *args, acc, gout, t0=t0, pixels=rc.sub_tile_pixels(ts, 1, q))
            assert bool((part[:, cols] == 0).all())


@pytest.mark.parametrize("tile_size,pix", [(16, 1), (32, 1), (32, 2)])
def test_sub_tiles_tile_the_tile(tile_size, pix):
    n = tile_size ** 2 // (rc.SUB_TILE ** 2 * pix)
    parts = [rc.sub_tile_pixels(tile_size, pix, q) for q in range(n)]
    assert all(p.numel() == 256 * pix for p in parts)
    assert torch.equal(torch.cat(parts).sort().values,
                       torch.arange(tile_size ** 2))
    # The last sub-tile starts in the last sub-tile column and row.
    col = tile_size - rc.SUB_TILE
    row = tile_size - rc.SUB_TILE * pix
    assert int(parts[-1][0]) == row * tile_size + col


def _butterfly(d: np.ndarray) -> np.ndarray:
    """Model of the kernel's `reduce_rows`: d [32 lanes, 10 rows] -> the
    value each lane ends with.  At the steps xor 16, 8, 4, 2 a lane keeps
    one half of what it holds (the upper half if its bit is set), adds the
    partner's copy of that half and hands the other half over; the step xor
    1 adds the last pair."""
    lanes = np.arange(32)
    held = d.astype(np.float32)
    for bit, width in ((16, 5), (8, 3), (4, 2), (2, 1)):
        pad = np.zeros((32, 2 * width), np.float32)
        pad[:, :held.shape[1]] = held
        upper = (lanes & bit) != 0
        keep = np.where(upper[:, None], pad[:, width:], pad[:, :width])
        send = np.where(upper[:, None], pad[:, :width], pad[:, width:])
        held = keep + send[lanes ^ bit]
    v = held[:, 0]
    return v + v[lanes ^ 1]


def test_transposed_butterfly_reduces_every_row():
    """Even lane l ends with the sum over all lanes of row
    5*b4 + 3*b3 + 2*b2 + b1, unless b2 and (b1 or b3), where it holds
    padding; every row lands on exactly one even lane."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(32, 10)).astype(np.float32)
    got = _butterfly(d)
    want = d.astype(np.float64).sum(0)
    seen = []
    for lane in range(0, 32, 2):
        b4, b3, b2, b1 = (lane >> 4) & 1, (lane >> 3) & 1, (lane >> 2) & 1, \
            (lane >> 1) & 1
        if b2 and (b1 or b3):
            assert got[lane] == 0.0
            continue
        row = 5 * b4 + 3 * b3 + 2 * b2 + b1
        seen.append(row)
        assert abs(got[lane] - want[row]) < 1e-5
        assert got[lane] == got[lane + 1]
    assert sorted(seen) == list(range(10))
