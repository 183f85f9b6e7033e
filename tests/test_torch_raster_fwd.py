"""What the forward raster kernel's design rests on, checked on the CPU: its
blocks each work on a sub-tile and its warps each on a patch that together
partition the tile, a sub-tile's pixels come out of the plain version
exactly as the whole tile's, and skipping the instances that the per-patch
reject rule names changes no bit of the result (a model of the kernel's
schedule in plain PyTorch).  Also that the kernel library's name follows
its headers.

The kernel itself runs only on a card (tests/test_torch_cuda.py); these
tests import no JAX.
"""

import shutil

import pytest
import torch

import chip_smoke
from mini3dgs_tpu_torch import convert
from mini3dgs_tpu_torch.ops import binning as B
from mini3dgs_tpu_torch.ops import cuda_library as cl
from mini3dgs_tpu_torch.ops import raster_cuda as rc
from mini3dgs_tpu_torch.ops.projection import project_gaussians

LAUNCHES = [(16, 1), (32, 1), (32, 2)]  # (tile size, pixels a thread)


def _blocks(ts: int, pix: int) -> int:
    return ts * ts // (256 * pix)


def _patch_case(ts: int):
    """`chip_smoke.patch_stream` on 4 x 3 tiles with its `patch_t0`: slices
    of 0, 1, 63, 64, 65 and 257 instances, footprints that end exactly on a
    patch's edge, a tile (8) that arrives closed and one (7) with a single
    open quadrant."""
    stream, start, count = chip_smoke.patch_stream(ts, 4, 3, 400 + ts, "cpu")
    return (stream, start, count, 4, ts), \
        chip_smoke.patch_t0(ts, 12, 500 + ts, "cpu")


def _scene_case(ts: int):
    """The packed stream of a projected scene, 96 x 64 pixels."""
    params, alive, cam = convert.flagship_scene_numpy(2048, 1500, seed=3)
    g = convert.gaussians_from_numpy(params, alive, "cpu")
    camera = convert.camera_from_numpy(**cam, width=96, height=64,
                                       device="cpu")
    b, stream = rc.tile_stream(project_gaussians(g, camera), 64, 96, ts)
    return (stream, b.tile_start, b.tile_count, 96 // ts, ts), None


@pytest.mark.parametrize("ts,pix", LAUNCHES)
def test_warp_patches_and_sub_tiles_partition_the_tile(ts, pix):
    """The pixels the kernel's threads own (`thread_pixels`, its index
    arithmetic): every pixel of the tile exactly once over the tile's
    blocks, a block's pixels its sub-tile, a warp's pixels a rectangle of
    PATCH_W x LANE_ROWS * pix, a lane's pixels one column LANE_ROWS rows
    apart."""
    owned = []
    for q in range(_blocks(ts, pix)):
        pixels = rc.thread_pixels(ts, pix, q)
        assert pixels.shape == (8, 32, pix)
        assert torch.equal(pixels.reshape(-1).sort().values,
                           rc.sub_tile_pixels(ts, pix, q).sort().values)
        for warp in pixels:
            x, y = warp % ts, warp // ts
            rect = ((y.min() + torch.arange(rc.LANE_ROWS * pix))[:, None] * ts
                    + x.min() + torch.arange(rc.PATCH_W)[None, :])
            assert torch.equal(warp.reshape(-1).sort().values,
                               rect.reshape(-1).sort().values)
            assert bool((x == x[:, :1]).all())
            assert bool((torch.diff(y, dim=1) == rc.LANE_ROWS).all())
        owned.append(pixels.reshape(-1))
    assert torch.equal(torch.cat(owned).sort().values, torch.arange(ts * ts))


@pytest.mark.parametrize("with_t0", [False, True])
@pytest.mark.parametrize("ts,pix", LAUNCHES)
def test_plain_forward_of_the_sub_tiles_is_the_tile(ts, pix, with_t0):
    """`raster_fwd_plain(pixels=)` over each block's sub-tile, put back
    together, equals the whole tile bitwise; with t0 a closed tile adds
    exactly nothing and hands t0 on, and so do the closed sub-tiles of the
    tile with one open quadrant."""
    args, t0 = _patch_case(ts)
    t0 = t0 if with_t0 else None
    whole = rc.raster_fwd_plain(*args, t0=t0)
    parts = torch.full_like(whole, float("nan"))
    for q in range(_blocks(ts, pix)):
        pixels = rc.sub_tile_pixels(ts, pix, q)
        part = rc.raster_fwd_plain(*args, t0=t0, pixels=pixels)
        assert part.shape == (12, rc.N_ACC, pixels.numel())
        parts[:, :, pixels] = part
    assert torch.equal(parts, whole)
    assert bool((whole[:, 4] > 0).any())
    if with_t0:
        assert bool((whole[8, :5] == 0).all())
        assert torch.equal(whole[8, 5], t0[8, 0])
        i = torch.arange(ts * ts)
        closed = (i // ts >= ts // 2) | (i % ts < ts // 2)  # but top right
        assert bool((whole[7, :5][:, closed] == 0).all())
        assert bool((whole[7, 4][~closed] > 0).any())
    else:
        assert bool((whole[:, 5:] == 0).all())


def _kernel_model(stream, start, count, tiles_x, ts, pix, t0=None):
    """The forward kernel's schedule in plain PyTorch: each block on its
    own sub-tile, and in each warp's patch the alpha of every instance that
    `patch_missed` rejects for that patch forced to 0 (the kernel never
    computes those pairs).  Otherwise the arithmetic of `raster_fwd_plain`.
    Returns (accumulators [T, 8, P], pairs rejected, pairs in all)."""
    T, P = start.shape[0], ts * ts
    out = torch.zeros(T, rc.N_ACC, P)
    px_all, py_all = rc._pixel_coords(T, tiles_x, ts, "cpu")
    ox, oy = px_all[:, :1, None], py_all[:, :1, None]       # tile origins
    st, ct = start.long()[:, None], count.long()[:, None]
    lanes = torch.arange(64)[None, :]
    rejected = pairs = 0
    for q in range(_blocks(ts, pix)):
        owned = rc.thread_pixels(ts, pix, q)                # [8, 32, pix]
        pixels = owned.reshape(-1)
        x0 = (owned % ts).amin((1, 2)).float()[None, :, None]
        y0 = (owned // ts).amin((1, 2)).float()[None, :, None]
        warp_of = torch.arange(8).repeat_interleave(32 * pix)
        px, py = px_all[:, pixels], py_all[:, pixels]
        trans = torch.ones(T, pixels.numel()) if t0 is None \
            else t0[:, 0, pixels]
        acc = [torch.zeros(T, pixels.numel()) for _ in range(5)]
        for base in range(0, int(count.max()), 64):
            idx = (st + base + lanes).clamp(max=stream.shape[1] - 1)
            missed = rc.patch_missed(stream[:, idx][:, :, None, :], ox + x0,
                                     oy + y0, rc.PATCH_W,
                                     rc.LANE_ROWS * pix)    # [T, 8, G]
            m = rc._slice_terms(stream, st, ct, px, py, trans, base, lanes,
                                missed=missed[:, warp_of, :])
            valid = m["valid"][:, None, :]
            rejected += int((missed & valid).sum())
            pairs += int(valid.expand_as(missed).sum())
            for k, r in enumerate((B.ROW_R, B.ROW_G, B.ROW_B, B.ROW_DEPTH)):
                acc[k] = acc[k] + (m["wgt"] * m["row"](r)).sum(-1)
            acc[4] = acc[4] + m["wgt"].sum(-1)
            trans = m["trans"]
        out[:, :5, pixels] = torch.stack(acc, dim=1)
        if t0 is not None:
            out[:, 5, pixels] = trans
    return out, rejected, pairs


@pytest.mark.parametrize("case", ["patch", "scene"])
@pytest.mark.parametrize("ts,pix", LAUNCHES)
def test_the_reject_changes_no_bit_of_the_forward(ts, pix, case):
    """The model of the kernel's schedule, which never computes a pair the
    per-patch rule rejects, equals `raster_fwd_plain` bitwise: on the patch
    streams (with t0, footprints ending on a patch's edge) and on a packed
    scene stream.  And the rule does reject a fair share of the pairs."""
    args, t0 = _patch_case(ts) if case == "patch" else _scene_case(ts)
    got, rejected, pairs = _kernel_model(*args, pix, t0=t0)
    want = rc.raster_fwd_plain(*args, t0=t0)
    assert torch.equal(got, want)
    assert bool((want[:, 4] > 0).any())
    assert pairs > 1000 and rejected > 0.1 * pairs


def test_library_name_follows_the_headers(tmp_path):
    """`library_path` hashes the headers beside the sources, so an edit to
    `raster_common.cuh` names a new library (and builds nothing); only the
    `.cu` files are compiled."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cl.CSRC_DIR, csrc)
    first = cl.library_path(csrc)
    assert first == cl.library_path() and first.parent == cl.BUILD_DIR
    assert [p.name for p in cl.kernel_sources(csrc)] == [
        "project_bwd.cu", "project_fwd.cu", "raster_bwd.cu", "raster_fwd.cu"]
    header = csrc / "raster_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    second = cl.library_path(csrc)
    assert second != first
    source = csrc / "raster_fwd.cu"
    source.write_text(source.read_text() + "\n")
    assert cl.library_path(csrc) not in (first, second)
    assert not second.exists()
