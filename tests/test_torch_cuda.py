"""The CUDA kernels against their plain PyTorch versions, on the card:
the raster kernels B1-B4 and the projection kernels P1 and P2.

Marked `cuda`: these tests skip on a host without a CUDA device (a CUDA
kernel has no CPU mode).  This file imports no JAX, so on a GPU host that
has no JAX it runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mini3dgs_tpu_torch.core.camera import Camera
from mini3dgs_tpu_torch.core.gaussians import Gaussians
from mini3dgs_tpu_torch.ops import projection as pj
from mini3dgs_tpu_torch.ops import raster_cuda as rc
from mini3dgs_tpu_torch.ops.cuda_library import LAUNCHES

pytestmark = pytest.mark.cuda
FWD, BWD = "raster_fwd.launches", "raster_bwd.launches"
FWD_T0, BWD_T0 = "raster_fwd.launches_t0", "raster_bwd.launches_t0"
P1, P2 = "project_fwd.launches", "project_bwd.launches"


def _launched(*totals) -> tuple:
    """The running launch totals named (cuda_library.LAUNCHES)."""
    return tuple(LAUNCHES[t] for t in totals)


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
    before = _launched(FWD)
    got = rc.raster_fwd(*args)
    assert _launched(FWD) == (before[0] + 1,)
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
    before = _launched(BWD)
    got = rc.raster_bwd(*args, acc, gout)
    again = rc.raster_bwd(*args, acc, gout)
    assert _launched(BWD) == (before[0] + 2,)
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
    fwd, bwd = _launched(FWD, BWD)
    acc = rc.raster_op(leaf, start, count, 4, 16)
    weights = torch.linspace(0.5, 1.5, acc[:, :5].numel(),
                             device=cuda).reshape(acc[:, :5].shape)
    (acc[:, :5] * weights).sum().backward()
    assert _launched(FWD, BWD) == (fwd + 1, bwd + 1)
    gout = torch.zeros_like(acc)
    gout[:, :5] = weights
    want = rc.raster_bwd_plain(s, start, count, 4, 16, acc.detach(), gout)
    assert _normalised_row_error(leaf.grad, want) < 1e-3
    with pytest.raises(ValueError, match="tile sizes"):
        rc.raster_fwd(s, start, count, 4, 8)


def _t0(T, P, device, seed=2):
    """A seeded incoming transmittance [T, 1, P]: a tenth of the pixels and
    the whole of tile 1 arrive closed (<= 0.005), tile 2 arrives at 1."""
    rng = np.random.default_rng(seed)
    t0 = rng.uniform(0.006, 1.0, (T, 1, P))
    some = rng.random((T, 1, P)) < 0.1
    t0[some] = rng.uniform(0.0, 0.005, int(some.sum()))
    t0[1] = rng.uniform(0.0, 0.005, (1, P))
    t0[2] = 1.0
    return torch.as_tensor(t0, dtype=torch.float32, device=device)


@pytest.mark.parametrize("tile_size", rc.KERNEL_TILE_SIZES)
def test_t0_kernels_match_plain_on_card(cuda, tile_size):
    """The builds with t0 on a band (`tile0` > 0): accumulators and the
    outgoing transmittance as the build without (max 5.5e-3 for an isolated
    early-stop flip, mean 2e-5), the ten gradient rows and d_t0 within 1e-3
    of the plain row's largest entry, two launches bitwise equal, a closed
    tile untouched, and the launches counted under `launches_t0` only."""
    stream, start, count = _stream(tile_size, 9, 7, cuda)
    tile0, T = 2 * 9, 5 * 9
    args = (stream, start[tile0:].contiguous(), count[tile0:].contiguous(), 9,
            tile_size)
    t0 = _t0(T, tile_size * tile_size, cuda)
    before = _launched(FWD, BWD, FWD_T0, BWD_T0)
    acc = rc.raster_fwd(*args, t0=t0, tile0=tile0)
    want = rc.raster_fwd_plain(*args, t0=t0, tile0=tile0)
    torch.cuda.synchronize()
    d = (acc - want).abs()
    assert float(d.max()) < 5.5e-3 and float(d.mean()) < 2e-5
    assert bool((acc[:, 6:] == 0).all()) and bool((acc[1, :5] == 0).all())
    assert torch.equal(acc[1, 5:6], t0[1])
    gen = torch.Generator(device=cuda).manual_seed(1)
    gout = torch.zeros_like(acc)
    gout[:, :6] = torch.randn(acc[:, :6].shape, generator=gen, device=cuda)
    got, got_t0 = rc.raster_bwd(*args, acc, gout, t0=t0, tile0=tile0)
    again, again_t0 = rc.raster_bwd(*args, acc, gout, t0=t0, tile0=tile0)
    want, want_t0 = rc.raster_bwd_plain(*args, acc, gout, t0=t0, tile0=tile0)
    torch.cuda.synchronize()
    assert _launched(FWD, BWD, FWD_T0, BWD_T0) == (
        before[0], before[1], before[2] + 1, before[3] + 2)
    assert torch.equal(got, again) and torch.equal(got_t0, again_t0)
    assert bool(torch.isfinite(got).all() & torch.isfinite(got_t0).all())
    assert _normalised_row_error(got, want) < 1e-3
    assert _normalised_row_error(got_t0.reshape(1, -1),
                                 want_t0.reshape(1, -1)) < 1e-3
    closed = slice(int(args[1][1]), int(args[1][1]) + int(args[2][1]))
    assert bool((got[:, closed] == 0).all()) and closed.stop > closed.start


def test_raster_op_with_t0_differentiates_on_card(cuda):
    """`raster_op` with a t0 that requires grad launches both builds with t0
    under `torch.autograd.grad`, and both gradients equal the plain
    backward's."""
    s, start, count = _stream(16, 4, 4, cuda)
    leaf = s.clone().requires_grad_(True)
    t0 = _t0(16, 256, cuda).requires_grad_(True)
    fwd, bwd = _launched(FWD_T0, BWD_T0)
    acc = rc.raster_op(leaf, start, count, 4, 16, t0=t0)
    weights = torch.linspace(0.5, 1.5, acc[:, :6].numel(),
                             device=cuda).reshape(acc[:, :6].shape)
    d_s, d_t0 = torch.autograd.grad((acc[:, :6] * weights).sum(), [leaf, t0])
    assert _launched(FWD_T0, BWD_T0) == (fwd + 1, bwd + 1)
    gout = torch.zeros_like(acc)
    gout[:, :6] = weights
    want, want_t0 = rc.raster_bwd_plain(s, start, count, 4, 16, acc.detach(),
                                        gout, t0=t0.detach())
    assert _normalised_row_error(d_s, want) < 1e-3
    assert _normalised_row_error(d_t0.reshape(1, -1),
                                 want_t0.reshape(1, -1)) < 1e-3


def test_without_t0_the_unchanged_kernels_launch_on_card(cuda):
    """`t0=None` launches the builds without t0 (counted under `launches`,
    pad rows 5..7 zero), and a t0 of ones gives bit for bit their
    accumulators and gradients."""
    s, start, count = _stream(32, 5, 4, cuda)
    args = (s, start, count, 5, 32)
    before = _launched(FWD, BWD, FWD_T0, BWD_T0)
    acc = rc.raster_fwd(*args)
    gout = torch.zeros_like(acc)
    gout[:, :5] = 1.0
    d = rc.raster_bwd(*args, acc, gout)
    assert _launched(FWD, BWD, FWD_T0, BWD_T0) == (
        before[0] + 1, before[1] + 1, before[2], before[3])
    assert bool((acc[:, 5:] == 0).all())
    ones = torch.ones(20, 1, 1024, device=cuda)
    acc1 = rc.raster_fwd(*args, t0=ones)
    d1, _ = rc.raster_bwd(*args, acc1, gout, t0=ones)
    assert torch.equal(acc1[:, :5], acc[:, :5]) and torch.equal(d1, d)


@pytest.mark.parametrize("with_t0", [False, True])
@pytest.mark.parametrize("tile_size", rc.KERNEL_TILE_SIZES)
def test_backward_kernel_patch_cases_on_card(cuda, tile_size, with_t0):
    """The streams of `chip_smoke.patch_stream`, made for the backward
    kernel's staging and its per-patch reject: slices of 0, 1, 64 and 65
    instances, footprints that end exactly on a patch's edge, a splat that
    covers the whole tile, w == 1 with op * w >= 1 and, with t0, a tile
    with three quadrants closed and one open and a tile that arrives closed.
    Rows and d_t0 against the plain version within chip_smoke.py's
    `gate_rows`, two launches bitwise equal, exact zeros for the closed
    tile."""
    import chip_smoke
    before = _launched(BWD, BWD_T0)
    chip_smoke.check_patch_cases(rc, tile_size, cuda, with_t0)
    assert _launched(BWD, BWD_T0) == (
        before[0] + 2 * (not with_t0), before[1] + 2 * with_t0)


@pytest.mark.parametrize("launch", ["band", "image"])
@pytest.mark.parametrize("with_t0", [False, True])
@pytest.mark.parametrize("tile_size", rc.KERNEL_TILE_SIZES)
def test_forward_kernel_patch_cases_on_card(cuda, tile_size, with_t0,
                                            launch):
    """The forward kernel on the streams of `chip_smoke.patch_stream`:
    slices of 0, 1, 63, 64, 65 and 257 instances, footprints that end
    exactly on a patch's edge, a splat that covers the whole tile, w == 1
    with op * w >= 1 and, with t0, a tile with one open quadrant and a tile
    that arrives closed (its accumulators exactly 0, T_end = t0).  Against
    the plain version within chip_smoke.py's `gate_acc`, two launches
    bitwise equal; a launch of fewer tiles than the card has SMs ("band")
    and one of more ("image")."""
    import chip_smoke
    rows = chip_smoke.patch_tile_rows(cuda)[launch == "image"]
    before = _launched(FWD, FWD_T0)
    chip_smoke.check_fwd_patch_cases(rc, tile_size, cuda, with_t0, rows)
    assert _launched(FWD, FWD_T0) == (
        before[0] + 2 * (not with_t0), before[1] + 2 * with_t0)


def _projection_scene(device, seed=0):
    """A pool of 3,501 slots (the last block of 128 ragged) and a tilted
    160 x 120 camera, with rows that reach every branch of the projection:
    dead slots, points behind the camera, points at 0 < Z <= 1e-6 on the
    optical axis, centres far off the image, radii at both clamps (log
    scales of -14 and +2), near-degenerate scales (one axis at -20; all
    three at -25, where |det| < 1e-12), and quaternions of every norm,
    zero included."""
    rng = np.random.default_rng(seed)
    a = 0.3
    R = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                  [-np.sin(a), 0.0, np.cos(a)]])
    centre = np.array([0.4, -0.2, -4.0])
    right, up, fwd = R[:, 0], R[:, 1], R[:, 2]

    def at(depth, lateral):
        return centre + depth[:, None] * fwd + lateral[:, :1] * right \
            + lateral[:, 1:] * up

    bulk = rng.uniform(0.5, 8.0, 3000)
    behind = rng.uniform(-5.0, -0.01, 200)
    near = np.linspace(1e-7, 1e-6, 64)
    off = rng.uniform(1.0, 8.0, 237)
    xyz = np.concatenate([
        at(bulk, rng.uniform(-1.2, 1.2, (3000, 2)) * bulk[:, None]),
        at(behind, rng.uniform(-2.0, 2.0, (200, 2))),
        at(near, np.zeros((64, 2))),
        at(off, rng.uniform(5.0, 50.0, (237, 2)) * off[:, None]
           * rng.choice([-1.0, 1.0], (237, 2)))]).astype(np.float32)
    n = xyz.shape[0]
    scaling = rng.normal(-3.0, 1.0, (n, 3))
    rows = rng.permutation(n)
    scaling[rows[:100]] = -14.0
    scaling[rows[100:200]] = 2.0
    scaling[rows[200:300], 0] = -20.0
    scaling[rows[300:320]] = -25.0
    rotation = rng.normal(0.0, 1.0, (n, 4))
    rotation[rows[320:400]] *= 1e3
    rotation[rows[400:480]] *= 1e-3
    rotation[rows[480:490]] = 0.0
    f32 = dict(dtype=torch.float32, device=device)
    as_t = lambda v: torch.as_tensor(np.asarray(v, np.float32), **f32)
    g = Gaussians(
        xyz=as_t(xyz), features_dc=as_t(rng.uniform(-0.5, 0.5, (n, 1, 3))),
        features_rest=as_t(rng.normal(0.0, 0.05, (n, 15, 3))),
        scaling=as_t(scaling), rotation=as_t(rotation),
        opacity=as_t(rng.normal(0.0, 2.0, (n, 1))),
        alive=torch.as_tensor(rng.random(n) > 0.1, device=device))
    camera = Camera.create(0, R, centre, 0.9, 0.7, 160, 120, device=device)
    return g, camera


def _assert_projection_matches(got, want, rotation):
    """chip_smoke.py's `gate_projection`: every field at the chain's dtype,
    shape and strides; `visible`, `depth`, `radius` and both extents
    bitwise; every other field within 1e-6 relative (the SH colour reads
    the camera centre, which the chain takes from a cuBLAS product whose
    order of sums the kernel cannot see).  The bitwise fields follow from
    the quaternion norm, whose order of sums the kernel copies from this
    torch's reduce kernel: under a torch that sums it in another order the
    gate holds radius and extents within 1e-6 relative and warns."""
    import chip_smoke
    chip_smoke.gate_projection(got, want, rotation, "P1")


@pytest.mark.parametrize("options", ["default", "other"])
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("color_mode,sh_degree", [
    ("dc_sigmoid", 0), ("sh", 0), ("sh", 1), ("sh", 2), ("sh", 3)])
def test_projection_kernel_matches_plain_on_card(cuda, color_mode,
                                                 sh_degree, antialias,
                                                 options):
    """One launch of `project_fwd` (through `project_gaussians`, under
    no_grad) against the plain chain on the same card."""
    g, camera = _projection_scene(cuda)
    kw = dict(color_mode=color_mode, sh_degree=sh_degree,
              antialias=antialias)
    if options == "other":
        kw.update(scale_modifier=1.3, radius_min=2.0, radius_max=20.0)
    with torch.no_grad():
        before = _launched(P1)
        got = pj.project_gaussians(g, camera, **kw)
        assert _launched(P1) == (before[0] + 1,)
        want = pj.project_gaussians_plain(g, camera, **kw)
    torch.cuda.synchronize()
    z = want.depth
    assert bool(((z > 0) & (z <= 1e-6)).any()) and bool((z < 0).any())
    if options == "other" or not antialias:  # the dilation lifts r past 0.01
        assert bool((want.radius == kw.get("radius_min", 0.01)).any())
    assert bool((want.radius == kw.get("radius_max", 50.0)).any())
    assert 100 < int(want.visible.sum()) < g.capacity - 100
    _assert_projection_matches(got, want, g.rotation)


def _assert_gradients_match(got, g, camera, cotangents, kw, name):
    """chip_smoke.py's `gate_projection_bwd`: P2's gradients finite, at
    their parameters' dtype and shape, exactly 0 on the rows the chain's
    guard drops, within 5e-5 of `project_bwd_plain`'s by each leaf's norm,
    and no farther from the float64 chain than 1.5 times the float32
    chain's own distance (plus 1e-6), given the cotangents of the rows the
    guard keeps."""
    import chip_smoke
    return chip_smoke.gate_projection_bwd(got, g, camera, cotangents, kw,
                                          name)


@pytest.mark.parametrize("options", ["default", "other"])
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("color_mode,sh_degree", [
    ("dc_sigmoid", 0), ("sh", 0), ("sh", 1), ("sh", 2), ("sh", 3)])
def test_projection_bwd_kernel_matches_plain_on_card(cuda, color_mode,
                                                     sh_degree, antialias,
                                                     options):
    """One launch of `project_bwd` (P2) with standard normal cotangents on
    every row, visible or not, against the plain VJP; dead rows, rows
    behind the camera and rows at 0 < Z <= 1e-6 get exactly 0."""
    import chip_smoke
    g, camera = _projection_scene(cuda)
    kw = dict(color_mode=color_mode, sh_degree=sh_degree,
              antialias=antialias)
    if options == "other":
        kw.update(scale_modifier=1.3, radius_min=2.0, radius_max=20.0)
    cots = chip_smoke.seeded_cotangents(g, 1)
    before = _launched(P2)
    got = pj.project_bwd(g, camera, cots, **kw)
    assert _launched(P2) == (before[0] + 1,)
    _assert_gradients_match(got, g, camera, cots, kw, "P2")
    with torch.no_grad():
        plain = pj.project_gaussians_plain(g, camera, **kw)
    z, visible = plain.depth, plain.visible
    dropped = {"dead": ~g.alive, "behind": z < 0,
               "at 0 < Z <= 1e-6": (z > 0) & (z <= 1e-6)}
    for what, rows in dropped.items():
        assert bool(rows.any()), what
        for k, v in got.items():
            assert v is None or bool((v[rows] == 0).all()), (what, k)
    near = chip_smoke.guarded_rows(g, camera, kw)
    assert bool((near & ~visible).any()) and 100 < int(visible.sum())


def test_projection_kernel_on_a_misaligned_slice_on_card(cuda):
    """A pool cut at slot 3 (features_rest no longer starts on 16 bytes,
    so P1 stages it and P2 stages it and stores its gradient with 4-byte
    accesses), as the sharded renders and steps cut it, against the plain
    chain and its VJP on the same slice."""
    import chip_smoke
    g, camera = _projection_scene(cuda)
    part = g.slots(3, g.capacity - 5)
    assert part.features_rest.data_ptr() % 16
    kw = dict(color_mode="sh", sh_degree=3)
    with torch.no_grad():
        got = pj.project_fwd(part, camera, **kw)
        want = pj.project_gaussians_plain(part, camera, **kw)
    _assert_projection_matches(got, want, part.rotation)
    cots = chip_smoke.seeded_cotangents(part, 2)
    _assert_gradients_match(pj.project_bwd(part, camera, cots, **kw), part,
                            camera, cots, kw, "P2 misaligned")


def test_projection_with_grad_takes_the_chain_on_card(cuda):
    """Parameters that require grad, with grad mode on, record the one
    op's graph: one P1 launch forward, outputs bit for bit
    `project_fwd`'s, and one P2 launch backward, gradients as the chain's
    (a loss over the visible rows, so every other row's cotangent is 0),
    held by chip_smoke.py's `gate_gradients`.
    A camera that requires grad takes the chain: no launch, the chain's
    outputs and gradients bit for bit."""
    import chip_smoke
    g, camera = _projection_scene(cuda)
    kw = dict(color_mode="sh", sh_degree=3, antialias=True)

    def grads(fn, cam, pool=g):
        params = {k: v.clone().requires_grad_(True)
                  for k, v in pool.params().items()}
        p = fn(pool.with_params(params), cam, **kw)
        loss = (p.means2d.sum(-1) + p.conic.sum(-1) + p.color.sum(-1)
                + p.opacity + p.depth)[p.visible].sum()
        return p, dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))

    launches = lambda: _launched(P1, P2)
    before = launches()
    got, got_grads = grads(pj.project_gaussians, camera)
    assert launches() == (before[0] + 1, before[1] + 1)
    with torch.no_grad():
        want = pj.project_fwd(g, camera, **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0.0, atol=0.0, equal_nan=True)
    _, chain_grads = grads(pj.project_gaussians_plain, camera)
    g64, camera64 = chip_smoke.float64_pair(g, camera)
    _, chain64_grads = grads(pj.project_gaussians_plain, camera64, g64)
    chip_smoke.gate_gradients(got_grads, chain_grads, chain64_grads,
                              "P1 + P2")
    cam = camera.replace(
        view_matrix=camera.view_matrix.clone().requires_grad_(True))
    before = launches()
    got, got_grads = grads(pj.project_gaussians, cam)
    assert launches() == before
    want, want_grads = grads(pj.project_gaussians_plain, cam)
    for a, b in zip((*got, *got_grads.values()),
                    (*want, *want_grads.values())):
        torch.testing.assert_close(a, b, rtol=0.0, atol=0.0, equal_nan=True)
