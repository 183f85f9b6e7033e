"""The port's ring route (parallel/ring.py, parallel/sharded.py, the `t0`
builds of the raster kernels, the ring binning, the banded loss and the mesh
helpers) against the JAX package, on identical numpy inputs, on the CPU.

On CPU tensors the kernel wrappers run their plain PyTorch versions; the
JAX side runs its Pallas kernels in interpret mode under `shard_map` on the
virtual CPU devices of tests/conftest.py.  The port's ranks are CPU ranks of
one process (`make_mesh(..., devices=["cpu"])`).

One difference in what row 5 of the accumulators (the outgoing
transmittance) means is by design: the JAX kernel goes on multiplying the
transmittance of a pixel whose gate has closed until its tile's chunk loop
ends, so its value there depends on the chunk width; the port's kernels stop
a pixel for good when its gate closes.  Both values lie at or below 0.005,
the next range adds nothing to such a pixel either way, and the chain's
cotangent of a closed pixel's transmittance is 0.  So the tests compare row
5 where the pixel is still open at the end, and seed its cotangent only
there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from mini3dgs_tpu.config import TrainingConfig as JConfig
from mini3dgs_tpu.core import loss as jloss
from mini3dgs_tpu.ops import binning as jbin
from mini3dgs_tpu.ops import projection as jproj
from mini3dgs_tpu.ops import raster_pallas as jras
from mini3dgs_tpu.ops import renderer as jren
from mini3dgs_tpu.parallel import mesh as jmesh
from mini3dgs_tpu.parallel import sharded as jsharded
from mini3dgs_tpu.train import trainer as jtrainer
from mini3dgs_tpu_torch import convert
from mini3dgs_tpu_torch.config import TrainingConfig as TConfig
from mini3dgs_tpu_torch.core import loss as tloss
from mini3dgs_tpu_torch.ops import binning as tbin
from mini3dgs_tpu_torch.ops import cuda_library
from mini3dgs_tpu_torch.ops import raster_cuda as tras
from mini3dgs_tpu_torch.ops import renderer as tren
from mini3dgs_tpu_torch.parallel import mesh as tmesh
from mini3dgs_tpu_torch.parallel import sharded as tsharded
from mini3dgs_tpu_torch.train import optimizer as toptim
from mini3dgs_tpu_torch.train import trainer as ttrainer
from tests.test_raster_pallas import make_gaussians, random_scene
from tests.test_render_golden import identity_camera
from tests.test_torch_core import (camera_pair, jax_gaussians, random_params,
                                   t2n)
from tests.test_torch_grad import (_sequential_bwd, assert_rows_close,
                                   numpy_scene, port_camera)
from tests.test_torch_loss import image_pair
from tests.test_torch_projection import torch_projected
from tests.test_torch_raster import edge_case_stream
from tests.test_torch_train import (PARAMS, STATS, jax_opt_numpy,
                                    jax_scene_numpy)

# Only what runs the JAX package under shard_map needs its virtual devices.
requires_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")
OPEN = 1.0 - 0.995  # a pixel's gate is open while its transmittance exceeds


def cpu_mesh(tile, data=1):
    return tmesh.make_mesh(data, tile, devices=["cpu"])


# ---- (a) the kernel module with t0 ---------------------------------------

@requires_8
@pytest.mark.parametrize("tile_size", [16, 32])
def test_raster_t0_matches_jax_kernels(tile_size):
    """The lower band of an image (`tile0` > 0) through the JAX raster_op
    built with has_t0=True (Pallas `_fwd_kernel` / `_bwd_kernel`, interpret
    mode) and through `raster_fwd` / `raster_bwd` with `t0` on CPU tensors,
    with a seeded t0 that holds pixels arriving closed and a cotangent whose
    row 5 is not zero.  Accumulator rows 0..4 atol 3e-5, row 5 the same where
    the pixel ends open (see the module's note); the ten instance rows
    normalised atol 1e-4 (the tolerances of test_torch_grad's t0-less
    case); d_t0 normalised atol 1e-4 where the gate is open on arrival
    (the TPU kernel floors its log-space transmittance at 1e-30 where the
    port's reaches 0)."""
    H, W, G = 48, 56, 32
    params, alive = random_params(n=120, capacity=128, seed=31)
    jc, _ = camera_pair(width=W, height=H, fov_deg=70.0)
    jp = jproj.project_gaussians(jax_gaussians(params, alive), jc)
    jb = jbin.bin_gaussians(jp, H, W, tile_size, 4096, G)
    n_live, K = int(jb.n_live), jb.s_rank.shape[0]
    tiles_x, P_ = -(-W // tile_size), tile_size * tile_size
    tile0 = tiles_x                       # the band below the first tile row
    T = tiles_x * -(-H // tile_size) - tile0
    inst = jras._widen_stream(jbin.pack_instances(
        jras.instance_attrs(jp), jb.s_rank, jb.rank_perm, jb.rank_key,
        jb.seg_start_gid, jb.counts_gid, jb.order, jb.n_live, G, 64))
    op = jras._make_raster_op(T, tiles_x, tile_size, G, K, 0, 0, True,
                              has_t0=True)
    start, count = jb.tile_start[tile0:], jb.tile_count[tile0:]
    tile_gid = tile0 + jnp.arange(T, dtype=jnp.int32)
    rng = np.random.default_rng(7)
    t0 = rng.uniform(0.05, 1.0, (T, 1, P_)).astype(np.float32)
    closed = rng.random((T, 1, P_)) < 0.1
    t0[closed] = rng.uniform(0.0, 0.005, int(closed.sum()))
    acc_j, vjp = jax.vjp(lambda i, t: op(i, start, count, tile_gid, t),
                         inst, jnp.asarray(t0))
    acc_j = np.asarray(acc_j)

    stream = np.asarray(inst).transpose(1, 0, 2).reshape(16, K)
    stream = torch.from_numpy(stream[:10, :n_live].copy())
    args = (stream, torch.from_numpy(np.array(start)),
            torch.from_numpy(np.array(count)), tiles_x, tile_size)
    launches = dict(cuda_library.LAUNCHES)
    acc_t = tras.raster_fwd(*args, t0=torch.from_numpy(t0), tile0=tile0)
    np.testing.assert_allclose(t2n(acc_t)[:, :5], acc_j[:, :5], atol=3e-5)
    # Which pixels end open is read off one side, the reference's, leaving
    # out the pixels within one float32 rounding of the threshold: a pixel
    # classified on each side separately could land on both sides of it.
    ends = np.float32(1.01 * OPEN)
    band = np.spacing(ends)
    ends_open = acc_j[:, 5] > ends + band
    ends_closed = acc_j[:, 5] < ends - band
    assert 0.3 < ends_open.mean() < 0.95     # some pixels close on the way
    np.testing.assert_allclose(t2n(acc_t)[:, 5][ends_open],
                               acc_j[:, 5][ends_open], atol=3e-5)
    assert t2n(acc_t)[:, 5][ends_closed].max() <= ends
    assert np.all(t2n(acc_t)[:, 6:] == 0)

    gout = np.zeros((T, 8, P_), np.float32)
    gout[:, :6] = rng.normal(size=(T, 6, P_))
    gout[:, 5] *= ends_open
    d_j, dt0_j = vjp(jnp.asarray(gout))
    d_j = np.asarray(d_j).transpose(1, 0, 2).reshape(16, K)[:10, :n_live]
    d_t, dt0_t = tras.raster_bwd(*args, acc_t, torch.from_numpy(gout),
                                 t0=torch.from_numpy(t0), tile0=tile0)
    # CPU tensors launch nothing
    assert launches == cuda_library.LAUNCHES
    # only the band's instances get a gradient
    band = slice(int(start[0]), n_live)
    assert np.all(t2n(d_t)[:, :band.start] == 0) and band.start > 0
    assert_rows_close(t2n(d_t)[:, band], d_j[:, band], 1e-4, range(10))
    arrives_open = t0 > OPEN
    assert dt0_t.shape == t0.shape
    assert_rows_close([t2n(dt0_t)[arrives_open]],
                      [np.asarray(dt0_j)[arrives_open]], 1e-4, ["d_t0"])


def test_t0_of_ones_is_the_single_pass():
    """With t0 == 1 rows 0..4 and the instance gradients are bit for bit
    those of the build without t0, row 5 is 1 - alpha up to the sums'
    rounding (atol 1e-6), and a tile that arrives closed adds nothing, hands
    its t0 on and gives its instances exactly 0."""
    s, starts, counts = (torch.from_numpy(a) for a in edge_case_stream(16))
    args = (s, starts, counts, 3, 16)
    ones = torch.ones(6, 1, 256)
    base = tras.raster_fwd(*args)
    acc = tras.raster_fwd(*args, t0=ones)
    assert torch.equal(acc[:, :5], base[:, :5])
    np.testing.assert_allclose(t2n(acc[:, 5]), 1.0 - t2n(base[:, 4]),
                               atol=1e-6)
    gout = torch.zeros(6, 8, 256)
    gout[:, :5] = torch.from_numpy(
        np.random.default_rng(0).normal(size=(6, 5, 256)).astype(np.float32))
    d, d_t0 = tras.raster_bwd(*args, acc, gout, t0=ones)
    assert torch.equal(d, tras.raster_bwd(*args, base, gout))
    closed = ones.clone()
    closed[5] = 0.004
    closed[3] = 0.0
    acc_c = tras.raster_fwd(*args, t0=closed)
    assert bool((acc_c[[3, 5], :5] == 0).all())
    assert torch.equal(acc_c[:, 5:6], closed) is False  # open tiles move on
    assert torch.equal(acc_c[[3, 5], 5:6], closed[[3, 5]])
    gout[:, 5] = 1.0
    d_c, dt0_c = tras.raster_bwd(*args, acc_c, gout, t0=closed)
    for t in (3, 5):
        cols = slice(int(starts[t]), int(starts[t]) + int(counts[t]))
        assert bool((d_c[:, cols] == 0).all())
    # T_end == t0 for a closed tile, so d_t0 is row 5's cotangent; 0 at t0 = 0
    np.testing.assert_allclose(t2n(dt0_c[5]), 1.0, rtol=1e-6)
    assert bool((dt0_c[3] == 0).all())


def test_raster_t0_rejects_bad_inputs():
    s, starts, counts = (torch.from_numpy(a) for a in edge_case_stream(16))
    with pytest.raises(ValueError, match="t0 must be float32"):
        tras.raster_fwd(s, starts, counts, 3, 16, t0=torch.ones(6, 256))
    with pytest.raises(ValueError, match="t0 must be float32"):
        tras.raster_fwd(s, starts, counts, 3, 16,
                        t0=torch.ones(6, 1, 256).double())
    with pytest.raises(ValueError, match="tile0"):
        tras.raster_fwd(s, starts, counts, 3, 16, tile0=2)
    with pytest.raises(ValueError, match="reaches past"):
        tras.check_tile_ranges(torch.tensor([10, 4]),
                               torch.tensor([[0, 5], [0, 2]]),
                               torch.tensor([[5, 5], [2, 3]]))
    tras.check_tile_ranges(torch.tensor([10, 5]),
                           torch.tensor([[0, 5], [0, 2]]),
                           torch.tensor([[5, 5], [2, 3]]))


# ---- (b) the backward's plain version against a float64 loop -------------

@pytest.mark.parametrize("tile_size", [8, 16])
def test_raster_bwd_t0_matches_sequential_loop(tile_size):
    """The edge streams of test_torch_grad (an empty tile, alpha = 1 ties, a
    tile that saturates early) with a seeded t0 that holds closed pixels, a
    closed tile and exact zeros, and a cotangent whose row 5 is three times
    the size of the others, as the chain's can be (S_j = total - prefix then
    carries a term larger than every local one).  Normalised atol 2e-4 for
    the instance rows, the t0-less case's bound (measured 2e-5), and 1e-5
    for d_t0 (one product sum and one division; measured 2e-7)."""
    s, starts, counts = edge_case_stream(tile_size)
    P_ = tile_size * tile_size
    rng = np.random.default_rng(11)
    t0 = rng.uniform(0.006, 1.0, (6, 1, P_)).astype(np.float32)
    some = rng.random((6, 1, P_)) < 0.15
    t0[some] = rng.uniform(0.0, 0.005, int(some.sum()))
    t0[5] = rng.uniform(0.0, 0.005, (1, P_))
    t0[5, 0, :7] = 0.0
    args = (torch.from_numpy(s), torch.from_numpy(starts),
            torch.from_numpy(counts), 3, tile_size)
    acc = tras.raster_fwd(*args, t0=torch.from_numpy(t0))
    gout = np.zeros((6, 8, P_), np.float32)
    gout[:, :6] = rng.normal(size=(6, 6, P_))
    gout[:, 5] *= 3.0
    got, got_t0 = tras.raster_bwd(*args, acc, torch.from_numpy(gout),
                                  t0=torch.from_numpy(t0))
    want, want_t0 = _sequential_bwd(s, starts, counts, 3, tile_size, t2n(acc),
                                    gout, t0=t0)
    assert np.isfinite(t2n(got)).all() and np.isfinite(t2n(got_t0)).all()
    assert_rows_close(t2n(got), want, 2e-4, range(10))
    assert_rows_close([t2n(got_t0)], [want_t0], 1e-5, ["d_t0"])
    tile5 = slice(starts[5], starts[5] + counts[5])     # arrives closed
    assert np.all(t2n(got)[:, tile5] == 0) and np.all(want[:, tile5] == 0)
    assert np.all(t2n(got_t0)[5, 0, :7] == 0)


def test_raster_op_differentiates_t0():
    """`raster_op` returns a gradient for t0, and both its gradients equal
    autograd of the differentiable plain forward on a tie-free stream
    (normalised atol 1e-4: the same sums in another order)."""
    jp = jproj.project_gaussians(
        jax_gaussians(*random_params(n=100, capacity=128, seed=33)),
        camera_pair(width=48, height=32)[0])
    tp = torch_projected(jp)
    b, stream = tras.tile_stream(tp, 32, 48, 16)
    rng = np.random.default_rng(3)
    t0 = torch.from_numpy(rng.uniform(0.2, 1.0, (6, 1, 256))
                          .astype(np.float32))
    wts = torch.from_numpy(rng.normal(size=(6, 6, 256)).astype(np.float32))
    grads = []
    for fwd in (tras.raster_op, tras.raster_fwd_plain):
        leaves = [stream.detach().clone().requires_grad_(True),
                  t0.clone().requires_grad_(True)]
        acc = fwd(leaves[0], b.tile_start, b.tile_count, 3, 16, t0=leaves[1])
        grads.append([t2n(g) for g in torch.autograd.grad(
            (acc[:, :6] * wts).sum(), leaves)])
    assert_rows_close(grads[0][0], grads[1][0], 1e-4, range(10))
    assert_rows_close([grads[0][1]], [grads[1][1]], 1e-4, ["d_t0"])


# ---- (c) ring binning ----------------------------------------------------

def _jax_ring_binning(jp, H, W, tile_size, n, Q, G):
    """Every origin's RingBinning fields, stacked over the tile axis."""
    def origin(proj):
        rb = jbin.bin_gaussians_ring_origin(proj, H, W, tile_size, Q, G,
                                            "tile", n)
        return tuple(x[None] for x in (rb.flat_rank, rb.live, rb.tile_start,
                                       rb.tile_count, rb.n_live,
                                       rb.n_dropped))
    return jax.jit(shard_map(origin, mesh=jmesh.make_mesh(1, n),
                             in_specs=(P(),), out_specs=P("tile"),
                             check_vma=False))(jp)


@requires_8
@pytest.mark.parametrize("n", [2, 4])
def test_ring_binning_matches_jax(n):
    """Per depth range, band and tile, the depth-rank lists of
    `bin_gaussians_ring_origin` equal those of the JAX RingBinning built
    with ample seg_capacity under shard_map (integers: exactly), and every
    segment holds exactly its live instances."""
    H, W, ts, Q, G = 64, 56, 16, 1024, 32
    params, alive = random_params(n=120, capacity=128, seed=17)
    jc, _ = camera_pair(width=W, height=H, fov_deg=70.0)
    jp = jproj.project_gaussians(jax_gaussians(params, alive), jc)
    tp = torch_projected(jp)
    flat_rank, live, j_start, j_count, j_live, j_dropped = (
        np.asarray(x) for x in _jax_ring_binning(jp, H, W, ts, n, Q, G))
    assert j_dropped.sum() == 0
    single = tbin.bin_gaussians(tp, H, W, ts)
    total = 0
    for r in range(n):
        rb = tbin.bin_gaussians_ring_origin(tp, H, W, ts, r, n)
        assert rb.n_live == int(j_live[r]) == int(live[r].sum())
        assert rb.n_dropped == 0 and len(rb.seg_start) == n + 1
        want = convert.ring_tile_lists(flat_rank[r], j_start[r], j_count[r],
                                       [b * Q for b in range(n)])
        got = convert.ring_tile_lists(t2n(rb.s_rank), t2n(rb.tile_start),
                                      t2n(rb.tile_count), rb.seg_start[:n])
        assert got == want
        ranks = t2n(rb.s_rank)
        assert rb.n_live == 0 or (
            ranks.min() >= r * 128 // n and ranks.max() < (r + 1) * 128 // n)
        np.testing.assert_array_equal(t2n(rb.tile_count), j_count[r])
        total += rb.n_live
    assert total == single.n_live > 200
    with pytest.raises(ValueError, match="capacity"):
        tbin.bin_gaussians_ring_origin(tp, H, W, ts, 0, 3)
    with pytest.raises(ValueError, match="tile rows"):
        tbin.bin_gaussians_ring_origin(tp, 48, W, ts, 0, 2)


# ---- (d) the ring render -------------------------------------------------

def _field(out, k):
    """`depth` is D / (A + 1e-6): where A ~ 0 it is a ratio of near-zeros,
    so compare the raw accumulator D instead, as tests/test_ring.py does."""
    if k == "depth":
        return t2n(out["depth"]) * (t2n(out["alpha"]) + 1e-6)
    return t2n(out[k])


def _jax_settings(cam, ring):
    return jren.RenderSettings(image_height=cam.height, image_width=cam.width,
                               use_pallas=True, max_instances=4096,
                               gaussian_chunk=32, ring=ring)


def _port_scene(jg, jc):
    params, alive = numpy_scene(jg)
    return (convert.gaussians_from_numpy(params, alive), port_camera(jc),
            tren.RenderSettings(image_height=jc.height, image_width=jc.width))


@requires_8
def test_ring_render_matches_jax_ring_and_single():
    """The isotropic scene of tests/test_ring.py on a (1, 4) mesh:
    `make_sharded_render(ring=True)` against the JAX package's (atol 2e-5,
    that test's bound: float32 association at the ranges' borders), against
    and against the port's single-device `render`, as is the band route
    (atol 2e-6: the same kernels' arithmetic, other sums)."""
    jc = identity_camera(64, 64, 70.0)
    jg = random_scene(60, seed=4)
    j_ring = jsharded.make_sharded_render(_jax_settings(jc, True),
                                          jmesh.make_mesh(data=1, tile=4))(
        jg, jc)
    tg, tc, st = _port_scene(jg, jc)
    single = tren.render(tg, tc, st)
    t_ring = tsharded.make_sharded_render(st.replace(ring=True),
                                          cpu_mesh(4))(tg, tc)
    t_band = tsharded.make_sharded_render(st, cpu_mesh(4))(tg, tc)
    for k in ("image", "alpha", "depth"):
        assert t_ring[k].shape == single[k].shape
        np.testing.assert_allclose(_field(t_ring, k), _field(j_ring, k),
                                   atol=2e-5, err_msg=f"ring vs JAX: {k}")
        np.testing.assert_allclose(_field(t_ring, k), _field(single, k),
                                   atol=2e-6, err_msg=f"ring vs single: {k}")
        # the band route's arithmetic is the single pass's, but a rank
        # projects a slice of the pool, where the CPU's vectorised
        # exp / sqrt may differ by an ulp from the whole pool's
        np.testing.assert_allclose(_field(t_band, k), _field(single, k),
                                   atol=2e-6, err_msg=f"band vs single: {k}")
    assert sum(map(sum, t_ring["seg_live"])) == single["n_live"] \
        == sum(t_ring["n_live"])
    # the band route bins through the sharded sort (the capacity, 60,
    # divides over the 4 bands): each rank counts its own band's instances
    assert sum(t_band["n_live"]) == single["n_live"]


@requires_8
def test_ring_saturating_stack_matches_jax():
    """The deep co-centred opaque stack of tests/test_ring.py: the early
    stop fires mid-stream, so the ranges' borders cross saturated pixels and
    the gate must read the alpha of the whole chain.  Against JAX's
    single-device render and JAX's ring atol 3e-5, that test's bound."""
    n = 48
    rng = np.random.default_rng(9)
    xyz = np.concatenate([rng.uniform(-0.05, 0.05, (n, 2)),
                          np.linspace(0.8, 2.4, n)[:, None]], axis=1)
    jg = make_gaussians(xyz.astype(np.float32), np.full((n, 3), 0.25,
                                                        np.float32),
                        rng.uniform(0, 1, (n, 3)), np.full(n, 0.7, np.float32))
    jc = identity_camera(64, 64, 70.0)
    j_single = jren.render(jg, jc, _jax_settings(jc, False))
    j_ring = jsharded.make_sharded_render(_jax_settings(jc, True),
                                          jmesh.make_mesh(data=1, tile=4))(
        jg, jc)
    tg, tc, st = _port_scene(jg, jc)
    t_ring = tsharded.make_sharded_render(st.replace(ring=True),
                                          cpu_mesh(4))(tg, tc)
    for k in ("image", "alpha"):
        np.testing.assert_allclose(t2n(t_ring[k]), np.asarray(j_single[k]),
                                   atol=3e-5, err_msg=k)
        np.testing.assert_allclose(t2n(t_ring[k]), np.asarray(j_ring[k]),
                                   atol=3e-5, err_msg=k)
    assert float(t_ring["alpha"].max()) > 0.995
    # multiplying a t0-less pass by t0 afterwards would fail here: ranges
    # behind a saturated pixel must add nothing
    assert min(map(sum, t_ring["seg_live"][1:])) > 0


def test_sharded_render_refuses_what_is_not_ported():
    params, alive, cam = convert.flagship_scene_numpy(30, 20, seed=0)
    g = convert.gaussians_from_numpy(params, alive)
    c = convert.camera_from_numpy(**cam, width=64, height=64)
    st = tren.RenderSettings(image_height=64, image_width=64)
    with pytest.raises(ValueError, match="does not divide"):
        tsharded.make_sharded_render(st.replace(ring=True), cpu_mesh(4))(g, c)
    with pytest.raises(NotImplementedError, match="golden"):
        tsharded.make_sharded_render(st.replace(raster="golden"),
                                     cpu_mesh(2))(g, c)
    with pytest.raises(ValueError, match="bands"):
        tsharded.make_sharded_render(st, cpu_mesh(3))
    with pytest.raises(ValueError, match="band"):
        tras.rasterize_tiles(None, 20, 64, None, row0=8, full_height=64)
    # C % n != 0 leaves the band route's projection replicated, not wrong
    out = tsharded.make_sharded_render(st, cpu_mesh(4))(g, c)
    np.testing.assert_array_equal(t2n(out["image"]),
                                  t2n(tren.render(g, c, st)["image"]))


# ---- (e) the banded loss -------------------------------------------------

def _jax_banded_loss(pred, target, n):
    H, W = pred.shape[1:]
    bh = H // n

    def f(p, t):
        row0 = jax.lax.axis_index("tile") * bh
        band = lambda x: jax.lax.dynamic_slice(x, (0, row0, 0), (3, bh, W))
        return jloss.gaussian_loss_banded(band(p), band(t), H, "tile", 0.2)[1]

    return jax.jit(shard_map(f, mesh=jmesh.make_mesh(1, n),
                             in_specs=(P(), P()), out_specs=P(),
                             check_vma=False))(jnp.asarray(pred),
                                               jnp.asarray(target))


@requires_8
@pytest.mark.parametrize("n", [1, 2, 4])
def test_banded_loss_matches_jax_and_the_whole_image(n):
    """`gaussian_loss_banded` on n bands against the JAX package's under
    shard_map and against the port's `gaussian_loss` on the assembled image:
    values atol 3e-6 (test_torch_loss's bound: the order of the final sums),
    every rank holds the same value, and the gradient with respect to the
    bands equals the whole-image gradient within 1e-5 of its largest entry
    (the halo's cotangent flows back to the neighbour)."""
    target, pred = image_pair((3, 64, 40), seed=5 + n)
    want_j = _jax_banded_loss(pred, target, n)
    bh = 64 // n
    leaf = torch.from_numpy(pred).requires_grad_(True)
    bands = lambda x: [x[:, i * bh:(i + 1) * bh] for i in range(n)]
    out = tloss.gaussian_loss_banded(bands(leaf),
                                     bands(torch.from_numpy(target)),
                                     ["cpu"] * n, 0.2)
    whole_leaf = torch.from_numpy(pred).requires_grad_(True)
    whole, parts = tloss.gaussian_loss(whole_leaf, torch.from_numpy(target),
                                       0.2)
    assert len(out) == n
    for total, got in out:
        for k in ("l1", "dssim", "total_loss"):
            np.testing.assert_allclose(float(got[k].detach()),
                                       float(want_j[k]), atol=3e-6, err_msg=k)
            np.testing.assert_allclose(float(got[k].detach()),
                                       float(parts[k].detach()), atol=3e-6,
                                       err_msg=k)
        assert float(total.detach()) == float(out[0][0].detach())
    out[0][0].backward()
    whole.backward()
    want = t2n(whole_leaf.grad)
    np.testing.assert_allclose(t2n(leaf.grad), want,
                               atol=1e-5 * np.abs(want).max())


def test_banded_loss_rejects_thin_bands():
    x = [torch.zeros(3, 4, 8)] * 2
    with pytest.raises(ValueError, match="thinner"):
        tloss.gaussian_loss_banded(x, x, ["cpu"] * 2)


# ---- (f) one sharded train step ------------------------------------------

SIZE, N_TILE = 32, 2


def _ring_step_setup():
    """A shared state two JAX steps into training (non-zero Adam moments and
    statistic buffers), as in test_torch_train.step_setup, at 32 x 32 so the
    image splits into 2 bands of one 16-pixel tile row; the target is a
    render of a perturbed copy of the scene (see step_setup for why)."""
    params, alive = random_params(n=50, capacity=64, seed=61, spread=0.35)
    rng = np.random.default_rng(62)
    t_params = {k: v.copy() for k, v in params.items()}
    for k, s in (("xyz", 0.03), ("features_dc", 0.3), ("opacity", 0.5)):
        t_params[k][:50] += rng.normal(0, s, t_params[k][:50].shape)
    jcam, tcam = camera_pair(width=SIZE, height=SIZE, fov_deg=70.0)
    common = dict(capacity=64, image_height=SIZE, image_width=SIZE,
                  tile_size=16, color_mode="sh", sh_degree=3,
                  position_lr_max_steps=100,
                  background_color=[0.2, 0.4, 0.6])
    jc = JConfig(**common, use_pallas=True, max_instances=2048,
                 gaussian_chunk=32)
    tc = TConfig(**common, mesh_tile=N_TILE, ring_exchange=True)
    render_kw = dict(image_height=SIZE, image_width=SIZE, tile_size=16,
                     color_mode="sh", sh_degree=3)
    jset = jren.RenderSettings(**render_kw, use_pallas=True,
                               bg_color=jnp.asarray(tc.background_color),
                               max_instances=2048, gaussian_chunk=32)
    tset = tren.RenderSettings(**render_kw,
                               bg_color=tuple(tc.background_color))
    target = np.asarray(jren.render(jax_gaussians(t_params, alive), jcam,
                                    jset)["image"])
    jcam = jcam.replace(image=jnp.asarray(target))
    tcam = tcam.replace(image=torch.from_numpy(target.copy()))
    jstep = jax.jit(jtrainer.make_step_body(jc, jset))
    jstate = jtrainer.create_train_state(jax_gaussians(params, alive), jc)
    for _ in range(2):
        jstate, _ = jstep(jstate, jcam)
    p, a, s = jax_scene_numpy(jstate.gaussians)
    tstate = ttrainer.TrainState(
        gaussians=convert.gaussians_from_numpy(p, a, stats=s),
        opt_state=convert.adam_state_from_numpy(
            **jax_opt_numpy(jstate.opt_state)), step=int(jstate.step))
    return jc, jset, jstate, jcam, tc, tset, tstate, tcam


def _assert_steps_close(got_g, want_g, want_nu, unit_of, firm_tol, all_tol):
    """Parameters as steps in units of the learning rate, as
    test_train_step_matches_jax compares them: within `firm_tol` of a step
    (plus 2 ulps of the value) where sqrt(nu) is at least 1e-2 of the
    tensor's largest, within `all_tol` everywhere."""
    for k in PARAMS:
        want = np.asarray(want_g[k], np.float64)
        err = np.abs(np.asarray(got_g[k], np.float64) - want) / unit_of[k]
        root_nu = np.sqrt(want_nu[k])
        firm = root_nu >= 1e-2 * root_nu.max()
        slack = 2 * np.spacing(np.abs(want).astype(np.float32)) / unit_of[k]
        assert np.all(err[firm] <= firm_tol + slack[firm]), \
            (k, err[firm].max())
        assert err.max() <= all_tol, (k, err.max())


@requires_8
def test_ring_train_step_matches_jax_and_single_device():
    """One `make_sharded_train_step(ring=True)` on a (1, 2) mesh from a
    shared state against the JAX package's ring step, and against the port's
    single-device `train_step`.  Loss rtol 1e-4 (JAX) and 1e-5 (single: the order of the final sums).
    Parameters in units of the learning rate (test_train_step_matches_jax's
    bounds against JAX: 2e-4 of a step where the second moment is firm, 5e-2
    everywhere; against the port's own single-device step 1e-4 and 1e-2).
    The statistic buffers and the `grads_only` gradients are compared too:
    a factor of n in the reductions hides behind Adam and shows only there
    (buffers within 1e-4 of the largest entry, gradients normalised atol
    1e-3, the render-gradient bound of test_torch_grad)."""
    jc, jset, jstate, jcam, tc, tset, tstate, tcam = _ring_step_setup()
    jmesh_ = jmesh.make_mesh(data=1, tile=N_TILE)
    jcams = jax.tree.map(lambda x: jnp.stack([x]), jcam)
    jring = jset.replace(ring=True)
    copy = lambda st: jax.tree.map(jnp.copy, st)
    jgrads, _ = jsharded.make_sharded_train_step(
        jc, jring, jmesh_, grads_only=True)(copy(jstate), jcams)
    jnew, jm = jsharded.make_sharded_train_step(jc, jring, jmesh_)(
        copy(jstate), jcams)

    tring = tset.replace(ring=True)
    before = convert.gaussians_to_numpy(tstate.gaussians)[0]
    tnew, tm = tsharded.make_sharded_train_step(tc, tring, cpu_mesh(N_TILE))(
        tstate, [tcam])
    tgrads, tm2 = tsharded.make_sharded_train_step(
        tc, tring, cpu_mesh(N_TILE), grads_only=True)(tstate, [tcam])
    one, om = ttrainer.train_step(tstate, tcam, tc, tset)

    for k in ("l1", "dssim", "total_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
        np.testing.assert_allclose(float(tm[k]), float(om[k]), rtol=1e-5,
                                   err_msg=k)
        assert float(tm2[k]) == float(tm[k])
    assert float(tm["render_drops"]) == float(jm["render_drops"]) == 0
    assert int(tm["n_visible"]) == int(om["n_visible"])
    assert 0 < tm["render_instances"] < om["render_instances"]
    assert tnew.step == int(jnew.step) == 3 and tstate.step == 2

    names = [k for k in PARAMS]
    assert_rows_close([t2n(tgrads[k]) for k in names],
                      [np.asarray(jgrads[k]) for k in names], 1e-3, names)
    factor = toptim.schedule_factor(tc, tstate.opt_state.sched_count)
    unit_of = {k: lr * factor for k, lr in toptim.group_lrs(tc).items()}
    got_p, got_alive, got_s = convert.gaussians_to_numpy(tnew.gaussians)
    _assert_steps_close(got_p, {k: getattr(jnew.gaussians, k) for k in PARAMS},
                        jax_opt_numpy(jnew.opt_state)["nu"], unit_of,
                        2e-4, 5e-2)
    one_p, _, one_s = convert.gaussians_to_numpy(one.gaussians)
    _assert_steps_close(got_p, one_p,
                        convert.adam_state_to_numpy(one.opt_state)["nu"],
                        unit_of, 1e-4, 1e-2)
    dead = ~got_alive
    for k in PARAMS:
        np.testing.assert_array_equal(got_p[k][dead], before[k][dead])
        assert np.abs(got_p[k] - before[k]).max() > 0, k
    for k in STATS:
        want = np.asarray(getattr(jnew.gaussians, k))
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(got_s[k], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)
        np.testing.assert_allclose(got_s[k], one_s[k], rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)


def test_sharded_step_with_two_cameras_and_exposure():
    """A (2, 2) mesh with per-camera exposure: the loss is the mean over the
    two cameras' single-device losses, the gradients (`grads_only`) are the
    mean of the two single-device gradients (normalised atol 1e-5), and the
    step refuses a camera batch of the wrong size."""
    params, alive, cam = convert.flagship_scene_numpy(64, 50, seed=3)
    # anisotropic splats: an isotropic one's rotation gradient is pure noise
    params["scaling"][:50] = np.log(np.random.default_rng(5).uniform(
        0.05, 0.15, (50, 3)))
    g = convert.gaussians_from_numpy(params, alive)
    cfg = TConfig(capacity=64, image_height=SIZE, image_width=SIZE,
                  tile_size=16, sh_degree=0, use_exposure=True)
    st = tren.RenderSettings(image_height=SIZE, image_width=SIZE)
    rng = np.random.default_rng(2)
    cams = [convert.camera_from_numpy(
        **cam, width=SIZE, height=SIZE,
        image=rng.uniform(0, 1, (3, SIZE, SIZE)).astype(np.float32))
        for _ in range(2)]
    cams[1] = cams[1].replace(
        view_matrix=cams[1].view_matrix + torch.tensor(
            [[0, 0, 0, 0.1], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0.]]))
    state = ttrainer.create_train_state(g, cfg, n_cameras=3)
    state = state.replace(exposure=state.exposure + torch.from_numpy(
        rng.normal(0, 0.05, (3, 3, 4)).astype(np.float32)))
    step = tsharded.make_sharded_train_step(
        cfg, st.replace(ring=True), cpu_mesh(2, data=2))
    new, m = step(state, cams, cam_idx=[2, 0])
    grads, _ = tsharded.make_sharded_train_step(
        cfg, st.replace(ring=True), cpu_mesh(2, data=2), grads_only=True)(
        state, cams, cam_idx=[2, 0])
    singles = [ttrainer.train_step(state, c, cfg, st, cam_idx=i)
               for c, i in zip(cams, (2, 0))]
    np.testing.assert_allclose(
        float(m["total_loss"]),
        np.mean([float(s[1]["total_loss"]) for s in singles]), rtol=1e-6)
    assert not torch.equal(new.exposure[2], state.exposure[2])
    assert torch.equal(new.exposure[1], state.exposure[1])
    # Adam's mu after one step from zero moments is 0.1 * gradient
    want = [0.5 * (singles[0][0].opt_state.mu[k] + singles[1][0].opt_state.mu[k])
            / 0.1 for k in PARAMS]
    assert_rows_close([t2n(grads[k]) for k in PARAMS],
                      [t2n(w) for w in want], 1e-5, PARAMS)
    with pytest.raises(ValueError, match="2 cameras"):
        step(state, cams[:1])


# ---- (g) ring gradients equal band-route gradients -----------------------

def test_ring_gradients_match_band_route():
    """The gradients of a seeded scalar loss through the ring (4 ranks) equal
    those through the band route and through the single-device `render`,
    per parameter group and for every slot (normalised atol 1e-5: the same
    terms, summed in another grouping)."""
    jg = random_scene(48, seed=3, spread=0.35)
    jc = identity_camera(64, 64, 70.0)
    tg, tc, st = _port_scene(jg, jc)
    target = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (3, 64, 64)).astype(np.float32))
    names = [k for k in PARAMS if k != "features_rest"]

    def grads(render_fn):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in tg.params().items()}
        out = render_fn(tg.with_params(leaves))
        loss = (((out["image"] - target) ** 2).sum()
                + 0.01 * out["depth"].sum() + 0.1 * out["alpha"].sum())
        return [t2n(x) for x in torch.autograd.grad(
            loss, [leaves[k] for k in names])]

    ring = grads(lambda g: tsharded.make_sharded_render(
        st.replace(ring=True), cpu_mesh(4))(g, tc))
    band = grads(lambda g: tsharded.make_sharded_render(st, cpu_mesh(4))(g, tc))
    single = grads(lambda g: tren.render(g, tc, st))
    assert all(np.abs(x).max() > 0 for x in single)
    assert_rows_close(ring, band, 1e-5, names)
    assert_rows_close(ring, single, 1e-5, names)


# ---- (h) the mesh helpers ------------------------------------------------

def test_make_mesh_places_ranks():
    mesh = tmesh.make_mesh(2, 3, devices=["cpu", "meta"])
    assert (mesh.data, mesh.tile) == (2, 3)
    assert [d.type for d in mesh.devices] == ["cpu", "meta"] * 3
    assert [d.type for d in mesh.tile_devices(1)] == ["meta", "cpu", "meta"]
    with pytest.raises(ValueError, match=">= 1"):
        tmesh.make_mesh(0, 2, devices=["cpu"])
    if not torch.cuda.is_available():
        # nothing moves to the CPU unless the caller names CPU devices
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh(1, 2)


def test_collectives_match_their_definitions():
    devs = ["cpu"] * 3
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.normal(size=(2, 4)).astype(np.float32))
          for _ in range(3)]
    send = [[xs[r] + 10 * d for d in range(3)] for r in range(3)]
    recv = tmesh.all_to_all(send, devs)
    for d in range(3):
        for r in range(3):
            assert torch.equal(recv[d][r], send[r][d])
    shifted = tmesh.ppermute(xs, [(0, 1), (1, 2)], devs)
    assert torch.equal(shifted[1], xs[0]) and torch.equal(shifted[2], xs[1])
    assert torch.equal(shifted[0], torch.zeros(2, 4))   # no sender: zeros
    pairs = tmesh.ppermute([(x, x + 1) for x in xs],
                           [(j, (j - 1) % 3) for j in range(3)], devs)
    assert torch.equal(pairs[0][1], xs[1] + 1) and isinstance(pairs[0], tuple)
    with pytest.raises(ValueError, match="permutation"):
        tmesh.ppermute(xs, [(0, 1), (2, 1)], devs)
    for g in tmesh.all_gather(xs, devs, dim=1):
        assert torch.equal(g, torch.cat(xs, dim=1))
    for s, m in zip(tmesh.psum(xs, devs), tmesh.pmean(xs, devs)):
        assert torch.equal(s, xs[0] + xs[1] + xs[2])
        np.testing.assert_allclose(t2n(m), t2n(s) / 3, rtol=1e-6)


def test_collectives_transpose_under_autograd():
    """The cotangents autograd sends back are the collectives' transposes:
    a psum hands every input the sum of the outputs' cotangents, a ppermute
    sends a cotangent back to its source (and none to a rank nobody read),
    an all_gather hands each rank its slice of every output's cotangent
    summed, an all_to_all transposes back."""
    devs = ["cpu"] * 3
    rng = np.random.default_rng(1)
    new = lambda: [torch.from_numpy(rng.normal(size=(2,)).astype(np.float32))
                   .requires_grad_(True) for _ in range(3)]
    w = [torch.from_numpy(rng.normal(size=(2,)).astype(np.float32))
         for _ in range(3)]
    xs = new()
    sum(float(d + 1) * (y * w[d]).sum()
        for d, y in enumerate(tmesh.psum(xs, devs))).backward()
    for x in xs:
        np.testing.assert_allclose(t2n(x.grad),
                                   t2n(1 * w[0] + 2 * w[1] + 3 * w[2]),
                                   rtol=1e-6)
    xs = new()
    sum((y * w[d]).sum() for d, y in enumerate(
        tmesh.ppermute(xs, [(0, 1), (1, 2)], devs))).backward()
    assert torch.equal(xs[0].grad, w[1]) and torch.equal(xs[1].grad, w[2])
    assert xs[2].grad is None
    xs = new()
    w6 = [torch.from_numpy(rng.normal(size=(6,)).astype(np.float32))
          for _ in range(3)]
    sum((y * w6[d]).sum() for d, y in enumerate(
        tmesh.all_gather(xs, devs))).backward()
    for r, x in enumerate(xs):
        np.testing.assert_allclose(
            t2n(x.grad), t2n(sum(v[2 * r:2 * r + 2] for v in w6)), rtol=1e-6)
    xs = new()
    recv = tmesh.all_to_all([[x * (d + 1) for d in range(3)] for x in xs],
                            devs)
    sum((recv[d][r] * w[d]).sum() for d in range(3)
        for r in range(3)).backward()
    for x in xs:
        np.testing.assert_allclose(t2n(x.grad),
                                   t2n(1 * w[0] + 2 * w[1] + 3 * w[2]),
                                   rtol=1e-6)
