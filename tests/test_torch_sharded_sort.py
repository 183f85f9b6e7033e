"""The band route's sharded candidate sort (parallel/sharded.py
`bin_gaussians_sharded`, and `_render_bands` rendering through it)
against the JAX package's `bin_gaussians_sharded` under `shard_map`, against
the port's single-device binning restricted to each band, and against the
band route that bins the whole image on every rank, on the CPU.

Integers compare exactly; the render bitwise (every band's kernels read
the same stream); gradients within rel-L2 1e-6.
"""

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from mini3dgs_tpu.ops import binning as jbin
from mini3dgs_tpu.ops.projection import project_gaussians as jproject
from mini3dgs_tpu.parallel import mesh as jmesh
from mini3dgs_tpu_torch import convert
from mini3dgs_tpu_torch.ops import binning as tbin
from mini3dgs_tpu_torch.ops import raster_cuda as tras
from mini3dgs_tpu_torch.ops import renderer as tren
from mini3dgs_tpu_torch.parallel import mesh as tmesh
from mini3dgs_tpu_torch.parallel import sharded as tsharded
from tests.test_raster_pallas import random_scene, rotated_scene
from tests.test_render_golden import identity_camera
from tests.test_torch_core import t2n
from tests.test_torch_grad import numpy_scene, port_camera
from tests.test_torch_projection import torch_projected

requires_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")
N, SIZE, TS = 4, 64, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread while this module runs: its tensors are small,
    and the test run's other workers need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_devices(n):
    return tmesh.make_mesh(1, n, devices=["cpu"]).tile_devices(0)


def jax_scene(aniso):
    """tests/test_sharding.py's scenes: 60 splats (a capacity that divides
    over 4), isotropic or rotated anisotropic, and its 70-degree camera."""
    return ((rotated_scene if aniso else random_scene)(60, seed=11),
            identity_camera(SIZE, SIZE, 70.0))


def band_of(b: tbin.Binning, i: int, ntb: int):
    """The single-device binning `b` restricted to band i's tiles: its
    stream slice and tile ranges local to the band."""
    tiles = slice(i * ntb, (i + 1) * ntb)
    lo = int(b.tile_start[tiles][0])
    hi = lo + int(b.tile_count[tiles].sum())
    return b.s_rank[lo:hi], b.tile_start[tiles] - lo, b.tile_count[tiles]


@requires_8
@pytest.mark.parametrize("aniso", [False, True])
def test_sharded_binning_matches_jax_and_the_bands(aniso):
    """n = 4, 64^2, tile 16 (tests/test_sharding.py's setting): for every
    band, `bin_gaussians_sharded` gives JAX's `bin_gaussians_sharded` under
    shard_map (s_rank, band-restricted counts_gid, tile ranges, n_live) and
    the port's single-device binning restricted to the band, exactly; and
    so it does over 8 bands at tile 8, where the capacity of 60 splits into
    unequal gid shards."""
    jg, jcam = jax_scene(aniso)
    jp = jproject(jg, jcam)
    band_h = SIZE // N

    def sharded(proj):
        b = jbin.bin_gaussians_sharded(
            proj, band_h, SIZE, TS, 1024, 32, "tile", N, full_height=SIZE,
            full_width=SIZE, route_capacity=1024)
        return (b.s_rank[None], b.counts_gid[None], b.tile_start[None],
                b.tile_count[None], b.n_live[None], b.n_dropped[None])

    want = [np.asarray(x) for x in jax.jit(shard_map(
        sharded, mesh=jmesh.make_mesh(data=1, tile=N), in_specs=(P(),),
        out_specs=P("tile"), check_vma=False))(jp)]
    tp = torch_projected(jp)
    got = tsharded.bin_gaussians_sharded([tp] * N, band_h, SIZE, TS,
                                     cpu_devices(N))
    single = tbin.bin_gaussians(tp, SIZE, SIZE, TS)
    ntb = band_h // TS * SIZE // TS
    for i, b in enumerate(got):
        assert want[5][i] == 0
        assert b.n_live == int(want[4][i]) > 0
        np.testing.assert_array_equal(t2n(b.s_rank), want[0][i][:b.n_live])
        np.testing.assert_array_equal(t2n(b.counts_gid), want[1][i])
        np.testing.assert_array_equal(t2n(b.tile_start), want[2][i])
        np.testing.assert_array_equal(t2n(b.tile_count), want[3][i])
        for x, y in zip((b.s_rank, b.tile_start, b.tile_count),
                        band_of(single, i, ntb)):
            assert torch.equal(x, y)
        assert torch.equal(b.order, single.order)
        assert b.n_dropped == 0
    assert sum(b.n_live for b in got) == single.n_live
    # gid shards of 8 and 7 slots: the capacity 60 over 8 bands at tile 8
    got = tsharded.bin_gaussians_sharded([tp] * 8, 8, SIZE, 8,
                                         cpu_devices(8))
    single = tbin.bin_gaussians(tp, SIZE, SIZE, 8)
    for i, b in enumerate(got):
        for x, y in zip((b.s_rank, b.tile_start, b.tile_count),
                        band_of(single, i, SIZE // 8)):
            assert torch.equal(x, y)
    assert sum(b.n_live for b in got) == single.n_live


def band_route(g, cam, settings, sharded_sort):
    """The band route over N CPU ranks from the ranks' projected sets:
    `_render_bands` (the sharded sort), or the reference, every rank
    binning the whole image (`rasterize_tiles` without a binning);
    with the gradient of a loss of image, alpha and depth."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in g.params().items()}
    gp = g.with_params(params)
    band_h = SIZE // N
    devices = cpu_devices(N)
    projs = tsharded._project([gp] * N, [cam] * N, settings, devices)
    if sharded_sort:
        outs = tsharded._render_bands(projs, settings, band_h, devices)
    else:
        outs = [tras.rasterize_tiles(proj, band_h, SIZE,
                                     torch.as_tensor(settings.bg_color),
                                     tile_size=TS, row0=i * band_h,
                                     full_height=SIZE)
                for i, proj in enumerate(projs)]
    out = tsharded._assemble(outs, devices[0], ring=False)
    target = torch.linspace(0, 1, 3 * SIZE * SIZE).reshape(3, SIZE, SIZE)
    loss = (((out["image"] - target) ** 2).mean() + 0.1 * out["alpha"].mean()
            + 0.01 * out["depth"].mean())
    grads = dict(zip(params, torch.autograd.grad(
        loss, list(params.values()), allow_unused=True)))
    return out, grads


@pytest.mark.parametrize("aniso", [False, True])
def test_band_route_through_the_sharded_sort(aniso):
    """The band route over 4 ranks, now binning through the sharded sort,
    against every rank binning the whole image (the same projected sets):
    image, alpha and depth bitwise, each band's stream counter its own band's
    (they add up to the whole image's), and the parameters' gradients
    within rel-L2 1e-6."""
    jg, jcam = jax_scene(aniso)
    params, alive = numpy_scene(jg)
    g = convert.gaussians_from_numpy(params, alive)
    cam = port_camera(jcam)
    settings = tren.RenderSettings(image_height=SIZE, image_width=SIZE,
                                   tile_size=TS, bg_color=(0.2, 0.4, 0.6))
    new, g_new = band_route(g, cam, settings, True)
    old, g_old = band_route(g, cam, settings, False)
    for k in ("image", "alpha", "depth"):
        assert torch.equal(new[k], old[k]), k
    whole = old["n_live"][0]
    assert old["n_live"] == [whole] * N
    assert sum(new["n_live"]) == whole and max(new["n_live"]) < whole
    for k, a in g_old.items():
        if a is None:
            assert g_new[k] is None, k
            continue
        rel = float((g_new[k] - a).double().norm() / a.double().norm())
        assert rel <= 1e-6, (k, rel)
