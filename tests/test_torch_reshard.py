"""The port's ring v2 / v3 (parallel/ring.py: `distributed_ranks`,
`rank_reshard_rows`, `reshard=` / `gid_sharded=`; ops/binning.py
`bin_gaussians_ring_origin_resharded`; the gauss-sharded step with
`ring_local`) against the JAX package and against the port's ring v1, on
identical numpy inputs, on the CPU.

The port's ranks are CPU ranks of one process; the JAX side runs under
`shard_map` on the virtual CPU devices of tests/conftest.py.  Integers and
moved rows compare exactly; renders bitwise (v2 / v3 hand the kernels v1's
streams); gradients within rel-L2 1e-6 (the same terms, added in another
order).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P
from torch.utils._python_dispatch import TorchDispatchMode

from mini3dgs_tpu.config import TrainingConfig as JConfig
from mini3dgs_tpu.ops import binning as jbin
from mini3dgs_tpu.ops.renderer import RenderSettings as JSettings
from mini3dgs_tpu.parallel import mesh as jmesh
from mini3dgs_tpu.parallel import sharded as jsharded
from mini3dgs_tpu.train import trainer as jtrainer
from mini3dgs_tpu_torch import convert
from mini3dgs_tpu_torch.config import TrainingConfig as TConfig
from mini3dgs_tpu_torch.ops import binning as tbin
from mini3dgs_tpu_torch.ops import raster_cuda as tras
from mini3dgs_tpu_torch.ops import renderer as tren
from mini3dgs_tpu_torch.ops.projection import project_gaussians
from mini3dgs_tpu_torch.parallel import mesh as tmesh
from mini3dgs_tpu_torch.parallel import ring as tring
from mini3dgs_tpu_torch.parallel import sharded as tsharded
from mini3dgs_tpu_torch.train import trainer as ttrainer
from tests.test_raster_pallas import random_scene
from tests.test_render_golden import identity_camera
from tests.test_torch_core import random_params, t2n
from tests.test_torch_grad import numpy_scene, port_camera

requires_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


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


def jax_by_rank(fn, n, *arrays):
    """fn under shard_map over a (1, n) mesh, every input and output split
    by rows over the ranks."""
    spec = P(("data", "tile"))
    return jax.jit(shard_map(fn, mesh=jmesh.make_mesh(data=1, tile=n),
                             in_specs=(spec,) * len(arrays), out_specs=spec,
                             check_vma=False))(*arrays)


def blocks(x, n):
    """A numpy array's n row blocks as CPU tensors."""
    return list(torch.from_numpy(np.ascontiguousarray(x)).chunk(n))


def scene(n_live, capacity, seed, iso, behind=0):
    """A port scene of `n_live` random splats in a pool of `capacity`
    (dead slots invisible), isotropic or anisotropic; the last `behind`
    live splats sit behind the camera (culled)."""
    params, alive = random_params(n=n_live, capacity=capacity, seed=seed,
                                  spread=0.4)
    if iso:
        params["scaling"][:n_live] = params["scaling"][:n_live, :1]
        params["rotation"][:n_live] = [1.0, 0.0, 0.0, 0.0]
    if behind:
        params["xyz"][n_live - behind:n_live, 2] = -2.0
    return convert.gaussians_from_numpy(params, alive)


def project(g, size):
    cam = convert.camera_from_numpy(np.eye(3), np.zeros(3), 1.2, 1.2, size,
                                    size)
    return project_gaussians(g, cam), cam


# ---- module 1: distributed depth ranks -----------------------------------

@requires_8
def test_distributed_ranks_matches_jax():
    """n = 8, C/n = 16, with the tie classes of tests/test_ring.py across
    the ranks' borders: every row's rank equals JAX's `distributed_ranks`
    (sentinel included) and, on the visible rows, the port's replicated
    stable-sort rank."""
    n, Cs = 8, 16
    C = n * Cs
    rng = np.random.default_rng(9)
    depth = rng.uniform(1.0, 5.0, C).astype(np.float32)
    depth[3] = depth[40] = depth[77] = depth[126] = 2.5
    depth[10] = depth[11] = depth[90] = 3.25
    visible = rng.random(C) > 0.3
    visible[40] = visible[77] = True
    want = np.asarray(jax_by_rank(
        lambda d, v: jbin.distributed_ranks(d, v, "tile", n), n,
        jnp.asarray(depth), jnp.asarray(visible)))
    depth_t = torch.from_numpy(depth).requires_grad_(True)
    got = tring.distributed_ranks(list(depth_t.chunk(n)),
                                  blocks(visible, n), cpu_devices(n))
    got = t2n(torch.cat(got))
    np.testing.assert_array_equal(got, want)
    assert tring.RANK_SENTINEL == 2 ** 31 - 1
    assert np.all(got[~visible] == tring.RANK_SENTINEL)
    replicated = np.argsort(np.argsort(np.where(visible, depth, np.inf),
                                       kind="stable"), kind="stable")
    np.testing.assert_array_equal(got[visible], replicated[visible])


# ---- module 2: the rank reshard ------------------------------------------

@requires_8
@pytest.mark.parametrize("jax_fn", ["dense", "compact"])
def test_rank_reshard_rows_matches_jax(jax_fn):
    """Rows and the gradient of sum(out^2) with respect to them equal JAX's
    `rank_reshard_rows` (a permutation of the ranks, every range loaded
    unevenly) or `rank_reshard_rows_compact` with an ample bucket (a third
    of the rows carrying the sentinel, so some ranks arrive nowhere and
    their rows are zero), exactly."""
    n, Cs, R = 8, 64, 14
    C = n * Cs
    rng = np.random.default_rng(5)
    mat = rng.standard_normal((C, R)).astype(np.float32)
    depth = rng.standard_normal(C) + np.arange(C) / C * 2.0
    rank = np.argsort(np.argsort(depth)).astype(np.int32)
    if jax_fn == "dense":
        fn = lambda m, r: jbin.rank_reshard_rows(m, r, "tile", n)
    else:
        rank[rng.random(C) < 0.33] = tring.RANK_SENTINEL
        fn = lambda m, r: jbin.rank_reshard_rows_compact(m, r, "tile", n,
                                                         Cs)[0]

    def grad_of(m, r):
        # each rank's own sum: the ranks' cotangents together are those of
        # the sum over the ranks (a psum here would scale them by n)
        return jax.grad(lambda x: jnp.square(fn(x, r)).sum())(m)

    want = np.asarray(jax_by_rank(fn, n, jnp.asarray(mat), jnp.asarray(rank)))
    want_g = np.asarray(jax_by_rank(grad_of, n, jnp.asarray(mat),
                                    jnp.asarray(rank)))
    leaf = torch.from_numpy(mat).requires_grad_(True)
    rows, drops = tring.rank_reshard_rows(
        list(leaf.chunk(n)), [r.long() for r in blocks(rank, n)],
        cpu_devices(n))
    got = torch.cat(rows)
    np.testing.assert_array_equal(t2n(got), want)
    assert drops == 0
    (got ** 2).sum().backward()
    np.testing.assert_array_equal(t2n(leaf.grad), want_g)
    if jax_fn == "compact":
        absent = ~np.isin(np.arange(C), rank)
        assert absent.any() and np.all(want[absent] == 0)


# ---- module 3: origin binning on rank-local rows -------------------------

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("iso", [True, False])
def test_resharded_origin_equals_v1(n, iso):
    """For every depth range, the origin binning of the rank-local rows
    (the distributed ranks and the reshard from the gid blocks, which ring
    v2 and v3 share) equals the v1 origin binning of the whole set bit for
    bit: segments, their tile ranges and the packed stream (s_rank in local
    row space, offset by the range's base).  The rank-local rows are the
    replicated stable depth order's rows of the range where visible, and
    zero rows elsewhere.  A quarter of the pool is dead and a tenth of the
    live splats lie behind the camera, so late ranges hold invisible
    rows."""
    size, ts = 64, 16
    C = 128
    g = scene(96, C, seed=17 + n, iso=iso, behind=10)
    proj, _ = project(g, size)
    devices = cpu_devices(n)
    Cs = C // n
    local = tring._rank_local_rows(
        [tbin.slice_rows(proj, slice(i * Cs, (i + 1) * Cs)) for i in range(n)],
        devices)
    order = torch.from_numpy(np.argsort(np.where(
        t2n(proj.visible), t2n(proj.depth), np.inf), kind="stable"))
    attrs = tras.instance_attrs(proj)
    total = 0
    for r in range(n):
        rb1 = tbin.bin_gaussians_ring_origin(proj, size, size, ts, r, n)
        stream1 = tbin.pack_instances(attrs, rb1)
        rb = tbin.bin_gaussians_ring_origin_resharded(
            local[r], r * Cs, C, size, size, ts, n)
        assert rb.seg_start == rb1.seg_start and rb.n_live == rb1.n_live
        assert torch.equal(rb.tile_start, rb1.tile_start)
        assert torch.equal(rb.tile_count, rb1.tile_count)
        assert torch.equal(rb.s_rank + r * Cs, rb1.s_rank)
        assert torch.equal(
            tbin.pack_instances(tras.instance_attrs(local[r]), rb), stream1)
        total += rb1.n_live
        rows = order[r * Cs:(r + 1) * Cs]
        vis = local[r].visible
        assert torch.equal(vis, proj.visible[rows])
        assert torch.equal(tring._as_rows(local[r])[vis],
                           tring._as_rows(proj)[rows][vis])
        assert not bool(tring._as_rows(local[r])[~vis].any())
    assert total == tbin.bin_gaussians(proj, size, size, ts).n_live > 200
    with pytest.raises(ValueError, match=f"not 1/{n} of the capacity"):
        tbin.bin_gaussians_ring_origin_resharded(local[0], 0, 2 * C, size,
                                                 size, ts, n)


# ---- module 4: the ring render -------------------------------------------

def ring_outputs(g, cam, size, n, route, ts=16):
    """The ring route's bands of `g` under `cam` over n CPU ranks, with
    the leaves of the parameters' gradient: route v1, v2 or v3."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in g.params().items()}
    proj = project_gaussians(g.with_params(params), cam)
    devices = cpu_devices(n)
    C = proj.means2d.shape[0]
    if route == "v3":
        Cs = C // n
        projs = [tbin.slice_rows(proj, slice(i * Cs, (i + 1) * Cs))
                 for i in range(n)]
    else:
        projs = [proj] * n
    outs = tring.ring_rasterize_bands(
        projs, size // n, size, (0.2, 0.4, 0.6), devices, tile_size=ts,
        reshard=route == "v2", gid_sharded=route == "v3")
    return outs, params


@pytest.mark.parametrize("route", ["v2", "v3"])
def test_ring_v2_v3_render_and_gradients_equal_v1(route):
    """At 64^2 over 4 ranks: image, alpha and depth of every band bitwise
    v1's, the counters v1's, and the gradient of a loss of all three with
    respect to every parameter within rel-L2 1e-6 of v1's."""
    size, n = 64, 4
    g = scene(100, 128, seed=23, iso=False, behind=8)
    _, cam = project(g, size)
    target = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (3, size // n, size)).astype(np.float32))
    grads = {}
    for r in ("v1", route):
        outs, params = ring_outputs(g, cam, size, n, r)
        loss = sum(((o["image"] - target) ** 2).mean()
                   + 0.1 * o["alpha"].mean() + 0.01 * o["depth"].mean()
                   for o in outs)
        grads[r] = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), allow_unused=True)))
        grads[r]["outs"] = outs
    for b, (o1, o) in enumerate(zip(grads["v1"].pop("outs"),
                                    grads[route].pop("outs"))):
        for k in ("image", "alpha", "depth"):
            assert torch.equal(o[k], o1[k]), (b, k)
        for k in ("n_live", "seg_live", "n_dropped", "reshard_drops"):
            assert o[k] == o1[k], (b, k)
    assert sum(o["n_live"] for o in outs) > 200
    for k, a in grads["v1"].items():
        b = grads[route][k]
        if a is None:
            assert b is None or not bool(b.any()), k
            continue
        rel = float((b - a).double().norm() / a.double().norm().clamp(
            min=1e-30))
        assert rel <= 1e-6, (k, rel)


# ---- modules 5, 6: the gauss-sharded step with ring_local ---------------

def v3_step_setup():
    """tests/test_ring.py's ring-local setting: 40 random splats, 32^2, a
    (1, 2) mesh, one camera, a seeded random target."""
    jg = random_scene(40, seed=2, spread=0.35)
    jcam = identity_camera(32, 32, 70.0)
    target = np.random.default_rng(1).uniform(0, 1, (3, 32, 32)).astype(
        np.float32)
    params, alive = numpy_scene(jg)
    tcam = port_camera(jcam).replace(image=torch.from_numpy(target))
    return jg, jcam.replace(image=jnp.asarray(target)), params, alive, tcam


@requires_8
def test_gauss_sharded_ring_local_step_matches_jax():
    """One gauss-sharded ring-v3 train step of the port against JAX's
    (capacity 64, 32^2, mesh (1, 2), ample reshard buckets): loss rtol
    1e-5, updated xyz atol 2e-5, no reshard drops; and the port's v3 step
    against its v1 step: loss and every updated parameter within the same
    bounds."""
    jg, jcam, params, alive, tcam = v3_step_setup()
    jcfg = JConfig(capacity=64, image_height=32, image_width=32,
                   use_pallas=True, max_instances=2048, gaussian_chunk=32,
                   mesh_data=1, mesh_tile=2, shard_gauss_state=True)
    jset = JSettings(image_height=32, image_width=32, use_pallas=True,
                     max_instances=2048, gaussian_chunk=32, ring=True,
                     ring_local=True, ring_reshard_capacity=32)
    jm = jmesh.make_mesh(data=1, tile=2)
    st = jsharded.shard_train_state(jtrainer.create_train_state(jg, jcfg), jm)
    st, jmet = jsharded.make_gauss_sharded_train_step(jcfg, jset, jm, st)(
        st, jax.tree.map(lambda x: jnp.stack([x]), jcam))

    tcfg = TConfig(capacity=64, image_height=32, image_width=32,
                   mesh_tile=2, shard_gauss_state=True, ring_exchange=True,
                   ring_local=True)
    mesh = tmesh.make_mesh(1, 2, devices=["cpu"])
    out = {}
    for local in (True, False):
        tset = tren.RenderSettings(image_height=32, image_width=32, ring=True,
                                   ring_local=local)
        state = tsharded.shard_train_state(ttrainer.create_train_state(
            convert.gaussians_from_numpy(params, alive), tcfg), mesh)
        new, met = tsharded.make_gauss_sharded_train_step(tcfg, tset, mesh)(
            state, [tcam])
        out[local] = (tsharded.gather_train_state(new, mesh).gaussians, met)
    g3, m3 = out[True]
    assert m3["reshard_drops"] == 0 == float(jmet["reshard_drops"])
    assert m3["render_drops"] == 0
    np.testing.assert_allclose(float(m3["total_loss"]),
                               float(jmet["total_loss"]), rtol=1e-5)
    np.testing.assert_allclose(t2n(g3.xyz), np.asarray(st.gaussians.xyz),
                               atol=2e-5)
    g1, m1 = out[False]
    np.testing.assert_allclose(float(m3["total_loss"]),
                               float(m1["total_loss"]), rtol=1e-5)
    for k in g1.params():
        np.testing.assert_allclose(t2n(getattr(g3, k)), t2n(getattr(g1, k)),
                                   atol=2e-5, err_msg=k)


class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in torch.utils._pytree.tree_leaves(out):
            if isinstance(x, torch.Tensor):
                self.shapes.append((tuple(x.shape), str(func)))
        return out


def test_ring_local_step_has_no_tensor_of_C_rows():
    """The counterpart of tests/test_ring.py's jaxpr walk: every op output
    of one gauss-sharded ring-v3 step (forward, backward, Adam) over 8 tile
    ranks, recorded with a TorchDispatchMode; C = 328 collides with no other
    size of the run.  No tensor has a dimension of C; some have C/8."""
    n, C = 8, 328
    H, W = 16 * n, 32
    rng = np.random.default_rng(3)
    params, alive = random_params(n=C, capacity=C, seed=3, spread=0.4)
    params["scaling"][:] = np.log(0.06)
    g = convert.gaussians_from_numpy(params, alive)
    cam = convert.camera_from_numpy(np.eye(3), np.zeros(3), 1.2, 1.2, W, H)
    cam = cam.replace(image=torch.from_numpy(
        rng.uniform(0, 1, (3, H, W)).astype(np.float32)))
    cfg = TConfig(capacity=C, image_height=H, image_width=W, mesh_tile=n,
                  shard_gauss_state=True, ring_exchange=True, ring_local=True)
    st = tren.RenderSettings(image_height=H, image_width=W, ring=True,
                             ring_local=True)
    mesh = tmesh.make_mesh(1, n, devices=["cpu"])
    state = tsharded.shard_train_state(ttrainer.create_train_state(g, cfg),
                                       mesh)
    step = tsharded.make_gauss_sharded_train_step(cfg, st, mesh)
    with _Shapes() as rec:
        new, metrics = step(state, [cam])
    offenders = sorted({s for s in rec.shapes if C in s[0]})
    assert not offenders, offenders[:20]
    assert any(C // n in s for s, _ in rec.shapes)
    assert float(metrics["render_instances"]) > 0
    assert metrics["reshard_drops"] == 0
    assert not torch.equal(new.shards[0].gaussians.xyz,
                           state.shards[0].gaussians.xyz)


def test_main_torch_trains_ring_v2_and_v3(tmp_path, capsys):
    """`main_torch.py` over a (1, 2) mesh trains the smoke config at 64x64
    with the JAX package's keys: `ring_exchange` and `ring_reshard` on the
    replicated state (v2), and `ring_exchange`, `shard_gauss_state` and
    `ring_local` (v3).  Both print their log and final lines, and the
    logged losses agree (rtol 1e-5: the same streams, one camera)."""
    import main_torch
    smoke = Path(__file__).resolve().parent.parent / "configs" / \
        "synthetic_smoke.yaml"
    losses = {}
    for route, keys in (("v2", "  ring_reshard: true\n"),
                        ("v3", "  shard_gauss_state: true\n"
                               "  ring_local: true\n")):
        cfg = tmp_path / f"{route}.yaml"
        cfg.write_text(smoke.read_text().replace(
            "  use_pallas: true\n",
            "  use_pallas: true\n  ring_exchange: true\n" + keys).replace(
            "image_height: 128\n  image_width: 128",
            "image_height: 64\n  image_width: 64"))
        assert main_torch.main(["--config", str(cfg), "--output",
                                str(tmp_path / route), "--device", "cpu",
                                "--mesh-tile", "2", "--iterations",
                                "5"]) == 0
        log = capsys.readouterr().out
        assert re.search(r"^final: psnr=([\d.]+) ssim=([\d.]+)$", log, re.M)
        losses[route] = float(re.search(
            r"^\[\s+5\] .*total_loss=([\d.e+-]+)", log, re.M).group(1))
    np.testing.assert_allclose(losses["v3"], losses["v2"], rtol=1e-5)
