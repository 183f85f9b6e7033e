"""The port's gauss-sharded state (parallel/sharded.py: `shard_train_state`,
`gather_train_state`, `make_gauss_sharded_train_step`,
`make_gauss_sharded_render`, `make_gauss_sharded_densify_step`,
`verify_shard_grad_parity`) against the JAX package's, on identical numpy
inputs, on the CPU.

The port's ranks are CPU ranks of one process; the JAX side runs under
`shard_map` on the virtual CPU devices of tests/conftest.py with the golden
raster (the port's band render runs the tile kernels, whose plain versions
run on CPU tensors).  The two layouts keep different statistic buffers by
design, in both packages: the replicated step accumulates the radius and
visibility of camera 0, the gauss-sharded step those of each rank's own
rows under its own data camera.  The scene therefore holds a Gaussian that
only one of the two cameras sees.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini3dgs_tpu.config import TrainingConfig as JConfig
from mini3dgs_tpu.ops import renderer as jren
from mini3dgs_tpu.parallel import mesh as jmesh
from mini3dgs_tpu.parallel import sharded as jsharded
from mini3dgs_tpu.train import trainer as jtrainer
from mini3dgs_tpu_torch import convert
from mini3dgs_tpu_torch.config import TrainingConfig as TConfig
from mini3dgs_tpu_torch.ops import renderer as tren
from mini3dgs_tpu_torch.ops.projection import project_gaussians
from mini3dgs_tpu_torch.parallel import mesh as tmesh
from mini3dgs_tpu_torch.parallel import sharded as tsharded
from mini3dgs_tpu_torch.train import optimizer as toptim
from mini3dgs_tpu_torch.train import trainer as ttrainer
from tests.test_torch_core import camera_pair, random_params, t2n
from tests.test_torch_grad import assert_rows_close
from tests.test_torch_ring import _assert_steps_close
from tests.test_torch_train import (PARAMS, STATS, jax_gaussians,
                                    jax_opt_numpy, jax_scene_numpy)
from tests.test_torch_trainer import jax_train_state, port_trainer

requires_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")
SIZE, CAP, N = 32, 64, 50
# The slot seen by camera 0 only: in block 1 of 16 slots, which data rank 1
# owns, so the two layouts count it differently.
ONE = 20
POOL = PARAMS + STATS + ("alive",)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread while this module runs: its tensors are small,
    and the test run's other workers need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(data=2, tile=2):
    return tmesh.make_mesh(data, tile, devices=["cpu"])


def assert_whole_states_equal(a, b):
    """Two port TrainStates equal bit for bit."""
    assert a.step == b.step
    for k in POOL:
        assert torch.equal(getattr(a.gaussians, k), getattr(b.gaussians, k)), k
    for x, y in ((a.opt_state, b.opt_state),):
        assert (x.count, x.sched_count) == (y.count, y.sched_count)
        for k in PARAMS:
            assert torch.equal(x.mu[k], y.mu[k]) and torch.equal(x.nu[k],
                                                                 y.nu[k]), k


# ---- the layout -----------------------------------------------------------

@requires_8
def test_shard_order_matches_jax():
    """Rank (d, t) holds what JAX's `shard_train_state` puts on mesh device
    (d, t) -- global block t * data + d, not d * tile + t -- for every
    [C, ...] leaf and every Adam moment, C/n rows each; step and counts
    stay whole; the gather inverts the split bit for bit; a capacity that
    does not divide raises with the numbers."""
    js, ts = jax_train_state(CAP, 48, seed=5)
    ts = ts.replace(step=7)
    jm = jmesh.make_mesh(data=2, tile=2)
    jsh = jsharded.shard_train_state(js, jm)
    mesh = cpu_mesh()
    sh = tsharded.shard_train_state(ts, mesh)
    assert len(sh.shards) == 4 and sh.capacity == CAP and sh.step == 7
    assert sh.num_alive() == ts.gaussians.num_alive()
    assert [tsharded.gauss_block(mesh, r) for r in range(4)] == [0, 2, 1, 3]

    def on(arr, d, t):
        dev = jm.devices[d, t]
        (s,) = [s for s in arr.addressable_shards if s.device == dev]
        return np.asarray(s.data)

    for d in range(2):
        for t in range(2):
            mine = sh.shards[d * 2 + t]
            for k in POOL:
                got = t2n(getattr(mine.gaussians, k))
                assert got.shape[0] == CAP // 4
                np.testing.assert_array_equal(
                    got, on(getattr(jsh.gaussians, k), d, t), err_msg=k)
            for slot in ("mu", "nu"):
                for k in PARAMS:
                    np.testing.assert_array_equal(
                        t2n(getattr(mine.opt_state, slot)[k]),
                        on(getattr(jsh.opt_state[0], slot)[k], d, t))
            assert mine.opt_state.count == ts.opt_state.count == 5
            assert mine.step == 7
    back = tsharded.gather_train_state(sh, mesh)
    assert_whole_states_equal(back, ts)
    # the shards are copies: the split state shares no storage with `ts`
    assert sh.shards[0].gaussians.xyz.data_ptr() != ts.gaussians.xyz.data_ptr()
    odd = ttrainer.grow_capacity(ts, CAP + 2)
    with pytest.raises(ValueError, match="66 does not divide over the 4"):
        tsharded.shard_train_state(odd, mesh)


# ---- the step -------------------------------------------------------------

def two_camera_scene():
    """The shared scene: 50 random splats (random_params) of which slot ONE
    sits where the 70-degree camera sees it and the 50-degree one does not,
    and the two cameras' targets: renders of a perturbed copy (near the
    render: the JAX package's jitted D-SSIM gradient moves by 4 % on
    unrelated images, tests/test_torch_train.py::step_setup)."""
    params, alive = random_params(n=N, capacity=CAP, seed=61, spread=0.35)
    params["xyz"][ONE] = [0.55, 0.05, 1.0]
    params["scaling"][ONE] = math.log(0.02)
    params["opacity"][ONE] = 2.0
    rng = np.random.default_rng(62)
    target = {k: v.copy() for k, v in params.items()}
    for k, s in (("xyz", 0.03), ("features_dc", 0.3), ("opacity", 0.5)):
        target[k][:N] += rng.normal(0, s, target[k][:N].shape)
    return params, alive, target


def port_cameras(fovs, params_target=None, alive=None):
    """Port cameras at the origin with the given FoVs; with targets
    rendered from `params_target` through the golden raster."""
    cams = [camera_pair(width=SIZE, height=SIZE, fov_deg=f)[1] for f in fovs]
    if params_target is None:
        return cams
    st = tren.RenderSettings(image_height=SIZE, image_width=SIZE,
                             tile_size=16, color_mode="sh", sh_degree=3,
                             bg_color=(0.2, 0.4, 0.6), raster="golden")
    g = convert.gaussians_from_numpy(params_target, alive)
    with torch.no_grad():
        return [c.replace(image=tren.render(g, c, st)["image"]) for c in cams]


def port_setup(capacity=CAP):
    cfg = TConfig(capacity=capacity, image_height=SIZE, image_width=SIZE,
                  tile_size=16, color_mode="sh", sh_degree=3,
                  position_lr_max_steps=100, background_color=[0.2, 0.4, 0.6],
                  mesh_data=2, mesh_tile=2)
    st = tren.RenderSettings(image_height=SIZE, image_width=SIZE,
                             tile_size=16, color_mode="sh", sh_degree=3,
                             bg_color=(0.2, 0.4, 0.6))
    return cfg, st


def own_view(g, cams, mesh, st):
    """Per slot, in global order: the visibility and radius of each slot
    under its owner's data camera, and under camera 0."""
    kw = dict(color_mode="sh", sh_degree=3)
    projs = [project_gaussians(g, c, **kw) for c in cams]
    n = mesh.data * mesh.tile
    Cs = g.capacity // n
    owner = np.zeros(g.capacity, int)
    for r in range(n):
        b = tsharded.gauss_block(mesh, r)
        owner[b * Cs:(b + 1) * Cs] = r // mesh.tile
    vis = np.stack([t2n(p.visible) for p in projs])
    rad = np.stack([t2n(p.radius) for p in projs])
    idx = np.arange(g.capacity)
    return vis[owner, idx], rad[owner, idx], vis[0], rad[0]


@pytest.mark.parametrize("fovs", [(70.0, 70.0), (70.0, 50.0)],
                         ids=["same_camera", "distinct_cameras"])
def test_gauss_sharded_step_matches_replicated(fovs):
    """One gauss-sharded step against the port's replicated step from the
    same fresh state on a (2, 2) mesh, at the JAX package's tolerances
    (tests/test_sharding.py): loss rtol 1e-5, xyz atol 2e-5, opacity atol
    3e-3, xyz_gradient_accum atol 1e-6 / rtol 1e-4 where the two layouts'
    visibilities agree.  The statistic buffers follow each layout's rule
    exactly: `denom` is the visibility under the owner's camera (replicated:
    camera 0) and `max_radii2D` its radius there."""
    params, alive, target = two_camera_scene()
    cams = port_cameras(fovs, target, alive)
    cfg, st = port_setup()
    mesh = cpu_mesh()
    g = convert.gaussians_from_numpy(params, alive)
    fresh = lambda: ttrainer.create_train_state(g, cfg)
    rep, m_rep = tsharded.make_sharded_train_step(cfg, st, mesh)(fresh(),
                                                                   cams)
    sh0 = tsharded.shard_train_state(fresh(), mesh)
    sh1, m_sh = tsharded.make_gauss_sharded_train_step(cfg, st, mesh)(sh0,
                                                                        cams)
    assert all(s.gaussians.capacity == CAP // 4 for s in sh1.shards)
    assert sh1.step == rep.step == 1
    got = tsharded.gather_train_state(sh1, mesh)
    np.testing.assert_allclose(float(m_sh["total_loss"]),
                               float(m_rep["total_loss"]), rtol=1e-5)
    gg, rg = got.gaussians, rep.gaussians
    np.testing.assert_allclose(t2n(gg.xyz), t2n(rg.xyz), atol=2e-5)
    np.testing.assert_allclose(t2n(gg.opacity), t2n(rg.opacity), atol=3e-3)
    vis_own, rad_own, vis0, rad0 = own_view(g, cams, mesh, st)
    np.testing.assert_array_equal(t2n(gg.denom), vis_own.astype(np.float32))
    np.testing.assert_array_equal(t2n(rg.denom), vis0.astype(np.float32))
    np.testing.assert_array_equal(t2n(gg.max_radii2D), rad_own * vis_own)
    np.testing.assert_array_equal(t2n(rg.max_radii2D), rad0 * vis0)
    same = vis_own == vis0
    np.testing.assert_allclose(t2n(gg.xyz_gradient_accum)[same],
                               t2n(rg.xyz_gradient_accum)[same],
                               atol=1e-6, rtol=1e-4)
    assert np.all(t2n(gg.xyz_gradient_accum)[~vis_own] == 0)
    if fovs[0] != fovs[1]:
        # slot ONE is seen by camera 0 only, and data rank 1 owns it
        assert vis0[ONE] and not vis_own[ONE]
        assert rg.denom[ONE] == 1 and gg.denom[ONE] == 0
    for k in ("l1", "dssim", "render_drops", "render_instances"):
        np.testing.assert_allclose(float(m_sh[k]), float(m_rep[k]),
                                   rtol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def jax_steps():
    """A state two JAX golden steps into training (non-zero moments and
    statistic buffers) under camera 0, then, from it, one JAX step over a
    (2, 2) mesh with the two distinct cameras: replicated, gauss-sharded,
    and gauss-sharded with `grads_only`."""
    params, alive, target = two_camera_scene()
    common = dict(capacity=CAP, image_height=SIZE, image_width=SIZE,
                  tile_size=16, color_mode="sh", sh_degree=3,
                  position_lr_max_steps=100, background_color=[0.2, 0.4, 0.6])
    jc = JConfig(**common, use_pallas=False)
    jset = jren.RenderSettings(image_height=SIZE, image_width=SIZE,
                               tile_size=16, color_mode="sh", sh_degree=3,
                               use_pallas=False,
                               bg_color=jnp.asarray([0.2, 0.4, 0.6]))
    jcams = []
    for fov in (70.0, 50.0):
        jcam = camera_pair(width=SIZE, height=SIZE, fov_deg=fov)[0]
        img = jren.render(jax_gaussians(target, alive), jcam, jset)["image"]
        jcams.append(jcam.replace(image=img))
    jstep = jax.jit(jtrainer.make_step_body(jc, jset))
    jstate = jtrainer.create_train_state(jax_gaussians(params, alive), jc)
    for _ in range(2):
        jstate, _ = jstep(jstate, jcams[0])
    batch = jax.tree.map(lambda *x: jnp.stack(x), *jcams)
    jm = jmesh.make_mesh(data=2, tile=2)
    copy = lambda st: jax.tree.map(jnp.copy, st)
    rep = jsharded.make_sharded_train_step(jc, jset, jm)(copy(jstate), batch)
    s0 = jsharded.shard_train_state(copy(jstate), jm)
    gs = jsharded.make_gauss_sharded_train_step(jc, jset, jm, s0)(s0, batch)
    s0 = jsharded.shard_train_state(copy(jstate), jm)
    grads, _ = jsharded.make_gauss_sharded_train_step(
        jc, jset, jm, s0, grads_only=True)(s0, batch)
    p, a, s = jax_scene_numpy(jstate.gaussians)
    tstate = ttrainer.TrainState(
        gaussians=convert.gaussians_from_numpy(p, a, stats=s),
        opt_state=convert.adam_state_from_numpy(
            **jax_opt_numpy(jstate.opt_state)), step=int(jstate.step))
    tcams = [c.replace(image=torch.from_numpy(np.array(j.image)))
             for c, j in zip(port_cameras((70.0, 50.0)), jcams)]
    return dict(rep=rep, gauss=gs, grads=grads, tstate=tstate, tcams=tcams)


@requires_8
def test_gauss_sharded_step_matches_jax(jax_steps):
    """The port's gauss-sharded step against JAX's make_gauss_sharded_train_
    step, two distinct cameras (FoV 70 / 50), from a state two steps in, at
    the tolerances of test_torch_ring's ring step against JAX: loss rtol
    1e-4, parameters within 2e-4 of a learning-rate step where the second
    moment is firm and 5e-2 everywhere, `grads_only` gradients normalised
    atol 1e-3, statistic buffers within 1e-4 of the largest entry.  Slot
    ONE (seen by camera 0 only, owned by data rank 1) is not counted by
    this step, in both packages."""
    cfg, st = port_setup()
    mesh = cpu_mesh()
    ts = jax_steps["tstate"]
    cams = jax_steps["tcams"]
    sh1, tm = tsharded.make_gauss_sharded_train_step(cfg, st, mesh)(
        tsharded.shard_train_state(ts, mesh), cams)
    tgrads, tm2 = tsharded.make_gauss_sharded_train_step(
        cfg, st, mesh, grads_only=True)(tsharded.shard_train_state(ts, mesh),
                                        cams)
    jnew, jm = jax_steps["gauss"]
    for k in ("l1", "dssim", "total_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
        assert float(tm2[k]) == float(tm[k])
    jgrads = jax_steps["grads"]
    assert_rows_close([t2n(tgrads[k]) for k in PARAMS],
                      [np.asarray(jgrads[k]) for k in PARAMS], 1e-3, PARAMS)
    got = tsharded.gather_train_state(sh1, mesh)
    assert got.step == int(jnew.step) == 3
    factor = toptim.schedule_factor(cfg, ts.opt_state.sched_count)
    unit_of = {k: lr * factor for k, lr in toptim.group_lrs(cfg).items()}
    got_p, _, got_s = convert.gaussians_to_numpy(got.gaussians)
    _assert_steps_close(got_p, {k: getattr(jnew.gaussians, k)
                                for k in PARAMS},
                        jax_opt_numpy(jnew.opt_state)["nu"], unit_of,
                        2e-4, 5e-2)
    for k in STATS:
        want = np.asarray(getattr(jnew.gaussians, k))
        np.testing.assert_allclose(got_s[k], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)
    # slot ONE: counted by the 2 steps under camera 0, not by this one
    assert got_s["denom"][ONE] == np.asarray(jnew.gaussians.denom)[ONE] == 2


@requires_8
def test_replicated_step_statistics_follow_camera_0_as_jax(jax_steps):
    """The replicated step over the same distinct cameras keeps camera 0's
    radius and visibility in both packages (statistic buffers within 1e-4
    of the largest entry, loss rtol 1e-4), and on the scene's slots seen by
    one camera only the two layouts' buffers differ, in JAX as in the
    port."""
    cfg, st = port_setup()
    mesh = cpu_mesh()
    new, tm = tsharded.make_sharded_train_step(cfg, st, mesh)(
        jax_steps["tstate"], jax_steps["tcams"])
    jnew, jm = jax_steps["rep"]
    np.testing.assert_allclose(float(tm["total_loss"]),
                               float(jm["total_loss"]), rtol=1e-4)
    got_s = convert.gaussians_to_numpy(new.gaussians)[2]
    for k in STATS:
        want = np.asarray(getattr(jnew.gaussians, k))
        np.testing.assert_allclose(got_s[k], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)
    j_rep = np.asarray(jnew.gaussians.denom)
    j_gauss = np.asarray(jax_steps["gauss"][0].gaussians.denom)
    assert j_rep[ONE] == got_s["denom"][ONE] == 3 and j_gauss[ONE] == 2
    np.testing.assert_array_equal(got_s["denom"] != j_gauss, j_rep != j_gauss)


def test_densify_on_sharded_state_equals_single_device():
    """4 splits and 4 clones forced as in tests/test_sharding.py: the
    gauss-sharded densify equals the single-device densify of the gathered
    state bit for bit (slots, moments zeroed at the changed slots, counts),
    and its result is split again, C/n rows a rank."""
    params, alive, _ = two_camera_scene()
    cfg, _ = port_setup()
    mesh = cpu_mesh()
    state = ttrainer.create_train_state(
        convert.gaussians_from_numpy(params, alive), cfg)
    g = state.gaussians
    scaling = g.scaling.clone()
    scaling[0:4] = math.log(0.05)
    scaling[4:8] = math.log(0.005)
    ones = torch.zeros(CAP)
    ones[0:8] = 1.0
    rng = np.random.default_rng(3)
    state = state.replace(
        gaussians=g.replace(scaling=scaling, xyz_gradient_accum=ones,
                            denom=ones.clone()),
        opt_state=toptim.AdamState(
            count=3, sched_count=3,
            mu={k: torch.from_numpy(rng.normal(size=v.shape).astype(
                np.float32)) for k, v in g.params().items()},
            nu={k: torch.from_numpy(np.abs(rng.normal(size=v.shape)).astype(
                np.float32)) for k, v in g.params().items()}))
    noise = torch.from_numpy(rng.normal(size=(CAP, 3)).astype(np.float32))
    want, wstats = ttrainer.densify_step(state, noise, 1.0, cfg)
    sh = tsharded.shard_train_state(state, mesh)
    got, stats = tsharded.make_gauss_sharded_densify_step(cfg, mesh)(
        sh, noise, 1.0)
    assert stats == wstats
    assert (stats["n_split"], stats["n_clone"]) == (4, 4)
    assert all(s.gaussians.capacity == CAP // 4 for s in got.shards)
    assert got.num_alive() == stats["n_alive"]
    assert_whole_states_equal(tsharded.gather_train_state(got, mesh), want)


def test_gauss_sharded_render_equals_render():
    """The band render over the split pool of a (2, 2) mesh equals
    `render` of the whole pool (image, alpha, depth within 1e-6), and over
    a (1, 2) mesh with the ring (ring v1, the `t0` builds' plain versions)
    within the ring's 1e-5."""
    params, alive, _ = two_camera_scene()
    g = convert.gaussians_from_numpy(params, alive)
    (cam,) = port_cameras((70.0,))
    _, st = port_setup()
    with torch.no_grad():
        want = tren.render(g, cam, st)
        for mesh, ring, tol in ((cpu_mesh(), False, 1e-6),
                                (cpu_mesh(1, 2), True, 1e-5)):
            s = st.replace(ring=ring)
            state = ttrainer.create_train_state(g, TConfig())
            shards = tsharded.shard_train_state(state, mesh).shards
            got = tsharded.make_gauss_sharded_render(s, mesh)(
                [x.gaussians for x in shards], cam)
            for k in ("image", "alpha", "depth"):
                np.testing.assert_allclose(t2n(got[k]), t2n(want[k]),
                                           atol=tol, err_msg=f"{k} {ring}")
            assert ("seg_live" in got) == ring


@pytest.mark.parametrize("gauss_sharded", [False, True],
                         ids=["replicated", "gauss_sharded"])
def test_verify_shard_grad_parity(gauss_sharded, monkeypatch):
    """The setup-time check passes for either layout on (1, 2) and (2, 2)
    meshes (measured deviations below 1e-4 against its 0.05), and fires
    when the data axis' reduction of the loss is scaled by 2."""
    cfg = TConfig()
    for data, tile in ((1, 2), (2, 2)):
        worst = tsharded.verify_shard_grad_parity(
            cfg, cpu_mesh(data, tile), gauss_sharded=gauss_sharded)
        assert 0 <= worst < 1e-4, (data, tile, worst)
    mean = tsharded._camera_mean
    monkeypatch.setattr(tsharded, "_camera_mean", lambda t: 2 * mean(t))
    with pytest.raises(RuntimeError, match="deviates from single-device"):
        tsharded.verify_shard_grad_parity(cfg, cpu_mesh(2, 2),
                                          gauss_sharded=gauss_sharded)


def test_checkpoint_cross_load(tmp_path):
    """A gauss-sharded trainer writes the single-device layout: a
    single-device trainer loads it as the gathered state, and a
    gauss-sharded trainer loads a single-device checkpoint split over its
    ranks, both bit for bit."""
    mesh_kw = dict(use_pallas=True, mesh_data=2, mesh_tile=2,
                   shard_gauss_state=True, verify_sharding=False,
                   iterations=2, densify_from_iter=100)
    a = port_trainer(tmp_path / "a", **mesh_kw)
    a.train()
    a.save_checkpoint(2)
    whole = a.gathered_state()
    b = port_trainer(tmp_path / "a", iterations=2)
    b.load_checkpoint(2)
    assert b.mesh is None and b.iteration == 2
    assert_whole_states_equal(b.state, whole)
    b.config = b.config.__class__(**{**b.config.__dict__,
                                     "output_path": str(tmp_path / "b")})
    b.save_checkpoint(2)
    c = port_trainer(tmp_path / "b", **mesh_kw)
    c.load_checkpoint(2)
    assert isinstance(c.state, tsharded.GaussShardedState)
    assert c.iteration == 2
    assert_whole_states_equal(c.gathered_state(), whole)
    for x, y in zip(c.state.shards, a.state.shards):
        for k in POOL:
            assert torch.equal(getattr(x.gaussians, k), getattr(y.gaussians,
                                                                k)), k
