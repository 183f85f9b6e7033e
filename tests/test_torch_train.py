"""The port's training slice against the JAX package on the CPU: the
learning-rate schedule and Adam against optax, density control against
`train/density.py`, one whole train step against `make_step_body` from a
shared non-zero numpy state on both raster paths, a short run whose loss
falls, and the entry point.

State crosses as numpy through `convert` (parameters, statistic buffers,
optax's `ScaleByAdamState` and schedule count); the clone jitter is drawn
once with numpy and handed to both packages.  Each test states its
tolerance.
"""

import dataclasses
import importlib.util
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini3dgs_tpu import config as jconfig
from mini3dgs_tpu.core import gaussians as jgauss
from mini3dgs_tpu.ops import renderer as jren
from mini3dgs_tpu.train import density as jdensity
from mini3dgs_tpu.train import optimizer as joptim
from mini3dgs_tpu.train import trainer as jtrainer
from mini3dgs_tpu_torch import config as tconfig
from mini3dgs_tpu_torch import convert
from mini3dgs_tpu_torch.core import gaussians as tgauss
from mini3dgs_tpu_torch.ops import cuda_library
from mini3dgs_tpu_torch.ops import renderer as tren
from mini3dgs_tpu_torch.train import density as tdensity
from mini3dgs_tpu_torch.train import exposure as texposure
from mini3dgs_tpu_torch.train import optimizer as toptim
from mini3dgs_tpu_torch.train import trainer as ttrainer
from tests.test_torch_core import camera_pair, random_params, t2n

REPO = Path(__file__).resolve().parent.parent
PARAMS = tgauss.PARAM_NAMES
STATS = tgauss.STAT_NAMES


def config_pair(**kw):
    """The same hyperparameters as a JAX and a port TrainingConfig."""
    tc = tconfig.TrainingConfig(**kw)
    shared = {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)
              if f.name not in tconfig.PORT_ONLY_KEYS}
    return jconfig.TrainingConfig(**shared), tc


def jax_gaussians(params, alive, stats=None):
    C = alive.shape[0]
    stats = stats or {k: np.zeros(C, np.float32) for k in STATS}
    return jgauss.Gaussians(
        **{k: jnp.asarray(v) for k, v in params.items()},
        **{k: jnp.asarray(v) for k, v in stats.items()},
        alive=jnp.asarray(alive))


def jax_scene_numpy(jg):
    return ({k: np.array(getattr(jg, k)) for k in PARAMS},
            np.array(jg.alive), {k: np.array(getattr(jg, k)) for k in STATS})


def jax_opt_numpy(opt_state):
    """optax's chain state as the arguments of convert.adam_state_from_numpy."""
    adam, sched = opt_state[0], opt_state[2]
    return dict(count=int(adam.count), sched_count=int(sched.count),
                mu={k: np.array(v) for k, v in adam.mu.items()},
                nu={k: np.array(v) for k, v in adam.nu.items()})


def test_config_fields_and_defaults_match_jax():
    """Every field of the port's TrainingConfig but `PORT_ONLY_KEYS` exists
    in the JAX package's with the same default; those keep the JAX
    package's behaviour at their defaults (the cosine schedule)."""
    jd, td = jconfig.TrainingConfig(), tconfig.TrainingConfig()
    for f in dataclasses.fields(td):
        if f.name in tconfig.PORT_ONLY_KEYS:
            assert not hasattr(jd, f.name), f.name
            continue
        assert getattr(td, f.name) == getattr(jd, f.name), f.name
    assert td.lr_schedule == "cosine"


# ---- schedule and Adam --------------------------------------------------

@pytest.mark.parametrize("delay_steps,max_steps", [(0, 30000), (100, 30000),
                                                   (0, 0), (50, 200)])
def test_cosine_delay_lr_matches_jax(delay_steps, max_steps):
    """rtol 1e-6: the port evaluates in float64, JAX in float32."""
    for step in (0, 1, 37, 100, 199, 200, 10000, 30000, 40000):
        want = float(joptim.cosine_delay_lr(step, 1.6e-4, 1.6e-6, delay_steps,
                                            0.01, max_steps))
        got = toptim.cosine_delay_lr(step, 1.6e-4, 1.6e-6, delay_steps, 0.01,
                                     max_steps)
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(step))


def test_group_lrs_match_jax():
    jc, tc = config_pair(feature_lr=0.003, opacity_lr=0.04)
    assert toptim.group_lrs(tc) == joptim.group_lrs(jc)


def test_adam_updates_match_optax_from_carried_state():
    """Three updates from a non-zero carried state (count 5, schedule count
    5, random moments) with fresh gradients each time.  Parameters agree to
    1e-5 of the parameter's learning rate plus float32 ulps of the value
    (optax takes the bias correction 1 - 0.999^t in float32, which for small
    t carries a relative error near 1e-5; the port takes it in float64);
    moments to rtol 1e-6; counts exactly."""
    jc, tc = config_pair(position_lr_max_steps=40, position_lr_delay_steps=20)
    rng = np.random.default_rng(0)
    shapes = dict(xyz=(32, 3), features_dc=(32, 1, 3),
                  features_rest=(32, 15, 3), scaling=(32, 3),
                  rotation=(32, 4), opacity=(32, 1))
    draw = lambda s=1.0: {k: (rng.normal(size=v) * s).astype(np.float32)
                          for k, v in shapes.items()}
    params, mu = draw(), draw(1e-3)
    nu = {k: np.abs(v) * 1e-3 for k, v in draw(1e-3).items()}

    tx = joptim.make_optimizer(jc)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    jstate = (jstate[0]._replace(
        count=jnp.int32(5), mu={k: jnp.asarray(v) for k, v in mu.items()},
        nu={k: jnp.asarray(v) for k, v in nu.items()}), jstate[1],
        jstate[2]._replace(count=jnp.int32(5)))
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = convert.adam_state_from_numpy(**jax_opt_numpy(jstate))
    lrs = toptim.group_lrs(tc)
    for _ in range(3):
        grads = draw(1e-2)
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                jstate, jparams)
        jparams = {k: jparams[k] + upd[k] for k in jparams}
        tparams, tstate = toptim.adam_update(
            tparams, {k: torch.from_numpy(v) for k, v in grads.items()},
            tstate, lrs, toptim.schedule_factor(tc, tstate.sched_count))
    want = jax_opt_numpy(jstate)
    got = convert.adam_state_to_numpy(tstate)
    assert (got["count"], got["sched_count"]) == (8, 8) \
        == (want["count"], want["sched_count"])
    for k in shapes:
        np.testing.assert_allclose(t2n(tparams[k]), np.asarray(jparams[k]),
                                   rtol=3e-7, atol=1e-5 * lrs[k], err_msg=k)
        np.testing.assert_allclose(got["mu"][k], want["mu"][k], rtol=1e-6,
                                   atol=1e-12)
        np.testing.assert_allclose(got["nu"][k], want["nu"][k], rtol=1e-6,
                                   atol=1e-12)


def test_reset_adam_slots_matches_jax():
    jc, _ = config_pair()
    rng = np.random.default_rng(1)
    params = {k: jnp.asarray(rng.normal(size=(16,) + s).astype(np.float32))
              for k, s in dict(xyz=(3,), opacity=(1,)).items()}
    tx = joptim.make_optimizer(jc)
    jstate = tx.init(params)
    jstate = (jstate[0]._replace(mu=params, nu=params),) + jstate[1:]
    mask = rng.random(16) < 0.4
    want = jax_opt_numpy(joptim.reset_adam_slots(jstate, jnp.asarray(mask)))
    got = convert.adam_state_to_numpy(toptim.reset_adam_slots(
        convert.adam_state_from_numpy(**jax_opt_numpy(jstate)),
        torch.from_numpy(mask)))
    for slot in ("mu", "nu"):
        for k in params:
            np.testing.assert_array_equal(got[slot][k], want[slot][k])
            assert np.all(got[slot][k][mask] == 0)


def test_exposure_matches_jax():
    from mini3dgs_tpu.train import exposure as jexposure
    np.testing.assert_array_equal(t2n(texposure.init_exposure(3)),
                                  np.asarray(jexposure.init_exposure(3)))
    rng = np.random.default_rng(2)
    M = rng.normal(size=(3, 4)).astype(np.float32)
    img = rng.random((3, 9, 7)).astype(np.float32)
    np.testing.assert_allclose(
        t2n(texposure.apply_exposure(torch.from_numpy(M),
                                     torch.from_numpy(img))),
        np.asarray(jexposure.apply_exposure(jnp.asarray(M),
                                            jnp.asarray(img))),
        rtol=1e-6, atol=1e-6)


# ---- density control ----------------------------------------------------

def density_scene(seed=0, capacity=96, n=64):
    """A pool with split candidates (big sigma), clone candidates (small
    sigma), cold Gaussians, a few nearly transparent ones and non-zero
    statistic buffers."""
    params, alive = random_params(n=n, capacity=capacity, seed=seed)
    rng = np.random.default_rng(seed + 100)
    params["scaling"][:n] = np.log(rng.choice([0.05, 0.005, 0.02], (n, 1))
                                   * rng.uniform(0.9, 1.1, (n, 3)))
    params["opacity"][5:9] = -8.0
    stats = dict(
        xyz_gradient_accum=np.where(alive, rng.uniform(0, 6e-4, capacity), 0),
        denom=np.where(alive, rng.integers(0, 3, capacity), 0),
        max_radii2D=np.where(alive, rng.uniform(0, 40, capacity), 0))
    return params, alive, {k: v.astype(np.float32) for k, v in stats.items()}


def assert_gaussians_equal(tg, jg, atol=1e-6):
    np.testing.assert_array_equal(t2n(tg.alive), np.asarray(jg.alive))
    for k in PARAMS + STATS:
        np.testing.assert_allclose(t2n(getattr(tg, k)),
                                   np.asarray(getattr(jg, k)), rtol=1e-6,
                                   atol=atol, err_msg=k)


def test_stat_norm_and_accumulate_match_jax():
    params, alive, stats = density_scene()
    rng = np.random.default_rng(3)
    C = alive.shape[0]
    xyz_grad = rng.normal(size=(C, 3)).astype(np.float32)
    vs_grad = rng.normal(size=(C, 2)).astype(np.float32)
    radii = rng.uniform(0, 50, C).astype(np.float32)
    visible = rng.random(C) < 0.6
    for space in ("viewspace", "world"):
        jc, tc = config_pair(densify_grad_space=space)
        want = jdensity.densify_stat_norm(jc, jnp.asarray(xyz_grad),
                                          jnp.asarray(vs_grad), 40, 56)
        got = tdensity.densify_stat_norm(tc, torch.from_numpy(xyz_grad),
                                         torch.from_numpy(vs_grad), 40, 56)
        np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-6)
    jg = jdensity.accumulate_grad_stats(
        jax_gaussians(params, alive, stats), want, jnp.asarray(radii),
        jnp.asarray(visible))
    tg = tdensity.accumulate_grad_stats(
        convert.gaussians_from_numpy(params, alive, stats=stats), got,
        torch.from_numpy(radii), torch.from_numpy(visible))
    assert_gaussians_equal(tg, jg)


def test_cadences_match_jax():
    jc, tc = config_pair(densify_from_iter=20, densify_until_iter=90,
                         densify_interval=10, prune_interval=15)
    for it in range(0, 130):
        assert tdensity.should_densify(it, tc) == \
            jdensity.should_densify(it, jc), it
        assert tdensity.should_prune(it, tc) == \
            jdensity.should_prune(it, jc), it


def test_prune_only_and_size_mask_match_jax():
    params, alive, stats = density_scene(seed=1)
    jc, tc = config_pair()
    jg, jn = jdensity.prune_only(jax_gaussians(params, alive, stats), jc)
    tg, tn = tdensity.prune_only(
        convert.gaussians_from_numpy(params, alive, stats=stats), tc)
    assert tn == int(jn) == 4
    assert_gaussians_equal(tg, jg)
    np.testing.assert_array_equal(
        t2n(tdensity.size_mask_quantile(tg, 0.7)),
        np.asarray(jdensity.size_mask_quantile(jg, 0.7)))


@pytest.mark.parametrize("capacity,size_prune", [(96, False), (96, True),
                                                 (70, False)])
def test_densify_and_prune_matches_jax(capacity, size_prune):
    """Identical alive masks, slots, counts and changed slots; parameters to
    1e-6.  The clone jitter is drawn once with numpy; the JAX side gets it
    by patching `jax.random.normal` for the call.  Capacity 70 overflows:
    children beyond the free slots are dropped, the same ones."""
    params, alive, stats = density_scene(seed=2, capacity=capacity)
    jc, tc = config_pair(capacity=capacity)
    noise = np.random.default_rng(5).normal(size=(capacity, 3)) \
        .astype(np.float32)
    real_normal = jax.random.normal
    jax.random.normal = lambda key, shape: jnp.asarray(noise)
    try:
        want = jdensity.densify_and_prune(
            jax_gaussians(params, alive, stats), jax.random.PRNGKey(0), 1.0,
            jc, size_prune=size_prune)
    finally:
        jax.random.normal = real_normal
    got = tdensity.densify_and_prune(
        convert.gaussians_from_numpy(params, alive, stats=stats),
        torch.from_numpy(noise), 1.0, tc, size_prune=size_prune)
    for k in ("n_split", "n_clone", "n_pruned", "n_dropped"):
        assert getattr(got, k) == int(getattr(want, k)), k
    assert got.n_split > 5 and got.n_clone > 5 and got.n_pruned > 0
    assert (got.n_dropped > 0) == (capacity == 70)
    np.testing.assert_array_equal(t2n(got.changed_slots),
                                  np.asarray(want.changed_slots))
    assert_gaussians_equal(got.gaussians, want.gaussians)


def test_reset_opacity_and_scene_extent_match_jax():
    params, alive, stats = density_scene(seed=3)
    jg = jax_gaussians(params, alive, stats)
    tg = convert.gaussians_from_numpy(params, alive, stats=stats)
    assert_gaussians_equal(tgauss.reset_opacity(tg, 0.01),
                           jgauss.reset_opacity(jg, 0.01))
    np.testing.assert_allclose(float(tgauss.scene_extent_of(tg)),
                               float(jgauss.scene_extent_of(jg)), rtol=1e-6)


# ---- the whole step -----------------------------------------------------

H, W = 40, 56


def step_setup(use_pallas, tile_size):
    """A shared state two JAX steps into training (non-zero Adam moments,
    counts and statistic buffers), as JAX objects and as the port's.

    The target is a render of a perturbed copy of the scene, not of an
    unrelated one.  The SSIM map is clamped to [0, 1]; between unrelated
    images it lies below 0 over a sixth of the pixels, and XLA's fused
    float32 evaluation then clamps a different handful of pixels than an
    unfused one: on such a pair the JAX D-SSIM gradient itself moves by 4 %
    of its largest entry between jit and no jit (the port's stays within
    1e-5 of a float64 evaluation).  On this pair it moves by 2e-4."""
    params, alive = random_params(n=100, capacity=128, seed=51)
    rng = np.random.default_rng(52)
    t_alive = alive
    t_params = {k: v.copy() for k, v in params.items()}
    for k, s in (("xyz", 0.03), ("features_dc", 0.3), ("opacity", 0.5)):
        t_params[k][:100] += rng.normal(0, s, t_params[k][:100].shape)
    jcam, tcam = camera_pair(width=W, height=H, fov_deg=70.0)
    jc, tc = config_pair(capacity=128, image_height=H, image_width=W,
                         tile_size=tile_size, color_mode="sh", sh_degree=3,
                         position_lr_max_steps=100,
                         background_color=[0.2, 0.4, 0.6])
    jc = dataclasses.replace(jc, use_pallas=use_pallas)
    common = dict(image_height=H, image_width=W, tile_size=tile_size,
                  color_mode="sh", sh_degree=3)
    jset = jren.RenderSettings(**common, use_pallas=use_pallas,
                               bg_color=jnp.asarray(tc.background_color),
                               max_instances=4096, gaussian_chunk=32)
    tset = tren.RenderSettings(**common, bg_color=tuple(tc.background_color),
                               raster="tiles" if use_pallas else "golden")
    target = np.asarray(jren.render(jax_gaussians(t_params, t_alive), jcam,
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
    return jstep, jstate, jcam, tstate, tcam, tc, tset


@pytest.mark.parametrize("use_pallas,tile_size", [(True, 16), (True, 32),
                                                  (False, 16)])
def test_train_step_matches_jax(use_pallas, tile_size):
    """One step from the shared state against `make_step_body` (Pallas in
    interpret mode at the same tile size, or the golden).  Loss and its
    parts rtol 1e-4; counters exactly.  Adam moments and statistic buffers
    within 1e-4 of the tensor's largest entry (they are linear in the
    gradients, whose render parity is 1e-3 normalised and measures 2e-5
    here).  Parameters are compared as steps in units of the learning rate
    (Adam's step is m/sqrt(v), of order 1 whatever the gradient's size, so
    it passes on the gradient's *relative* error): where sqrt(nu) is at
    least 1e-2 of the tensor's largest, within 2e-4 of a step plus 2 ulps of
    the value; everywhere within 5e-2 of a step (measured 1.5e-2 on an
    element whose gradient is 1e-4 of the largest).  Dead slots bit for bit
    unchanged."""
    jstep, jstate, jcam, tstate, tcam, tc, tset = step_setup(use_pallas,
                                                             tile_size)
    before = convert.gaussians_to_numpy(tstate.gaussians)[0]
    launches = dict(cuda_library.LAUNCHES)
    tnew, tm = ttrainer.train_step(tstate, tcam, tc, tset)
    assert cuda_library.LAUNCHES == launches
    jnew, jm = jstep(jstate, jcam)

    for k in ("l1", "dssim", "total_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    for k in ("render_drops", "render_drops_large", "render_instances",
              "render_n_large", "n_visible"):
        assert int(tm[k]) == int(jm[k]), k
    assert set(tm) == set(jm)
    assert (tm["render_instances"] > 0) == use_pallas
    assert tnew.step == int(jnew.step) == 3 and tstate.step == 2

    factor = toptim.schedule_factor(tc, tstate.opt_state.sched_count)
    lrs = toptim.group_lrs(tc)
    got_p, got_alive, got_s = convert.gaussians_to_numpy(tnew.gaussians)
    dead = ~got_alive
    want_opt = jax_opt_numpy(jnew.opt_state)
    got_opt = convert.adam_state_to_numpy(tnew.opt_state)
    assert (got_opt["count"], got_opt["sched_count"]) == (3, 3) \
        == (want_opt["count"], want_opt["sched_count"])
    for k in PARAMS:
        want = np.asarray(getattr(jnew.gaussians, k))
        unit = lrs[k] * factor
        err = np.abs(got_p[k].astype(np.float64) - want) / unit
        root_nu = np.sqrt(want_opt["nu"][k])
        firm = root_nu >= 1e-2 * root_nu.max()
        assert firm.mean() > 0.1, k
        slack = 2 * np.spacing(np.abs(want)) / unit
        assert np.all(err[firm] <= 2e-4 + slack[firm]), (k, err[firm].max())
        assert err.max() <= 5e-2, (k, err.max())
        np.testing.assert_array_equal(got_p[k][dead], before[k][dead])
        assert np.abs(got_p[k] - before[k]).max() > 0, k
        for slot in ("mu", "nu"):
            w = want_opt[slot][k]
            np.testing.assert_allclose(got_opt[slot][k], w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=f"{slot} {k}")
    for k in STATS:
        want = np.asarray(getattr(jnew.gaussians, k))
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(got_s[k], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)


@pytest.mark.parametrize("raster", ["tiles", "golden"])
def test_twenty_steps_reduce_loss(raster):
    """The scene of test_train_step_reduces_loss (64 random Gaussians, the
    target a render of a second set): after 20 steps the loss is lower, the
    step count is 20 and dead slots have not moved."""
    params, alive, cam = convert.flagship_scene_numpy(128, 64, seed=0)
    t_params, t_alive, _ = convert.flagship_scene_numpy(128, 64, seed=7)
    camera = convert.camera_from_numpy(**cam, width=32, height=32)
    settings = tren.RenderSettings(image_height=32, image_width=32,
                                   raster=raster)
    with torch.no_grad():
        target = tren.render(convert.gaussians_from_numpy(t_params, t_alive),
                             camera, settings)["image"]
    camera = camera.replace(image=target)
    cfg = tconfig.TrainingConfig(capacity=128, image_height=32,
                                 image_width=32)
    state = ttrainer.create_train_state(
        convert.gaussians_from_numpy(params, alive), cfg)
    losses = []
    for _ in range(20):
        state, m = ttrainer.train_step(state, camera, cfg, settings)
        losses.append(float(m["total_loss"]))
    assert losses[-1] < losses[0] and np.isfinite(losses).all()
    assert state.step == 20 and state.opt_state.count == 20
    got = convert.gaussians_to_numpy(state.gaussians)[0]
    for k in PARAMS:
        np.testing.assert_array_equal(got[k][~alive], params[k][~alive])
    assert float(state.gaussians.denom.max()) == 20.0


def test_densify_prune_and_reset_steps_keep_state_consistent():
    """densify_step zeroes the Adam moments of exactly the changed slots;
    prune_step those of the newly dead; the opacity reset only lowers."""
    params, alive, stats = density_scene(seed=4)
    cfg = tconfig.TrainingConfig(capacity=96)
    g = convert.gaussians_from_numpy(params, alive, stats=stats)
    state = ttrainer.create_train_state(g, cfg)
    ones = {k: torch.ones_like(v) for k, v in g.params().items()}
    state = state.replace(opt_state=toptim.AdamState(4, 4, ones, dict(ones)))
    noise = torch.from_numpy(np.random.default_rng(6).normal(
        size=(96, 3)).astype(np.float32))
    new, stats_d = ttrainer.densify_step(state, noise, 1.0, cfg)
    changed = t2n(new.gaussians.alive) != alive
    assert stats_d["n_alive"] == int(new.gaussians.alive.sum()) \
        == alive.sum() + stats_d["n_split"] + stats_d["n_clone"] \
        - stats_d["n_pruned"] - stats_d["n_dropped"]
    mu = t2n(new.opt_state.mu["xyz"])
    assert np.all(mu[changed] == 0) and (mu == 0).any(1).sum() >= changed.sum()
    assert np.all(mu[~(mu == 0).any(1)] == 1) and new.opt_state.count == 4
    assert float(new.gaussians.denom.abs().max()) == 0.0

    pruned, n = ttrainer.prune_step(state, cfg)
    gone = alive & ~t2n(pruned.gaussians.alive)
    assert n == gone.sum() == 4
    assert np.all(t2n(pruned.opt_state.nu["opacity"])[gone] == 0)
    assert np.all(t2n(pruned.opt_state.nu["opacity"])[~gone] == 1)

    reset = ttrainer.reset_opacity_step(state)
    logit = math.log(0.01 / 0.99)
    op = t2n(reset.gaussians.opacity)[:, 0]
    assert np.all(op[alive] <= logit + 1e-6)
    np.testing.assert_array_equal(op[~alive], params["opacity"][~alive, 0])


def test_state_round_trips_through_numpy():
    params, alive, stats = density_scene(seed=5)
    g = convert.gaussians_from_numpy(params, alive, stats=stats)
    p2, a2, s2 = convert.gaussians_to_numpy(g)
    for k in PARAMS:
        np.testing.assert_array_equal(p2[k], params[k])
    for k in STATS:
        np.testing.assert_array_equal(s2[k], stats[k])
    np.testing.assert_array_equal(a2, alive)
    cam = convert.camera_from_numpy(np.eye(3), np.zeros(3), 1.0, 1.0, 8, 6,
                                    image=np.ones((3, 6, 8)))
    assert cam.image.shape == (3, 6, 8) and cam.image.dtype == torch.float32


def test_train_entry_point_runs_on_cpu(capsys):
    """scripts/train_torch.py at a tiny size: JSON log lines, a densify, a
    prune and an opacity reset at the given cadences, the SH unlock, and a
    final line with a lower loss and a higher PSNR."""
    spec = importlib.util.spec_from_file_location(
        "train_torch", REPO / "scripts" / "train_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rc = mod.main(["--device", "cpu", "--iterations", "12", "--size", "48",
                   "--n-gaussians", "200", "--capacity", "256",
                   "--tile-size", "16", "--log-interval", "4",
                   "--densify-from-iter", "5", "--densify-interval", "5",
                   "--sh-increase-interval", "4", "--prune-interval", "8",
                   "--opacity-reset-interval", "10"])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    final = lines[-1]
    assert final["device"] == "cpu" and final["iterations"] == 12
    assert final["last_loss"] < final["first_loss"]
    assert final["psnr_end"] > final["psnr_start"]
    by_it = {x["iteration"]: x for x in lines[:-1]}
    assert by_it[5]["n_clone"] > 0 and by_it[10].get("opacity_reset")
    assert "n_pruned" in by_it[8] and "n_split" not in by_it[8]
    assert [by_it[i]["sh_degree"] for i in (4, 8, 12)] == [1, 2, 3]
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="--device cpu"):
            mod.main(["--iterations", "1"])
