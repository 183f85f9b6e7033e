"""The port's `GaussianTrainer` against the JAX package's on the CPU.

One JAX run (a module fixture, as tests/test_trainer_integration.py builds
its trainer, with the golden raster and one step per dispatch) and one
port run of the same 12 iterations: 3 turntable cameras and 1 test view
at 32x32, 60 Gaussians in a pool of 512, targets rendered from a perturbed
copy of the scene (near the render: JAX's jitted D-SSIM gradient moves by
4 % on unrelated images, tests/test_torch_train.py::step_setup), SH 3
unlocked one band every 8 steps, densify at 4 and 8, prune at 7, opacity
reset at 8 and the pool's compaction when the window closes at 8.
Both sides take the same clone jitter (`jax.random.normal` patched as in
tests/test_torch_train.py, the port's `_clone_noise` replaced).  Also
`grow_capacity` / `compact_train_state` against JAX's, and the port's
resume from a checkpoint against its uninterrupted run, bit for bit.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini3dgs_tpu import config as jconfig
from mini3dgs_tpu.data import dataset as jdataset
from mini3dgs_tpu.ops import renderer as jren
from mini3dgs_tpu.train import trainer as jtrainer
from mini3dgs_tpu_torch import config as tconfig
from mini3dgs_tpu_torch import convert
from mini3dgs_tpu_torch.core import gaussians as tgauss
from mini3dgs_tpu_torch.data import dataset as tdataset
from mini3dgs_tpu_torch.ops import renderer as tren
from mini3dgs_tpu_torch.train import checkpoint as tckpt
from mini3dgs_tpu_torch.train import optimizer as toptim
from mini3dgs_tpu_torch.train import trainer as ttrainer
from mini3dgs_tpu_torch.core.loss import ssim
from mini3dgs_tpu_torch.utils import vis as tvis
from mini3dgs_tpu_torch.utils.metrics import psnr
from tests.test_torch_core import t2n
from tests.test_torch_train import jax_gaussians, jax_opt_numpy

PARAMS = tgauss.PARAM_NAMES
STATS = tgauss.STAT_NAMES
EVENTS = ("n_split", "n_clone", "n_pruned", "n_dropped", "n_alive")
SIZE, CAPACITY, N = 32, 512, 60
BG = [0.2, 0.4, 0.6]
CONFIG = dict(
    capacity=CAPACITY, image_height=SIZE, image_width=SIZE, tile_size=16,
    color_mode="sh", sh_degree=3, sh_increase_interval=8, iterations=12,
    log_interval=1, eval_interval=12, densify_from_iter=4, densify_interval=4,
    densify_until_iter=8, densify_grad_threshold=1e-6, prune_interval=7,
    opacity_reset_interval=8, background_color=BG, position_lr_max_steps=100,
    use_pallas=False)


def scene():
    """60 Gaussians of the flagship scene made anisotropic (an isotropic
    splat's true rotation gradient is 0, and both sides would compare
    noise), 40 % of them at the split size, SH rest features, and 30 % of
    them near the prune threshold (logit -5.1, opacity 0.0061)."""
    p, a, _ = convert.flagship_scene_numpy(CAPACITY, N, seed=0)
    rng = np.random.default_rng(1)
    p["scaling"][:N][rng.random(N) < 0.4] = math.log(0.2)
    p["scaling"][:N] += np.log([1.0, 0.8, 0.6])
    p["features_rest"][:N] = rng.normal(0, 0.2, (N, 15, 3))
    p["opacity"][:N] = rng.uniform(-1, 2, (N, 1))
    p["opacity"][:N][rng.random(N) < 0.3] = -5.1
    target = {k: v.copy() for k, v in p.items()}
    rng = np.random.default_rng(9)
    for k, s in (("xyz", 0.05), ("features_dc", 0.3), ("opacity", 0.5)):
        target[k][:N] += rng.normal(0, s, target[k][:N].shape)
    return p, a, target


def noise_for(capacity):
    """The clone jitter of a densify event in a pool of `capacity`."""
    return np.random.default_rng(capacity).normal(size=(capacity, 3)) \
        .astype(np.float32)


def port_trainer(output, **over):
    """The port's trainer on the shared scene and cameras, jitter
    injected."""
    p, a, target = scene()
    cfg = tconfig.TrainingConfig(**{**CONFIG, **over}, device="cpu",
                                 output_path=str(output))
    cams = tvis.turntable_cameras(4, radius=4.0, width=SIZE,
                                  image_height=SIZE)
    ds = tdataset.CameraDataset("<test>")
    ds.cameras = [c.replace(image=torch.from_numpy(t))
                  for c, t in zip(cams, targets())]
    ds.train_cameras, ds.test_cameras = ds.cameras[:3], ds.cameras[3:]
    t = ttrainer.GaussianTrainer(cfg)
    t.setup(dataset=ds, gaussians=convert.gaussians_from_numpy(p, a))
    t._clone_noise = lambda it, cap: torch.from_numpy(noise_for(cap))
    return t


def jax_cameras():
    from mini3dgs_tpu.utils import vis as jvis
    return jvis.turntable_cameras(4, radius=4.0, width=SIZE,
                                  image_height=SIZE)


def targets():
    """The four views of the perturbed scene as numpy images (rendered by
    the port's golden compositor; both trainers get these arrays)."""
    _, a, target = scene()
    st = tren.RenderSettings(image_height=SIZE, image_width=SIZE,
                             tile_size=16, color_mode="sh", sh_degree=3,
                             bg_color=tuple(BG), raster="golden")
    g = convert.gaussians_from_numpy(target, a)
    with torch.no_grad():
        return [t2n(tren.render(g, c, st)["image"]) for c in
                tvis.turntable_cameras(4, radius=4.0, width=SIZE,
                                       image_height=SIZE)]


def run(trainer, **kw):
    log = {}
    trainer.train(log_fn=lambda it, m: log.__setitem__(it, m), **kw)
    return log


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX trainer, its log, port trainer, its log), 12 iterations each."""
    tmp = tmp_path_factory.mktemp("trainer")
    p, a, _ = scene()
    jcfg = jconfig.TrainingConfig(**CONFIG, output_path=str(tmp / "jax"),
                                  save_interval=10 ** 9, steps_per_call=1)
    ds = jdataset.CameraDataset("<test>")
    ds.cameras = [c.replace(image=jnp.asarray(t))
                  for c, t in zip(jax_cameras(), targets())]
    ds.train_cameras, ds.test_cameras = ds.cameras[:3], ds.cameras[3:]
    jt = jtrainer.GaussianTrainer(jcfg)
    jt.setup(dataset=ds, gaussians=jax_gaussians(p, a))
    real_normal = jax.random.normal
    jax.random.normal = lambda key, shape: jnp.asarray(noise_for(shape[0]))
    try:
        jlog = run(jt)
    finally:
        jax.random.normal = real_normal
    pt = port_trainer(tmp / "port", save_interval=6)
    plog = run(pt)
    return jt, jlog, pt, plog, tmp


def test_events_and_counts_match_jax(runs):
    """The same events at the same iterations with the same counts, the
    pool compacted 512 -> 256 at 8, and every event kind present."""
    jt, jlog, pt, plog, _ = runs
    assert sorted(plog) == sorted(jlog) == list(range(1, 13))
    for it in jlog:
        got = {k: plog[it][k] for k in EVENTS if k in plog[it]}
        want = {k: jlog[it][k] for k in EVENTS if k in jlog[it]}
        assert got == want, it
    assert plog[4]["n_split"] > 0 and plog[8]["n_clone"] > 0
    assert plog[7]["n_pruned"] > 0
    assert pt.state.gaussians.capacity == jt.state.gaussians.capacity == 256
    assert pt.state.gaussians.num_alive() == int(jt.state.gaussians.num_alive())
    np.testing.assert_array_equal(t2n(pt.state.gaussians.alive),
                                  np.asarray(jt.state.gaussians.alive))
    assert pt.iteration == jt.iteration == pt.state.step == 12
    assert pt.active_sh_degree() == jt.active_sh_degree() == 1
    assert pt.scene_extent == pytest.approx(jt.scene_extent, rel=1e-6)
    assert pt.config == dataclasses.replace(
        pt.config, **{f.name: getattr(jt.config, f.name)
                      for f in dataclasses.fields(pt.config)
                      if f.name not in ("output_path", "save_interval",
                                        "device", *tconfig.PORT_ONLY_KEYS)})


def test_losses_match_jax(runs):
    """Logged losses within rtol 1e-4 (measured 3.3e-5 at most; one step
    agrees to 1e-4 in tests/test_torch_train.py), every logged metric
    present on both sides, the stream counters exactly."""
    jt, jlog, pt, plog, _ = runs
    for it in jlog:
        assert set(plog[it]) == set(jlog[it]), it
        for k in ("l1", "dssim", "total_loss"):
            np.testing.assert_allclose(plog[it][k], jlog[it][k], rtol=1e-4,
                                       err_msg=f"{it} {k}")
        for k in ("render_drops", "render_instances", "n_visible"):
            assert plog[it][k] == jlog[it][k], (it, k)
    np.testing.assert_allclose(pt.train_losses, jt.train_losses, rtol=1e-4)


def test_final_parameters_match_jax(runs):
    """Parameters after 12 iterations, in units of each group's learning
    rate (Adam's step is of order 1 in those units whatever the gradient's
    size): within 1e-2 of a step everywhere (measured 3.1e-3 at most),
    Adam moments and statistic buffers within 1e-3 of the tensor's largest
    entry (measured 1.5e-4), counts exactly.  Empty slots are equal."""
    jt, _, pt, _, _ = runs
    cfg = pt.config
    lrs = toptim.group_lrs(cfg)
    factor = toptim.schedule_factor(cfg, pt.state.opt_state.sched_count - 1)
    got, alive, got_s = convert.gaussians_to_numpy(pt.state.gaussians)
    # the slots the compaction left empty (slots pruned later keep their
    # last, trained values)
    empty = np.asarray(jt.state.gaussians.opacity)[:, 0] == -10.0
    assert empty.sum() > 50 and not (empty & alive).any()
    want_opt = jax_opt_numpy(jt.state.opt_state)
    got_opt = convert.adam_state_to_numpy(pt.state.opt_state)
    assert (got_opt["count"], got_opt["sched_count"]) == \
        (want_opt["count"], want_opt["sched_count"]) == (12, 12)
    for k in PARAMS:
        want = np.asarray(getattr(jt.state.gaussians, k))
        err = np.abs(got[k].astype(np.float64) - want) / (lrs[k] * factor)
        assert err.max() <= 1e-2, (k, err.max())
        np.testing.assert_array_equal(got[k][empty], want[empty])
        for slot in ("mu", "nu"):
            w = want_opt[slot][k]
            np.testing.assert_allclose(got_opt[slot][k], w, rtol=0,
                                       atol=1e-3 * np.abs(w).max(),
                                       err_msg=f"{slot} {k}")
    for k in STATS:
        want = np.asarray(getattr(jt.state.gaussians, k))
        np.testing.assert_allclose(got_s[k], want, rtol=0,
                                   atol=1e-3 * max(np.abs(want).max(), 1e-30),
                                   err_msg=k)


def test_validate_matches_jax(runs):
    """validate(): PSNR within 1e-3 dB, SSIM within 5e-5 (measured 4e-6
    and 6e-6), and the validation inside the run too."""
    jt, _, pt, _, _ = runs
    got, want = pt.validate(), jt.validate()
    assert abs(got["psnr"] - want["psnr"]) < 1e-3
    assert abs(got["ssim"] - want["ssim"]) < 5e-5
    assert len(pt.val_losses) == len(jt.val_losses) == 1
    assert abs(pt.val_losses[0] - jt.val_losses[0]) < 1e-3


def test_validate_renders_each_view_at_its_size(runs):
    """A test view of another size than the training views is rendered
    at its own size (the JAX trainer's rule)."""
    _, _, pt, _, _ = runs
    (cam,) = pt.dataset.test_cameras
    small = convert.camera_from_numpy(t2n(cam.R), t2n(cam.T),
                                      float(cam.FoVx), float(cam.FoVy), 24,
                                      20)
    st = pt.settings.replace(image_height=20, image_width=24)
    with torch.no_grad():
        img = tren.render(pt.state.gaussians, small, st)["image"]
    target = img * 0.9
    pt.dataset.test_cameras = [small.replace(image=target)]
    try:
        got = pt.validate()
    finally:
        pt.dataset.test_cameras = [cam]
    assert got["psnr"] == pytest.approx(float(psnr(img, target)), abs=1e-9)
    assert got["ssim"] == pytest.approx(float(ssim(img, target)), abs=1e-9)


def test_resume_is_bitwise(runs, tmp_path):
    """The port's run saved at 6 and resumed by a new trainer gives the
    uninterrupted run's state and losses bit for bit; the compacted
    checkpoint of 12 loads into a 512-slot trainer as 256 slots and is not
    compacted again."""
    _, _, pt, plog, tmp = runs
    out = tmp / "port"
    assert tckpt.latest_checkpoint_iteration(str(out)) == 12
    assert tckpt.checkpoint_capacity(str(out), 6) == 512
    assert tckpt.checkpoint_capacity(str(out), 12) == 256
    assert tckpt.checkpoint_capacity(str(out), 7) is None
    r = port_trainer(out, save_interval=10 ** 9)
    r.load_checkpoint(6)
    assert r.iteration == 6 and not r._state_compacted
    rlog = run(r, iterations=6)
    assert r.iteration == 12
    assert sorted(rlog) == list(range(7, 13))
    for it in rlog:
        assert rlog[it] == plog[it], it
    a, b = r.state, pt.state
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for k in PARAMS + STATS + ("alive",):
        assert torch.equal(getattr(a.gaussians, k), getattr(b.gaussians, k)), k
    for k in PARAMS:
        assert torch.equal(a.opt_state.mu[k], b.opt_state.mu[k])
        assert torch.equal(a.opt_state.nu[k], b.opt_state.nu[k])
    c = port_trainer(out)
    c.load_checkpoint(12)
    assert c.state.gaussians.capacity == 256 and c._state_compacted


def jax_train_state(capacity, n, seed):
    """A JAX TrainState with random moments and statistic buffers, and the
    port's from the same numpy arrays."""
    p, a, _ = convert.flagship_scene_numpy(capacity, n, seed=seed)
    a[np.random.default_rng(seed).random(capacity) < 0.2] = False
    rng = np.random.default_rng(seed + 1)
    stats = {k: rng.random(capacity).astype(np.float32) for k in STATS}
    jc = jconfig.TrainingConfig(capacity=capacity)
    js = jtrainer.create_train_state(jax_gaussians(p, a, stats), jc)
    mu = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
    nu = {k: np.abs(rng.normal(size=v.shape)).astype(np.float32)
          for k, v in p.items()}
    js = js.replace(opt_state=(js.opt_state[0]._replace(
        count=jnp.int32(5), mu={k: jnp.asarray(v) for k, v in mu.items()},
        nu={k: jnp.asarray(v) for k, v in nu.items()}),) + js.opt_state[1:])
    ts = ttrainer.TrainState(
        gaussians=convert.gaussians_from_numpy(p, a, stats=stats),
        opt_state=convert.adam_state_from_numpy(**jax_opt_numpy(js.opt_state)),
        step=0)
    return js, ts


def assert_states_equal(ts, js):
    got, alive, got_s = convert.gaussians_to_numpy(ts.gaussians)
    np.testing.assert_array_equal(alive, np.asarray(js.gaussians.alive))
    for k in PARAMS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(js.gaussians, k)))
    for k in STATS:
        np.testing.assert_array_equal(got_s[k], np.asarray(getattr(js.gaussians, k)))
    want, mine = jax_opt_numpy(js.opt_state), \
        convert.adam_state_to_numpy(ts.opt_state)
    for slot in ("mu", "nu"):
        for k in PARAMS:
            np.testing.assert_array_equal(mine[slot][k], want[slot][k])
    assert mine["count"] == want["count"]


@pytest.mark.parametrize("op,arg", [("grow", 96), ("compact", None),
                                    ("compact", 64)])
def test_capacity_changes_match_jax(op, arg):
    """grow_capacity and compact_train_state equal JAX's exactly: the pool,
    the statistic buffers and the Adam moments slot for slot."""
    js, ts = jax_train_state(64, 50, seed=21)
    if op == "grow":
        jout, tout = jtrainer.grow_capacity(js, arg), \
            ttrainer.grow_capacity(ts, arg)
        assert tout.gaussians.capacity == 96
    else:
        jout, tout = jtrainer.compact_train_state(js, arg), \
            ttrainer.compact_train_state(ts, arg)
    assert_states_equal(tout, jout)
    with pytest.raises(ValueError):
        ttrainer.grow_capacity(ts, 32)
