"""The port's `GaussianTrainer` over a (data, tile) mesh against the JAX
package's, on the CPU.

One JAX run (a module fixture) over a (2, 2) mesh with `shard_gauss_state`,
the golden raster and one step per dispatch, and two port runs over the
same mesh of CPU ranks (the tile kernels' plain versions), one with the
state split over the ranks and one with it replicated: the setting of
tests/test_torch_trainer.py (32x32, 3 turntable cameras and 1 test view, 60
Gaussians in a pool of 512, targets near the render, SH unlocked every 8
steps, densify at 4 and 8, prune at 7, opacity reset and the compaction at
8, 12 iterations, the same clone jitter on both sides), in which every
iteration draws two cameras, one per data rank.  The setup's gradient
self-check is off in these runs (tests/test_torch_gauss_sharded.py tests
it).  Also the fallback of `validate` to one device, a bitwise resume under
a mesh, and the compaction's capacity rounded to the mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini3dgs_tpu import config as jconfig
from mini3dgs_tpu.data import dataset as jdataset
from mini3dgs_tpu.train import trainer as jtrainer
from mini3dgs_tpu_torch import convert
from mini3dgs_tpu_torch.config import TrainingConfig as TConfig
from mini3dgs_tpu_torch.data import dataset as tdataset
from mini3dgs_tpu_torch.ops import renderer as tren
from mini3dgs_tpu_torch.parallel import sharded as tsharded
from mini3dgs_tpu_torch.train import checkpoint as tckpt
from mini3dgs_tpu_torch.train import optimizer as toptim
from mini3dgs_tpu_torch.train.trainer import GaussianTrainer
from mini3dgs_tpu_torch.core.loss import ssim
from mini3dgs_tpu_torch.utils.metrics import psnr
from tests.test_torch_core import t2n
from tests.test_torch_train import jax_gaussians, jax_opt_numpy
from tests.test_torch_trainer import (CONFIG, EVENTS, PARAMS, STATS,
                                      jax_cameras, noise_for, port_trainer,
                                      run, scene, targets)

MESH = dict(mesh_data=2, mesh_tile=2, verify_sharding=False)
LAYOUTS = ["gauss_sharded", "replicated"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread while this module runs: its tensors are small,
    and the test run's other workers need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_mesh_trainer(output, gauss_sharded=True, **over):
    return port_trainer(output, use_pallas=True,
                        shard_gauss_state=gauss_sharded, **MESH, **over)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": (trainer, log), "gauss_sharded": (trainer, log),
    "replicated": (trainer, log), "tmp": dir}, 12 iterations each."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    tmp = tmp_path_factory.mktemp("mesh_trainer")
    p, a, _ = scene()
    jcfg = jconfig.TrainingConfig(**CONFIG, **MESH, shard_gauss_state=True,
                                  output_path=str(tmp / "jax"),
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
    out = {"jax": (jt, jlog), "tmp": tmp}
    for layout in LAYOUTS:
        pt = port_mesh_trainer(tmp / layout, layout == "gauss_sharded",
                               save_interval=6)
        out[layout] = (pt, run(pt))
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
def test_events_and_counts_match_jax(runs, layout):
    """The same events at the same iterations with the same counts, the
    pool compacted 512 -> 256 at 8 (a multiple of the 4 ranks), and the
    state still split over the ranks after densify, prune, reset and
    compaction."""
    jt, jlog = runs["jax"]
    pt, plog = runs[layout]
    assert sorted(plog) == sorted(jlog) == list(range(1, 13))
    for it in jlog:
        got = {k: plog[it][k] for k in EVENTS if k in plog[it]}
        want = {k: jlog[it][k] for k in EVENTS if k in jlog[it]}
        assert got == want, it
    assert plog[4]["n_split"] > 0 and plog[8]["n_clone"] > 0
    assert plog[7]["n_pruned"] > 0
    whole = pt.gathered_state()
    assert whole.gaussians.capacity == jt.state.gaussians.capacity == 256
    np.testing.assert_array_equal(t2n(whole.gaussians.alive),
                                  np.asarray(jt.state.gaussians.alive))
    assert pt.iteration == jt.iteration == whole.step == 12
    assert pt.active_sh_degree() == jt.active_sh_degree() == 1
    if layout == "gauss_sharded":
        assert isinstance(pt.state, tsharded.GaussShardedState)
        assert [s.gaussians.capacity for s in pt.state.shards] == [64] * 4
    else:
        assert isinstance(pt.state, type(whole))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_losses_match_jax(runs, layout):
    """Logged losses within rtol 1e-4 (tests/test_torch_trainer.py's bound)
    and the drop counter exactly, on the keys both log (the port's step
    also logs `render_instances` and `n_visible`)."""
    jt, jlog = runs["jax"]
    pt, plog = runs[layout]
    for it in jlog:
        assert set(jlog[it]) <= set(plog[it]), it
        for k in ("l1", "dssim", "total_loss"):
            np.testing.assert_allclose(plog[it][k], jlog[it][k], rtol=1e-4,
                                       err_msg=f"{it} {k}")
        assert plog[it]["render_drops"] == jlog[it]["render_drops"] == 0
    np.testing.assert_allclose(pt.train_losses, jt.train_losses, rtol=1e-4)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_final_parameters_match_jax(runs, layout):
    """Parameters after 12 iterations within 1e-2 of a learning-rate step
    where the second moment is firm (sqrt(nu) >= 1e-2 of its largest;
    tests/test_torch_trainer.py's bound, measured 2.5e-3) and within 5e-2
    everywhere (test_torch_ring's bound for the tile kernels against JAX:
    the port runs the tiles route, JAX the golden raster, and a slot whose
    gradient is near 0 moves by Adam's sign-like first steps; measured
    1.03e-2 on one features_dc entry), Adam moments and statistic buffers
    within 1e-3 of the tensor's largest entry, counts exactly.  The
    replicated layout keeps camera 0's radii, the JAX run (gauss-sharded)
    those of each rank's own camera, so its `max_radii2D` is held to its
    own rule in tests/test_torch_gauss_sharded.py instead, and here only
    shown to differ."""
    jt, _ = runs["jax"]
    pt, _ = runs[layout]
    whole = pt.gathered_state()
    cfg = pt.config
    lrs = toptim.group_lrs(cfg)
    factor = toptim.schedule_factor(cfg, whole.opt_state.sched_count - 1)
    got, alive, got_s = convert.gaussians_to_numpy(whole.gaussians)
    want_opt = jax_opt_numpy(jt.state.opt_state)
    got_opt = convert.adam_state_to_numpy(whole.opt_state)
    assert (got_opt["count"], got_opt["sched_count"]) == \
        (want_opt["count"], want_opt["sched_count"]) == (12, 12)
    for k in PARAMS:
        want = np.asarray(getattr(jt.state.gaussians, k))
        err = np.abs(got[k].astype(np.float64) - want) / (lrs[k] * factor)
        root_nu = np.sqrt(want_opt["nu"][k])
        firm = root_nu >= 1e-2 * root_nu.max()
        assert err[firm].max() <= 1e-2, (k, err[firm].max())
        assert err.max() <= 5e-2, (k, err.max())
        for slot in ("mu", "nu"):
            w = want_opt[slot][k]
            np.testing.assert_allclose(got_opt[slot][k], w, rtol=0,
                                       atol=1e-3 * np.abs(w).max(),
                                       err_msg=f"{slot} {k}")
    for k in STATS:
        want = np.asarray(getattr(jt.state.gaussians, k))
        close = np.abs(got_s[k] - want).max() <= 1e-3 * np.abs(want).max()
        assert close == (layout == "gauss_sharded"
                         or k != "max_radii2D"), k


@pytest.mark.parametrize("layout", LAYOUTS)
def test_validate_matches_jax(runs, layout):
    """validate() through the mesh's band render: PSNR within 1e-3 dB and
    SSIM within 5e-5 of JAX's, equal to the single-device render of the
    gathered pool (1e-5 dB), and the validation inside the run too."""
    jt, _ = runs["jax"]
    pt, _ = runs[layout]
    got, want = pt.validate(), jt.validate()
    assert abs(got["psnr"] - want["psnr"]) < 1e-3
    assert abs(got["ssim"] - want["ssim"]) < 5e-5
    (cam,) = pt.dataset.test_cameras
    assert pt._mesh_render_fn(pt.settings) is not None
    with torch.no_grad():
        img = tren.render(pt.gathered_state().gaussians, cam,
                          pt.settings)["image"]
    assert got["psnr"] == pytest.approx(float(psnr(img, cam.image)), abs=1e-5)
    assert len(pt.val_losses) == len(jt.val_losses) == 1
    assert abs(pt.val_losses[0] - jt.val_losses[0]) < 1e-3


@pytest.mark.parametrize("gauss_sharded", [False, True],
                         ids=["replicated", "gauss_sharded"])
def test_validate_falls_back_on_an_odd_height(gauss_sharded):
    """tests/test_eval_sharded.py's case: 48 rows do not split into 2
    bands of 32-pixel tile rows, so `validate` renders the view on one
    device (from the gathered pool), with the values of that render.  The
    setup's gradient self-check runs."""
    ds = tdataset.RandomDataset(n_cameras=2, width=48, height=48)
    ds.load_cameras()
    cfg = TConfig(capacity=2048, image_height=48, image_width=48,
                  iterations=1, tile_size=32, mesh_data=1, mesh_tile=2,
                  shard_gauss_state=gauss_sharded, device="cpu")
    t = GaussianTrainer(cfg)
    t.setup(dataset=ds)
    assert t.mesh.tile == 2 and t._mesh_render_fn(t.settings) is None
    assert isinstance(t.state, tsharded.GaussShardedState) == gauss_sharded
    got = t.validate()
    cams = ds.get_test_cameras()
    with torch.no_grad():
        imgs = [tren.render(t.gathered_state().gaussians, c, t.settings)
                ["image"] for c in cams]
    assert got["psnr"] == pytest.approx(np.mean(
        [float(psnr(i, c.image)) for i, c in zip(imgs, cams)]), abs=1e-9)
    assert got["ssim"] == pytest.approx(np.mean(
        [float(ssim(i, c.image)) for i, c in zip(imgs, cams)]), abs=1e-9)


def test_resume_under_a_mesh_is_bitwise(runs, tmp_path):
    """The gauss-sharded run saved at 6 (gathered, single-device layout)
    and resumed by a new trainer over the mesh gives the uninterrupted
    run's losses and state bit for bit, shard for shard."""
    pt, plog = runs["gauss_sharded"]
    out = runs["tmp"] / "gauss_sharded"
    assert tckpt.checkpoint_capacity(str(out), 6) == 512
    r = port_mesh_trainer(out, save_interval=10 ** 9)
    r.load_checkpoint(6)
    assert r.iteration == 6 and isinstance(r.state,
                                           tsharded.GaussShardedState)
    rlog = run(r, iterations=6)
    assert sorted(rlog) == list(range(7, 13))
    for it in rlog:
        assert rlog[it] == plog[it], it
    assert r.state.step == pt.state.step == 12
    for a, b in zip(r.state.shards, pt.state.shards):
        for k in PARAMS + STATS + ("alive",):
            assert torch.equal(getattr(a.gaussians, k),
                               getattr(b.gaussians, k)), k
        for k in PARAMS:
            assert torch.equal(a.opt_state.mu[k], b.opt_state.mu[k])
            assert torch.equal(a.opt_state.nu[k], b.opt_state.nu[k])


def test_compaction_rounds_the_capacity_to_the_mesh(tmp_path):
    """Over a (3, 1) mesh the compaction rounds `compact`'s 128 slots for
    60 alive up to 129, a multiple of the 3 ranks (the JAX trainer's
    rule), and the state stays split: 43 slots a rank, the alive ones
    packed to the front in slot order."""
    p, a, _ = convert.flagship_scene_numpy(384, 60, seed=0)
    cfg = TConfig(**{**CONFIG, "capacity": 384, "use_pallas": True},
                  mesh_data=3, mesh_tile=1, shard_gauss_state=True,
                  verify_sharding=False, device="cpu",
                  output_path=str(tmp_path))
    t = GaussianTrainer(cfg, tren.RenderSettings(image_height=32,
                                                 image_width=32))
    t.setup(gaussians=convert.gaussians_from_numpy(p, a))
    assert t.state.capacity == 384
    before = t.gathered_state().gaussians
    t._maybe_compact_state()
    assert [s.gaussians.capacity for s in t.state.shards] == [43] * 3
    g = t.gathered_state().gaussians
    assert g.capacity == 129 and g.num_alive() == before.num_alive() == 60
    assert torch.equal(g.xyz[:60], before.xyz[before.alive])


def test_densify_over_a_mesh_runs_the_sharded_densify_step(tmp_path,
                                                           monkeypatch):
    """The gauss-sharded trainer's densify event (at 4) runs through
    `make_gauss_sharded_densify_step`, the trainer keeps what it returns,
    and that equals the single-device densify of the gathered state bit
    for bit."""
    from mini3dgs_tpu_torch.train.trainer import densify_step
    calls = []
    real = tsharded.make_gauss_sharded_densify_step

    def spy(config, mesh):
        step = real(config, mesh)

        def densify(state, noise, extent, size_prune=False):
            whole = tsharded.gather_train_state(state, mesh, noise.device)
            out = step(state, noise, extent, size_prune)
            calls.append((out, densify_step(whole, noise, extent, config,
                                            size_prune)))
            return out
        return densify

    monkeypatch.setattr(tsharded, "make_gauss_sharded_densify_step", spy)
    pt = port_mesh_trainer(tmp_path, save_interval=10 ** 9)
    log = run(pt, iterations=4)
    assert len(calls) == 1 and log[4]["n_clone"] + log[4]["n_split"] > 0
    (got, stats), (want, want_stats) = calls[0]
    assert got is pt.state and stats == want_stats
    whole = tsharded.gather_train_state(got, pt.mesh)
    for k in PARAMS + STATS + ("alive",):
        assert torch.equal(getattr(whole.gaussians, k),
                           getattr(want.gaussians, k)), k
    for k in PARAMS:
        assert torch.equal(whole.opt_state.mu[k], want.opt_state.mu[k]), k
        assert torch.equal(whole.opt_state.nu[k], want.opt_state.nu[k]), k
