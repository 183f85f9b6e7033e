"""The plain reference against the measured package at a tiny size on the
CPU (the package runs its kernels' plain versions there): a frame, and a
train step's loss, gradients and Adam update, leaf by leaf; and the
reference's rates, the paper's."""

import dataclasses
import math

import pytest
import torch
from conftest import SEED, tiny_cell

from harness import scene
from reference import train as ref
from reference.projection import Camera as RefCamera


def _setup(name, n=1500):
    cell = tiny_cell(name, n=n)
    params = scene.make_gaussians(cell.config, SEED, "cpu")
    views = scene.train_views(cell.config, SEED, "cpu")
    return cell, params, views


def _port(params, views, i, cfg_tile, bg):
    from mini3dgs_tpu_torch.core.camera import Camera
    from mini3dgs_tpu_torch.core.gaussians import Gaussians
    from mini3dgs_tpu_torch.ops.renderer import RenderSettings
    R, T = views.poses[i]
    cam = Camera.create(i, R, T, views.fovx, views.fovy, views.width,
                        views.height, image=views.targets[i])
    n = params["xyz"].shape[0]
    g = Gaussians(**params, alive=torch.ones(n, dtype=torch.bool))
    st = RenderSettings(image_height=views.height, image_width=views.width,
                        bg_color=bg, tile_size=cfg_tile, color_mode="sh",
                        sh_degree=3, raster="tiles")
    return g, cam, st


def _ref_settings(bg, lrs=(), delay_steps=0):
    return ref.Settings(tile_size=32, bg=bg, sh_degree=3, radius_min=0.01,
                        radius_max=50.0, lrs=lrs, position_lr_init=1.6e-4,
                        position_lr_final=1.6e-6,
                        position_lr_delay_steps=delay_steps,
                        position_lr_delay_mult=0.01,
                        position_lr_max_steps=30000)


def test_position_rate_decays_exponentially():
    st = _ref_settings((0.0, 0.0, 0.0))
    assert ref.position_lr(st, 0) == pytest.approx(1.6e-4)
    assert ref.position_lr(st, 15000) == pytest.approx(1.6e-5)
    assert ref.position_lr(st, 30000) == pytest.approx(1.6e-6)
    assert ref.position_lr(st, 40000) == pytest.approx(1.6e-6)
    ramp = _ref_settings((0.0, 0.0, 0.0), delay_steps=100)
    assert ref.position_lr(ramp, 0) == pytest.approx(1.6e-6)
    assert ref.position_lr(ramp, 100) == pytest.approx(
        ref.position_lr(st, 100))


def test_frame_matches_the_port():
    from mini3dgs_tpu_torch.ops.renderer import render
    cell, params, views = _setup("mipnerf360_outdoor.render")
    bg = (0.0, 0.0, 0.0)
    for i in range(3):
        g, cam, st = _port(params, views, i, 32, bg)
        want = render(g, cam, st)["image"]
        R, T = views.poses[i]
        rc = RefCamera.from_pose(R, T, views.fovx, views.fovy, views.width,
                                 views.height, "cpu")
        got = ref.render(params, rc, _ref_settings(bg))[0]
        assert (got - want).abs().max() < 2e-5


def test_train_step_matches_the_port_but_for_the_rates():
    """Loss and gradients agree; each leaf's Adam update is the
    reference's times the measured package's rate over the paper's (every
    group on the cosine factor, the SH rest terms at the feature rate)."""
    from mini3dgs_tpu_torch.config import TrainingConfig
    from mini3dgs_tpu_torch.train import trainer as T
    cell, params, views = _setup("nerf_synthetic_800.train")
    bg = (1.0, 1.0, 1.0)
    g, cam, st = _port(params, views, 2, 32, bg)
    cfg = TrainingConfig(device="cpu", background_color=list(bg))
    state = T.create_train_state(g, cfg)
    state = state.replace(opt_state=dataclasses.replace(
        state.opt_state, sched_count=15000))
    new, metrics = T.train_step(state, cam, cfg, st)
    lrs = {"features_dc": cfg.feature_lr,
           "features_rest": cfg.feature_lr / 20.0,
           "opacity": cfg.opacity_lr, "scaling": cfg.scaling_lr,
           "rotation": cfg.rotation_lr}
    R, Tc = views.poses[2]
    rc = RefCamera.from_pose(R, Tc, views.fovx, views.fovy, views.width,
                             views.height, "cpu")
    rs = _ref_settings(bg, tuple(lrs.items()))
    loss, grads = ref.loss_and_grads(params, rc, views.targets[2], rs)
    assert abs(float(loss) - float(metrics["total_loss"])) < 1e-6
    p1, st1 = ref.adam(params, grads, ref.AdamState(
        0, 15000, {k: torch.zeros_like(v) for k, v in params.items()},
        {k: torch.zeros_like(v) for k, v in params.items()}), rs)
    # the port's rate at schedule step 15,000 of 30,000: the cosine halfway
    cos = (1.6e-6 + (1.6e-4 - 1.6e-6) * 0.5 * (1.0 + math.cos(math.pi / 2))
           ) / 1.6e-4
    port = dict(lrs, xyz=cos * 1.6e-4, features_rest=cos * cfg.feature_lr,
                **{k: cos * v for k, v in lrs.items()
                   if k != "features_rest"})
    paper = dict(lrs, xyz=ref.position_lr(rs, 15001))
    for k in ref.PARAMS:
        g_port = new.opt_state.mu[k] / (1.0 - ref.B1)
        scale = grads[k].abs().max() + 1e-12
        assert (g_port - grads[k]).abs().max() / scale < 1e-4, k
        # Adam's first step is about the rate times sign(g): where g is
        # near zero the sign can differ, so compare the whole update
        step = new.gaussians.params()[k] - params[k]
        want = (p1[k] - params[k]) * (port[k] / paper[k])
        assert (step - want).norm() / want.norm() < 1e-3, k
