"""Parity of the port's core math (mini3dgs_tpu_torch.core, convert, utils)
with the JAX package on identical numpy inputs.  Also holds the scene and
camera helpers the other test_torch_* files share.

Tolerance: rtol 1e-6 (float32 elementwise math in the same order on both
sides; what is left is libm ulps: XLA's sqrt differs from torch's by an ulp
on ~12% of inputs), plus atol 5e-7, a few ulps of 1.0, for entries that are
differences of O(1) terms such as 1 - 2(y^2 + z^2)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini3dgs_tpu.core import camera as jcam
from mini3dgs_tpu.core import gaussians as jgauss
from mini3dgs_tpu.core import sh as jsh
from mini3dgs_tpu.core import transforms as jtf
from mini3dgs_tpu.utils import metrics as jmetrics
from mini3dgs_tpu.utils import vis as jvis
from mini3dgs_tpu_torch import convert
from mini3dgs_tpu_torch.core import camera as tcam
from mini3dgs_tpu_torch.core import sh as tsh
from mini3dgs_tpu_torch.core import transforms as ttf
from mini3dgs_tpu_torch.utils import metrics as tmetrics
from mini3dgs_tpu_torch.utils import vis as tvis

RTOL, ATOL = 1e-6, 5e-7


def t2n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def random_params(n=200, capacity=256, seed=0, spread=0.6, zmin=0.5,
                  zmax=4.0, sh_scale=0.3):
    """Seeded full-capacity parameter arrays: anisotropic, randomly rotated
    splats in front of an identity camera, with degree-3 SH rest features.
    Dead slots follow the JAX pool's convention (tiny scale, ~0 opacity)."""
    rng = np.random.default_rng(seed)
    p = dict(xyz=np.zeros((capacity, 3), np.float32),
             features_dc=np.zeros((capacity, 1, 3), np.float32),
             features_rest=np.zeros((capacity, 15, 3), np.float32),
             scaling=np.full((capacity, 3), -10.0, np.float32),
             rotation=np.tile(np.float32([1, 0, 0, 0]), (capacity, 1)),
             opacity=np.full((capacity, 1), -10.0, np.float32))
    p["xyz"][:n] = np.concatenate(
        [rng.uniform(-spread, spread, (n, 2)), rng.uniform(zmin, zmax, (n, 1))],
        axis=1)
    p["features_dc"][:n] = rng.normal(0.0, 1.0, (n, 1, 3))
    p["features_rest"][:n] = rng.normal(0.0, sh_scale, (n, 15, 3))
    p["scaling"][:n] = np.log(rng.uniform(0.01, 0.12, (n, 3)))
    p["rotation"][:n] = rng.standard_normal((n, 4))
    p["opacity"][:n] = rng.uniform(-2.0, 3.0, (n, 1))
    alive = np.zeros(capacity, bool)
    alive[:n] = True
    return p, alive


def jax_gaussians(params, alive):
    C = alive.shape[0]
    return jgauss.Gaussians(
        **{k: jnp.asarray(v) for k, v in params.items()},
        alive=jnp.asarray(alive), xyz_gradient_accum=jnp.zeros(C),
        denom=jnp.zeros(C), max_radii2D=jnp.zeros(C))


def camera_pair(R=np.eye(3), T=np.zeros(3), fov_deg=60.0, width=56,
                height=40):
    """The same view as a JAX and a port camera."""
    fov = math.radians(fov_deg)
    return (jcam.Camera.create(0, R, T, fov, fov, width=width, height=height),
            convert.camera_from_numpy(R, T, fov, fov, width, height))


def test_transforms_match_jax():
    q = np.random.default_rng(1).standard_normal((64, 4)).astype(np.float32)
    for a, b in zip(jtf.quat_to_rotmat_components(jnp.asarray(q)),
                    ttf.quat_to_rotmat_components(torch.from_numpy(q))):
        np.testing.assert_allclose(t2n(b), np.asarray(a), RTOL, ATOL)
    np.testing.assert_allclose(t2n(ttf.normalize_quat(torch.from_numpy(q))),
                               np.asarray(jtf.normalize_quat(jnp.asarray(q))),
                               RTOL, ATOL)
    x = np.random.default_rng(2).uniform(0.01, 0.99, 64).astype(np.float32)
    np.testing.assert_allclose(t2n(ttf.inverse_sigmoid(torch.from_numpy(x))),
                               np.asarray(jtf.inverse_sigmoid(jnp.asarray(x))),
                               RTOL, ATOL)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_matches_jax(degree):
    rng = np.random.default_rng(degree)
    coeffs = rng.normal(0, 1, (128, 16, 3)).astype(np.float32)
    dirs = rng.standard_normal((128, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    for jf, tf in ((jsh.eval_sh, tsh.eval_sh), (jsh.sh_to_rgb, tsh.sh_to_rgb)):
        np.testing.assert_allclose(
            t2n(tf(degree, torch.from_numpy(coeffs), torch.from_numpy(dirs))),
            np.asarray(jf(degree, jnp.asarray(coeffs), jnp.asarray(dirs))),
            RTOL, 1e-6)


def test_cameras_match_jax():
    """view_matrix, camera_center and float32 focals of turntable views."""
    jc = jvis.turntable_cameras(5, radius=3.5, height=0.7, width=72,
                                image_height=40, fov_deg=50.0)
    tc = tvis.turntable_cameras(5, radius=3.5, height=0.7, width=72,
                                image_height=40, fov_deg=50.0)
    for a, b in zip(jc, tc):
        assert (a.width, a.height, a.uid) == (b.width, b.height, b.uid)
        np.testing.assert_array_equal(t2n(b.view_matrix),
                                      np.asarray(a.view_matrix))
        np.testing.assert_array_equal(t2n(b.R), np.asarray(a.R))
        np.testing.assert_allclose(t2n(b.camera_center),
                                   np.asarray(a.camera_center), RTOL, 1e-6)
        for f in ("fx", "fy", "FoVx", "FoVy"):
            assert getattr(b, f).dtype == torch.float32
            np.testing.assert_allclose(t2n(getattr(b, f)),
                                       np.asarray(getattr(a, f)), RTOL)


def test_gaussians_activations_match_jax():
    params, alive = random_params(n=50, capacity=64)
    jg = jax_gaussians(params, alive)
    tg = convert.gaussians_from_numpy(params, alive)
    assert tg.capacity == 64 and tg.num_alive() == 50
    for name in ("get_scaling", "get_rotation", "get_opacity",
                 "get_features"):
        np.testing.assert_allclose(t2n(getattr(tg, name)),
                                   np.asarray(getattr(jg, name)), RTOL, ATOL)
    np.testing.assert_array_equal(t2n(tg.alive), np.asarray(jg.alive))


def test_flagship_scene_matches_graft_entry():
    """flagship_scene_numpy rebuilds __graft_entry__._scene array for array."""
    from __graft_entry__ import _scene
    jg, jc = _scene(capacity=300, n=200, width=40, height=30, seed=3)
    params, alive, cam = convert.flagship_scene_numpy(300, 200, seed=3)
    for k, v in params.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jg, k)), k)
    np.testing.assert_array_equal(alive, np.asarray(jg.alive))
    tc = convert.camera_from_numpy(**cam, width=40, height=30)
    np.testing.assert_array_equal(t2n(tc.view_matrix),
                                  np.asarray(jc.view_matrix))
    np.testing.assert_array_equal(t2n(tc.FoVx), np.asarray(jc.FoVx))


def test_metrics_match_jax():
    rng = np.random.default_rng(4)
    a, b = rng.random((2, 3, 16, 16)).astype(np.float32)
    for jf, tf in ((jmetrics.mse, tmetrics.mse), (jmetrics.psnr,
                                                   tmetrics.psnr)):
        np.testing.assert_allclose(
            float(tf(torch.from_numpy(a), torch.from_numpy(b))),
            float(jf(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


# ---- the reference-parity API: SH helpers, covariance chain, projection
# matrices and point projection.  Tolerance rtol 1e-5, atol 1e-6 (float32
# matrix products whose sums both sides may order differently).
CORE_RTOL, CORE_ATOL = 1e-5, 1e-6
PROJ_CASES = [
    (math.radians(60), math.radians(60), 640, 480),
    (math.radians(90), math.radians(70), 800, 800),
    (math.radians(35), math.radians(45), 1024, 768),
]


def test_sh_helpers_match_jax():
    for d in range(4):
        assert tsh.num_sh_coeffs(d) == jsh.num_sh_coeffs(d) == (d + 1) ** 2
    rgb = np.random.default_rng(5).random((64, 3)).astype(np.float32)
    np.testing.assert_allclose(t2n(tsh.rgb_to_sh_dc(torch.from_numpy(rgb))),
                               np.asarray(jsh.rgb_to_sh_dc(jnp.asarray(rgb))),
                               CORE_RTOL, CORE_ATOL)


def test_covariance_chain_matches_jax():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((64, 4)).astype(np.float32)
    s = rng.uniform(0.01, 0.5, (64, 3)).astype(np.float32)
    view = np.linalg.qr(rng.standard_normal((3, 3)))[0].astype(np.float32)
    J = rng.normal(0, 2.0, (64, 2, 3)).astype(np.float32)
    R = ttf.quat_to_rotmat(torch.from_numpy(q))
    np.testing.assert_allclose(t2n(R), np.asarray(jtf.quat_to_rotmat(
        jnp.asarray(q))), CORE_RTOL, CORE_ATOL)
    np.testing.assert_allclose(t2n(R @ R.transpose(-1, -2)),
                               np.broadcast_to(np.eye(3), (64, 3, 3)),
                               atol=1e-5)
    cov = ttf.build_covariance_3d(torch.from_numpy(s), torch.from_numpy(q))
    jcov = jtf.build_covariance_3d(jnp.asarray(s), jnp.asarray(q))
    np.testing.assert_allclose(t2n(cov), np.asarray(jcov), CORE_RTOL,
                               CORE_ATOL)
    cov2 = ttf.project_covariance_2d(cov, torch.from_numpy(view),
                                     torch.from_numpy(J))
    jcov2 = jtf.project_covariance_2d(jcov, jnp.asarray(view), jnp.asarray(J))
    assert cov2.shape == (64, 2, 2)
    np.testing.assert_allclose(t2n(cov2), np.asarray(jcov2), CORE_RTOL,
                               CORE_ATOL)


@pytest.mark.parametrize("fovx,fovy,w,h", PROJ_CASES)
def test_projection_matrices_match_jax(fovx, fovy, w, h):
    P1 = tcam.build_projection_matrix_v1(0.1, 1000.0, fovx, fovy)
    P2 = tcam.build_projection_matrix_v2(0.1, 1000.0, fovx, fovy, w, h)
    np.testing.assert_allclose(t2n(P1), np.asarray(
        jcam.build_projection_matrix_v1(0.1, 1000.0, fovx, fovy)),
        CORE_RTOL, CORE_ATOL)
    np.testing.assert_allclose(t2n(P2), np.asarray(
        jcam.build_projection_matrix_v2(0.1, 1000.0, fovx, fovy, w, h)),
        CORE_RTOL, CORE_ATOL)
    # the two forms agree, as tests/test_camera.py checks for JAX's
    np.testing.assert_allclose(t2n(P1), t2n(P2), atol=1e-6)


@pytest.mark.parametrize("fovx,fovy,w,h", PROJ_CASES)
def test_camera_projection_matches_jax(fovx, fovy, w, h):
    """The accessors and point projection against JAX's on a rotated,
    translated camera; NDC through v1 (the camera's) against v2."""
    rng = np.random.default_rng(w)
    R = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    R *= np.sign(np.linalg.det(R))
    T = rng.normal(0, 1, 3)
    jc = jcam.Camera.create(0, R, T, fovx, fovy, width=w, height=h)
    tc = convert.camera_from_numpy(R, T, fovx, fovy, w, h)
    for name in ("world_view_transform", "projection_matrix",
                 "full_proj_transform"):
        np.testing.assert_allclose(t2n(getattr(tc, name)),
                                   np.asarray(getattr(jc, name)),
                                   CORE_RTOL, CORE_ATOL, err_msg=name)
    # points in front of the camera: the centre plus depth along +z
    local = np.concatenate([rng.uniform(-0.5, 0.5, (32, 2)),
                            rng.uniform(1.0, 8.0, (32, 1))], axis=1)
    pts = (local @ R.T + T).astype(np.float32)
    xy = tcam.project_points(torch.from_numpy(pts), tc)
    np.testing.assert_allclose(t2n(xy), np.asarray(jcam.project_points(
        jnp.asarray(pts), jc)), CORE_RTOL, CORE_ATOL)
    ndc = tcam.project_points_ndc(torch.from_numpy(pts), tc)
    np.testing.assert_allclose(t2n(ndc), np.asarray(jcam.project_points_ndc(
        jnp.asarray(pts), jc)), CORE_RTOL, CORE_ATOL)
    assert np.isfinite(t2n(ndc)).all()
    P2 = tcam.build_projection_matrix_v2(tc.znear, tc.zfar, fovx, fovy, w, h)
    homo = torch.cat([torch.from_numpy(pts), torch.ones(32, 1)], dim=-1)
    clip2 = homo @ (P2 @ tc.view_matrix).T
    np.testing.assert_allclose(t2n(ndc), t2n(clip2[:, :3] / clip2[:, 3:4]),
                               atol=1e-6)
