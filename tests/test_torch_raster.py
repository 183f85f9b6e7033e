"""The port's rasterizers against the JAX package: the tile path (on the
CPU the kernel wrapper runs its plain PyTorch version) against JAX
`rasterize_tiles` with the Pallas kernel in interpret mode, the golden
against JAX's golden, the reference's analytic oracle, and the plain
version against a sequential per-instance loop on edge-case streams.

Tolerances are those of test_pallas_forward_matches_golden: image and alpha
atol 3e-5, depth atol 1e-3 (depth = D/(A+1e-6) amplifies where A is small)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini3dgs_tpu.ops import projection as jproj
from mini3dgs_tpu.ops import raster_pallas as jras
from mini3dgs_tpu.ops import raster_ref as jref
from mini3dgs_tpu_torch import convert
from mini3dgs_tpu_torch.ops import cuda_library
from mini3dgs_tpu_torch.ops import raster_cuda as tras
from mini3dgs_tpu_torch.ops import raster_ref as tref
from mini3dgs_tpu_torch.ops.renderer import RenderSettings, render
from tests.test_torch_core import (camera_pair, jax_gaussians, random_params,
                                   t2n)
from tests.test_torch_projection import torch_projected

H, W = 40, 56
BG = (0.3, 0.6, 0.9)
ATOL = {"image": 3e-5, "alpha": 3e-5, "depth": 1e-3}


def _jax_projected(seed):
    params, alive = random_params(n=120, capacity=128, seed=seed)
    jc, _ = camera_pair(width=W, height=H, fov_deg=70.0)
    return jproj.project_gaussians(jax_gaussians(params, alive), jc)


def _assert_outputs_close(t_out, j_out):
    for k, atol in ATOL.items():
        np.testing.assert_allclose(t2n(t_out[k]), np.asarray(j_out[k]),
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("tile_size", [16, 32])
def test_rasterize_tiles_matches_jax_pallas(tile_size):
    jp = _jax_projected(seed=11)
    j_out = jras.rasterize_tiles(jp, H, W, jnp.asarray(BG, jnp.float32),
                                 tile_size=tile_size, max_instances=4096,
                                 gaussian_chunk=32)
    t_out = tras.rasterize_tiles(torch_projected(jp), H, W,
                                 torch.tensor(BG), tile_size=tile_size)
    assert t_out["n_live"] == int(j_out["n_live"]) > 0
    assert float(j_out["alpha"].max()) > 0.9  # some pixels saturate
    _assert_outputs_close(t_out, j_out)


def test_golden_matches_jax_golden():
    jp = _jax_projected(seed=12)
    tp = torch_projected(jp)
    j_out = jref.rasterize_image(jp.means2d, jp.conic, jp.depth, jp.color,
                                 jp.opacity, jp.visible, H, W,
                                 jnp.asarray(BG, jnp.float32),
                                 radius=jp.radius, tile_size=16)
    t_out = tref.rasterize_image(tp.means2d, tp.conic, tp.depth, tp.color,
                                 tp.opacity, tp.visible, H, W,
                                 torch.tensor(BG), radius=tp.radius,
                                 tile_size=16, pixel_block=1000)
    _assert_outputs_close(t_out, j_out)


@pytest.mark.parametrize("raster", ["tiles", "golden"])
def test_analytic_oracle(raster):
    """Two splats on the optical axis at depths 1 and 2, opacity 0.5 each:
    alpha = 0.75, rgb = 0.5 sigmoid(c0) + 0.25 sigmoid(c1), depth = 4/3
    (reference tests/test_renderer.py:127-161)."""
    params, alive = random_params(n=2, capacity=2)
    params["xyz"][:] = [[0, 0, 1.0], [0, 0, 2.0]]
    params["scaling"][:] = math.log(0.01)
    params["rotation"][:] = [1, 0, 0, 0]
    params["features_dc"][:, 0] = [[1, 0, 0], [0, 1, 0]]
    params["opacity"][:] = 0.0  # logit(0.5)
    _, cam = camera_pair(width=64, height=64)
    out = render(convert.gaussians_from_numpy(params, alive), cam,
                 RenderSettings(64, 64, raster=raster))
    sig = lambda v: 1 / (1 + np.exp(-np.array(v, np.float64)))
    np.testing.assert_allclose(float(out["alpha"][0, 32, 32]), 0.75,
                               atol=1e-3)
    np.testing.assert_allclose(t2n(out["image"][:, 32, 32]),
                               0.5 * sig([1, 0, 0]) + 0.25 * sig([0, 1, 0]),
                               atol=1e-3)
    np.testing.assert_allclose(float(out["depth"][0, 32, 32]), 4 / 3,
                               atol=2e-2)


def _sequential_raster(stream, tile_start, tile_count, tiles_x, ts):
    """The kernel's loop, one instance at a time, in float32 numpy."""
    T = len(tile_start)
    out = np.zeros((T, 8, ts * ts), np.float32)
    i = np.arange(ts * ts)
    one = np.float32(1.0)
    for t in range(T):
        px = ((t % tiles_x) * ts + i % ts).astype(np.float32)
        py = ((t // tiles_x) * ts + i // ts).astype(np.float32)
        trans = np.ones(ts * ts, np.float32)
        acc = np.zeros((5, ts * ts), np.float32)
        for j in range(tile_start[t], tile_start[t] + tile_count[t]):
            x, y, qa, qb, qc, op, r, g, b, d = stream[:, j]
            dx, dy = px - x, py - y
            w = np.minimum(np.exp(dx * dx * qa + dx * dy * qb + dy * dy * qc),
                           one)
            alpha = np.where(w >= np.float32(1e-5), np.minimum(op * w, one),
                             np.float32(0))
            c = trans * alpha * ((one - trans) < np.float32(0.995))
            acc += c[None] * np.array([r, g, b, d, 1], np.float32)[:, None]
            trans = trans * (one - alpha)
        out[t, :5] = acc
    return out


def edge_case_stream(tile_size, tiles_x=3, tiles_y=2, seed=0):
    """A seeded instance stream over a tiles_x x tiles_y grid with the
    kernel's edge cases: an empty tile, slices that are not a multiple of
    the plain version's 64-wide chunk, alpha = 1 splats (opacity 1 centred
    on a pixel), and a tile that saturates within its first instances."""
    rng = np.random.default_rng(seed)
    counts = np.array([0, 1, 63, 65, 130, 97][:tiles_x * tiles_y], np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    n = int(counts.sum())
    tile = np.repeat(np.arange(len(counts)), counts)
    ox, oy = (tile % tiles_x) * tile_size, (tile // tiles_x) * tile_size
    s = np.zeros((10, n), np.float32)
    s[0] = ox + rng.uniform(-4, tile_size + 4, n)
    s[1] = oy + rng.uniform(-4, tile_size + 4, n)
    sig = rng.uniform(0.8, 0.6 * tile_size, (2, n))
    rho = rng.uniform(-0.6, 0.6, n)
    det = (1 - rho ** 2) * sig[0] ** 2 * sig[1] ** 2
    qa, qb, qc = sig[1] ** 2 / det, -rho * sig[0] * sig[1] / det, \
        sig[0] ** 2 / det
    s[2], s[3], s[4] = -0.5 * qa, -qb, -0.5 * qc
    s[5] = rng.uniform(0.05, 0.99, n)
    s[6:9] = rng.random((3, n))
    s[9] = np.sort(rng.uniform(0.5, 5.0, n))
    # alpha = 1: opacity 1 at an integer pixel centre of tiles 1 and 3
    for t in (1, 3):
        j = starts[t]
        s[0, j], s[1, j] = (t % tiles_x) * tile_size + 2, \
            (t // tiles_x) * tile_size + 3
        s[5, j] = 1.0
    # tile 4 saturates early: its first 20 splats are broad and opaque
    j = slice(starts[4], starts[4] + 20)
    s[2, j], s[3, j], s[4, j], s[5, j] = -1e-4, 0.0, -1e-4, 0.9
    return s, starts, counts


@pytest.mark.parametrize("tile_size", [8, 16])
def test_raster_fwd_plain_matches_sequential_loop(tile_size):
    s, starts, counts = edge_case_stream(tile_size)
    want = _sequential_raster(s, starts, counts, 3, tile_size)
    launches = dict(cuda_library.LAUNCHES)
    got = tras.raster_fwd(torch.from_numpy(s), torch.from_numpy(starts),
                          torch.from_numpy(counts), 3, tile_size)
    assert got.shape == (6, 8, tile_size * tile_size)
    assert cuda_library.LAUNCHES == launches  # CPU tensors launch nothing
    np.testing.assert_allclose(t2n(got), want, atol=3e-5, rtol=1e-5)
    assert np.all(want[0] == 0) and np.all(t2n(got)[0] == 0)  # empty tile
    assert want[4, 4].min() > 0.995                  # saturated tile
    assert np.all(t2n(got)[:, 5:] == 0)


def test_raster_fwd_rejects_bad_inputs():
    s, starts, counts = (torch.from_numpy(a) for a in edge_case_stream(16))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tras.raster_fwd(s.to("meta"), starts.to("meta"), counts.to("meta"),
                        3, 16)
    with pytest.raises(ValueError, match="float32"):
        tras.raster_fwd(s.double(), starts, counts, 3, 16)
    with pytest.raises(ValueError, match="int32"):
        tras.raster_fwd(s, starts.long(), counts, 3, 16)
    with pytest.raises(ValueError, match="whole number"):
        tras.raster_fwd(s, starts, counts, 4, 16)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No fallback: where nvcc is missing the kernel library fails to build
    and says why."""
    monkeypatch.setattr(cuda_library, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_library.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_library.kernel_library.__wrapped__()
    assert not list(tmp_path.iterdir())
