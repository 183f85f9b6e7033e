"""Gradients of the port's render path against the JAX package, on
identical numpy inputs, on the CPU (where the kernel wrappers run their
plain PyTorch versions).

The port's backward raster (`raster_bwd_plain`, written by hand with the
CUDA kernel's masks) is held against the VJP of the JAX `raster_op` with
the Pallas kernel in interpret mode and against a sequential per-instance
loop; projection, pack and the whole `render` are held against `jax.grad`.

No scene here that is compared with JAX holds an exact tie op*w == 1 or
w == 1 (a splat of opacity 1 centred on a pixel): `jnp.minimum` passes
half the gradient at a tie and the port's strict masks none.  The edge
streams of the sequential-loop test do hold such ties; their reference
uses the kernel's masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini3dgs_tpu.ops import binning as jbin
from mini3dgs_tpu.ops import projection as jproj
from mini3dgs_tpu.ops import raster_pallas as jras
from mini3dgs_tpu.ops import renderer as jren
from mini3dgs_tpu_torch import convert
from mini3dgs_tpu_torch.ops import binning as tbin
from mini3dgs_tpu_torch.ops import cuda_library
from mini3dgs_tpu_torch.ops import projection as tproj
from mini3dgs_tpu_torch.ops import raster_cuda as tras
from mini3dgs_tpu_torch.ops import raster_ref as tref
from mini3dgs_tpu_torch.ops import renderer as tren
from tests.test_raster_pallas import random_scene
from tests.test_render_golden import identity_camera, make_gaussians
from tests.test_torch_core import (camera_pair, jax_gaussians, random_params,
                                   t2n)
from tests.test_torch_projection import torch_projected
from tests.test_torch_raster import edge_case_stream

GROUPS = ("xyz", "scaling", "rotation", "opacity", "features_dc")


def numpy_scene(jg):
    """(params, alive) numpy arrays of a JAX Gaussians."""
    return ({k: np.array(v) for k, v in jg.params().items()},
            np.array(jg.alive))


def port_camera(jc):
    return convert.camera_from_numpy(np.array(jc.R), np.array(jc.T),
                                     float(jc.FoVx), float(jc.FoVy),
                                     jc.width, jc.height)


def assert_rows_close(got, want, atol, names):
    """Each row normalised by the reference row's largest magnitude."""
    for name, a, b in zip(names, got, want):
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=atol,
                                   err_msg=str(name))


# ---- the backward raster kernel's plain version -------------------------

@pytest.mark.parametrize("tile_size", [16, 32])
def test_raster_bwd_plain_matches_jax_vjp(tile_size):
    """Same stream, ranges and cotangent through the JAX raster_op's VJP
    (Pallas `_bwd_kernel`, interpret mode) and `raster_bwd` on CPU tensors.
    Per instance row, normalised atol 1e-4: both are float32 sums over a
    tile's pixels of the same terms; JAX builds the transmittance in log
    space and the geometric rows from pixel moments, which round
    differently (measured 2e-5 here)."""
    H, W, G = 40, 56, 32
    params, alive = random_params(n=120, capacity=128, seed=31)
    jc, _ = camera_pair(width=W, height=H, fov_deg=70.0)
    jp = jproj.project_gaussians(jax_gaussians(params, alive), jc)
    jb = jbin.bin_gaussians(jp, H, W, tile_size, 4096, G)
    n_live, K = int(jb.n_live), jb.s_rank.shape[0]
    tiles_x, tiles_y = -(-W // tile_size), -(-H // tile_size)
    T, P = tiles_x * tiles_y, tile_size * tile_size
    inst = jras._widen_stream(jbin.pack_instances(
        jras.instance_attrs(jp), jb.s_rank, jb.rank_perm, jb.rank_key,
        jb.seg_start_gid, jb.counts_gid, jb.order, jb.n_live, G, 64))
    op = jras._make_raster_op(T, tiles_x, tile_size, G, K, 0, 0, True,
                              has_t0=False)
    tile_gid = jnp.arange(T, dtype=jnp.int32)
    acc_j, vjp = jax.vjp(
        lambda i: op(i, jb.tile_start, jb.tile_count, tile_gid), inst)
    gout = np.zeros((T, 8, P), np.float32)
    gout[:, :5] = np.random.default_rng(3).normal(size=(T, 5, P))
    d_j = np.asarray(vjp(jnp.asarray(gout))[0])            # [K/G, 16, G]
    d_j = d_j.transpose(1, 0, 2).reshape(16, K)[:10, :n_live]

    stream = np.asarray(inst).transpose(1, 0, 2).reshape(16, K)
    stream = torch.from_numpy(stream[:10, :n_live].copy())
    start = torch.from_numpy(np.array(jb.tile_start))
    count = torch.from_numpy(np.array(jb.tile_count))
    acc_t = tras.raster_fwd(stream, start, count, tiles_x, tile_size)
    np.testing.assert_allclose(t2n(acc_t), np.asarray(acc_j), atol=3e-5)
    launches = dict(cuda_library.LAUNCHES)
    d_t = tras.raster_bwd(stream, start, count, tiles_x, tile_size, acc_t,
                          torch.from_numpy(gout))
    assert cuda_library.LAUNCHES == launches  # CPU tensors launch nothing
    assert d_t.shape == (10, n_live) and n_live > 100
    assert_rows_close(t2n(d_t), d_j, 1e-4, range(10))


def _sequential_bwd(stream, tile_start, tile_count, tiles_x, ts, acc, gout,
                    t0=None):
    """The backward kernel's loop, one pixel and one instance at a time in
    float64 numpy, with the kernel's strict masks.  With `t0` [T, 1, P] the
    transmittance starts there, <gout, acc> takes row 5 too, and the result
    is (d, d_t0)."""
    s = stream.astype(np.float64)
    d = np.zeros_like(s)
    i = np.arange(ts * ts)
    rows = 5 if t0 is None else 6
    d_t0 = None if t0 is None else np.zeros(t0.shape)
    for t in range(len(tile_start)):
        px = ((t % tiles_x) * ts + i % ts).astype(np.float64)
        py = ((t // tiles_x) * ts + i // ts).astype(np.float64)
        g = gout[t, :5].astype(np.float64)
        total = (gout[t, :rows].astype(np.float64) * acc[t, :rows]).sum(0)
        trans = np.ones(ts * ts)
        if t0 is not None:
            # the gates see the float32 value the kernel is handed
            trans = t0[t, 0].astype(np.float64)
            d_t0[t, 0] = total / np.maximum(trans, 1e-30)
        prefix = np.zeros(ts * ts)
        for j in range(tile_start[t], tile_start[t] + tile_count[t]):
            x, y, qa, qb, qc, op, r, gg, b, dep = s[:, j]
            dx, dy = px - x, py - y
            # the gates are decided in float32, as the kernel decides them
            dx32, dy32 = dx.astype(np.float32), dy.astype(np.float32)
            lw32 = (dx32 * dx32 * stream[2, j] + dx32 * dy32 * stream[3, j]
                    + dy32 * dy32 * stream[4, j])
            w32 = np.minimum(np.exp(lw32), np.float32(1))
            w = np.minimum(np.exp(dx * dx * qa + dx * dy * qb
                                  + dy * dy * qc), 1.0)
            gate = (1.0 - trans) < 0.995
            on = gate & (w32 >= np.float32(1e-5))
            a_raw = op * w
            alpha = np.where(on, np.minimum(a_raw, 1.0), 0.0)
            wgt = trans * alpha
            u = g[0] * r + g[1] * gg + g[2] * b + g[3] * dep + g[4]
            prefix = prefix + u * wgt
            mask = on & (stream[5, j] * w32 < 1) & (a_raw > 0)
            with np.errstate(divide="ignore", invalid="ignore"):
                d_alpha = np.where(
                    mask, u * trans - (total - prefix) / (1.0 - alpha), 0.0)
            d_lw = np.where(w32 < 1, w * d_alpha * op, 0.0)
            d[0, j] = -(d_lw * (2 * dx * qa + dy * qb)).sum()
            d[1, j] = -(d_lw * (2 * dy * qc + dx * qb)).sum()
            d[2, j] = (d_lw * dx * dx).sum()
            d[3, j] = (d_lw * dx * dy).sum()
            d[4, j] = (d_lw * dy * dy).sum()
            d[5, j] = (d_alpha * w).sum()
            d[6:10, j] = (g[:4] * wgt).sum(1)
            trans = trans * (1.0 - alpha)
    return d if t0 is None else (d, d_t0)


@pytest.mark.parametrize("tile_size", [8, 16])
def test_raster_bwd_plain_matches_sequential_loop(tile_size):
    """Edge streams (an empty tile, slices that are not a multiple of the
    64-wide slice, alpha = 1 ties, a tile that saturates early) against a
    float64 loop.  Normalised atol 2e-4: S_j is a float32 difference of
    nearly equal sums, divided by 1 - alpha (measured 1e-5).  Rows behind
    a saturated tile's early exit are exactly 0."""
    s, starts, counts = edge_case_stream(tile_size)
    P = tile_size * tile_size
    args = (torch.from_numpy(s), torch.from_numpy(starts),
            torch.from_numpy(counts), 3, tile_size)
    acc = tras.raster_fwd(*args)
    gout = np.zeros((6, 8, P), np.float32)
    gout[:, :5] = np.random.default_rng(9).normal(size=(6, 5, P))
    got = t2n(tras.raster_bwd(*args, acc, torch.from_numpy(gout)))
    want = _sequential_bwd(s, starts, counts, 3, tile_size, t2n(acc), gout)
    assert np.isfinite(got).all()
    assert_rows_close(got, want, 2e-4, range(10))
    tail = slice(starts[4] + 64, starts[4] + counts[4])  # tile 4 saturates
    assert np.all(got[:, tail] == 0) and np.all(want[:, tail] == 0)
    assert np.abs(got[:, starts[4]:starts[4] + 20]).max() > 0
    # the hand-written gradient is deterministic
    again = t2n(tras.raster_bwd(*args, acc, torch.from_numpy(gout)))
    np.testing.assert_array_equal(got, again)


def test_raster_bwd_rejects_bad_inputs():
    s, starts, counts = (torch.from_numpy(a) for a in edge_case_stream(16))
    acc = torch.zeros(6, 8, 256)
    with pytest.raises(ValueError, match="accumulators"):
        tras.raster_bwd(s, starts, counts, 3, 16, acc, acc[:, :5])
    with pytest.raises(ValueError, match="accumulators"):
        tras.raster_bwd(s, starts, counts, 3, 16, acc.double(), acc)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tras.raster_bwd(*(v.to("meta") for v in (s, starts, counts)), 3, 16,
                        acc.to("meta"), acc.to("meta"))


def test_raster_op_takes_a_strided_cotangent():
    """The cotangent reaches the backward through the epilogue's permute
    and [:H, :W] slice; the hand-written gradient equals autograd of the
    differentiable plain forward on a tie-free stream (atol 1e-4
    normalised: the same sums in another order)."""
    jp = jproj.project_gaussians(
        jax_gaussians(*random_params(n=100, capacity=128, seed=33)),
        camera_pair(width=50, height=37)[0])
    tp = torch_projected(jp)
    bg = torch.tensor([0.2, 0.5, 0.7])
    grads = []
    for fwd in (tras.raster_op, tras.raster_fwd_plain):
        leaves = [f.clone().requires_grad_(True)
                  for f in (tp.means2d, tp.conic, tp.color, tp.opacity,
                            tp.depth)]
        proj = tp._replace(means2d=leaves[0], conic=leaves[1],
                           color=leaves[2], opacity=leaves[3],
                           depth=leaves[4])
        out = tras.rasterize_tiles(proj, 37, 50, bg, tile_size=16, fwd=fwd)
        loss = (out["image"] ** 2).mean() + 0.1 * out["alpha"].mean() \
            + 0.01 * out["depth"].mean()
        grads.append([t2n(g) for g in torch.autograd.grad(loss, leaves)])
    assert_rows_close(grads[0], grads[1], 1e-4,
                      ("means2d", "conic", "color", "opacity", "depth"))


# ---- projection and pack ------------------------------------------------

@pytest.mark.parametrize("color_mode,sh_degree", [("dc_sigmoid", 0),
                                                  ("sh", 3)])
def test_projection_gradients_match_jax(color_mode, sh_degree):
    """d(sum of the visible rows of every differentiable field, each with
    a seeded weight)/d(params) against jax.grad.  Normalised atol 1e-5:
    the same float32 chain differentiated by two autodiffs (measured
    1e-6).  radius, ext_x, ext_y and visible feed only the integer binning
    and must leak no NaN."""
    params, alive = random_params(n=200, capacity=256, seed=41, zmin=-0.5)
    R = np.array([[0.96, 0.0, 0.28], [0.0, 1.0, 0.0], [-0.28, 0.0, 0.96]])
    jc, tc = camera_pair(R=R, T=np.array([0.1, -0.2, -0.3]))
    kw = dict(color_mode=color_mode, sh_degree=sh_degree)
    fields = ("means2d", "conic", "depth", "color", "opacity")
    rng = np.random.default_rng(4)
    jg = jax_gaussians(params, alive)
    vis = np.asarray(jproj.project_gaussians(jg, jc, **kw).visible)
    wts = {f: rng.normal(size=np.shape(getattr(
        jproj.project_gaussians(jg, jc, **kw), f))).astype(np.float32)
        * vis.reshape((-1,) + (1,) * (f in ("means2d", "conic", "color")))
        for f in fields}

    def jloss(p):
        proj = jproj.project_gaussians(jg.with_params(p), jc, **kw)
        return sum((getattr(proj, f) * wts[f]).sum() for f in fields)

    jgrads = jax.grad(jloss)(jg.params())
    tg = convert.gaussians_from_numpy(params, alive)
    leaves = {k: v.requires_grad_(True) for k, v in tg.params().items()}
    proj = tproj.project_gaussians(tg.with_params(leaves), tc, **kw)
    loss = sum((getattr(proj, f) * torch.from_numpy(wts[f])).sum()
               for f in fields)
    names = [k for k in leaves if k != "features_rest" or sh_degree > 0]
    tgrads = torch.autograd.grad(loss, [leaves[k] for k in names])
    for g in tgrads:
        assert bool(torch.isfinite(g).all())
    assert_rows_close([t2n(g) for g in tgrads],
                      [np.asarray(jgrads[k]) for k in names], 1e-5, names)


def test_pack_backward_matches_jax():
    """d(sum(stream * weights))/d(attrs): `index_select`'s backward (an
    index_add over instances) against the JAX pack's sort-carried segmented
    sum.  atol 1e-5 normalised: both add each Gaussian's instances in
    float32, in different orders."""
    params, alive = random_params(n=150, capacity=256, seed=6)
    jc, _ = camera_pair(width=48, height=40)
    jp = jproj.project_gaussians(jax_gaussians(params, alive), jc)
    G = 32
    jb = jbin.bin_gaussians(jp, 40, 48, 16, 4096, G)
    n_live, K = int(jb.n_live), jb.s_rank.shape[0]
    wts = np.zeros((10, K), np.float32)
    wts[:, :n_live] = np.random.default_rng(8).normal(size=(10, n_live))
    jw = jnp.asarray(wts.reshape(10, K // G, G).transpose(1, 0, 2))

    def jloss(attrs):
        return (jbin.pack_instances(
            attrs, jb.s_rank, jb.rank_perm, jb.rank_key, jb.seg_start_gid,
            jb.counts_gid, jb.order, jb.n_live, G, 64) * jw).sum()

    d_j = np.asarray(jax.grad(jloss)(jras.instance_attrs(jp))).T  # [10, C]
    tp = torch_projected(jp)
    attrs = tras.instance_attrs(tp).requires_grad_(True)
    tb = tbin.bin_gaussians(tp, 40, 48, 16)
    (tbin.pack_instances(attrs, tb)
     * torch.from_numpy(wts[:, :n_live])).sum().backward()
    assert_rows_close(t2n(attrs.grad), d_j, 1e-5, range(10))


# ---- the whole render ---------------------------------------------------

def _render_grads_jax(jg, jc, loss_of, use_pallas, tile_size=16, chunk=32):
    st = jren.RenderSettings(image_height=jc.height, image_width=jc.width,
                             use_pallas=use_pallas, max_instances=4096,
                             gaussian_chunk=chunk, tile_size=tile_size)
    probe = jnp.zeros((jg.capacity, 2), jnp.float32)

    def loss(p, pr):
        return loss_of(jren.render(jg.with_params(p), jc, st,
                                   means2d_probe=pr), jnp)

    val, (gp, gprobe) = jax.value_and_grad(loss, argnums=(0, 1))(
        jg.params(), probe)
    grads = {k: np.asarray(v) for k, v in gp.items()}
    grads["probe"] = np.asarray(gprobe)
    return float(val), grads


def _render_grads_port(jg, jc, loss_of, raster, tile_size=16):
    params, alive = numpy_scene(jg)
    tg = convert.gaussians_from_numpy(params, alive)
    leaves = {k: v.requires_grad_(True) for k, v in tg.params().items()}
    probe = torch.zeros(tg.capacity, 2, requires_grad=True)
    st = tren.RenderSettings(image_height=jc.height, image_width=jc.width,
                             raster=raster, tile_size=tile_size)
    loss = loss_of(tren.render(tg.with_params(leaves), port_camera(jc), st,
                               means2d_probe=probe), torch)
    names = [k for k in leaves if k != "features_rest"]
    gs = torch.autograd.grad(loss, [leaves[k] for k in names] + [probe])
    grads = {k: t2n(g) for k, g in zip(names + ["probe"], gs)}
    return float(loss.detach()), grads


@pytest.mark.parametrize("raster", ["tiles", "golden"])
def test_render_gradients_match_jax(raster):
    """The scene and loss of test_pallas_gradients_match_golden; the port's
    tile path against JAX's Pallas path (interpret mode), its golden against
    JAX's golden, per parameter group and for the viewspace probe.
    Normalised atol 1e-3, that test's bound and reason (float32 association:
    chunked transmittance scans and the pack backward's sums round
    differently); loss rtol 1e-4."""
    jc = identity_camera(32, 32, 70.0)
    jg = random_scene(40, seed=2, spread=0.35, zmin=0.6, zmax=3.0)
    target = np.random.default_rng(0).uniform(0, 1, (3, 32, 32)) \
        .astype(np.float32)

    def loss_of(out, xp):
        tgt = xp.asarray(target) if xp is jnp else torch.from_numpy(target)
        return (((out["image"] - tgt) ** 2).mean()
                + 0.1 * out["alpha"].mean() + 0.01 * out["depth"].mean())

    lj, gj = _render_grads_jax(jg, jc, loss_of, use_pallas=raster == "tiles")
    lt, gt = _render_grads_port(jg, jc, loss_of, raster)
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    names = GROUPS + ("probe",)
    assert np.abs(gj["probe"]).max() > 0
    assert_rows_close([gt[k] for k in names], [gj[k] for k in names], 1e-3,
                      names)


def test_golden_gradients_do_not_depend_on_the_pixel_block():
    """The golden composites pixels in blocks (each chunk of Gaussians is
    recomputed in the backward pass, torch.utils.checkpoint).  Three
    blocks of 500 pixels against one block: the image is bitwise equal (a
    pixel's arithmetic does not see its block); the gradients are sums
    over pixels taken block by block, so they differ by float32
    association only, atol 1e-5 of each group's largest entry."""
    jc = identity_camera(32, 32, 70.0)
    jg = random_scene(40, seed=2, spread=0.35, zmin=0.6, zmax=3.0)
    params, alive = numpy_scene(jg)
    tg = convert.gaussians_from_numpy(params, alive)
    proj = tproj.project_gaussians(tg, port_camera(jc))
    fields = ("means2d", "conic", "depth", "color", "opacity")
    grads, images = [], []
    for pixel_block in (500, 65536):
        leaves = [getattr(proj, f).detach().requires_grad_(True)
                  for f in fields]
        out = tref.rasterize_image(*leaves, proj.visible, 32, 32,
                                   torch.zeros(3), radius=proj.radius,
                                   pixel_block=pixel_block)
        loss = ((out["image"] ** 2).mean() + 0.1 * out["alpha"].mean()
                + 0.01 * out["depth"].mean())
        grads.append([t2n(g) for g in torch.autograd.grad(loss, leaves)])
        images.append(out["image"].detach())
    assert torch.equal(images[0], images[1])
    assert all(np.abs(g).max() > 0 for g in grads[1])
    assert_rows_close(grads[0], grads[1], 1e-5, fields)


def _opaque_front_scene():
    """test_pallas_early_stop_consistency: an opaque front splat saturates
    the pixels under it."""
    n = 30
    rng = np.random.default_rng(5)
    xyz = [[0, 0, 0.5]] + np.concatenate(
        [rng.uniform(-0.2, 0.2, (n, 2)), rng.uniform(1.0, 3.0, (n, 1))],
        axis=1).tolist()
    sig = [[0.3, 0.3, 0.3]] + [[0.05] * 3] * n
    return (make_gaussians(xyz, sig, rng.uniform(0, 1, (n + 1, 3)),
                           [0.999] + [0.8] * n), None, 2e-4,
            ("xyz", "opacity"))


def _stacked_scene():
    """test_early_exit_skipped_chunks_zero_grads: 120 opaque splats stacked
    on one spot, so the centre tiles stop long before their lists end."""
    rng = np.random.default_rng(4)
    n = 120
    xyz = np.concatenate([rng.normal(0, 0.02, (n, 2)),
                          rng.uniform(0.5, 4.0, (n, 1))], axis=1)
    jg = make_gaussians(xyz, np.full((n, 3), 0.08), rng.uniform(0, 1, (n, 3)),
                        np.full(n, 0.95))
    target = rng.uniform(0, 1, (3, 32, 32)).astype(np.float32)
    return jg, target, 1e-3, ("xyz", "opacity", "scaling", "features_dc")


@pytest.mark.parametrize("scene", [_opaque_front_scene, _stacked_scene])
def test_early_stop_gradients_match_jax_golden(scene):
    """The two early-stop cases of tests/test_raster_pallas.py: the port's
    tile path (early exit, exact zeros behind it) against jax.grad of the
    JAX golden, with those tests' losses and normalised tolerances (2e-4
    and 1e-3)."""
    jg, target, atol, names = scene()
    jc = identity_camera(32, 32) if target is None \
        else identity_camera(32, 32, 70.0)

    def loss_of(out, xp):
        if target is None:
            return (out["image"] ** 2).mean()
        tgt = xp.asarray(target) if xp is jnp else torch.from_numpy(target)
        return ((out["image"] - tgt) ** 2).mean()

    _, gj = _render_grads_jax(jg, jc, loss_of, use_pallas=False)
    _, gt = _render_grads_port(jg, jc, loss_of, "tiles")
    for k in names:
        assert np.isfinite(gt[k]).all(), k
    assert_rows_close([gt[k] for k in names], [gj[k] for k in names], atol,
                      names)
