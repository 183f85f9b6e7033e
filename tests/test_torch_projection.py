"""Parity of the port's projection and instance packing with the JAX
package on identical numpy inputs.

Tolerance: rtol 1e-5 (the covariance chain compounds a dozen float32
roundings, and the two frameworks' tan/sqrt/exp differ by ulps), plus an
absolute floor of 1e-6 x the field's largest magnitude for entries that
cancel (x = fx*X/Z + cx near 0 carries ulps of cx, not of x); `visible`
must be exactly equal."""

import numpy as np
import pytest
import torch

from mini3dgs_tpu.ops import binning as jbin
from mini3dgs_tpu.ops import projection as jproj
from mini3dgs_tpu.ops import raster_pallas as jras
from mini3dgs_tpu_torch import convert
from mini3dgs_tpu_torch.ops import binning as tbin
from mini3dgs_tpu_torch.ops import cuda_library
from mini3dgs_tpu_torch.ops import projection as tproj
from mini3dgs_tpu_torch.ops import raster_cuda as tras
from tests.test_torch_core import (camera_pair, jax_gaussians, random_params,
                                   t2n)

RTOL, ATOL_SCALE = 1e-5, 1e-6
FIELDS = ("means2d", "conic", "depth", "radius", "color", "opacity", "ext_x",
          "ext_y")


def torch_projected(jp) -> tproj.Projected:
    """The JAX projection's output as the port's Projected (each stage of
    the port is fed the JAX output of the stage before it)."""
    return tproj.Projected(**{f: torch.from_numpy(np.array(getattr(jp, f)))
                              for f in tproj.Projected._fields})


@pytest.mark.parametrize("color_mode,sh_degree", [("dc_sigmoid", 0),
                                                  ("sh", 3)])
@pytest.mark.parametrize("antialias", [False, True])
def test_projection_matches_jax(color_mode, sh_degree, antialias):
    params, alive = random_params(n=300, capacity=384, seed=5, zmin=-0.5)
    R = np.array([[0.96, 0.0, 0.28], [0.0, 1.0, 0.0], [-0.28, 0.0, 0.96]])
    jc, tc = camera_pair(R=R, T=np.array([0.1, -0.2, -0.3]), width=56,
                         height=40)
    kw = dict(color_mode=color_mode, sh_degree=sh_degree,
              antialias=antialias)
    jp = jproj.project_gaussians(jax_gaussians(params, alive), jc, **kw)
    tp = tproj.project_gaussians(convert.gaussians_from_numpy(params, alive),
                                 tc, **kw)
    vis = np.asarray(jp.visible)
    assert 50 < vis.sum() < 300  # some splats behind the camera or off-image
    np.testing.assert_array_equal(t2n(tp.visible), vis)
    for f in FIELDS:
        a, b = t2n(getattr(tp, f)), np.asarray(getattr(jp, f))
        assert a.dtype == np.float32, f
        # culled rows may hold extreme values (Z -> 1e-6); compare visible
        np.testing.assert_allclose(a[vis], b[vis], RTOL,
                                   ATOL_SCALE * np.abs(b[vis]).max(),
                                   err_msg=f)


def test_instance_stream_matches_jax_pack():
    """instance_attrs + pack_instances equal the JAX stream's live rows."""
    params, alive = random_params(n=150, capacity=256, seed=6)
    jc, _ = camera_pair(width=48, height=40)
    jp = jproj.project_gaussians(jax_gaussians(params, alive), jc)
    G = 32
    jb = jbin.bin_gaussians(jp, 40, 48, 16, 4096, G)
    n_live = int(jb.n_live)
    attrs = jras.instance_attrs(jp)
    jstream = np.asarray(jbin.pack_instances(
        attrs, jb.s_rank, jb.rank_perm, jb.rank_key, jb.seg_start_gid,
        jb.counts_gid, jb.order, jb.n_live, G, 64))     # [K/G, 10, G]
    jstream = jstream.transpose(1, 0, 2).reshape(tbin.STREAM_ROWS, -1)

    tp = torch_projected(jp)
    np.testing.assert_array_equal(t2n(tras.instance_attrs(tp)),
                                  np.asarray(attrs).T)
    tb, tstream = tras.tile_stream(tp, 40, 48, 16)
    assert tb.n_live == n_live and tstream.shape == (10, n_live)
    assert tstream.is_contiguous()
    np.testing.assert_array_equal(t2n(tstream), jstream[:, :n_live])


def _pool(device="cpu"):
    params, alive, cam = convert.flagship_scene_numpy(64, 48, seed=2)
    return (convert.gaussians_from_numpy(params, alive, device),
            convert.camera_from_numpy(width=32, height=24, device=device,
                                      **cam))


@pytest.mark.parametrize("grad_mode", [True, False])
@pytest.mark.parametrize("requires_grad", ["none", "xyz", "features_rest",
                                           "camera"])
def test_the_op_records_a_graph_by_autograd(monkeypatch, grad_mode,
                                            requires_grad):
    """`project_fwd`'s one op records a graph exactly when grad mode is on
    and a parameter requires grad (the camera is a constant to it), and its
    forward gives what P1 writes.  On the CPU the kernel's launch is a fake
    that writes the plain chain's values, and the device check lets CPU
    tensors through."""
    g, camera = _pool()
    if requires_grad == "camera":
        camera = camera.replace(
            view_matrix=camera.view_matrix.clone().requires_grad_(True))
    elif requires_grad != "none":
        g = g.replace(**{requires_grad: getattr(g, requires_grad).clone()
                         .requires_grad_(True)})
    kw = dict(color_mode="sh", sh_degree=3, antialias=True)
    with torch.no_grad():
        want = tproj.project_gaussians_plain(g, camera, **kw)
    calls = []

    def fake_launch(entry, device, *args):
        calls.append(entry)
        for out, value in zip(args[-len(want):], want):
            out.copy_(value)

    monkeypatch.setattr(tproj, "launch", fake_launch)
    monkeypatch.setattr(tproj, "_check_fwd_args",
                        lambda g, camera: g.xyz.device)
    with torch.set_grad_enabled(grad_mode):
        got = tproj.project_fwd(g, camera, **kw)
    assert calls == ["project_fwd_launch"]
    graph = grad_mode and requires_grad in ("xyz", "features_rest")
    for f in tproj.Projected._fields:
        assert getattr(got, f).requires_grad == (
            graph and f in tproj.COTANGENT_FIELDS), f
    if graph:
        assert type(got.means2d.grad_fn).__name__ == "_ProjectBackward"
    for a, b in zip(got, want):
        assert torch.equal(a.detach(), b)


@pytest.mark.parametrize("grad_mode", [True, False])
def test_cpu_tensors_take_the_plain_chain(monkeypatch, grad_mode):
    """On the CPU `project_gaussians` is `project_gaussians_plain`, with or
    without a graph, and never reaches the kernel's wrapper."""
    def no_kernel(*args, **kw):
        raise AssertionError("the kernel's wrapper ran on CPU tensors")

    monkeypatch.setattr(tproj, "project_fwd", no_kernel)
    g, camera = _pool()
    kw = dict(color_mode="sh", sh_degree=3, antialias=True)
    with torch.set_grad_enabled(grad_mode):
        got = tproj.project_gaussians(g, camera, **kw)
    want = tproj.project_gaussians_plain(g, camera, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _bad_inputs(case):
    """The pool and camera of `_pool` with one thing the kernel does not
    take, and the message it raises with."""
    g, camera = _pool()
    if case == "cpu":
        return g, camera, {}, "CUDA tensors"
    if case == "float64":
        return g.replace(xyz=g.xyz.double()), camera, {}, "xyz must be float32"
    if case == "rest_rows":
        return (g.replace(features_rest=g.features_rest[:, :3].contiguous()),
                camera, {}, "features_rest must be")
    if case == "alive_dtype":
        return g.replace(alive=g.alive.float()), camera, {}, "alive must be"
    if case == "strided":
        wide = torch.zeros(g.capacity, 6)
        wide[:, :3] = g.xyz
        return g.replace(xyz=wide[:, :3]), camera, {}, "contiguous"
    if case == "camera_dtype":
        return (g, camera.replace(FoVx=camera.FoVx.double()), {},
                "camera.FoVx must be float32")
    if case == "devices":
        return (g, camera.replace(FoVy=camera.FoVy.to("meta")), {},
                "several devices")
    if case == "color_mode":
        return g, camera, {"color_mode": "rgb"}, "unknown color_mode"
    raise KeyError(case)


@pytest.mark.parametrize("case", ["cpu", "float64", "rest_rows",
                                  "alive_dtype", "strided", "camera_dtype",
                                  "devices", "color_mode"])
def test_project_fwd_rejects_what_the_kernel_does_not_take(case):
    """The wrapper checks every input before it loads the library: a CUDA
    tensor on the kernel's path launches the kernel or raises, and CPU
    tensors always raise."""
    g, camera, kw, message = _bad_inputs(case)
    before = dict(cuda_library.LAUNCHES)
    with pytest.raises(ValueError, match=message):
        tproj.project_fwd(g, camera, **kw)
    assert cuda_library.LAUNCHES == before


def test_project_bwd_rejects_what_the_kernel_does_not_take():
    """P2's wrapper, and P1's under a graph, check their inputs as P1's
    does without one, before they load the library: CPU tensors always
    raise."""
    before = dict(cuda_library.LAUNCHES)
    for case in ("cpu", "float64", "rest_rows", "alive_dtype", "strided",
                 "camera_dtype", "devices", "color_mode"):
        g, camera, kw, message = _bad_inputs(case)
        cots = (None,) * len(tproj.COTANGENT_FIELDS)
        with pytest.raises(ValueError, match=message):
            tproj.project_bwd(g, camera, cots, **kw)
        g = g.replace(opacity=g.opacity.clone().requires_grad_(True))
        with pytest.raises(ValueError, match=message):
            tproj.project_fwd(g, camera, **kw)
    assert cuda_library.LAUNCHES == before


@pytest.mark.parametrize("requires_grad", ["none", "params", "camera",
                                           "both"])
def test_route_rule_on_cpu_tensors(monkeypatch, requires_grad):
    """CPU tensors take the plain chain whatever requires grad, and a graph
    through the camera keeps its gradient: no kernel wrapper runs (each is
    replaced by one that records its call)."""
    calls = []

    def record(name):
        def wrapper(*args, **kw):
            calls.append(name)
            raise AssertionError(f"{name} ran on CPU tensors")
        return wrapper

    for name in ("project_fwd", "project_bwd", "launch"):
        monkeypatch.setattr(tproj, name, record(name))
    g, camera = _pool()
    if requires_grad in ("params", "both"):
        g = g.with_params({k: v.clone().requires_grad_(True)
                           for k, v in g.params().items()})
    if requires_grad in ("camera", "both"):
        camera = camera.replace(
            view_matrix=camera.view_matrix.clone().requires_grad_(True))
    kw = dict(color_mode="sh", sh_degree=3, antialias=True)
    got = tproj.project_gaussians(g, camera, **kw)
    assert calls == []
    want = tproj.project_gaussians_plain(g, camera, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if requires_grad in ("camera", "both"):
        (d_view,) = torch.autograd.grad(got.means2d.sum(),
                                        [camera.view_matrix])
        assert bool(d_view.abs().sum() > 0)


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("color_mode,sh_degree", [
    ("dc_sigmoid", 0), ("sh", 0), ("sh", 1), ("sh", 2), ("sh", 3)])
def test_project_bwd_plain_is_the_chains_vjp(color_mode, sh_degree,
                                             antialias):
    """`project_bwd_plain` with standard normal cotangents on every row
    equals the gradients of sum(field * cotangent) through the chain, taken
    by `backward` into the leaves; a cotangent of None counts as 0, and the
    SH rest has no gradient under "dc_sigmoid" (the chain does not read
    it)."""
    g, camera = _pool()
    kw = dict(color_mode=color_mode, sh_degree=sh_degree,
              antialias=antialias)
    gen = torch.Generator().manual_seed(7)
    C = g.capacity
    cots = tuple(torch.randn(*shape, generator=gen)
                 for shape in ((C, 2), (C, 3), (C,), (C, 3), (C,)))
    got = tproj.project_bwd_plain(g, camera, cots, **kw)
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in g.params().items()}
    p = tproj.project_gaussians_plain(g.with_params(leaves), camera, **kw)
    sum((getattr(p, f) * t).sum()
        for f, t in zip(tproj.COTANGENT_FIELDS, cots)).backward()
    assert set(got) == set(leaves)
    for k, leaf in leaves.items():
        if color_mode == "dc_sigmoid" and k == "features_rest":
            assert got[k] is None and leaf.grad is None
            continue
        assert got[k].shape == leaf.shape
        torch.testing.assert_close(got[k], leaf.grad, rtol=1e-6, atol=0.0)
    no_depth = tproj.project_bwd_plain(
        g, camera, cots[:2] + (None,) + cots[3:], **kw)
    zero_depth = tproj.project_bwd_plain(
        g, camera, cots[:2] + (torch.zeros(C),) + cots[3:], **kw)
    for k, v in no_depth.items():
        assert (v is None and zero_depth[k] is None) or torch.equal(
            v, zero_depth[k])
