"""bench_torch.py, the port's twin of bench.py, on the CPU.

The bench's gradient (|render - 0|.mean() with respect to all six
parameter groups, bench.py's settings: tile 32, SH 0, black background) on
the flagship scene at bench.py's CPU size (64x64, 2,000 Gaussians in 4,096
slots) is held against `jax.grad` of bench.py's own loss on the scene
bench.py's `build` makes, through JAX's golden route (`use_pallas=False`,
as bench.py runs on the CPU); the port's side goes through its tile route
(the kernels' plain versions) and through its golden route.  The golden's
backward lets each chunk go; the CPU run of `main` prints bench.py's
keys; the twin imports no JAX; without a card it raises.
"""

import ast
import json
import weakref
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_torch as B
from mini3dgs_tpu.ops.renderer import render as jrender
from mini3dgs_tpu_torch import convert
from mini3dgs_tpu_torch.ops.renderer import RenderSettings, render
from torch.utils._python_dispatch import TorchDispatchMode

REPO = Path(__file__).resolve().parent.parent
SIZE, N, CAPACITY = 64, 2_000, 4096
KEYS = ("metric", "value", "unit", "vs_baseline", "spread", "reps",
        "mgaussians_per_s")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread while this module runs: its tensors are small,
    and the test run's other workers need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@jax.jit
def _jax_value_and_grad(g, cam, settings, target):
    """bench.py's chain loss and its gradient with respect to the params
    dict: one compile serves both scenes (same shapes and static fields)."""
    def loss_fn(params):
        out = jrender(g.with_params(params), cam, settings)
        return jnp.abs(out["image"] - target).mean()

    return jax.value_and_grad(loss_fn)(g.params())


def jax_loss_and_grads(aniso: bool):
    """bench.py's `build` at its CPU size, its chain's loss and jax.grad at
    the unperturbed parameters: (loss, {group: numpy gradient})."""
    with mock.patch.object(bench, "make_chain", lambda *a: a):
        g, cam, settings, target = bench.build(
            width=SIZE, height=SIZE, n=N, capacity=CAPACITY,
            use_pallas=False, max_instances=2 ** 14, aniso=aniso)
    loss, grads = _jax_value_and_grad(g, cam, settings, target)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def port_loss_and_grads(raster: str, aniso: bool):
    """The chain's loss and gradients at the unperturbed parameters, on the
    CPU: (loss, {group: numpy gradient})."""
    seen = {}

    def make_chain(g, cam, settings, target):
        from mini3dgs_tpu_torch.ops.renderer import render
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in g.params().items()}
        out = render(g.with_params(leaves), cam, settings)
        loss = (out["image"] - target).abs().mean()
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
        seen.update(settings=settings, loss=float(loss.detach()),
                    grads={k: v.numpy() for k, v in zip(leaves, grads)})

    with mock.patch.object(B, "make_chain", make_chain):
        B.build(width=SIZE, height=SIZE, n=N, capacity=CAPACITY,
                raster=raster, aniso=aniso, device="cpu")
    st = seen["settings"]
    assert (st.tile_size, st.sh_degree, st.color_mode, st.bg_color) == (
        32, 0, "dc_sigmoid", (0.0, 0.0, 0.0))
    return seen["loss"], seen["grads"]


@pytest.mark.parametrize("aniso", [False, True])
def test_bench_gradient_matches_jax(aniso):
    """All six groups' gradients of the port's tile route (plain versions)
    and golden route against JAX's golden, each normalised by the JAX
    group's largest magnitude: atol 1e-3, the whole-render bound of
    tests/test_torch_grad.py (float32 association of the chunked scans
    and sums); the loss rtol 1e-4.  Measured (64x64, CPU): loss 2e-7 to
    3e-7 relative, rows 3e-6 to 3e-5 of their largest entry.

    Where the exact gradient is 0, there is no largest entry to normalise
    by: features_rest (SH 0 does not read it) in both packages, and in the
    isotropic scene the rotation (R S S^T R^T = s^2 I for every R), whose
    entries are float32 cancellation residue (JAX 4.4e-11, the port 1e-10,
    against 4.7e-4 for xyz).  Those groups are held to 1e-6 of the xyz
    group's largest entry in both packages instead."""
    lj, gj = jax_loss_and_grads(aniso)
    assert set(gj) == {"xyz", "features_dc", "features_rest", "scaling",
                       "rotation", "opacity"}
    zero = {"features_rest"} | ({"rotation"} if not aniso else set())
    xyz_scale = np.abs(gj["xyz"]).max()
    assert xyz_scale > 0 and np.abs(gj["rotation"]).max() > (
        1e-6 * xyz_scale if aniso else 0)
    for raster in ("tiles", "golden"):
        lt, gt = port_loss_and_grads(raster, aniso)
        np.testing.assert_allclose(lt, lj, rtol=1e-4, err_msg=raster)
        assert set(gt) == set(gj)
        for k, want in gj.items():
            got = gt[k]
            assert got.shape == want.shape and np.isfinite(got).all()
            if k in zero:
                for name, v in (("port", got), ("jax", want)):
                    assert np.abs(v).max() <= 1e-6 * xyz_scale, (
                        raster, k, name, np.abs(v).max())
                continue
            scale = np.abs(want).max() + 1e-8
            np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                                       atol=1e-3, err_msg=f"{raster} {k}")


class _TrackShape(TorchDispatchMode):
    """Weak references to every tensor of one shape that an op returns."""

    def __init__(self, shape):
        super().__init__()
        self.shape, self.refs = shape, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and tuple(t.shape) == self.shape:
                self.refs.append(weakref.ref(t))
        return out


def test_golden_backward_releases_each_chunk():
    """Under the bench's loss (the image alone), the golden route's
    backward pass recomputes each chunk of 512 Gaussians and must let its
    [pixels, 512] tensors go before the pass ends: when the last gradient
    (xyz's) arrives none is alive.  Once a node that saved the
    chunk's contributions for the depth, which the loss does not read,
    never ran and held one such tensor per chunk (8 here) until the end:
    at 800^2 and 2^17 slots 78 GB, and the golden step ran out of the
    card's memory at any pixel block."""
    params, alive, cam = convert.flagship_scene_numpy(4096, 2000)
    g = convert.gaussians_from_numpy(params, alive)
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in g.params().items()}
    out = render(g.with_params(leaves), convert.camera_from_numpy(
        **cam, width=32, height=32), RenderSettings(
        image_height=32, image_width=32, tile_size=32, raster="golden"))
    loss = out["image"].abs().mean()
    mode, alive_at_end = _TrackShape((32 * 32, 512)), []
    leaves["xyz"].register_hook(lambda _: alive_at_end.append(
        sum(r() is not None for r in mode.refs)))
    with mode:
        torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    assert len(mode.refs) > 8 and alive_at_end == [0]


def test_main_on_the_cpu_prints_bench_keys(capsys):
    """`main(["--device", "cpu"])`: one JSON line with bench.py's keys at
    its CPU size, finite and positive, one rep, vs_baseline 1.0, the
    device named, no card figures; no anisotropic or trained line."""
    assert B.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(KEYS) <= set(out)
    assert out["metric"] == B.METRIC and out["unit"] == "Mpix/s"
    assert out["reps"] == 1 and out["vs_baseline"] == 1.0
    assert out["device"] == "cpu" and out["power_limit_w"] is None
    assert all(out[k] is None for k in (
        "device_busy_ms", "device_launches", "host_launch_us"))
    assert "aniso_rotated_mpix_s" not in out
    assert not any(k.startswith("trained_") for k in out)
    for k in ("value", "mgaussians_per_s"):
        assert np.isfinite(out[k]) and out[k] > 0, (k, out[k])
    assert out["spread"] == 0.0


def test_main_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="(?i)cuda"):
        B.main([])


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_twin_imports_no_jax():
    """bench_torch.py imports neither jax, the JAX package nor bench.py."""
    names = {n.split(".")[0] for n in _imports(REPO / "bench_torch.py")}
    assert names and not names & {"jax", "jaxlib", "mini3dgs_tpu", "bench"}
