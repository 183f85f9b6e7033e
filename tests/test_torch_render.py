"""The port's render slice end to end against JAX `render(use_pallas=True)`
(Pallas in interpret mode), the PLY exchange between the two packages, the
entry point, and the rule that the port never imports JAX.

Render tolerances: image/alpha atol 3e-5 and depth atol 1e-3 as in
test_pallas_forward_matches_golden; the per-Gaussian outputs as in
test_torch_projection (rtol 1e-5, floor 1e-6 x the field's largest value);
visibility and the stream counters exactly."""

import ast
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini3dgs_tpu.ops import renderer as jren
from mini3dgs_tpu.utils import gaussian_ply as jply
from mini3dgs_tpu_torch import convert
from mini3dgs_tpu_torch.ops import renderer as tren
from mini3dgs_tpu_torch.utils import gaussian_ply as tply
from tests.test_torch_core import (camera_pair, jax_gaussians, random_params,
                                   t2n)

REPO = Path(__file__).resolve().parent.parent
H, W = 40, 56


@pytest.mark.parametrize("color_mode,sh_degree,tile_size",
                         [("dc_sigmoid", 0, 16), ("sh", 3, 32)])
def test_render_matches_jax(color_mode, sh_degree, tile_size):
    params, alive = random_params(n=150, capacity=192, seed=21)
    R = np.array([[0.96, 0.0, 0.28], [0.0, 1.0, 0.0], [-0.28, 0.0, 0.96]])
    jc, tc = camera_pair(R=R, T=np.array([0.3, 0.0, -0.2]), width=W,
                         height=H, fov_deg=70.0)
    common = dict(image_height=H, image_width=W, tile_size=tile_size,
                  color_mode=color_mode, sh_degree=sh_degree)
    j_out = jren.render(jax_gaussians(params, alive), jc, jren.RenderSettings(
        **common, bg_color=jnp.asarray([1.0, 1.0, 1.0]), use_pallas=True,
        max_instances=4096, gaussian_chunk=32))
    t_out = tren.render(convert.gaussians_from_numpy(params, alive), tc,
                        tren.RenderSettings(**common, bg_color=(1.0, 1.0, 1.0)))
    assert set(t_out) == set(j_out)
    for k, atol in (("image", 3e-5), ("alpha", 3e-5), ("depth", 1e-3)):
        np.testing.assert_allclose(t2n(t_out[k]), np.asarray(j_out[k]),
                                   atol=atol, err_msg=k)
    vis = np.asarray(j_out["visibility_filter"])
    np.testing.assert_array_equal(t2n(t_out["visibility_filter"]), vis)
    for k in ("viewspace_points", "radii", "conics"):
        b = np.asarray(j_out[k])[vis]
        np.testing.assert_allclose(t2n(t_out[k])[vis], b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max(), err_msg=k)
    for k in ("n_dropped", "n_live", "n_dropped_large", "n_large"):
        assert t_out[k] == int(j_out[k]), k
    assert t_out["n_live"] > 0


def test_ply_round_trip_between_packages(tmp_path):
    """PLY written by either package reads back identically in the other."""
    params, alive = random_params(n=40, capacity=48, seed=22)
    tg = convert.gaussians_from_numpy(params, alive)
    assert tply.export_gaussians_ply(tg, str(tmp_path / "t.ply")) == 40
    jply.export_gaussians_ply(jax_gaussians(params, alive),
                              str(tmp_path / "j.ply"))
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    back = tply.import_gaussians_ply(str(tmp_path / "j.ply"), capacity=48)
    jback = jply.import_gaussians_ply(str(tmp_path / "t.ply"), capacity=48)
    for k in convert.PARAM_NAMES + ("alive",):
        np.testing.assert_array_equal(t2n(getattr(back, k)),
                                      np.asarray(getattr(jback, k)), k)
        np.testing.assert_array_equal(t2n(getattr(back, k))[alive],
                                      (params[k] if k != "alive"
                                       else alive)[alive], k)


def _module_imports(path: Path):
    """The modules that `path` (a file of the repository) imports, at any
    depth of its tree: relative imports resolved against its package, and
    `from m import n` as both m and m.n (n may be a module)."""
    package = path.relative_to(REPO).parts[:-1]
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            parts = package[:len(package) + 1 - node.level] \
                if node.level else ()
            module = ".".join(parts + ((node.module,) if node.module
                                       else ()))
            if node.module:
                yield module
            yield from (f"{module}.{a.name}" for a in node.names)


# The JAX-side scripts the port copies what it needs from (the port keeps
# its own copy: scripts/*_torch.py and mini3dgs_tpu_torch/data/synthetic.py).
JAX_SIDE_SCRIPTS = ("make_synthetic_scene", "export_colmap_scene",
                    "preprocess", "train_path_parity", "train_1m",
                    "train_probe", "__graft_entry__")


def test_port_imports_no_jax():
    """No port file imports JAX, the JAX package, the packages the GPU host
    lacks (Pillow, PyYAML, plyfile), or a JAX-side script it copies."""
    files = sorted((REPO / "mini3dgs_tpu_torch").rglob("*.py"))
    files += sorted((REPO / "scripts").glob("*_torch.py"))
    files += [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for name in _module_imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax",
                                "mini3dgs_tpu", "PIL", "yaml", "plyfile"), \
                f"{path} imports {name}"
            parts = name.split(".")
            assert not (parts[-1] in JAX_SIDE_SCRIPTS
                        and parts[:-1] in ([], ["scripts"])), \
                f"{path} imports the JAX-side script {name}"


def test_the_ports_imports_point_down():
    """The layers' arrows: no module of `utils/` imports an op, the mesh or
    the trainer; the projection does not import the raster; the kernel
    library imports no op; only the kernel library loads a C library."""
    pkg = REPO / "mini3dgs_tpu_torch"
    name = lambda path: ".".join(path.relative_to(REPO).with_suffix("").parts)
    imports = {name(path): set(_module_imports(path))
               for path in pkg.rglob("*.py")}
    up = lambda mods, layers: sorted(
        m for m in mods for layer in layers
        if (m + ".").startswith(f"mini3dgs_tpu_torch.{layer}."))
    for module, mods in imports.items():
        if module.startswith("mini3dgs_tpu_torch.utils."):
            assert not up(mods, ("ops", "parallel", "train")), module
        if module != "mini3dgs_tpu_torch.ops.cuda_library":
            assert "ctypes" not in mods, module
    assert not up(imports["mini3dgs_tpu_torch.ops.projection"],
                  ("ops.raster_cuda",))
    assert up(imports["mini3dgs_tpu_torch.ops.projection"],
              ("ops.cuda_library",))
    assert up(imports["mini3dgs_tpu_torch.ops.cuda_library"], ("ops",)) \
        == []


def _entry_args(tmp_path, device):
    params, alive, _ = convert.flagship_scene_numpy(256, 200, seed=1)
    ply = tmp_path / "scene.ply"
    tply.export_gaussians_ply(convert.gaussians_from_numpy(params, alive),
                              str(ply))
    return ["--ply", str(ply), "--output", str(tmp_path / "frames"),
            "--n-frames", "2", "--size", "32",
            "--tile-size", "16", "--bg", "1,1,1", "--device", device]


def _entry_main():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "render_novel_view_torch",
        REPO / "scripts" / "render_novel_view_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def test_entry_point_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        _entry_main()(_entry_args(tmp_path, "cuda"))
    assert not (tmp_path / "frames").exists()


def test_entry_point_renders_frames_on_cpu(tmp_path, capsys):
    assert _entry_main()(_entry_args(tmp_path, "cpu")) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["frames"] == 2 and len(line["frame_ms"]) == 2
    for i in range(2):
        rgba = np.load(tmp_path / "frames" / f"frame_{i:04d}.npy")
        assert rgba.shape == (4, 32, 32) and np.isfinite(rgba).all()
        assert rgba[3].max() > 0
