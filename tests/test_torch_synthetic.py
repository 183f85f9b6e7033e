"""The procedural scene of the port (data/synthetic.py) and its scripts
(scripts/make_synthetic_scene_torch.py, export_colmap_scene_torch.py,
preprocess_torch.py) against the JAX-side scripts on the CPU.

Tolerances: the seed point cloud, the camera poses and the COLMAP model
exactly (bitwise); the ray-marched views against the JAX renderer
(`_build_renderer`, jitted on the CPU): NaN at the same values (a pixel
whose subsamples both hit and miss carries NaN colour in both), at most
5 % of the other values more than 1e-5 apart and at most 1 % more than
1e-3, since the hit test and the texture lattice's floor() flip at edges.
Measured on the CPU host (values of [H, W, 4]): 16^2 spp 1 plain 8 and 2
of 1,024 above 1e-5, textured 13 and 7; 24^2 spp 2 plain 0 and 1 of
2,304, textured 21 and 43; none above 1e-3 in any case.  The generated
PNGs: the same transforms JSON, RGBA within one level of 255.
"""

import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mini3dgs_tpu_torch.data import synthetic
from mini3dgs_tpu_torch.utils import png

REPO = Path(__file__).resolve().parent.parent
POSES = [(0.3, 0.5), (2.0, 0.9)]


def _script(name):
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        spec = importlib.util.spec_from_file_location(
            name, REPO / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(REPO / "scripts"))
    return mod


@pytest.fixture(scope="module")
def jscene():
    return _script("make_synthetic_scene")


@pytest.mark.parametrize("texture", [False, True])
def test_surface_points_are_the_jax_scripts(jscene, texture):
    pts, cols = synthetic.sample_surface_points(n=3000, seed=4,
                                                texture=texture)
    jpts, jcols = jscene.sample_surface_points(n=3000, seed=4,
                                               texture=texture)
    assert pts.dtype == jpts.dtype == np.float32 and pts.shape == (3000, 3)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(cols, jcols)


def test_camera_poses_are_the_jax_scripts(jscene):
    for theta, phi in POSES + [(1.0, math.pi / 2), (5.5, 0.2)]:
        R, T = synthetic.camera_pose(theta, phi, 3.6)
        jR, jT = jscene.camera_pose(theta, phi, 3.6)
        np.testing.assert_array_equal(R, jR)
        np.testing.assert_array_equal(T, jT)
        np.testing.assert_array_equal(synthetic.to_blender_c2w(R, T),
                                      jscene.to_blender_c2w(jR, jT))
    assert synthetic.FOVX == jscene.FOVX
    assert synthetic.TEX_PALETTES == jscene.TEX_PALETTES
    assert synthetic.TEX_FREQS == jscene.TEX_FREQS


@pytest.mark.parametrize("size,spp", [(16, 1), (24, 2)])
@pytest.mark.parametrize("texture", [False, True])
def test_render_matches_the_jax_renderer(jscene, size, spp, texture):
    render = jscene._build_renderer(size, spp, texture=texture)
    for theta, phi in POSES:
        R, T = synthetic.camera_pose(theta, phi, 3.6)
        want = np.asarray(render(R, T))
        got = synthetic.render_view(R, T, size, spp, texture).numpy()
        assert got.shape == want.shape == (size, size, 4)
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        d = np.abs(got - want)[~nan]
        assert (d > 1e-5).mean() <= 0.05, (d > 1e-5).sum()
        assert (d > 1e-3).mean() <= 0.01, (d > 1e-3).sum()
        assert 0.2 < want[..., 3].mean() < 0.6


def _tiny_scene(root: Path, jax_side: bool):
    common = ["--out", str(root), "--n-train", "2", "--n-test", "1",
              "--size", "16", "--spp", "1", "--texture"]
    if jax_side:
        mod = _script("make_synthetic_scene")
        assert mod.main(common) == 0
    else:
        mod = _script("make_synthetic_scene_torch")
        assert mod.main(common + ["--device", "cpu"]) == 0
    assert mod.main(["--out", str(root), "--points-only", "--texture",
                     "--n-points", "400"]) == 0


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The tiny texture scene written by both generators."""
    tmp = tmp_path_factory.mktemp("scenes")
    _tiny_scene(tmp / "port", jax_side=False)
    _tiny_scene(tmp / "jax", jax_side=True)
    return tmp


def test_generator_writes_the_jax_scripts_scene(scenes):
    port, jax_ = scenes / "port", scenes / "jax"
    for split in ("train", "test"):
        meta = json.loads((port / f"transforms_{split}.json").read_text())
        assert meta == json.loads(
            (jax_ / f"transforms_{split}.json").read_text())
        for fr in meta["frames"]:
            name = fr["file_path"] + ".png"
            got = png.decode((port / name).read_bytes()).astype(int)
            want = np.asarray(Image.open(jax_ / name)).astype(int)
            assert got.shape == want.shape == (16, 16, 4)
            assert np.abs(got - want).max() <= 1
    assert (port / "points3d.ply").read_bytes() == \
        (jax_ / "points3d.ply").read_bytes()


def test_exporter_writes_the_jax_exporters_model(scenes, capsys):
    src = scenes / "port"
    tout, jout = scenes / "colmap_port", scenes / "colmap_jax"
    assert _script("export_colmap_scene_torch").main(
        ["--src", str(src), "--out", str(tout)]) == 0
    assert _script("export_colmap_scene").main(
        ["--src", str(src), "--out", str(jout)]) == 0
    assert capsys.readouterr().out.count("pose round-trip OK") == 2
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tout / "sparse/0" / name).read_bytes() == \
            (jout / "sparse/0" / name).read_bytes(), name
    names = sorted(p.name for p in (jout / "images").iterdir())
    assert names == sorted(p.name for p in (tout / "images").iterdir())
    assert len(names) == 3
    for n in names:
        np.testing.assert_array_equal(
            png.decode((tout / "images" / n).read_bytes()),
            np.asarray(Image.open(jout / "images" / n)))


def test_preprocess_gives_what_the_jax_script_gives(scenes, capsys):
    """Both scripts on the exported COLMAP model: the same report and the
    same point cloud files."""
    root = scenes / "colmap_port"
    if not (root / "sparse/0/points3D.bin").exists():
        assert _script("export_colmap_scene_torch").main(
            ["--src", str(scenes / "port"), "--out", str(root)]) == 0
    capsys.readouterr()
    outs = {}
    for name, extra in (("preprocess_torch", ["--device", "cpu"]),
                        ("preprocess", [])):
        assert _script(name).main(
            ["--data", str(root), "--export-ply", str(scenes / f"{name}.ply"),
             "--export-npz", str(scenes / f"{name}.npz")] + extra) == 0
        outs[name] = capsys.readouterr().out.replace(name, "X")
    assert outs["preprocess_torch"] == outs["preprocess"]
    assert "point cloud: 400 points (with colors)" in outs["preprocess"]
    assert (scenes / "preprocess_torch.ply").read_bytes() == \
        (scenes / "preprocess.ply").read_bytes()
    a, b = (np.load(scenes / f"{n}.npz")
            for n in ("preprocess_torch", "preprocess"))
    for k in ("points", "colors"):
        np.testing.assert_array_equal(a[k], b[k])


def test_generator_refuses_cuda_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        _script("make_synthetic_scene_torch").main(
            ["--out", str(tmp_path / "s"), "--size", "8", "--n-train", "1",
             "--n-test", "1"])
    assert not (tmp_path / "s" / "train").exists()
