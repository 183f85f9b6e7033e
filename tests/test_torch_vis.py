"""The port's utils/vis.py against the JAX package's: the camera-rig and
Gaussian scatter plots (matplotlib) and the frames and video of a camera
path (imageio).  Only the matplotlib and imageio parts skip where those
packages are missing.  The plots are compared as decoded pixels, exactly;
the frames decode to the same pixels as the JAX package's (written through
Pillow there, through the port's own PNG codec here)."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mini3dgs_tpu.utils import vis as jvis
from mini3dgs_tpu_torch import convert
from mini3dgs_tpu_torch.utils import png
from mini3dgs_tpu_torch.utils import vis as tvis
from tests.test_torch_core import jax_gaussians, random_params


def _pixels(path):
    return png.decode(path.read_bytes())


def test_visualize_cameras_matches_jax(tmp_path):
    pytest.importorskip("matplotlib")
    kw = dict(radius=3.0, height=1.0, width=32, image_height=32)
    tvis.visualize_cameras(tvis.turntable_cameras(6, **kw),
                           str(tmp_path / "t" / "cams.png"))
    jvis.visualize_cameras(jvis.turntable_cameras(6, **kw),
                           str(tmp_path / "j" / "cams.png"))
    np.testing.assert_array_equal(_pixels(tmp_path / "t" / "cams.png"),
                                  _pixels(tmp_path / "j" / "cams.png"))


@pytest.mark.parametrize("max_points", [20000, 50])
def test_visualize_gaussians_matches_jax(tmp_path, max_points):
    pytest.importorskip("matplotlib")
    params, alive = random_params(n=120, capacity=160, seed=8)
    tvis.visualize_gaussians(convert.gaussians_from_numpy(params, alive),
                             str(tmp_path / "t.png"), max_points=max_points)
    jvis.visualize_gaussians(jax_gaussians(params, alive),
                             str(tmp_path / "j.png"), max_points=max_points)
    np.testing.assert_array_equal(_pixels(tmp_path / "t.png"),
                                  _pixels(tmp_path / "j.png"))


def _image_of(cam):
    """A deterministic [3,H,W] image per camera (its uid sets the ramp)."""
    h, w = cam.height, cam.width
    ramp = np.linspace(0, 1, h * w, dtype=np.float32).reshape(h, w)
    return np.stack([ramp, np.roll(ramp, cam.uid), 1 - ramp]) ** (1 + cam.uid)


def test_video_frames_match_jax(tmp_path):
    kw = dict(width=24, image_height=16)
    tframes = tvis.create_video_from_cameras(
        lambda c: torch.from_numpy(_image_of(c)),
        tvis.turntable_cameras(3, **kw), str(tmp_path / "t"))
    jframes = jvis.create_video_from_cameras(
        lambda c: jnp.asarray(_image_of(c)), jvis.turntable_cameras(3, **kw),
        str(tmp_path / "j"))
    assert [p.name for p in tframes] == [p.name for p in jframes] == [
        f"frame_{i:04d}.png" for i in range(3)]
    for a, b in zip(tframes, jframes):
        np.testing.assert_array_equal(_pixels(a), _pixels(b))


def test_video_is_written_through_imageio(tmp_path):
    imageio = pytest.importorskip("imageio.v2")
    cams = tvis.turntable_cameras(2, width=24, image_height=16)
    frames = tvis.create_video_from_cameras(
        _image_of, cams, str(tmp_path / "f"), video_path=str(tmp_path /
                                                             "v.gif"))
    back = imageio.mimread(tmp_path / "v.gif")
    assert len(back) == len(frames) == 2
    assert back[0].shape[:2] == (16, 24)


def test_video_without_imageio_keeps_the_frames(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    cams = tvis.turntable_cameras(2, width=24, image_height=16)
    frames = tvis.create_video_from_cameras(
        _image_of, cams, str(tmp_path / "f"), video_path=str(tmp_path /
                                                             "v.mp4"))
    assert [p.exists() for p in frames] == [True, True]
    assert not (tmp_path / "v.mp4").exists()
    assert "imageio is not installed" in capsys.readouterr().err
