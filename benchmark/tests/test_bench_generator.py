"""The frozen scene generator reproduces the measured package's
`render_view` at a tiny size (so both scenes stay the same scene), and
its outdoor surfaces fill the frame."""

import torch

from harness import generator, scene
from conftest import SEED, tiny_cell


def test_render_view_reproduces_the_package():
    """Equal wherever the package's view is a number.  Where it is NaN (a
    silhouette pixel some of whose rays escaped every surface: their t
    overflows), the copy gives the hits' colour."""
    from mini3dgs_tpu_torch.data import synthetic
    for texture in (False, True):
        R, T = synthetic.camera_pose(0.7, 0.4, 3.6)
        want = synthetic.render_view(R, T, 24, spp=2, texture=texture)
        got = generator.render_view(generator.Scene(texture, "cpu"), R, T,
                                    24, 24, spp=2)
        ok = torch.isfinite(want)
        assert torch.equal(got[ok], want[ok])
        assert bool(torch.isfinite(got).all())
        assert bool(ok[..., 3].all())


def test_outdoor_targets_fill_the_frame():
    cell = tiny_cell("mipnerf360_outdoor.render", width=48, height=32,
                     views=2)
    cell.config["scene"]["march_steps"] = 192
    v = scene.train_views(cell.config, SEED, "cpu")
    for img in v.targets:
        assert img.shape == (3, 32, 48)
        covered = (img.sum(0) > 0).float().mean()
        assert covered > 0.95


def test_gaussians_lie_on_the_surfaces():
    cell = tiny_cell("mipnerf360_outdoor.render", n=3000)
    p = scene.make_gaussians(cell.config, SEED, "cpu")
    sc = scene.scene_of(cell.config, "cpu")
    # each on its own surface (some of the objects' lie inside another)
    d = sc.distances(p["xyz"]).abs().min(dim=1).values
    assert d.max() < 1e-4
    assert p["xyz"].shape == (3000, 3)
    assert p["features_rest"].shape == (3000, 15, 3)
    s = p["scaling"].exp()
    assert bool((s[:, 2] < s[:, :2].min(dim=1).values).all())
    q = p["rotation"]
    assert torch.allclose(q.norm(dim=1), torch.ones(3000), atol=1e-5)
