"""The port's data layer against the JAX package and Pillow: the PNG codec
(Pillow-written files and hand-filtered rows of every filter type), the
COLMAP readers and writers, the three datasets and `load_dataset`, and the
point-cloud initialisation, compaction and `fov_from_focal`.

Decoded bytes, COLMAP models, dataset splits and sizes are compared
exactly; cameras and images within 1e-6 (float32 conversions of the same
numbers); `RandomDataset`'s rendered targets within the render tolerance
of tests/test_torch_render.py, atol 3e-5."""

import io
import json
import math
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mini3dgs_tpu import config as jconfig
from mini3dgs_tpu.core import camera as jcamera
from mini3dgs_tpu.core import gaussians as jgauss
from mini3dgs_tpu.data import colmap as jcolmap
from mini3dgs_tpu.data import dataset as jdataset
from mini3dgs_tpu.utils import io as jio
from mini3dgs_tpu_torch import config as tconfig
from mini3dgs_tpu_torch import convert
from mini3dgs_tpu_torch.core import camera as tcamera
from mini3dgs_tpu_torch.core import gaussians as tgauss
from mini3dgs_tpu_torch.data import colmap as tcolmap
from mini3dgs_tpu_torch.data import dataset as tdataset
from mini3dgs_tpu_torch.utils import io as tio
from mini3dgs_tpu_torch.utils import png
from tests.test_torch_core import t2n

# ---- PNG ------------------------------------------------------------------


def smooth_image(h, w, c, seed):
    """Gradients plus a noisy patch, so Pillow's adaptive filtering picks
    several filter types."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    planes = [np.sin(x / (7.0 + k)) + np.cos(y / (5.0 + 2 * k)) + x * y / 900
              for k in range(c)]
    img = np.stack(planes, -1)
    img = ((img - img.min()) / np.ptp(img) * 255).astype(np.uint8)
    img[h // 3:h // 2, w // 4:w // 2] = rng.integers(
        0, 256, (h // 2 - h // 3, w // 2 - w // 4, c))
    return img[..., 0] if c == 1 else img


def pillow_png(arr, palette=False):
    """PNG bytes written by Pillow (its mode follows the array's shape and
    dtype; `palette` converts to a palette image)."""
    im = Image.fromarray(arr)
    buf = io.BytesIO()
    (im.convert("P") if palette else im).save(buf, format="PNG")
    return buf.getvalue()


def with_header(data, **fields):
    """`data` with IHDR fields (bit depth, colour type, interlace) changed
    and its CRC recomputed."""
    names = ("width", "height", "depth", "ctype", "comp", "filt", "interlace")
    hdr = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])))
    hdr.update(fields)
    body = b"IHDR" + struct.pack(">IIBBBBB", *(hdr[n] for n in names))
    return (data[:12] + body + struct.pack(">I", zlib.crc32(body))
            + data[33:])


def filter_types(data):
    raw = zlib.decompress(b"".join(b for k, b in png._chunks(data)
                                   if k == b"IDAT"))
    w, h = struct.unpack(">II", data[16:24])
    stride = len(raw) // h
    return {raw[r * stride] for r in range(h)}


@pytest.mark.parametrize("c", [1, 3, 4])
def test_png_decodes_pillow_files_exactly(c):
    arr = smooth_image(61, 77, c, seed=c)
    data = pillow_png(arr)
    assert len(filter_types(data)) >= 2
    got = png.decode(data)
    np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(data))))
    np.testing.assert_array_equal(got, arr)


def hand_filtered_png(img, ftypes):
    """A PNG whose row r is filtered with ftypes[r] (the PNG spec's
    definitions, written out per byte)."""
    H, W, C = img.shape
    rows = []
    prev = np.zeros(W * C, np.int64)
    for r in range(H):
        cur = img[r].reshape(-1).astype(np.int64)
        out = np.zeros_like(cur)
        for i in range(W * C):
            a = cur[i - C] if i >= C else 0
            b = prev[i]
            cc = prev[i - C] if i >= C else 0
            p = a + b - cc
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
            pred = [0, a, b, (a + b) // 2,
                    a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
                    ][ftypes[r]]
            out[i] = (cur[i] - pred) % 256
        rows.append(bytes([ftypes[r]]) + out.astype(np.uint8).tobytes())
        prev = cur
    chunk = lambda k, b: (struct.pack(">I", len(b)) + k + b
                          + struct.pack(">I", zlib.crc32(k + b)))
    ctype = {1: 0, 3: 2, 4: 6}[C]
    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("c", [1, 3, 4])
def test_png_decodes_every_row_filter(c):
    """Random bytes (every Paeth branch and wrap-around occurs) with rows
    of filter types 0-4, in runs and alternating; Pillow's decode and the
    original bytes agree with the port's."""
    rng = np.random.default_rng(10 + c)
    img = rng.integers(0, 256, (23, 19, c), dtype=np.uint8)
    ftypes = [r % 5 for r in range(13)] + [4] * 5 + [3] * 3 + [1, 2]
    data = hand_filtered_png(img, ftypes)
    assert filter_types(data) == {0, 1, 2, 3, 4}
    want = np.asarray(Image.open(io.BytesIO(data)))
    got = png.decode(data)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img[..., 0] if c == 1 else img)


@pytest.mark.parametrize("c", [1, 3, 4])
def test_pillow_reads_the_port_png(c):
    arr = smooth_image(17, 29, c, seed=20 + c)
    data = png.encode(arr)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  arr)
    np.testing.assert_array_equal(png.decode(data), arr)


def test_png_raises_on_what_it_does_not_read():
    arr = smooth_image(8, 8, 3, seed=1)
    for data in (pillow_png(arr, palette=True), pillow_png(arr[..., :2]),
                 pillow_png(arr[..., 0].astype(np.uint16) * 200),
                 with_header(png.encode(arr), interlace=1),
                 with_header(png.encode(arr), depth=16)):
        with pytest.raises(ValueError, match="unsupported PNG"):
            png.decode(data)
    data = bytearray(png.encode(arr))
    data[40] ^= 1  # inside IDAT
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode(b"GIF89a" + bytes(20))


@pytest.mark.parametrize("c,bg", [(1, 1.0), (3, 1.0), (4, 1.0), (4, 0.0),
                                  (4, (0.2, 0.4, 0.6))])
def test_load_and_save_image_match_jax(tmp_path, c, bg):
    """load_image equals the JAX package's (Pillow) bit for bit, alpha
    composited onto `bg`; save_image writes the bytes Pillow decodes to
    what the JAX package's save_image writes."""
    path = tmp_path / "im.png"
    path.write_bytes(pillow_png(smooth_image(21, 33, c, seed=c)))
    np.testing.assert_array_equal(tio.load_image(str(path), bg=bg),
                                  jio.load_image(str(path), bg=bg))
    img = np.random.default_rng(3).uniform(-0.1, 1.1, (3, 9, 14)) \
        .astype(np.float32)
    jio.save_image(img, str(tmp_path / "j.png"))
    tio.save_image(torch.from_numpy(img), str(tmp_path / "t.png"))
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "t.png")),
        np.asarray(Image.open(tmp_path / "j.png")))


# ---- point clouds -----------------------------------------------------------


@pytest.mark.parametrize("suffix", [".npz", ".npy", ".ply", ".txt"])
def test_point_cloud_files_match_jax(tmp_path, suffix):
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    cols = rng.random((50, 3)).astype(np.float32)
    path = str(tmp_path / f"cloud{suffix}")
    tio.save_point_cloud(pts, cols, path)
    got, want = tio.load_point_cloud(path), jio.load_point_cloud(path)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[0], pts, atol=1e-5)
    jpath = str(tmp_path / f"jcloud{suffix}")
    jio.save_point_cloud(pts, cols, jpath)
    for g, w in zip(tio.load_point_cloud(jpath), jio.load_point_cloud(jpath)):
        np.testing.assert_array_equal(g, w)


# ---- COLMAP -------------------------------------------------------------------


def rig_model(n_views=5, W=40, H=30, f=35.0, model="PINHOLE"):
    """A COLMAP camera and n_views world->camera poses on a circle looking
    at the origin (the construction of tests/test_trainer_integration.py)."""
    params = {"PINHOLE": [f, f * 1.1, W / 2, H / 2],
              "SIMPLE_RADIAL": [f, W / 2, H / 2, 0.05]}[model]
    cams = {1: jcolmap.ColmapCamera(1, model, W, H, np.array(params))}
    imgs = {}
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        center = np.array([np.sin(ang) * 2.5, 0.3, -np.cos(ang) * 2.5])
        fwd = -center / np.linalg.norm(center)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R_w2c = np.stack([right, down, fwd], axis=1).T
        t = -R_w2c @ center
        w = np.sqrt(max(1 + np.trace(R_w2c), 1e-12)) / 2
        q = np.array([w, (R_w2c[2, 1] - R_w2c[1, 2]) / (4 * w),
                      (R_w2c[0, 2] - R_w2c[2, 0]) / (4 * w),
                      (R_w2c[1, 0] - R_w2c[0, 1]) / (4 * w)])
        imgs[i + 1] = jcolmap.ColmapImage(i + 1, q, t, 1, f"im_{i}.png")
    return cams, imgs


def write_text_model(cams, imgs, pts, cols, sp):
    with open(sp / "cameras.txt", "w") as f:
        f.write("# camera list\n")
        for c in cams.values():
            f.write(f"{c.id} {c.model} {c.width} {c.height} "
                    + " ".join(repr(float(v)) for v in c.params) + "\n")
    with open(sp / "images.txt", "w") as f:
        f.write("# image list\n")
        for im in imgs.values():
            f.write(f"{im.id} " + " ".join(repr(float(v)) for v in im.qvec)
                    + " " + " ".join(repr(float(v)) for v in im.tvec)
                    + f" {im.camera_id} {im.name}\n\n")
    with open(sp / "points3D.txt", "w") as f:
        for i, (p, c) in enumerate(zip(pts, cols)):
            rgb = (np.clip(c, 0, 1) * 255).astype(np.uint8)
            xyz = " ".join(repr(float(v)) for v in p)
            f.write(f"{i} {xyz} {rgb[0]} {rgb[1]} {rgb[2]} 0.5 1 2\n")


def assert_models_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        for f in vars(w):
            a, b = getattr(g, f), getattr(w, f)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, f


def test_colmap_models_read_identically(tmp_path):
    """Binary models written by the JAX writers and text models are read
    by the port exactly as by the JAX readers; the port's writers write
    the JAX writers' bytes."""
    cams, imgs = rig_model()
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    cols = rng.random((40, 3)).astype(np.float32)
    jcolmap.write_cameras_binary(cams, str(tmp_path / "cameras.bin"))
    jcolmap.write_images_binary(imgs, str(tmp_path / "images.bin"))
    jcolmap.write_points3d_binary(pts, cols, str(tmp_path / "points3D.bin"))
    write_text_model(cams, imgs, pts, cols, tmp_path)
    for kind in ("cameras", "images"):
        for fmt in ("binary", "text"):
            path = str(tmp_path / f"{kind}.{'bin' if fmt == 'binary' else 'txt'}")
            assert_models_equal(
                getattr(tcolmap, f"read_{kind}_{fmt}")(path),
                getattr(jcolmap, f"read_{kind}_{fmt}")(path))
    for fmt, name in (("binary", "points3D.bin"), ("text", "points3D.txt")):
        path = str(tmp_path / name)
        for g, w in zip(getattr(tcolmap, f"read_points3d_{fmt}")(path),
                        getattr(jcolmap, f"read_points3d_{fmt}")(path)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    tcolmap.write_cameras_binary(cams, str(tmp_path / "c2.bin"))
    tcolmap.write_images_binary(imgs, str(tmp_path / "i2.bin"))
    tcolmap.write_points3d_binary(pts, cols, str(tmp_path / "p2.bin"))
    for mine, theirs in (("c2.bin", "cameras.bin"), ("i2.bin", "images.bin"),
                         ("p2.bin", "points3D.bin")):
        assert (tmp_path / mine).read_bytes() == \
            (tmp_path / theirs).read_bytes()
    cam = jcolmap.ColmapCamera(1, "OPENCV", 20, 16,
                               np.array([18.0, 19.0, 10.0, 8.0, 0.1, -0.02,
                                         0.001, 0.002]))
    img = np.random.default_rng(7).random((16, 20, 3)).astype(np.float32)
    got, want = tcolmap.undistort_image(img, cam), \
        jcolmap.undistort_image(img, cam)
    np.testing.assert_array_equal(got[0], want[0])


def assert_cameras_match(tcams, jcams, image_atol=1e-6):
    assert len(tcams) == len(jcams)
    for tc, jc in zip(tcams, jcams):
        assert (tc.uid, tc.image_name, tc.width, tc.height) == \
            (jc.uid, jc.image_name, jc.width, jc.height)
        for f in ("R", "T", "view_matrix", "FoVx", "FoVy"):
            np.testing.assert_allclose(t2n(getattr(tc, f)),
                                       np.asarray(getattr(jc, f)),
                                       rtol=1e-6, atol=1e-6, err_msg=f)
        np.testing.assert_allclose(t2n(tc.camera_center),
                                   np.asarray(jc.camera_center), atol=1e-6)
        assert (tc.image is None) == (jc.image is None)
        if jc.image is not None:
            np.testing.assert_allclose(t2n(tc.image), np.asarray(jc.image),
                                       rtol=0, atol=image_atol)


def assert_datasets_match(td, jd, image_atol=1e-6):
    assert type(td).__name__ == type(jd).__name__
    for split in ("cameras", "train_cameras", "test_cameras"):
        assert_cameras_match(getattr(td, split), getattr(jd, split),
                             image_atol)
    ti, ji = td.get_scene_info(), jd.get_scene_info()
    np.testing.assert_allclose(ti["radius"], ji["radius"], rtol=1e-6)
    np.testing.assert_allclose(ti["center"], ji["center"], atol=1e-6)
    for g, w in zip(td.get_point_cloud(), jd.get_point_cloud()):
        np.testing.assert_array_equal(g, w)
    assert getattr(td, "bg_color", None) == getattr(jd, "bg_color", None)


def colmap_scene(root, binary=True, n_views=9):
    """A COLMAP scene on disk: the model (binary or text) and RGB / RGBA
    PNGs written with Pillow."""
    cams, imgs = rig_model(n_views=n_views)
    sp = root / "sparse" / "0"
    sp.mkdir(parents=True)
    (root / "images").mkdir()
    rng = np.random.default_rng(8)
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    cols = rng.random((64, 3)).astype(np.float32)
    if binary:
        jcolmap.write_cameras_binary(cams, str(sp / "cameras.bin"))
        jcolmap.write_images_binary(imgs, str(sp / "images.bin"))
        jcolmap.write_points3d_binary(pts, cols, str(sp / "points3D.bin"))
    else:
        write_text_model(cams, imgs, pts, cols, sp)
    for i, im in enumerate(imgs.values()):
        c = 4 if i % 2 else 3
        arr = smooth_image(30, 40, c, seed=30 + i)
        (root / "images" / im.name).write_bytes(pillow_png(arr))


@pytest.mark.parametrize("binary", [True, False])
def test_colmap_dataset_matches_jax(tmp_path, binary):
    colmap_scene(tmp_path, binary)
    td = tdataset.COLMAPDataset(str(tmp_path))
    jd = jdataset.COLMAPDataset(str(tmp_path))
    td.load_cameras()
    jd.load_cameras()
    assert (len(td.train_cameras), len(td.test_cameras)) == (7, 2)
    assert_datasets_match(td, jd)


def test_blender_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(9)
    for split, n in (("train", 3), ("test", 2)):
        frames = []
        for i in range(n):
            name = f"{split}/r_{i}"
            (tmp_path / split).mkdir(exist_ok=True)
            (tmp_path / f"{name}.png").write_bytes(
                pillow_png(smooth_image(24, 24, 4, seed=40 + i)))
            c2w = np.eye(4)
            ang = rng.uniform(0, 2 * np.pi)
            c2w[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                           [-np.sin(ang), 0, np.cos(ang)]]
            c2w[:3, 3] = rng.normal(size=3) * 3
            frames.append({"file_path": name,
                           "transform_matrix": c2w.tolist()})
        (tmp_path / f"transforms_{split}.json").write_text(json.dumps(
            {"camera_angle_x": 0.69, "frames": frames}))
    for white in (True, False):
        td = tdataset.BlenderDataset(str(tmp_path), white_background=white)
        jd = jdataset.BlenderDataset(str(tmp_path), white_background=white)
        td.load_cameras()
        jd.load_cameras()
        assert (len(td.train_cameras), len(td.test_cameras)) == (3, 2)
        assert_datasets_match(td, jd)


def test_random_dataset_matches_jax():
    """Cameras exactly (1e-6); the golden-rendered targets within the
    render tolerance, atol 3e-5."""
    td = tdataset.RandomDataset(n_cameras=3, width=24, height=20)
    jd = jdataset.RandomDataset(n_cameras=3, width=24, height=20)
    td.load_cameras()
    jd.load_cameras()
    assert (len(td.train_cameras), len(td.test_cameras)) == (3, 1)
    assert_datasets_match(td, jd, image_atol=3e-5)
    assert float(td.cameras[0].image.max()) > 0.1


def test_load_dataset_dispatches_as_jax(tmp_path):
    colmap_scene(tmp_path / "colmap", n_views=2)
    (tmp_path / "blender").mkdir()
    (tmp_path / "blender" / "transforms_train.json").write_text(json.dumps(
        {"camera_angle_x": 0.7, "frames": []}))
    for root in ("colmap", "blender", "none"):
        # the random scene at test_random_dataset_matches_jax's size, so
        # that the JAX package's golden render reuses its compiled ops
        kw = dict(data_path=str(tmp_path / root), image_height=20,
                  image_width=24, background_color=[0.0, 0.0, 0.0])
        td = tdataset.load_dataset(tconfig.TrainingConfig(**kw))
        jd = jdataset.load_dataset(jconfig.TrainingConfig(**kw))
        assert type(td).__name__ == type(jd).__name__
        assert len(td.cameras) == len(jd.cameras)
        assert getattr(td, "white_background", None) == \
            getattr(jd, "white_background", None)
    assert type(td).__name__ == "RandomDataset" and td.cameras[0].width == 24


# ---- core leftovers ---------------------------------------------------------


def test_fov_from_focal_matches_jax():
    for f, px in ((35.0, 40), (1111.1, 800), (0.5, 3)):
        assert tcamera.fov_from_focal(f, px) == jcamera.fov_from_focal(f, px)


@pytest.mark.parametrize("with_colors,capacity", [(True, None), (False, 96)])
def test_create_from_pcd_matches_jax(with_colors, capacity):
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(70, 3)).astype(np.float32) * 2
    cols = rng.random((70, 3)).astype(np.float32) if with_colors else None
    tg = tgauss.create_from_pcd(pts, cols, capacity=capacity)
    jg = jgauss.create_from_pcd(pts, cols, capacity=capacity)
    for k in tgauss.PARAM_NAMES + tgauss.STAT_NAMES + ("alive",):
        np.testing.assert_array_equal(t2n(getattr(tg, k)),
                                      np.asarray(getattr(jg, k)), err_msg=k)


@pytest.mark.parametrize("capacity", [None, 96])
def test_compact_matches_jax(capacity):
    params, alive, _ = convert.flagship_scene_numpy(128, 100, seed=12)
    alive[np.random.default_rng(13).random(128) < 0.3] = False
    rng = np.random.default_rng(14)
    stats = {k: rng.random(128).astype(np.float32)
             for k in tgauss.STAT_NAMES}
    tg = tgauss.compact(convert.gaussians_from_numpy(params, alive,
                                                     stats=stats), capacity)
    jg = jgauss.compact(jgauss.Gaussians(
        **{k: jnp.asarray(v) for k, v in params.items()},
        **{k: jnp.asarray(v) for k, v in stats.items()},
        alive=jnp.asarray(alive)), capacity)
    assert tg.capacity == jg.capacity == (capacity or 128)
    for k in tgauss.PARAM_NAMES + tgauss.STAT_NAMES + ("alive",):
        np.testing.assert_array_equal(t2n(getattr(tg, k)),
                                      np.asarray(getattr(jg, k)), err_msg=k)
    for n in (1, 3, 100, 1000, 100_000, 167_714):
        pow2 = 1 << max(int(np.ceil(np.log2(max(n * 1.25, 2.0)))), 1)
        aligned = max(-(-int(n * 1.15) // 256) * 256, 256)
        assert tgauss.compact_capacity(n) == (
            min(pow2, aligned) if aligned >= n else pow2)


def test_create_from_random_is_seeded_and_shaped():
    """The draws are torch's (JAX's differ), so this checks what the JAX
    function promises: the ranges, scales, unit quaternions and opacity,
    and the same pool from the same generator seed."""
    make = lambda: tgauss.create_from_random(
        torch.Generator().manual_seed(3), 50, scene_extent=2.0, capacity=64)
    g, g2 = make(), make()
    j = jgauss.create_from_random(jax.random.PRNGKey(0), 50, 2.0, 64)
    for k in tgauss.PARAM_NAMES + ("alive",):
        assert torch.equal(getattr(g, k), getattr(g2, k))
        assert getattr(g, k).shape == np.asarray(getattr(j, k)).shape
    xyz = t2n(g.xyz)[:50]
    assert np.abs(xyz).max() <= 2.0 and np.abs(xyz).max() > 1.0
    np.testing.assert_allclose(t2n(g.scaling)[:50], math.log(0.04))
    np.testing.assert_allclose(np.linalg.norm(t2n(g.rotation), axis=1), 1.0,
                               rtol=1e-6)
    np.testing.assert_array_equal(t2n(g.opacity)[:50], -2.0)
    np.testing.assert_array_equal(t2n(g.alive), np.asarray(j.alive))
