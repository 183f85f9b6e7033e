"""The procedural benchmark scene (counterpart of the scene in
scripts/make_synthetic_scene.py, kept here as package code so that the
generator script, its exporter and the tests share one definition).

Six SDF objects (two tori, three spheres, a rounded box) lit by two
directional lights and an ambient term, seen from cameras on the upper
hemisphere, in the NeRF-synthetic layout `BlenderDataset` reads.  With
`texture=True` the albedos are piecewise-constant procedural cells 5-15 px
wide at 800^2, a scene that only a dense population of small splats
reconstructs (configs/sdf_tex_30k.yaml).

`render_view` ray-marches the scene in plain PyTorch on an explicit
device: spp^2 subsample rays a pixel, all of them batched into one march
(as the JAX renderer does), 128 steps of 0.9 times the distance, a hit
where the last distance is below 1e-3 and t < 12, central-difference
normals (eps 1e-3), straight alpha.  At 800^2 with spp 2 one view marches
2.56M rays; the march holds a few [4, 800, 800, 3] float32 tensors (31 MB
each) and the albedo of the six objects [4, 800, 800, 6, 3] (184 MB).
Peak device memory of one such view: 571 MB above what was allocated
before, 0.14 s a view once warm (NVIDIA H100 80GB HBM3, 700.00 W;
scripts/tex30k_run_torch.py).

`sample_surface_points` (numpy, seeded) is the stand-in for the SfM seed
points of a real scene.  `_tex_albedo` and `_hash_lattice` take `xp`, numpy
or torch, so the renderer and the sampler share one texture.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FOVX = 0.6911112070083618  # camera_angle_x of NeRF-synthetic lego

TEX_PALETTES = [
    ([0.90, 0.20, 0.15], [0.95, 0.85, 0.20]),   # torus: red/gold
    ([0.10, 0.30, 0.85], [0.20, 0.90, 0.90]),   # sphere: blue/cyan
    ([0.90, 0.45, 0.10], [0.30, 0.10, 0.50]),   # box: orange/purple
    ([0.10, 0.70, 0.20], [0.95, 0.95, 0.90]),   # small sphere: green/white
    ([0.85, 0.10, 0.50], [0.15, 0.15, 0.20]),   # small sphere: magenta/near-black
    ([0.40, 0.25, 0.10], [0.90, 0.80, 0.60]),   # small torus: brown/sand
]
TEX_FREQS = [24.0, 30.0, 26.0, 40.0, 40.0, 34.0]

# The scene's objects: (kind, centre, sizes) in the JAX script's order.
OBJECTS = [
    ("torus", [0.0, -0.15, 0.0], (0.75, 0.22)),
    ("sphere", [0.45, 0.38, -0.25], (0.34,)),
    ("box", [-0.55, 0.25, 0.35], ([0.22, 0.3, 0.2], 0.05)),
    ("sphere", [-0.2, -0.1, -0.65], (0.18,)),
    ("sphere", [0.75, -0.35, 0.55], (0.15,)),
    ("torus", [0.05, 0.75, 0.3], (0.3, 0.09)),
]
CONST_ALBEDOS = {3: [0.9, 0.9, 0.25], 4: [0.35, 0.9, 0.5],
                 5: [0.55, 0.35, 0.95]}
LIGHTS = [([0.5, 0.7, -0.5], 0.9),    # key
          ([-0.6, 0.4, 0.6], 0.45)]   # fill
AMBIENT = 0.22
MARCH_STEPS = 128


def _f32(xp, v, like):
    if xp is np:
        return np.asarray(v, np.float32)
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def _hash_lattice(xp, p, scale):
    """Per-lattice-cell uniform [0,1) value (piecewise constant: sharp
    edges at every cell boundary, the texture's high-frequency content).

    The sine's argument reaches ~1e4 and its value is scaled by 43758, so
    one float32 ulp of the argument or of the sine moves the cell's value
    by up to 3e-3, and every library rounds them its own way.  In torch
    the argument is therefore formed as XLA forms it for the JAX renderer
    on the CPU, fma(q2, c, fma(q0, a, q1 * b)) (each fused multiply-add
    exact in float64, then rounded once), and the sine is taken in float64
    and rounded: the card and the CPU give one texture, and it is the JAX
    renderer's wherever XLA's float32 sine rounds correctly."""
    q = xp.floor(p * scale)
    if xp is np:
        h = xp.sin(q[..., 0] * 12.9898 + q[..., 1] * 78.233
                   + q[..., 2] * 37.719) * 43758.5453
        return h - xp.floor(h)
    a, b, c = (torch.tensor(v, dtype=torch.float32).double()
               for v in (12.9898, 78.233, 37.719))
    q64 = q.double()
    inner = (q64[..., 0] * a + (q[..., 1] * b.float()).double()).float()
    arg = (q64[..., 2] * c + inner.double()).float()
    h = torch.sin(arg.double()).float() * 43758.5453
    return h - torch.floor(h)


def _tex_albedo(xp, p, ca, cb, freq):
    """Two-colour palette mixed by a fine 3D checker + two hash lattices."""
    ca = _f32(xp, ca, p)
    cb = _f32(xp, cb, p)
    ch = (xp.floor(p[..., 0] * freq) + xp.floor(p[..., 1] * freq)
          + xp.floor(p[..., 2] * freq)) % 2.0
    m = 0.35 * ch + 0.45 * _hash_lattice(xp, p, freq * 1.7) \
        + 0.20 * _hash_lattice(xp, p, freq * 3.1)
    m = xp.clip(m, 0.0, 1.0)[..., None]
    return ca * (1.0 - m) + cb * m


# --------------------------------------------------------------------------
# The SDF scene, in torch
# --------------------------------------------------------------------------

def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1))


def _sdf(kind, c, sizes, p):
    q = p - c
    if kind == "sphere":
        return _norm(q) - sizes[0]
    if kind == "torus":
        qxz = torch.sqrt(q[..., 0] ** 2 + q[..., 2] ** 2) - sizes[0]
        return torch.sqrt(qxz ** 2 + q[..., 1] ** 2) - sizes[1]
    b, rad = sizes
    q = q.abs() - b
    return (_norm(torch.clamp(q, min=0.0))
            + torch.clamp(torch.maximum(q[..., 0], torch.maximum(
                q[..., 1], q[..., 2])), max=0.0) - rad)


def _albedo(i: int, p: torch.Tensor, texture: bool) -> torch.Tensor:
    if texture:
        ca, cb = TEX_PALETTES[i]
        return _tex_albedo(torch, p, ca, cb, TEX_FREQS[i])
    if i == 0:
        ang = torch.atan2(p[..., 2], p[..., 0])
        s = 0.5 + 0.5 * torch.sin(6.0 * ang)
        return torch.stack([0.85 * s + 0.1, 0.25 + 0.2 * s,
                            0.2 * torch.ones_like(s)], dim=-1)
    if i == 1:
        ch = (torch.floor(p[..., 0] * 6) + torch.floor(p[..., 1] * 6)
              + torch.floor(p[..., 2] * 6)) % 2
        return torch.stack([0.15 + 0.1 * ch, 0.35 + 0.45 * ch,
                            0.8 - 0.3 * ch], dim=-1)
    if i == 2:
        g = 0.5 + 0.5 * torch.sin(10.0 * p[..., 1])
        return torch.stack([0.9 * torch.ones_like(g), 0.75 * g + 0.15,
                            0.15 + 0.2 * g], dim=-1)
    return _f32(torch, CONST_ALBEDOS[i], p).expand(p.shape[:-1] + (3,))


class Scene:
    """The SDF scene on one device: distances, object ids and albedos of
    points [..., 3]."""

    def __init__(self, texture: bool, device):
        self.texture = texture
        self.objects = [(k, torch.tensor(c, dtype=torch.float32,
                                         device=device),
                         tuple(torch.tensor(s, dtype=torch.float32,
                                            device=device)
                               if isinstance(s, list) else s for s in sizes))
                        for k, c, sizes in OBJECTS]

    def distances(self, p: torch.Tensor) -> torch.Tensor:
        """[..., n_obj]."""
        return torch.stack([_sdf(k, c, s, p) for k, c, s in self.objects],
                           dim=-1)

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        d = _sdf(*self.objects[0], p)
        for obj in self.objects[1:]:
            d = torch.minimum(d, _sdf(*obj, p))
        return d

    def albedo(self, p: torch.Tensor, oid: torch.Tensor) -> torch.Tensor:
        cols = torch.stack([_albedo(i, p, self.texture)
                            for i in range(len(self.objects))], dim=-2)
        return torch.take_along_dim(cols, oid[..., None, None],
                                    dim=-2)[..., 0, :]


def render_view(R, T, size: int, spp: int = 2, texture: bool = False,
                device="cpu") -> torch.Tensor:
    """R [3,3] camera->world rotation (+z forward, y-down pixels), T [3]
    camera centre -> [size, size, 4] float32 RGBA (straight alpha) on
    `device`."""
    device = torch.device(device)
    scene = Scene(texture, device)
    f32 = dict(dtype=torch.float32, device=device)
    H = W = size
    fx = fy = 0.5 * W / math.tan(FOVX / 2)
    cx, cy = 0.5 * W, 0.5 * H
    R = torch.as_tensor(np.asarray(R, np.float32), **f32)
    T = torch.as_tensor(np.asarray(T, np.float32), **f32)
    with torch.no_grad():
        sub = (torch.arange(spp, **f32) + 0.5) / spp - 0.5
        sy, sx = torch.meshgrid(sub, sub, indexing="ij")
        dxy = torch.stack([sx, sy], dim=-1).reshape(-1, 2)        # [S,2]
        ii, jj = torch.meshgrid(torch.arange(H, **f32),
                                torch.arange(W, **f32), indexing="ij")
        x = (jj[None] + dxy[:, 0, None, None] - cx) / fx          # [S,H,W]
        y = -(ii[None] + dxy[:, 1, None, None] - cy) / fy
        d_cam = torch.stack([x, y, torch.ones_like(x)], dim=-1)   # [S,H,W,3]
        d_cam = d_cam / _norm(d_cam)[..., None]
        d = d_cam @ R.T
        o = T.expand(d.shape)
        t = torch.full(d.shape[:-1], 0.05, **f32)
        for _ in range(MARCH_STEPS):
            dist = scene.distance(o + t[..., None] * d)
            t = t + torch.clamp(dist, min=0.0) * 0.9
        hit = (dist < 1e-3) & (t < 12.0)
        p = o + t[..., None] * d
        oid = scene.distances(p).argmin(dim=-1)
        eps = 1e-3
        n = torch.stack([
            scene.distance(p + e) - scene.distance(p - e)
            for e in torch.eye(3, **f32) * eps], dim=-1)
        n = n / (_norm(n)[..., None] + 1e-9)
        shade = AMBIENT
        for ldir, lint in LIGHTS:
            ldir = torch.tensor(ldir, **f32)
            ldir = ldir / _norm(ldir)
            shade = shade + lint * torch.clamp((n * ldir).sum(-1), min=0.0)
        rgb = torch.clamp(scene.albedo(p, oid) * shade[..., None], 0.0, 1.0)
        a = hit.to(torch.float32)
        rgb_acc = (rgb * a[..., None]).mean(dim=0)                # [H,W,3]
        a_acc = a.mean(dim=0)
        straight = torch.where(a_acc[..., None] > 1e-6,
                               rgb_acc / torch.clamp(a_acc[..., None],
                                                     min=1e-6), 0.0)
        return torch.cat([torch.clamp(straight, 0, 1), a_acc[..., None]],
                         dim=-1)


# --------------------------------------------------------------------------
# Cameras and the seed point cloud (numpy)
# --------------------------------------------------------------------------

def camera_pose(theta: float, phi: float, radius: float):
    """Camera on the sphere looking at the origin.  Returns (R, T): the C2W
    rotation with columns [right, up, fwd] (+z forward) and the centre."""
    center = np.array([radius * math.cos(phi) * math.sin(theta),
                       radius * math.sin(phi),
                       -radius * math.cos(phi) * math.cos(theta)], np.float64)
    fwd = -center / np.linalg.norm(center)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    nr = np.linalg.norm(right)
    if nr < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
        nr = 1.0
    right = right / nr
    upv = np.cross(fwd, right)
    R = np.stack([right, upv, fwd], axis=1)
    return R.astype(np.float32), center.astype(np.float32)


def to_blender_c2w(R: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Inverse of BlenderDataset's convention flip:
    c2w_blender[:3,:3] = R_ours @ diag(1,-1,-1)."""
    c2w = np.eye(4, dtype=np.float64)
    c2w[:3, :3] = R @ np.diag([1.0, -1.0, -1.0])
    c2w[:3, 3] = T
    return c2w


def sample_surface_points(n: int = 30000, seed: int = 1,
                          texture: bool = False):
    """Surface samples of the six objects with their albedo times a
    typical shading factor 0.65 (numpy, from default_rng(seed)): the
    scene's seed point cloud, written as `points3d.ply`."""
    rng = np.random.default_rng(seed)

    def torus(c, R_, r_, m):
        u = rng.uniform(0, 2 * math.pi, m)
        v = rng.uniform(0, 2 * math.pi, m)
        return np.stack([c[0] + (R_ + r_ * np.cos(v)) * np.cos(u),
                         c[1] + r_ * np.sin(v),
                         c[2] + (R_ + r_ * np.cos(v)) * np.sin(u)], axis=1)

    def sphere(c, r_, m):
        d = rng.standard_normal((m, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return np.asarray(c) + r_ * d

    def box(c, b, m):
        # sample on the 6 faces, area-weighted
        b = np.asarray(b)
        areas = np.array([b[1] * b[2], b[1] * b[2], b[0] * b[2],
                          b[0] * b[2], b[0] * b[1], b[0] * b[1]])
        face = rng.choice(6, m, p=areas / areas.sum())
        p = rng.uniform(-1, 1, (m, 3)) * b
        axis = face // 2
        sign = np.where(face % 2 == 0, 1.0, -1.0)
        p[np.arange(m), axis] = sign * b[axis]
        return np.asarray(c) + p

    def alb_torus(p):
        ang = np.arctan2(p[:, 2], p[:, 0])
        s = 0.5 + 0.5 * np.sin(6.0 * ang)
        return np.stack([0.85 * s + 0.1, 0.25 + 0.2 * s,
                         0.2 * np.ones_like(s)], axis=1)

    def alb_sphere(p):
        ch = ((np.floor(p[:, 0] * 6) + np.floor(p[:, 1] * 6)
               + np.floor(p[:, 2] * 6)) % 2)
        return np.stack([0.15 + 0.1 * ch, 0.35 + 0.45 * ch,
                         0.8 - 0.3 * ch], axis=1)

    def alb_box(p):
        g = 0.5 + 0.5 * np.sin(10.0 * p[:, 1])
        return np.stack([0.9 * np.ones_like(g), 0.75 * g + 0.15,
                         0.15 + 0.2 * g], axis=1)

    geoms = [
        torus([0.0, -0.15, 0.0], 0.75, 0.22, n * 4 // 10),
        sphere([0.45, 0.38, -0.25], 0.34, n * 2 // 10),
        box([-0.55, 0.25, 0.35], [0.22, 0.3, 0.2], n * 2 // 10),
        sphere([-0.2, -0.1, -0.65], 0.18, n // 20),
        sphere([0.75, -0.35, 0.55], 0.15, n // 20),
        torus([0.05, 0.75, 0.3], 0.3, 0.09, n // 10),
    ]
    if texture:
        def make_tex(i):
            ca, cb = TEX_PALETTES[i]
            return lambda p: _tex_albedo(np, p, ca, cb, TEX_FREQS[i])
        albs = [make_tex(i) for i in range(6)]
    else:
        albs = [alb_torus, alb_sphere, alb_box] + [
            (lambda p, c=CONST_ALBEDOS[i]: np.tile(c, (len(p), 1)))
            for i in (3, 4, 5)]
    parts = list(zip(geoms, albs))
    pts = np.concatenate([p for p, _ in parts]).astype(np.float32)
    cols = np.concatenate([a(p) for p, a in parts]).astype(np.float32)
    cols = np.clip(cols * 0.65, 0.0, 1.0)  # typical shading factor
    return pts, cols
