"""The benchmark's scene generator: a frozen copy of the procedural SDF
scene of the measured package (`data/synthetic.py`: six textured objects,
two directional lights and an ambient term, ray-marched in plain PyTorch),
made to take any W x H and field of view, and to add a ground plane and a
distant background shell for an unbounded outdoor capture.

`render_view` ray-marches a target: spp^2 sub-sample rays a pixel, each
step 0.9 times the distance to the nearest surface, a hit where the last
distance is below 1e-3 and t < max_t, central-difference normals, straight
alpha.  With no extra surfaces, a square image and the lego field of view
it computes what the package's `render_view` computes.

`sample_gaussians` places Gaussians on the surfaces from a torch.Generator
on the device: points sampled on each surface (the objects' split of the
package's seed sampler), pulled onto the SDF's zero set, and given the
scale of the local sample spacing, flattened along the normal, a high
opacity, the shaded albedo as the SH DC term and small SH rest terms.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

FOVX_LEGO = 0.6911112070083618  # camera_angle_x of NeRF-synthetic lego
SH_C0 = 0.28209479177387814

TEX_PALETTES = [
    ([0.90, 0.20, 0.15], [0.95, 0.85, 0.20]),
    ([0.10, 0.30, 0.85], [0.20, 0.90, 0.90]),
    ([0.90, 0.45, 0.10], [0.30, 0.10, 0.50]),
    ([0.10, 0.70, 0.20], [0.95, 0.95, 0.90]),
    ([0.85, 0.10, 0.50], [0.15, 0.15, 0.20]),
    ([0.40, 0.25, 0.10], [0.90, 0.80, 0.60]),
]
TEX_FREQS = [24.0, 30.0, 26.0, 40.0, 40.0, 34.0]
OBJECTS = [
    ("torus", [0.0, -0.15, 0.0], (0.75, 0.22)),
    ("sphere", [0.45, 0.38, -0.25], (0.34,)),
    ("box", [-0.55, 0.25, 0.35], ([0.22, 0.3, 0.2], 0.05)),
    ("sphere", [-0.2, -0.1, -0.65], (0.18,)),
    ("sphere", [0.75, -0.35, 0.55], (0.15,)),
    ("torus", [0.05, 0.75, 0.3], (0.3, 0.09)),
]
# The seed sampler's split of the objects' points (tenths, twentieths).
OBJECT_SHARES = (0.4, 0.2, 0.2, 0.05, 0.05, 0.1)
CONST_ALBEDOS = {3: [0.9, 0.9, 0.25], 4: [0.35, 0.9, 0.5],
                 5: [0.55, 0.35, 0.95]}
LIGHTS = [([0.5, 0.7, -0.5], 0.9), ([-0.6, 0.4, 0.6], 0.45)]
AMBIENT = 0.22
# The outdoor surfaces' textures: ground (grass and dirt), shell (sky and
# tree line).
EXTRA_PALETTES = {"plane": (([0.30, 0.42, 0.16], [0.52, 0.46, 0.32]), 9.0),
                  "shell": (([0.50, 0.64, 0.86], [0.22, 0.30, 0.16]), 2.5)}


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1))


def _hash_lattice(p, scale):
    """Per-lattice-cell value in [0, 1), formed as the package forms it (the
    sine's argument by fused steps in float64, the sine in float64), so that
    the card and the CPU give one texture."""
    q = torch.floor(p * scale)
    a, b, c = (torch.tensor(v, dtype=torch.float32).double()
               for v in (12.9898, 78.233, 37.719))
    q64 = q.double()
    inner = (q64[..., 0] * a + (q[..., 1] * b.float()).double()).float()
    arg = (q64[..., 2] * c + inner.double()).float()
    h = torch.sin(arg.double()).float() * 43758.5453
    return h - torch.floor(h)


def _tex_albedo(p, ca, cb, freq):
    ca = torch.as_tensor(ca, dtype=torch.float32, device=p.device)
    cb = torch.as_tensor(cb, dtype=torch.float32, device=p.device)
    ch = (torch.floor(p[..., 0] * freq) + torch.floor(p[..., 1] * freq)
          + torch.floor(p[..., 2] * freq)) % 2.0
    m = 0.35 * ch + 0.45 * _hash_lattice(p, freq * 1.7) \
        + 0.20 * _hash_lattice(p, freq * 3.1)
    m = torch.clip(m, 0.0, 1.0)[..., None]
    return ca * (1.0 - m) + cb * m


def _sdf(kind, c, sizes, p):
    if kind == "plane":          # the ground y = c, seen from above
        return p[..., 1] - c
    if kind == "shell":          # a sphere of radius c, seen from inside
        return c - _norm(p)
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
        return _tex_albedo(p, ca, cb, TEX_FREQS[i])
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
    return torch.as_tensor(CONST_ALBEDOS[i], dtype=torch.float32,
                           device=p.device).expand(p.shape[:-1] + (3,))


class Scene:
    """The six objects and the `extras`, e.g. [("plane", -0.5), ("shell",
    9.0)], on one device."""

    def __init__(self, texture: bool, device, extras: Sequence = ()):
        self.texture = texture
        t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        self.objects = [(k, t(c), tuple(t(s) if isinstance(s, list) else s
                                        for s in sizes))
                        for k, c, sizes in OBJECTS]
        self.objects += [(kind, float(v), ()) for kind, v in extras]
        self.kinds = [k for k, _, _ in self.objects]

    def distances(self, p: torch.Tensor) -> torch.Tensor:
        return torch.stack([_sdf(k, c, s, p) for k, c, s in self.objects],
                           dim=-1)

    def distance(self, p: torch.Tensor) -> torch.Tensor:
        d = _sdf(*self.objects[0], p)
        for obj in self.objects[1:]:
            d = torch.minimum(d, _sdf(*obj, p))
        return d

    def albedo_of(self, i: int, p: torch.Tensor) -> torch.Tensor:
        if i < len(OBJECTS):
            return _albedo(i, p, self.texture)
        (ca, cb), freq = EXTRA_PALETTES[self.kinds[i]]
        return _tex_albedo(p, ca, cb, freq)

    def albedo(self, p: torch.Tensor, oid: torch.Tensor) -> torch.Tensor:
        cols = torch.stack([self.albedo_of(i, p)
                            for i in range(len(self.objects))], dim=-2)
        return torch.take_along_dim(cols, oid[..., None, None],
                                    dim=-2)[..., 0, :]

    def normal(self, p: torch.Tensor, sdf=None) -> torch.Tensor:
        """Central-difference normals of the scene's SDF (or of `sdf`)."""
        sdf = self.distance if sdf is None else sdf
        eps = 1e-3
        n = torch.stack([sdf(p + e) - sdf(p - e)
                         for e in torch.eye(3, dtype=p.dtype,
                                            device=p.device) * eps], dim=-1)
        return n / (_norm(n)[..., None] + 1e-9)

    def surface(self, i: int):
        """The SDF of surface i alone."""
        return lambda p: _sdf(*self.objects[i], p)

    def shade(self, n: torch.Tensor) -> torch.Tensor:
        s = AMBIENT
        for ldir, lint in LIGHTS:
            ldir = torch.tensor(ldir, dtype=n.dtype, device=n.device)
            ldir = ldir / _norm(ldir)
            s = s + lint * torch.clamp((n * ldir).sum(-1), min=0.0)
        return s


def render_view(scene: Scene, R, T, width: int, height: int,
                fovx: float = FOVX_LEGO, spp: int = 2,
                march_steps: int = 128, max_t: float = 12.0) -> torch.Tensor:
    """R [3, 3] camera->world rotation (+z forward, y-down pixels), T [3]
    the centre -> [height, width, 4] float32 RGBA, straight alpha."""
    device = scene.objects[0][1].device
    f32 = dict(dtype=torch.float32, device=device)
    H, W = height, width
    fx = fy = 0.5 * W / math.tan(fovx / 2)
    cx, cy = 0.5 * W, 0.5 * H
    R = torch.as_tensor(np.asarray(R, np.float32), **f32)
    T = torch.as_tensor(np.asarray(T, np.float32), **f32)
    with torch.no_grad():
        sub = (torch.arange(spp, **f32) + 0.5) / spp - 0.5
        sy, sx = torch.meshgrid(sub, sub, indexing="ij")
        dxy = torch.stack([sx, sy], dim=-1).reshape(-1, 2)
        ii, jj = torch.meshgrid(torch.arange(H, **f32),
                                torch.arange(W, **f32), indexing="ij")
        x = (jj[None] + dxy[:, 0, None, None] - cx) / fx
        y = -(ii[None] + dxy[:, 1, None, None] - cy) / fy
        d_cam = torch.stack([x, y, torch.ones_like(x)], dim=-1)
        d_cam = d_cam / _norm(d_cam)[..., None]
        d = d_cam @ R.T
        o = T.expand(d.shape)
        t = torch.full(d.shape[:-1], 0.05, **f32)
        for _ in range(march_steps):
            dist = scene.distance(o + t[..., None] * d)
            t = t + torch.clamp(dist, min=0.0) * 0.9
        hit = (dist < 1e-3) & (t < max_t)
        p = o + t[..., None] * d
        oid = scene.distances(p).argmin(dim=-1)
        rgb = torch.clamp(scene.albedo(p, oid)
                          * scene.shade(scene.normal(p))[..., None], 0.0, 1.0)
        a = hit.to(torch.float32)
        # A ray that escapes every surface grows t geometrically until its
        # point overflows and its colour is NaN: only hits carry colour.
        rgb_acc = torch.where(hit[..., None], rgb, 0.0).mean(dim=0)
        a_acc = a.mean(dim=0)
        straight = torch.where(a_acc[..., None] > 1e-6,
                               rgb_acc / torch.clamp(a_acc[..., None],
                                                     min=1e-6), 0.0)
        return torch.cat([torch.clamp(straight, 0, 1), a_acc[..., None]],
                         dim=-1)


def camera_pose(theta: float, phi: float, radius: float):
    """A camera on the sphere looking at the origin: (R, T), the C2W
    rotation with columns [right, up, forward] and the centre."""
    center = np.array([radius * math.cos(phi) * math.sin(theta),
                       radius * math.sin(phi),
                       -radius * math.cos(phi) * math.cos(theta)], np.float64)
    fwd = -center / np.linalg.norm(center)
    right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
    nr = np.linalg.norm(right)
    right = np.array([1.0, 0.0, 0.0]) if nr < 1e-6 else right / nr
    R = np.stack([right, np.cross(fwd, right), fwd], axis=1)
    return R.astype(np.float32), center.astype(np.float32)


def _surface_points(kind, c, sizes, n, gen, device):
    """n points on one surface (parametric; the box on its faces, area
    weighted) and the surface's area."""
    f32 = dict(dtype=torch.float32, device=device)
    u = lambda *shape: torch.rand(*shape, generator=gen, **f32)
    if kind == "torus":
        R_, r_ = sizes
        a, b = 2 * math.pi * u(n), 2 * math.pi * u(n)
        p = torch.stack([(R_ + r_ * torch.cos(b)) * torch.cos(a),
                         r_ * torch.sin(b),
                         (R_ + r_ * torch.cos(b)) * torch.sin(a)], -1)
        return p + torch.as_tensor(c, **f32), 4 * math.pi ** 2 * R_ * r_
    if kind == "sphere":
        d = torch.randn(n, 3, generator=gen, **f32)
        d = d / _norm(d)[:, None]
        return torch.as_tensor(c, **f32) + sizes[0] * d, \
            4 * math.pi * sizes[0] ** 2
    b = torch.as_tensor(sizes[0], **f32) + sizes[1]
    faces = torch.stack([b[1] * b[2], b[0] * b[2], b[0] * b[1]])
    axis = torch.multinomial(faces.repeat(2) / faces.repeat(2).sum(), n,
                             replacement=True, generator=gen) % 3
    sign = torch.where(u(n) < 0.5, -1.0, 1.0)
    p = (2 * u(n, 3) - 1) * b
    p[torch.arange(n, device=device), axis] = sign * b[axis]
    return torch.as_tensor(c, **f32) + p, float(8 * faces.sum())


def _disk_points(y0, r0, r1, n, gen, device):
    """Ground points with log-uniform distance from the centre: an equal
    number a ring of every width ratio, as a capture's density falls off."""
    f32 = dict(dtype=torch.float32, device=device)
    r = r0 * (r1 / r0) ** torch.rand(n, generator=gen, **f32)
    a = 2 * math.pi * torch.rand(n, generator=gen, **f32)
    p = torch.stack([r * torch.cos(a), torch.full_like(r, y0),
                     r * torch.sin(a)], -1)
    # area per point at distance r: 2 pi r^2 ln(r1 / r0) / n
    spacing = r * math.sqrt(2 * math.pi * math.log(r1 / r0) / n)
    return p, spacing


def _shell_points(radius, y0, n, gen, device):
    """Points on the shell above the ground plane y0."""
    f32 = dict(dtype=torch.float32, device=device)
    lo = y0 / radius
    yy = lo + (1 - lo) * torch.rand(n, generator=gen, **f32)
    a = 2 * math.pi * torch.rand(n, generator=gen, **f32)
    s = torch.sqrt(torch.clamp(1 - yy * yy, min=0.0))
    p = radius * torch.stack([s * torch.cos(a), yy, s * torch.sin(a)], -1)
    area = 2 * math.pi * radius ** 2 * (1 - lo)
    return p, torch.full((n,), math.sqrt(area / n), **f32)


def _quat_z_to(n: torch.Tensor, twist: torch.Tensor) -> torch.Tensor:
    """wxyz quaternions that turn +z onto the unit normals n, after a twist
    about z."""
    z = torch.zeros_like(n)
    z[:, 2] = 1.0
    w = 1.0 + n[:, 2]
    xyz = torch.cross(z, n, dim=-1)
    flip = w < 1e-6      # n = -z: half a turn about x
    q = torch.cat([w[:, None], xyz], -1)
    q[flip] = torch.tensor([0.0, 1.0, 0.0, 0.0], device=n.device)
    q = q / _norm(q)[:, None]
    c, s = torch.cos(0.5 * twist), torch.sin(0.5 * twist)
    w1, x1, y1, z1 = q.unbind(-1)
    return torch.stack([w1 * c - z1 * s, x1 * c + y1 * s,
                        y1 * c - x1 * s, w1 * s + z1 * c], -1)


def sample_gaussians(scene: Scene, counts: dict, gen: torch.Generator,
                     sigma_per_spacing: float, flatten: float,
                     opacity_range, sh_rest_std: float,
                     ground: tuple = (), shell: tuple = ()):
    """Gaussians on the scene's surfaces.  `counts`: {"objects": n,
    "ground": n, "shell": n}; `ground` (y0, r0, r1), `shell` (radius, y0).
    Returns the parameter tensors (xyz, features_dc [n, 1, 3],
    features_rest [n, 15, 3], scaling as log-sigma, rotation wxyz, opacity
    logit) on the generator's device."""
    dev = gen.device
    parts = []                   # (surface index, points, spacing)
    n_obj = counts.get("objects", 0)
    shares = [int(n_obj * s) for s in OBJECT_SHARES]
    shares[0] += n_obj - sum(shares)
    for i, ((kind, c, sizes), m) in enumerate(zip(OBJECTS, shares)):
        p, area = _surface_points(kind, c, sizes, m, gen, dev)
        parts.append((i, p, torch.full((m,), math.sqrt(area / m),
                                       device=dev)))
    for part, kind, make, args in (("ground", "plane", _disk_points, ground),
                                   ("shell", "shell", _shell_points, shell)):
        if counts.get(part, 0):
            parts.append((scene.kinds.index(kind),
                          *make(*args, counts[part], gen, dev)))
    pts, normals, rgbs = [], [], []
    with torch.no_grad():
        for i, p, _ in parts:
            sdf = scene.surface(i)
            for _ in range(2):   # onto the surface's zero set
                p = p - sdf(p)[:, None] * scene.normal(p, sdf)
            normal = scene.normal(p, sdf)
            pts.append(p)
            normals.append(normal)
            rgbs.append(torch.clamp(scene.albedo_of(i, p)
                                    * scene.shade(normal)[:, None], 0, 1))
    p, normal, rgb = torch.cat(pts), torch.cat(normals), torch.cat(rgbs)
    spacing = torch.cat([s for _, _, s in parts])
    n = p.shape[0]
    u = lambda *shape: torch.rand(*shape, generator=gen, device=dev)
    aniso = 0.7 + 0.6 * u(n)
    sig = sigma_per_spacing * spacing
    scaling = torch.log(torch.stack([sig * aniso, sig / aniso,
                                     sig * flatten], -1))
    rotation = _quat_z_to(normal, 2 * math.pi * u(n))
    lo, hi = opacity_range
    op = lo + (hi - lo) * u(n)
    return dict(
        xyz=p.contiguous(),
        features_dc=((rgb - 0.5) / SH_C0)[:, None, :].contiguous(),
        features_rest=sh_rest_std * torch.randn(n, 15, 3, generator=gen,
                                                device=dev),
        scaling=scaling.contiguous(), rotation=rotation.contiguous(),
        opacity=torch.log(op / (1 - op))[:, None].contiguous())
