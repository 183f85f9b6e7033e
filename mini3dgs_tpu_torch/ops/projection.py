"""EWA projection of 3D Gaussians to screen space + frustum culling
(counterpart of mini3dgs_tpu/ops/projection.py).

World->camera transform, pinhole projection x = fx*X/Z + cx,
y = -fy*Y/Z + cy (y-down), Sigma_cam = Rv Sigma Rv^T,
Sigma_2D = J Sigma_cam J^T + 1e-6 I, conic = Sigma_2D^-1, radius =
3*sqrt(lambda_max) clamped, and the cull predicate Z>0, -r<=x<W+r,
-r<=y<H+r, r>0.  The 3x3 products are written out per component in float32
(no matmul), so no TF32 path can touch them on the GPU.

`project_gaussians` runs CUDA tensors through `project_fwd`: one autograd
op whose forward is one launch of the hand-written kernel
`csrc/project_fwd.cu` (P1) and whose backward is one launch of
`csrc/project_bwd.cu` (P2, `project_bwd`); autograd records its graph where
grad mode is on and a parameter requires grad (a train step), and nowhere
else (the viewer, the trainer's validation and evaluation renders).  CPU
tensors, and a graph through the camera, run `project_gaussians_plain`,
the differentiable chain of PyTorch ops, which both kernels are held
against on the card (P2 through `project_bwd_plain`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from ..core import sh as sh_lib
from ..core.camera import Camera
from ..core.gaussians import PARAM_NAMES, SH_REST, Gaussians
from ..core.transforms import quat_to_rotmat_components
from .cuda_library import launch
from .raster_ref import W_EPS

# s >= dx^2/Sigma_xx, so |dx| > sqrt(2 ln(1/W_EPS) * a) means w < W_EPS;
# the extents add 1 px for float rounding of the sqrt and the raster's
# quadratic.
CULL_SIGMA = math.sqrt(2.0 * math.log(1.0 / W_EPS))


class Projected(NamedTuple):
    means2d: torch.Tensor   # [C,2] pixel coordinates
    conic: torch.Tensor     # [C,3] (a, b, c) of the symmetric 2x2 conic Q
    depth: torch.Tensor     # [C]   camera-frame Z
    radius: torch.Tensor    # [C]   pixel radius (3 sigma), clamped
    visible: torch.Tensor   # [C]   bool cull mask (includes alive)
    color: torch.Tensor     # [C,3] decoded RGB
    opacity: torch.Tensor   # [C]   sigmoid opacity
    # Exact-cull half-extents: a pixel with |px-cx| > ext_x has weight below
    # the W_EPS skip threshold, so binning may drop tiles beyond them.
    ext_x: torch.Tensor     # [C]
    ext_y: torch.Tensor     # [C]


def _dot3(u, v):
    return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]


def camera_needs_grad(camera: Camera) -> bool:
    """Whether grad mode is on and a camera tensor requires grad."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in (camera.view_matrix, camera.FoVx,
                                  camera.FoVy))


def project_gaussians(g: Gaussians, camera: Camera, *,
                      radius_min: float = 0.01, radius_max: float = 50.0,
                      color_mode: str = "dc_sigmoid", sh_degree: int = 0,
                      scale_modifier: float = 1.0,
                      antialias: bool = False) -> Projected:
    """The projected rows of every slot of `g`: `project_fwd` (P1, and P2
    in the backward; it raises on what the kernels do not take) for CUDA
    tensors, `project_gaussians_plain` for CPU tensors and for a graph
    through the camera."""
    kw = dict(radius_min=radius_min, radius_max=radius_max,
              color_mode=color_mode, sh_degree=sh_degree,
              scale_modifier=scale_modifier, antialias=antialias)
    if g.xyz.device.type != "cuda" or camera_needs_grad(camera):
        return project_gaussians_plain(g, camera, **kw)
    return project_fwd(g, camera, **kw)


def project_gaussians_plain(g: Gaussians, camera: Camera, *,
                            radius_min: float = 0.01,
                            radius_max: float = 50.0,
                            color_mode: str = "dc_sigmoid",
                            sh_degree: int = 0, scale_modifier: float = 1.0,
                            antialias: bool = False) -> Projected:
    """The projection as a chain of PyTorch ops, on either device and
    differentiable.  Under a graph, a row that cannot be visible gets a
    gradient of exactly 0, and its conic, radius and extents are those of
    its point moved to depth 1 (without a graph they are what P1
    computes)."""
    W, H = camera.width, camera.height
    fx = 0.5 * W / torch.tan(camera.FoVx * 0.5)
    fy = 0.5 * H / torch.tan(camera.FoVy * 0.5)
    cx, cy = 0.5 * W, 0.5 * H

    V = camera.view_matrix
    Rv, Tv = V[:3, :3], V[:3, 3]
    Xw = g.xyz
    X, Y, Z = (_dot3(Rv[i], (Xw[:, 0], Xw[:, 1], Xw[:, 2])) + Tv[i]
               for i in range(3))

    # Guard divides: behind-camera / dead points get Z=1 and are culled.
    front = Z > 1e-6
    Zs = torch.where(front, Z, torch.ones_like(Z))
    invZ = 1.0 / Zs

    xpix = fx * X * invZ + cx
    ypix = -fy * Y * invZ + cy
    means2d = torch.stack([xpix, ypix], dim=-1)

    # Sigma_cam = (Rv R diag(s)) (Rv R diag(s))^T, one column product at a
    # time: rows[i][l] = (sum_j Rv[i,j] r_jl) * s_l.
    sigma = g.get_scaling * scale_modifier
    s0, s1, s2 = sigma[:, 0], sigma[:, 1], sigma[:, 2]
    r = quat_to_rotmat_components(g.rotation)
    rows = []
    for i in range(3):
        m0, m1, m2 = Rv[i, 0], Rv[i, 1], Rv[i, 2]
        rows.append(((m0 * r[0] + m1 * r[3] + m2 * r[6]) * s0,
                     (m0 * r[1] + m1 * r[4] + m2 * r[7]) * s1,
                     (m0 * r[2] + m1 * r[5] + m2 * r[8]) * s2))

    if any(t.requires_grad for t in (X, Y, Zs, sigma, r[0], fx, fy)):
        # Under a graph, a row that no radius (at most radius_max) can bring
        # into the frame takes the Jacobian at depth 1: a centre just in
        # front of the camera's plane far to the side overflows the 2D
        # covariance, and autograd would multiply the row's zero cotangent
        # by its infinite derivatives.  Its gradient is then exactly 0;
        # every other row computes what it did.
        m = max(radius_min, radius_max)
        near = (front & g.alive & (xpix >= -m) & (xpix < W + m)
                & (ypix >= -m) & (ypix < H + m))
        invZ = 1.0 / torch.where(near, Zs, 1.0)
    invZ2 = invZ * invZ

    # J = [[fx/Z, 0, -fx X/Z^2], [0, -fy/Z, fy Y/Z^2]]
    j00 = fx * invZ
    j02 = -fx * X * invZ2
    j11 = -fy * invZ
    j12 = fy * Y * invZ2
    c00, c01, c02 = (_dot3(rows[0], rows[0]), _dot3(rows[0], rows[1]),
                     _dot3(rows[0], rows[2]))
    c11, c12, c22 = (_dot3(rows[1], rows[1]), _dot3(rows[1], rows[2]),
                     _dot3(rows[2], rows[2]))
    a = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22) + 1e-6
    b = j11 * (j00 * c01 + j02 * c12) + j12 * (j00 * c02 + j02 * c22)
    c = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22) + 1e-6

    # Mip-splatting antialiasing (opt-in): dilate by the 0.3 px^2 pixel
    # footprint and scale opacity by sqrt(det(Sigma)/det(Sigma + sI)).
    comp = 1.0
    if antialias:
        det_raw = torch.clamp(a * c - b * b, min=1e-12)
        a = a + 0.3
        c = c + 0.3
        det_blur = a * c - b * b
        comp = torch.sqrt(torch.clamp(det_raw / det_blur, min=0.0))

    det = a * c - b * b
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    inv_det = 1.0 / det
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(0.25 * (a - c) ** 2 + b * b, min=0.0))
    lam_max = torch.clamp(mid + disc, min=1e-12)
    radius = torch.clamp(3.0 * torch.sqrt(lam_max), radius_min, radius_max)

    visible = (front & g.alive
               & (xpix >= -radius) & (xpix < W + radius)
               & (ypix >= -radius) & (ypix < H + radius)
               & (radius > 0))

    if color_mode == "dc_sigmoid":
        color = torch.sigmoid(g.features_dc[:, 0, :])
    elif color_mode == "sh":
        dirs = Xw - camera.camera_center[None, :]
        dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
        color = sh_lib.sh_to_rgb(sh_degree, g.get_features, dirs)
    else:
        raise ValueError(f"unknown color_mode {color_mode!r}")

    opacity = torch.sigmoid(g.opacity[:, 0]) * comp

    ext_x = CULL_SIGMA * torch.sqrt(torch.clamp(a, min=0.0)) + 1.0
    ext_y = CULL_SIGMA * torch.sqrt(torch.clamp(c, min=0.0)) + 1.0
    return Projected(means2d=means2d, conic=conic, depth=Z, radius=radius,
                     visible=visible, color=color, opacity=opacity,
                     ext_x=ext_x, ext_y=ext_y)


def _check_fwd_args(g: Gaussians, camera: Camera) -> torch.device:
    """Raise on what the kernel does not take; returns the device."""
    C = g.xyz.shape[0]
    shapes = dict(xyz=(C, 3), features_dc=(C, 1, 3),
                  features_rest=(C, SH_REST, 3), scaling=(C, 3),
                  rotation=(C, 4), opacity=(C, 1))
    tensors = {k: getattr(g, k) for k in shapes}
    for k, shape in shapes.items():
        v = tensors[k]
        if v.dtype != torch.float32 or tuple(v.shape) != shape:
            raise ValueError(f"{k} must be float32 {shape}, got {v.dtype} "
                             f"{tuple(v.shape)}")
    if g.alive.dtype != torch.bool or tuple(g.alive.shape) != (C,):
        raise ValueError(f"alive must be bool ({C},), got {g.alive.dtype} "
                         f"{tuple(g.alive.shape)}")
    tensors["alive"] = g.alive
    cam = dict(view_matrix=(4, 4), FoVx=(), FoVy=())
    for k, shape in cam.items():
        v = getattr(camera, k)
        if v.dtype != torch.float32 or tuple(v.shape) != shape:
            raise ValueError(f"camera.{k} must be float32 {shape}, got "
                             f"{v.dtype} {tuple(v.shape)}")
        tensors[f"camera.{k}"] = v
    for k, v in tensors.items():
        if not v.is_contiguous():
            raise ValueError(f"project_fwd needs contiguous tensors; {k} is "
                             f"not")
    devices = {v.device for v in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    device = g.xyz.device
    if device.type != "cuda":
        raise ValueError(f"project_fwd runs on CUDA tensors, not {device}")
    return device


def _degree(color_mode: str, sh_degree: int) -> int:
    """The kernels' build: -1 for "dc_sigmoid", else the SH degree, read
    as eval_sh reads it (below 1 as 0, above 3 as 3)."""
    if color_mode not in ("dc_sigmoid", "sh"):
        raise ValueError(f"unknown color_mode {color_mode!r}")
    return -1 if color_mode == "dc_sigmoid" else min(max(sh_degree, 0), 3)


def _inputs(g: Gaussians, camera: Camera) -> tuple:
    """The ten tensors both kernels read, in their C interface's order; the
    camera's detached (the kernels give it no gradient)."""
    return (g.xyz, g.features_dc, g.features_rest, g.scaling, g.rotation,
            g.opacity, g.alive, camera.view_matrix.detach(),
            camera.FoVx.detach(), camera.FoVy.detach())


def project_fwd(g: Gaussians, camera: Camera, *, radius_min: float = 0.01,
                radius_max: float = 50.0, color_mode: str = "dc_sigmoid",
                sh_degree: int = 0, scale_modifier: float = 1.0,
                antialias: bool = False) -> Projected:
    """`project_gaussians_plain` in one launch of `csrc/project_fwd.cu`
    (P1): the same `Projected`, field for field, at the same shapes, dtypes
    and layout, differentiable with respect to the six parameter groups of
    `g` through one launch of `csrc/project_bwd.cu` (P2) in the backward;
    the camera is a constant to it.  CUDA tensors only; raises on any
    other input.  Each launch counts in cuda_library.LAUNCHES
    (`project_fwd.launches`, `project_bwd.launches`) and in the active
    recording (`projection_kernel`, `projection_bwd_kernel`)."""
    degree = _degree(color_mode, sh_degree)
    _check_fwd_args(g, camera)
    return Projected(*_Project.apply(
        *_inputs(g, camera), camera.width, camera.height, degree,
        radius_min, radius_max, scale_modifier, antialias))


# The cotangents P2 reads, by field of `Projected`; the other four fields
# (radius, visible and the extents) are not differentiable.
COTANGENT_FIELDS = ("means2d", "conic", "depth", "color", "opacity")


def _launch_bwd(inputs: tuple, width: int, height: int, degree: int,
                radius_min: float, radius_max: float, scale_modifier: float,
                antialias: bool, cotangents: tuple) -> dict:
    """One launch of P2 on checked `inputs` and `cotangents` (tensors in
    COTANGENT_FIELDS' order, or None); returns the six gradients by
    parameter name, features_rest None for "dc_sigmoid" (the chain does not
    read it)."""
    device = inputs[0].device
    C = inputs[0].shape[0]
    shapes = dict(means2d=(C, 2), conic=(C, 3), depth=(C,), color=(C, 3),
                  opacity=(C,))
    cots = []
    for name, t in zip(COTANGENT_FIELDS, cotangents):
        if t is None:
            cots.append(None)
            continue
        if (t.dtype != torch.float32 or tuple(t.shape) != shapes[name]
                or t.device != device):
            raise ValueError(f"the cotangent of {name} must be float32 "
                             f"{shapes[name]} on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        cots.append(t.contiguous())
    grads = {k: torch.empty_like(v) for k, v in zip(PARAM_NAMES, inputs)}
    if degree < 0:
        grads["features_rest"] = None
    m = max(radius_min, radius_max)
    launch("project_bwd_launch", device, *inputs, C, width, height, degree,
           int(antialias), scale_modifier, -m, width + m, height + m, *cots,
           *(grads[k] for k in PARAM_NAMES))
    return grads


def project_bwd(g: Gaussians, camera: Camera, cotangents: tuple, *,
                radius_min: float = 0.01, radius_max: float = 50.0,
                color_mode: str = "dc_sigmoid", sh_degree: int = 0,
                scale_modifier: float = 1.0,
                antialias: bool = False) -> dict:
    """The gradients of the six parameter groups of `g` (by name; the SH
    rest None for "dc_sigmoid") given the cotangents of the projection's
    outputs (`COTANGENT_FIELDS`' order, each a tensor or None), in one
    launch of `csrc/project_bwd.cu` (P2).  Equal to `project_bwd_plain` on
    every row the chain's guard keeps under a graph (alive, in front of the
    camera, its centre within max(radius_min, radius_max) of the frame) and
    exactly 0 on every other row, where the chain's gradient is 0 whenever
    the row's cotangents are, as every consumer gives them.  CUDA tensors
    only; raises on any other input.  Each launch counts as
    `project_bwd.launches` and `projection_bwd_kernel`."""
    degree = _degree(color_mode, sh_degree)
    _check_fwd_args(g, camera)
    return _launch_bwd(_inputs(g, camera), camera.width, camera.height,
                       degree, radius_min, radius_max, scale_modifier,
                       antialias, tuple(cotangents))


def project_bwd_plain(g: Gaussians, camera: Camera, cotangents: tuple,
                      **kw) -> dict:
    """P2's plain version: the vector-Jacobian product of
    `project_gaussians_plain` with the cotangents of its outputs
    (`COTANGENT_FIELDS`' order, each a tensor or None) by
    `torch.autograd.grad`, with respect to the six parameter groups of `g`
    (by name; None for a group the chain does not read).  Either device."""
    params = {k: v.detach().requires_grad_(True)
              for k, v in g.params().items()}
    with torch.enable_grad():
        p = project_gaussians_plain(g.with_params(params), camera, **kw)
        pairs = [(getattr(p, f), t) for f, t in
                 zip(COTANGENT_FIELDS, cotangents) if t is not None]
        grads = torch.autograd.grad([o for o, _ in pairs],
                                    list(params.values()),
                                    [t for _, t in pairs], allow_unused=True)
    return dict(zip(params, grads))


class _Project(torch.autograd.Function):
    """`project_fwd`'s op: P1 forward, inside the op (torch.profiler links a
    kernel to the op that launched it; a `record_function` range such as
    `3dgs:projection` is no op, so a kernel launched from Python straight
    under it would count towards no stage), and P2 backward.  The
    forward's values are P1's on every row.  Where the chain under a graph
    moves a row that cannot be visible to depth 1 (its conic, radius and
    extents then differ from P1's), the row is invisible on both routes:
    the raster never reads it, `accumulate_grad_stats` multiplies its
    radius by `visible`, and P2 gives it a gradient of exactly 0, as the
    chain does for its cotangent of 0.  Saves its inputs, not copies, and
    no intermediate."""

    @staticmethod
    def forward(ctx, xyz, features_dc, features_rest, scaling, rotation,
                opacity, alive, view_matrix, fov_x, fov_y, width, height,
                degree, radius_min, radius_max, scale_modifier, antialias):
        inputs = (xyz, features_dc, features_rest, scaling, rotation,
                  opacity, alive, view_matrix, fov_x, fov_y)
        device, C = xyz.device, xyz.shape[0]
        f32 = dict(dtype=torch.float32, device=device)
        out = Projected(
            means2d=torch.empty(C, 2, **f32), conic=torch.empty(C, 3, **f32),
            depth=torch.empty(C, **f32), radius=torch.empty(C, **f32),
            visible=torch.empty(C, dtype=torch.bool, device=device),
            color=torch.empty(C, 3, **f32), opacity=torch.empty(C, **f32),
            ext_x=torch.empty(C, **f32), ext_y=torch.empty(C, **f32))
        launch("project_fwd_launch", device, *inputs, C, width, height,
               degree, int(antialias), scale_modifier, radius_min,
               radius_max, CULL_SIGMA, *out)
        ctx.save_for_backward(*inputs)
        ctx.options = (width, height, degree, radius_min, radius_max,
                       scale_modifier, antialias)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(out.radius, out.visible, out.ext_x,
                                    out.ext_y)
        return tuple(out)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        by_field = dict(zip(Projected._fields, grads))
        g = _launch_bwd(ctx.saved_tensors, *ctx.options,
                        tuple(by_field[f] for f in COTANGENT_FIELDS))
        return (*(g[k] for k in PARAM_NAMES), *(None,) * 11)
