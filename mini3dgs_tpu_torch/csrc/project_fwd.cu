// Forward EWA projection for Hopper (sm_90a): the whole of
// ops/projection.py `project_gaussians_plain` in one launch, for renders that
// need no autograd graph (ops/projection.py `project_fwd`).
//
// Replaces no Pallas kernel: the JAX package's projection
// (mini3dgs_tpu/ops/projection.py) is plain jnp, which XLA fuses into a few
// loops on the TPU.  Eager PyTorch runs the same chain as about 150 small
// kernels, each reading and writing whole [C] intermediates, and one host
// dispatch each; this kernel is what XLA's fusion would have been.
//
// Per Gaussian, from the world->camera matrix V = [Rv | Tv], the fields of
// view and the image size: the camera-frame point (X, Y, Z); pinhole means
// x = fx X/Z + W/2, y = -fy Y/Z + H/2; Sigma_cam = (Rv R diag(s))(Rv R
// diag(s))^T from the normalised quaternion and s = exp(log-scale) *
// scale_modifier; Sigma_2D = J Sigma_cam J^T + 1e-6 I; the optional
// antialias dilation and its opacity factor; the conic, the 3-sigma radius
// clamped to [radius_min, radius_max], the cull; the colour (sigmoid of the
// DC term, or SH of degree 0-3 along the view direction, + 0.5, clamped at
// 0); the opacity's sigmoid; the exact-cull half-extents
// cull_sigma sqrt(Sigma_xx) + 1 and cull_sigma sqrt(Sigma_yy) + 1.
//
// What bounds it on this card: bytes.  A Gaussian reads 237 B (xyz 12,
// log-scale 12, quaternion 16, opacity 4, features_dc 12, features_rest 180,
// alive 1) and writes 53 B (means 8, conic 12, depth 4, radius 4, visible 1,
// colour 12, opacity 4, extents 8): 290 B against about 512 float32
// operations, so at 3.35 TB/s and 67 TFLOP/s the bytes take ten times as
// long as the arithmetic.
//
// Design.
// - One thread a Gaussian, blocks of kBlock = 128 threads; every output is
//   written once, no intermediate reaches device memory.
// - features_rest is array-of-structs, 45 floats (180 B) a row.  A warp
//   reading its rows in place would issue 45 loads, each touching 32 rows
//   180 B apart.  Instead the block stages its contiguous slice (128 rows,
//   23,040 B) into shared memory with 16-byte loads, the block's threads on
//   consecutive addresses, and each thread then reads its own row there at a
//   stride of 45 words: 45 is odd, so a warp's 32 lanes hit 32 banks.  A
//   slice that does not start on 16 bytes (a pool cut at a row that is not a
//   multiple of 4) is staged with 4-byte loads.  Only the SH builds of
//   degree 1-3 stage it; features_dc is read in place.
// - The camera stays on the device: thread 0 derives fx, fy and the camera
//   centre from the view matrix and the fields of view into shared memory,
//   so the launch needs no host sync and no small kernels.
// - Rounding: every +, -, * and / is a round-to-nearest intrinsic (`Rn`) in
//   the order of the plain chain's eager PyTorch ops, so none is contracted
//   into an FMA, and tanf, expf and the square roots are the ones PyTorch's
//   kernels call.  Every field then rounds as the chain's kernels round it,
//   except where a reduction's order is not the kernel's to see: the
//   quaternion's and the view direction's norms follow the order of
//   PyTorch's reduction kernel (see `quat_norm`, `dir_norm`), and the camera
//   centre (a cuBLAS gemv in the chain) is summed in row order, which moves
//   only the SH colour, by ulps.

#include "project_common.cuh"

namespace {

// kDeg: -1 for color_mode "dc_sigmoid", else the SH degree 0-3.
template <int kDeg>
__global__ void __launch_bounds__(kBlock)
project_fwd_kernel(const float* __restrict__ xyz,
                   const float* __restrict__ f_dc,
                   const float* __restrict__ f_rest,
                   const float* __restrict__ scaling,
                   const float* __restrict__ rotation,
                   const float* __restrict__ opacity,
                   const bool* __restrict__ alive,
                   const float* __restrict__ view,
                   const float* __restrict__ fovx,
                   const float* __restrict__ fovy, int64_t n, int width,
                   int height, bool antialias, float scale_modifier,
                   float radius_min, float radius_max, float cull_sigma,
                   float* __restrict__ means2d, float* __restrict__ conic,
                   float* __restrict__ depth, float* __restrict__ radius,
                   bool* __restrict__ visible, float* __restrict__ color,
                   float* __restrict__ opac_out, float* __restrict__ ext_x,
                   float* __restrict__ ext_y) {
  constexpr bool kStage = kDeg >= 1;
  __shared__ __align__(16) float rest_s[kStage ? kBlock * kRest : 4];
  __shared__ Cam cam;

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBlock;
  const int64_t i = row0 + threadIdx.x;
  const bool live = i < n;

  // This thread's inputs, loaded before the staging so that both are in
  // flight together.
  float p[3], ls[3], q[4], dc[3], op = 0.0f;
  bool al = false;
  if (live) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p[k] = xyz[3 * i + k];
      ls[k] = scaling[3 * i + k];
      dc[k] = f_dc[3 * i + k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = rotation[4 * i + k];
    op = opacity[i];
    al = alive[i];
  }

  if (threadIdx.x == 0) load_cam(cam, view, fovx, fovy, width, height);
  if constexpr (kStage)
    stage_rest(rest_s, f_rest + row0 * kRest,
               block_rest_floats(row0, n));
  __syncthreads();
  if (!live) return;

  const Rn fx = cam.fx, fy = cam.fy;
  const Rn cx = 0.5f * static_cast<float>(width);
  const Rn cy = 0.5f * static_cast<float>(height);
  Rn Rv[3][3], Tv[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) Rv[r][c] = cam.view[4 * r + c];
    Tv[r] = cam.view[4 * r + 3];
  }

  const Rn x0 = p[0], x1 = p[1], x2 = p[2];
  const Rn X = Rv[0][0] * x0 + Rv[0][1] * x1 + Rv[0][2] * x2 + Tv[0];
  const Rn Y = Rv[1][0] * x0 + Rv[1][1] * x1 + Rv[1][2] * x2 + Tv[1];
  const Rn Z = Rv[2][0] * x0 + Rv[2][1] * x1 + Rv[2][2] * x2 + Tv[2];

  // Behind-camera points get Z = 1 for the divides and are culled.
  const bool front = Z.v > kEps2d;
  const Rn Zs = front ? Z : Rn(1.0f);
  const Rn invZ = Rn(1.0f) / Zs;
  const Rn invZ2 = invZ * invZ;
  const Rn xpix = fx * X * invZ + cx;
  const Rn ypix = -fy * Y * invZ + cy;

  // Sigma_cam rows: (sum_j Rv[i,j] r_jl) * s_l.
  Rn s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) s[k] = Rn(expf(ls[k])) * Rn(scale_modifier);
  const Rn qd = quat_norm(q[0], q[1], q[2], q[3]) + Rn(kTiny);
  const Rn w = Rn(q[0]) / qd, qx = Rn(q[1]) / qd, qy = Rn(q[2]) / qd,
           qz = Rn(q[3]) / qd;
  const Rn xx = qx * qx, yy = qy * qy, zz = qz * qz;
  const Rn wx = w * qx, wy = w * qy, wz = w * qz;
  const Rn xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const Rn rot[9] = {Rn(1.0f) - Rn(2.0f) * (yy + zz), Rn(2.0f) * (xy - wz),
                     Rn(2.0f) * (xz + wy), Rn(2.0f) * (xy + wz),
                     Rn(1.0f) - Rn(2.0f) * (xx + zz), Rn(2.0f) * (yz - wx),
                     Rn(2.0f) * (xz - wy), Rn(2.0f) * (yz + wx),
                     Rn(1.0f) - Rn(2.0f) * (xx + yy)};
  Rn rows[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int l = 0; l < 3; ++l)
      rows[r][l] = (Rv[r][0] * rot[l] + Rv[r][1] * rot[3 + l] +
                    Rv[r][2] * rot[6 + l]) * s[l];
  }
  auto dot3 = [](const Rn* u, const Rn* v) {
    return u[0] * v[0] + u[1] * v[1] + u[2] * v[2];
  };
  const Rn c00 = dot3(rows[0], rows[0]), c01 = dot3(rows[0], rows[1]),
           c02 = dot3(rows[0], rows[2]), c11 = dot3(rows[1], rows[1]),
           c12 = dot3(rows[1], rows[2]), c22 = dot3(rows[2], rows[2]);

  // J = [[fx/Z, 0, -fx X/Z^2], [0, -fy/Z, fy Y/Z^2]]
  const Rn j00 = fx * invZ;
  const Rn j02 = -fx * X * invZ2;
  const Rn j11 = -fy * invZ;
  const Rn j12 = fy * Y * invZ2;
  Rn a = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22) +
         Rn(kEps2d);
  const Rn b = j11 * (j00 * c01 + j02 * c12) + j12 * (j00 * c02 + j02 * c22);
  Rn c = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22) +
         Rn(kEps2d);

  Rn comp = 1.0f;
  if (antialias) {
    const Rn det_raw = clamp_min(a * c - b * b, kTiny);
    a = a + Rn(static_cast<float>(0.3));
    c = c + Rn(static_cast<float>(0.3));
    const Rn det_blur = a * c - b * b;
    comp = sqrt_rn(clamp_min(det_raw / det_blur, 0.0f));
  }
  Rn det = a * c - b * b;
  if (fabsf(det.v) < kTiny) det = kTiny;
  const Rn inv_det = Rn(1.0f) / det;

  const Rn mid = Rn(0.5f) * (a + c);
  const Rn disc = sqrt_rn(
      clamp_min(Rn(0.25f) * ((a - c) * (a - c)) + b * b, 0.0f));
  const Rn lam_max = clamp_min(mid + disc, kTiny);
  const Rn rad = clamp(Rn(3.0f) * sqrt_rn(lam_max), radius_min,
                       radius_max);
  const bool vis = front && al && xpix.v >= (-rad).v &&
                   xpix.v < (Rn(static_cast<float>(width)) + rad).v &&
                   ypix.v >= (-rad).v &&
                   ypix.v < (Rn(static_cast<float>(height)) + rad).v &&
                   rad.v > 0.0f;

  Rn rgb[3];
  if constexpr (kDeg < 0) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) rgb[ch] = sigmoid(dc[ch]);
  } else {
    // The chain's eval_sh, term by term, on coefficient k of channel ch:
    // k = 0 is features_dc, k >= 1 row k - 1 of features_rest.
    const float* rest = rest_s + threadIdx.x * kRest;
    auto coef = [&](int k, int ch) -> Rn {
      return k == 0 ? Rn(dc[ch]) : Rn(rest[3 * (k - 1) + ch]);
    };
    Rn basis[16];
    if constexpr (kDeg >= 1) {
      Rn d0 = x0 - Rn(cam.centre[0]), d1 = x1 - Rn(cam.centre[1]),
         d2 = x2 - Rn(cam.centre[2]);
      const Rn dn = dir_norm(d0, d1, d2) + Rn(kTiny);
      const Rn x = d0 / dn, y = d1 / dn, z = d2 / dn;
      basis[1] = Rn(kC1) * y;
      basis[2] = Rn(kC1) * z;
      basis[3] = Rn(kC1) * x;
      const Rn xx2 = x * x, yy2 = y * y, zz2 = z * z;
      const Rn xy2 = x * y, yz2 = y * z, xz2 = x * z;
      basis[4] = Rn(kC2[0]) * xy2;
      basis[5] = Rn(kC2[1]) * yz2;
      basis[6] = Rn(kC2[2]) * (Rn(2.0f) * zz2 - xx2 - yy2);
      basis[7] = Rn(kC2[3]) * xz2;
      basis[8] = Rn(kC2[4]) * (xx2 - yy2);
      basis[9] = Rn(kC3[0]) * y * (Rn(3.0f) * xx2 - yy2);
      basis[10] = Rn(kC3[1]) * xy2 * z;
      basis[11] = Rn(kC3[2]) * y * (Rn(4.0f) * zz2 - xx2 - yy2);
      basis[12] = Rn(kC3[3]) * z * (Rn(2.0f) * zz2 - Rn(3.0f) * xx2 -
                                    Rn(3.0f) * yy2);
      basis[13] = Rn(kC3[4]) * x * (Rn(4.0f) * zz2 - xx2 - yy2);
      basis[14] = Rn(kC3[5]) * z * (xx2 - yy2);
      basis[15] = Rn(kC3[6]) * x * (xx2 - Rn(3.0f) * yy2);
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      Rn v = Rn(kC0) * coef(0, ch);
      if constexpr (kDeg >= 1)
        v = v - basis[1] * coef(1, ch) + basis[2] * coef(2, ch) -
            basis[3] * coef(3, ch);
      if constexpr (kDeg >= 2) {
#pragma unroll
        for (int k = 4; k < 9; ++k) v = v + basis[k] * coef(k, ch);
      }
      if constexpr (kDeg >= 3) {
#pragma unroll
        for (int k = 9; k < 16; ++k) v = v + basis[k] * coef(k, ch);
      }
      rgb[ch] = clamp_min(v + Rn(0.5f), 0.0f);
    }
  }

  Rn opa = sigmoid(op);
  if (antialias) opa = opa * comp;

  means2d[2 * i] = xpix.v;
  means2d[2 * i + 1] = ypix.v;
  conic[3 * i] = (c * inv_det).v;
  conic[3 * i + 1] = (-b * inv_det).v;
  conic[3 * i + 2] = (a * inv_det).v;
  depth[i] = Z.v;
  radius[i] = rad.v;
  visible[i] = vis;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) color[3 * i + ch] = rgb[ch].v;
  opac_out[i] = opa.v;
  ext_x[i] = (Rn(cull_sigma) * sqrt_rn(clamp_min(a, 0.0f)) +
              Rn(1.0f)).v;
  ext_y[i] = (Rn(cull_sigma) * sqrt_rn(clamp_min(c, 0.0f)) +
              Rn(1.0f)).v;
}

}  // namespace

// Inputs: xyz [n, 3], f_dc [n, 3], f_rest [n, 45], scaling [n, 3],
// rotation [n, 4], opacity [n] float32, alive [n] bool, view [4, 4], fovx
// and fovy (one float32 each), all on the device and contiguous.  Outputs
// (written in full): means2d [n, 2], conic [n, 3], depth, radius [n],
// visible [n] bool, color [n, 3], opacity [n], ext_x, ext_y [n].
// sh_degree -1 selects color_mode "dc_sigmoid", 0-3 "sh" of that degree.
// Launches on `stream`; returns the cudaError_t of the launch (0 on
// success).
extern "C" int project_fwd_launch(
    const float* xyz, const float* f_dc, const float* f_rest,
    const float* scaling, const float* rotation, const float* opacity,
    const bool* alive, const float* view, const float* fovx,
    const float* fovy, long long n, int width, int height, int sh_degree,
    int antialias, float scale_modifier, float radius_min, float radius_max,
    float cull_sigma, float* means2d, float* conic, float* depth,
    float* radius, bool* visible, float* color, float* opac_out,
    float* ext_x, float* ext_y, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n + kBlock - 1) / kBlock);
#define PROJECT_FWD_LAUNCH(DEG)                                              \
  project_fwd_kernel<DEG><<<blocks, kBlock, 0, s>>>(                         \
      xyz, f_dc, f_rest, scaling, rotation, opacity, alive, view, fovx,      \
      fovy, n, width, height, antialias != 0, scale_modifier, radius_min,    \
      radius_max, cull_sigma, means2d, conic, depth, radius, visible, color, \
      opac_out, ext_x, ext_y)
  switch (sh_degree) {
    case -1: PROJECT_FWD_LAUNCH(-1); break;
    case 0: PROJECT_FWD_LAUNCH(0); break;
    case 1: PROJECT_FWD_LAUNCH(1); break;
    case 2: PROJECT_FWD_LAUNCH(2); break;
    case 3: PROJECT_FWD_LAUNCH(3); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PROJECT_FWD_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
