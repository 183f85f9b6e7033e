// Backward EWA projection for Hopper (sm_90a), P2: the vector-Jacobian
// product of ops/projection.py `project_gaussians_plain` with respect to the
// six Gaussian parameter groups, in one launch, for a train step's
// projection (ops/projection.py `_ProjectGraph`, whose forward is P1,
// csrc/project_fwd.cu).
//
// Replaces no Pallas kernel: the JAX package's projection gradient is XLA's
// autodiff of plain jnp (mini3dgs_tpu/ops/projection.py), fused on the TPU.
// Eager PyTorch runs the chain's backward as some 400-600 small kernels over
// [C] and [C, 3] intermediates, SH 3 alone allocating and adding a zeroed
// [C, 16, 3] gradient for each of its 16 coefficient slices.
//
// Per Gaussian, from the cotangents of means2d (2), conic (3), depth,
// colour (3) and opacity: the gradients of xyz (3), features_dc (3),
// features_rest (45), the log-scale (3), the quaternion (4) and the opacity
// logit, through the pinhole means, the Jacobian J, Sigma_cam = (Rv R S)
// (Rv R S)^T with R from the normalised quaternion and S = exp(log-scale)
// * scale_modifier, Sigma_2D = J Sigma_cam J^T + 1e-6 I, the optional
// antialias dilation and its opacity factor, the conic and its guarded
// determinant, the opacity's sigmoid, and the colour (the DC sigmoid, or SH
// of degree 0-3 along the normalised view direction, clamped at 0).  Each
// clamp and guard passes the gradient where PyTorch's derivative of it does
// (`clamp`: where the input >= its bound; `where`: on the branch taken;
// `sqrt`: grad / (2 sqrt); `linalg.norm`: 0 at a norm of 0).
//
// A row gets exactly 0 in all its gradients, and none of the arithmetic, if
// it is dead, if its cotangents are all 0, or if it is not "near" by the
// chain's guard under a graph (in front of the camera, alive, its centre
// within max(radius_min, radius_max) of the frame): the guard's rows, which
// the chain gives a gradient of exactly 0 because every consumer gives an
// invisible row a cotangent of 0.
//
// What bounds it on this card: bytes.  A Gaussian reads its 237 B of
// parameters (as P1) and 40 B of cotangents and writes 236 B of gradients:
// 513 B against about 1,000 float32 operations, so at 3.35 TB/s and
// 67 TFLOP/s the bytes take about ten times as long as the arithmetic.
//
// Design.
// - One thread a Gaussian, blocks of kBlock = 128 threads.  The forward's
//   intermediates are recomputed in registers from the parameters, with
//   P1's rounding (`Rn`, project_common.cuh), so every branch (the guard,
//   the determinant's floor, the clamps) falls as in the chain and P1; none
//   is saved between the passes.  The backward itself is plain float
//   arithmetic.
// - features_rest (45 floats, 180 B a row) goes through shared memory both
//   ways, as in P1: the block stages its rows with 16-byte loads, each
//   thread reads its row there (a stride of 45 words: 32 banks) and
//   overwrites it with its gradient, and the block stores the tile with
//   16-byte stores.  A slice that does not start on 16 bytes (a ring rank's
//   block) is copied with 4-byte accesses.
// - No atomics and no sums across rows: every row writes its own outputs,
//   so the result is the same bits whatever the launch's size or where a
//   pool is cut into blocks.
// - The camera stays on the device (thread 0 derives it, as in P1); a
//   cotangent that autograd gives as None arrives as a null pointer and
//   reads as 0.

#include "project_common.cuh"

namespace {

__device__ __forceinline__ float cot_or_zero(const float* t, int64_t k) {
  return t != nullptr ? t[k] : 0.0f;
}

// kDeg: -1 for color_mode "dc_sigmoid", else the SH degree 0-3.
template <int kDeg>
__global__ void __launch_bounds__(kBlock)
project_bwd_kernel(const float* __restrict__ xyz,
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
                   float near_lo, float near_hi_x, float near_hi_y,
                   const float* __restrict__ d_means2d,
                   const float* __restrict__ d_conic,
                   const float* __restrict__ d_depth,
                   const float* __restrict__ d_color,
                   const float* __restrict__ d_opacity,
                   float* __restrict__ g_xyz, float* __restrict__ g_dc,
                   float* __restrict__ g_rest,
                   float* __restrict__ g_scaling,
                   float* __restrict__ g_rotation,
                   float* __restrict__ g_opacity) {
  constexpr bool kSH = kDeg >= 0;     // has a features_rest gradient
  constexpr bool kStage = kDeg >= 1;  // reads features_rest
  constexpr int kCoefs = kSH ? (kDeg + 1) * (kDeg + 1) : 0;
  __shared__ __align__(16) float rest_s[kSH ? kBlock * kRest : 4];
  __shared__ Cam cam;

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBlock;
  const int64_t i = row0 + threadIdx.x;
  const bool live = i < n;
  const int total = block_rest_floats(row0, n);

  float p[3] = {}, ls[3] = {}, q[4] = {}, dc[3] = {}, op = 0.0f;
  float gm[2] = {}, gcn[3] = {}, gz = 0.0f, gcol[3] = {}, gop = 0.0f;
  bool al = false;
  if (live) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p[k] = xyz[3 * i + k];
      ls[k] = scaling[3 * i + k];
      dc[k] = f_dc[3 * i + k];
      gcn[k] = cot_or_zero(d_conic, 3 * i + k);
      gcol[k] = cot_or_zero(d_color, 3 * i + k);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = rotation[4 * i + k];
    op = opacity[i];
    al = alive[i];
    gm[0] = cot_or_zero(d_means2d, 2 * i);
    gm[1] = cot_or_zero(d_means2d, 2 * i + 1);
    gz = cot_or_zero(d_depth, i);
    gop = cot_or_zero(d_opacity, i);
  }
  if (threadIdx.x == 0) load_cam(cam, view, fovx, fovy, width, height);
  if constexpr (kStage)
    stage_rest(rest_s, f_rest + row0 * kRest, total);
  __syncthreads();

  float* rest = rest_s + threadIdx.x * kRest;  // this row's tile (kSH)
  float gp[3] = {}, gdc[3] = {}, gls[3] = {}, gq[4] = {}, gopac = 0.0f;
  bool done = false;
  const bool any = gm[0] != 0.0f || gm[1] != 0.0f || gcn[0] != 0.0f ||
                   gcn[1] != 0.0f || gcn[2] != 0.0f || gz != 0.0f ||
                   gcol[0] != 0.0f || gcol[1] != 0.0f || gcol[2] != 0.0f ||
                   gop != 0.0f;
  // The forward, as P1 rounds it, as far as the chain's guard.
  const float fx = cam.fx, fy = cam.fy;
  float Rv[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) Rv[r][c] = cam.view[4 * r + c];
  Rn X, Y, Z, invZ;
  if (live && al && any) {
    X = Rn(Rv[0][0]) * Rn(p[0]) + Rn(Rv[0][1]) * Rn(p[1]) +
        Rn(Rv[0][2]) * Rn(p[2]) + Rn(cam.view[3]);
    Y = Rn(Rv[1][0]) * Rn(p[0]) + Rn(Rv[1][1]) * Rn(p[1]) +
        Rn(Rv[1][2]) * Rn(p[2]) + Rn(cam.view[7]);
    Z = Rn(Rv[2][0]) * Rn(p[0]) + Rn(Rv[2][1]) * Rn(p[1]) +
        Rn(Rv[2][2]) * Rn(p[2]) + Rn(cam.view[11]);
    const bool front = Z.v > kEps2d;
    invZ = Rn(1.0f) / (front ? Z : Rn(1.0f));
    const Rn xpix = Rn(fx) * X * invZ + Rn(0.5f * static_cast<float>(width));
    const Rn ypix = -Rn(fy) * Y * invZ +
                    Rn(0.5f * static_cast<float>(height));
    done = front && xpix.v >= near_lo && xpix.v < near_hi_x &&
           ypix.v >= near_lo && ypix.v < near_hi_y;
  }
  if (done) {
    // The rest of the forward (in front: the Jacobian's 1 / Z is invZ).
    const Rn invZ2 = invZ * invZ;
    Rn s[3];
    float e[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      e[k] = expf(ls[k]);
      s[k] = Rn(e[k]) * Rn(scale_modifier);
    }
    const Rn qn2 = quat_norm(q[0], q[1], q[2], q[3]);
    const Rn qd = qn2 + Rn(kTiny);
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
    Rn M[3][3], rows[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        M[r][l] = Rn(Rv[r][0]) * rot[l] + Rn(Rv[r][1]) * rot[3 + l] +
                  Rn(Rv[r][2]) * rot[6 + l];
        rows[r][l] = M[r][l] * s[l];
      }
    }
    auto dot3 = [](const Rn* u, const Rn* v) {
      return u[0] * v[0] + u[1] * v[1] + u[2] * v[2];
    };
    const Rn c00 = dot3(rows[0], rows[0]), c01 = dot3(rows[0], rows[1]),
             c02 = dot3(rows[0], rows[2]), c11 = dot3(rows[1], rows[1]),
             c12 = dot3(rows[1], rows[2]), c22 = dot3(rows[2], rows[2]);
    const Rn j00 = Rn(fx) * invZ;
    const Rn j02 = -Rn(fx) * X * invZ2;
    const Rn j11 = -Rn(fy) * invZ;
    const Rn j12 = Rn(fy) * Y * invZ2;
    const Rn a0 = j00 * (j00 * c00 + j02 * c02) +
                  j02 * (j00 * c02 + j02 * c22) + Rn(kEps2d);
    const Rn b = j11 * (j00 * c01 + j02 * c12) + j12 * (j00 * c02 + j02 * c22);
    const Rn c0 = j11 * (j11 * c11 + j12 * c12) +
                  j12 * (j11 * c12 + j12 * c22) + Rn(kEps2d);
    Rn a = a0, c = c0, comp = 1.0f, ratio = 0.0f, det_blur = 1.0f;
    bool raw_passes = false;
    if (antialias) {
      const Rn det_pre = a0 * c0 - b * b;
      raw_passes = det_pre.v >= kTiny;
      const Rn det_raw = clamp_min(det_pre, kTiny);
      a = a0 + Rn(static_cast<float>(0.3));
      c = c0 + Rn(static_cast<float>(0.3));
      det_blur = a * c - b * b;
      ratio = det_raw / det_blur;
      comp = sqrt_rn(clamp_min(ratio, 0.0f));
    }
    Rn det = a * c - b * b;
    const bool floored = fabsf(det.v) < kTiny;
    if (floored) det = kTiny;
    const float inv = (Rn(1.0f) / det).v;
    const float sig = sigmoid(op).v;

    // ---- opacity and conic -------------------------------------------
    gopac = gop * comp.v * sig * (1.0f - sig);
    const float g_comp = gop * sig;
    const float av = a.v, bv = b.v, cv = c.v;
    float ga = gcn[2] * inv, gb = -gcn[1] * inv, gc = gcn[0] * inv;
    if (!floored) {
      const float g_inv = gcn[0] * cv - gcn[1] * bv + gcn[2] * av;
      const float g_det = -g_inv * inv * inv;
      ga += g_det * cv;
      gc += g_det * av;
      gb -= 2.0f * bv * g_det;
    }
    if (antialias) {
      const float g_ratio = ratio.v >= 0.0f ? g_comp / (2.0f * comp.v) : 0.0f;
      const float g_blur = -g_ratio * ratio.v / det_blur.v;
      ga += g_blur * cv;
      gc += g_blur * av;
      gb -= 2.0f * bv * g_blur;
      if (raw_passes) {  // det_raw = clamp(a0 c0 - b^2, 1e-12)
        const float g_raw = g_ratio / det_blur.v;
        ga += g_raw * c0.v;
        gc += g_raw * a0.v;
        gb -= 2.0f * bv * g_raw;
      }
    }

    // ---- Sigma_2D = J Sigma_cam J^T ----------------------------------
    const float J00 = j00.v, J02 = j02.v, J11 = j11.v, J12 = j12.v;
    const float C00 = c00.v, C01 = c01.v, C02 = c02.v, C11 = c11.v,
                C12 = c12.v, C22 = c22.v;
    const float g_j00 = ga * (2.0f * J00 * C00 + 2.0f * J02 * C02) +
                        gb * (J11 * C01 + J12 * C02);
    const float g_j02 = ga * (2.0f * J00 * C02 + 2.0f * J02 * C22) +
                        gb * (J11 * C12 + J12 * C22);
    const float g_j11 = gb * (J00 * C01 + J02 * C12) +
                        gc * (2.0f * J11 * C11 + 2.0f * J12 * C12);
    const float g_j12 = gb * (J00 * C02 + J02 * C22) +
                        gc * (2.0f * J11 * C12 + 2.0f * J12 * C22);
    // Each off-diagonal weight is doubled: c_ij is both (i, j) and (j, i).
    const float G[3][3] = {
        {2.0f * ga * J00 * J00, gb * J11 * J00,
         2.0f * ga * J00 * J02 + gb * J12 * J00},
        {gb * J11 * J00, 2.0f * gc * J11 * J11,
         gb * J11 * J02 + 2.0f * gc * J11 * J12},
        {2.0f * ga * J00 * J02 + gb * J12 * J00,
         gb * J11 * J02 + 2.0f * gc * J11 * J12,
         2.0f * (ga * J02 * J02 + gb * J12 * J02 + gc * J12 * J12)}};

    // ---- J and the means: X, Y, Z ------------------------------------
    const float Xv = X.v, Yv = Y.v, iz = invZ.v, iz2 = invZ2.v;
    float g_iz = g_j00 * fx - g_j11 * fy + gm[0] * fx * Xv - gm[1] * fy * Yv;
    const float g_iz2 = -g_j02 * fx * Xv + g_j12 * fy * Yv;
    const float gX = -g_j02 * fx * iz2 + gm[0] * fx * iz;
    const float gY = g_j12 * fy * iz2 - gm[1] * fy * iz;
    g_iz += 2.0f * iz * g_iz2;
    const float gZ = -g_iz * iz * iz + gz;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      gp[k] = Rv[0][k] * gX + Rv[1][k] * gY + Rv[2][k] * gZ;

    // ---- Sigma_cam -> the scales and the rotation ----------------------
    float g_rot[9] = {};
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      float g_s = 0.0f;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const float g_row = G[r][0] * rows[0][l].v + G[r][1] * rows[1][l].v +
                            G[r][2] * rows[2][l].v;
        g_s += g_row * M[r][l].v;
        const float g_m = g_row * s[l].v;
#pragma unroll
        for (int j = 0; j < 3; ++j) g_rot[3 * j + l] += Rv[r][j] * g_m;
      }
      gls[l] = g_s * scale_modifier * e[l];
    }
    const float W_ = w.v, QX = qx.v, QY = qy.v, QZ = qz.v;
    const float* R = g_rot;
    const float gqn[4] = {
        2.0f * (-QZ * R[1] + QY * R[2] + QZ * R[3] - QX * R[5] - QY * R[6] +
                QX * R[7]),
        2.0f * (QY * R[1] + QZ * R[2] + QY * R[3] - 2.0f * QX * R[4] -
                W_ * R[5] + QZ * R[6] + W_ * R[7] - 2.0f * QX * R[8]),
        2.0f * (-2.0f * QY * R[0] + QX * R[1] + W_ * R[2] + QX * R[3] +
                QZ * R[5] - W_ * R[6] + QZ * R[7] - 2.0f * QY * R[8]),
        2.0f * (-2.0f * QZ * R[0] - W_ * R[1] + QX * R[2] + W_ * R[3] -
                2.0f * QZ * R[4] + QY * R[5] + QX * R[6] + QY * R[7])};
    {  // q / (|q| + 1e-12); linalg.norm's derivative is 0 at |q| = 0
      const float d = qd.v, nrm = qn2.v;
      const float dot = gqn[0] * q[0] + gqn[1] * q[1] + gqn[2] * q[2] +
                        gqn[3] * q[3];
      const float along = nrm > 0.0f ? dot / (d * d) / nrm : 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) gq[k] = gqn[k] / d - along * q[k];
    }

    // ---- colour ----------------------------------------------------------
    if constexpr (kDeg < 0) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float sd = sigmoid(dc[ch]).v;
        gdc[ch] = gcol[ch] * sd * (1.0f - sd);
      }
    } else {
      auto coef = [&](int k, int ch) -> Rn {
        return k == 0 ? Rn(dc[ch]) : Rn(rest[3 * (k - 1) + ch]);
      };
      // The basis with eval_sh's signs: b1 = -C1 y, b2 = C1 z, b3 = -C1 x.
      Rn basis[16];
      basis[0] = kC0;
      Rn d0, d1, d2, dn, x, y, z;
      if constexpr (kDeg >= 1) {
        d0 = Rn(p[0]) - Rn(cam.centre[0]);
        d1 = Rn(p[1]) - Rn(cam.centre[1]);
        d2 = Rn(p[2]) - Rn(cam.centre[2]);
        dn = dir_norm(d0, d1, d2);
        const Rn den = dn + Rn(kTiny);
        x = d0 / den;
        y = d1 / den;
        z = d2 / den;
        basis[1] = -(Rn(kC1) * y);
        basis[2] = Rn(kC1) * z;
        basis[3] = -(Rn(kC1) * x);
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
      // The forward colour, as P1 sums it, for the clamp at 0.
      float gv[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        Rn v = Rn(kC0) * coef(0, ch);
        if constexpr (kDeg >= 1)
          v = v - Rn(kC1) * y * coef(1, ch) + Rn(kC1) * z * coef(2, ch) -
              Rn(kC1) * x * coef(3, ch);
        if constexpr (kDeg >= 2) {
#pragma unroll
          for (int k = 4; k < 9; ++k) v = v + basis[k] * coef(k, ch);
        }
        if constexpr (kDeg >= 3) {
#pragma unroll
          for (int k = 9; k < 16; ++k) v = v + basis[k] * coef(k, ch);
        }
        gv[ch] = (v + Rn(0.5f)).v >= 0.0f ? gcol[ch] : 0.0f;
        gdc[ch] = gv[ch] * kC0;
      }
      // d colour / d coefficient is the basis; d colour / d basis the
      // coefficient.  The tile row is read, then overwritten.
      float gB[16] = {};  // d colour / d basis[k], summed over channels
#pragma unroll
      for (int k = 1; k < kCoefs; ++k) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          gB[k] += gv[ch] * rest[3 * (k - 1) + ch];
          rest[3 * (k - 1) + ch] = gv[ch] * basis[k].v;
        }
      }
#pragma unroll
      for (int k = 3 * (kCoefs > 0 ? kCoefs - 1 : 0); k < kRest; ++k)
        rest[k] = 0.0f;
      if constexpr (kDeg >= 1) {
        const float X_ = x.v, Y_ = y.v, Z_ = z.v;
        const float XX = X_ * X_, YY = Y_ * Y_, ZZ = Z_ * Z_;
        float gx = -kC1 * gB[3], gy = -kC1 * gB[1], gz_ = kC1 * gB[2];
        if constexpr (kDeg >= 2) {
          gx += kC2[0] * Y_ * gB[4] - 2.0f * kC2[2] * X_ * gB[6] +
                kC2[3] * Z_ * gB[7] + 2.0f * kC2[4] * X_ * gB[8];
          gy += kC2[0] * X_ * gB[4] + kC2[1] * Z_ * gB[5] -
                2.0f * kC2[2] * Y_ * gB[6] - 2.0f * kC2[4] * Y_ * gB[8];
          gz_ += kC2[1] * Y_ * gB[5] + 4.0f * kC2[2] * Z_ * gB[6] +
                 kC2[3] * X_ * gB[7];
        }
        if constexpr (kDeg >= 3) {
          gx += kC3[0] * 6.0f * X_ * Y_ * gB[9] + kC3[1] * Y_ * Z_ * gB[10] -
                kC3[2] * 2.0f * X_ * Y_ * gB[11] -
                kC3[3] * 6.0f * X_ * Z_ * gB[12] +
                kC3[4] * (4.0f * ZZ - 3.0f * XX - YY) * gB[13] +
                kC3[5] * 2.0f * X_ * Z_ * gB[14] +
                kC3[6] * (3.0f * XX - 3.0f * YY) * gB[15];
          gy += kC3[0] * (3.0f * XX - 3.0f * YY) * gB[9] +
                kC3[1] * X_ * Z_ * gB[10] +
                kC3[2] * (4.0f * ZZ - XX - 3.0f * YY) * gB[11] -
                kC3[3] * 6.0f * Y_ * Z_ * gB[12] -
                kC3[4] * 2.0f * X_ * Y_ * gB[13] -
                kC3[5] * 2.0f * Y_ * Z_ * gB[14] -
                kC3[6] * 6.0f * X_ * Y_ * gB[15];
          gz_ += kC3[1] * X_ * Y_ * gB[10] + kC3[2] * 8.0f * Y_ * Z_ * gB[11] +
                 kC3[3] * (6.0f * ZZ - 3.0f * XX - 3.0f * YY) * gB[12] +
                 kC3[4] * 8.0f * X_ * Z_ * gB[13] +
                 kC3[5] * (XX - YY) * gB[14];
        }
        // dirs = d / (|d| + 1e-12); linalg.norm's derivative is 0 at 0.
        const float den = (dn + Rn(kTiny)).v, nrm = dn.v;
        const float dv[3] = {d0.v, d1.v, d2.v};
        const float gd[3] = {gx, gy, gz_};
        const float dot = gd[0] * dv[0] + gd[1] * dv[1] + gd[2] * dv[2];
        const float along = nrm > 0.0f ? dot / (den * den) / nrm : 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) gp[k] += gd[k] / den - along * dv[k];
      }
    }
  } else if constexpr (kSH) {
    if (live) {
#pragma unroll
      for (int k = 0; k < kRest; ++k) rest[k] = 0.0f;
    }
  }

  if constexpr (kSH) {
    __syncthreads();
    store_rest(g_rest + row0 * kRest, rest_s, total);
  }
  if (!live) return;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_xyz[3 * i + k] = gp[k];
    g_dc[3 * i + k] = gdc[k];
    g_scaling[3 * i + k] = gls[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) g_rotation[4 * i + k] = gq[k];
  g_opacity[i] = gopac;
}

}  // namespace

// Inputs: as project_fwd_launch (xyz [n, 3], f_dc [n, 3], f_rest [n, 45],
// scaling [n, 3], rotation [n, 4], opacity [n] float32, alive [n] bool,
// view [4, 4], fovx and fovy, all on the device and contiguous); the guard's
// bounds near_lo = -m, near_hi_x = W + m, near_hi_y = H + m with m =
// max(radius_min, radius_max), as float32; the cotangents d_means2d [n, 2],
// d_conic [n, 3], d_depth [n], d_color [n, 3], d_opacity [n], each
// contiguous or null (read as 0).  Outputs (written in full): g_xyz [n, 3],
// g_dc [n, 3], g_rest [n, 45] (null and unwritten for sh_degree -1),
// g_scaling [n, 3], g_rotation [n, 4], g_opacity [n].  sh_degree -1
// selects color_mode "dc_sigmoid", 0-3 "sh" of that degree.  Launches on
// `stream`; returns the cudaError_t of the launch (0 on success).
extern "C" int project_bwd_launch(
    const float* xyz, const float* f_dc, const float* f_rest,
    const float* scaling, const float* rotation, const float* opacity,
    const bool* alive, const float* view, const float* fovx,
    const float* fovy, long long n, int width, int height, int sh_degree,
    int antialias, float scale_modifier, float near_lo, float near_hi_x,
    float near_hi_y, const float* d_means2d, const float* d_conic,
    const float* d_depth, const float* d_color, const float* d_opacity,
    float* g_xyz, float* g_dc, float* g_rest, float* g_scaling,
    float* g_rotation, float* g_opacity, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n + kBlock - 1) / kBlock);
#define PROJECT_BWD_LAUNCH(DEG)                                              \
  project_bwd_kernel<DEG><<<blocks, kBlock, 0, s>>>(                         \
      xyz, f_dc, f_rest, scaling, rotation, opacity, alive, view, fovx,      \
      fovy, n, width, height, antialias != 0, scale_modifier, near_lo,       \
      near_hi_x, near_hi_y, d_means2d, d_conic, d_depth, d_color, d_opacity, \
      g_xyz, g_dc, g_rest, g_scaling, g_rotation, g_opacity)
  switch (sh_degree) {
    case -1: PROJECT_BWD_LAUNCH(-1); break;
    case 0: PROJECT_BWD_LAUNCH(0); break;
    case 1: PROJECT_BWD_LAUNCH(1); break;
    case 2: PROJECT_BWD_LAUNCH(2); break;
    case 3: PROJECT_BWD_LAUNCH(3); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PROJECT_BWD_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
