// What the projection kernels (project_fwd.cu, P1; project_bwd.cu, P2)
// share: the block size, the SH constants, the float that rounds as the
// plain chain's eager kernels round (`Rn`), the two norms in the order of
// PyTorch's reduce kernel, the camera a block derives once, and the staging
// of features_rest.  P2 recomputes P1's forward with these, so both take
// every branch of ops/projection.py `project_gaussians_plain` on the same
// bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kRest = 45;  // floats of a features_rest row (15 x 3)

constexpr float kC0 = 0.28209479177387814;
constexpr float kC1 = 0.4886025119029199;
__device__ constexpr float kC2[5] = {
    1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
    -1.0925484305920792, 0.5462742152960396};
__device__ constexpr float kC3[7] = {
    -0.5900435899266435, 2.890611442640554, -0.4570457994644658,
    0.3731763325901154, -0.4570457994644658, 1.445305721320277,
    -0.5900435899266435};
// The chain's Python float constants, as PyTorch casts them to float32.
constexpr float kTiny = 1e-12;
constexpr float kEps2d = 1e-6;

// A float whose arithmetic rounds once an operation, never fused: the
// rounding of one eager PyTorch kernel an operation.
struct Rn {
  float v;
  __device__ Rn(float x = 0.0f) : v(x) {}
};
__device__ __forceinline__ Rn operator+(Rn a, Rn b) {
  return __fadd_rn(a.v, b.v);
}
__device__ __forceinline__ Rn operator-(Rn a, Rn b) {
  return __fsub_rn(a.v, b.v);
}
__device__ __forceinline__ Rn operator*(Rn a, Rn b) {
  return __fmul_rn(a.v, b.v);
}
__device__ __forceinline__ Rn operator/(Rn a, Rn b) {
  return __fdiv_rn(a.v, b.v);
}
__device__ __forceinline__ Rn operator-(Rn a) { return -a.v; }
__device__ __forceinline__ Rn sqrt_rn(Rn a) {
  return __fsqrt_rn(a.v);
}
// torch.clamp's rules: NaN passes through, then max, then min.
__device__ __forceinline__ Rn clamp_min(Rn a, float lo) {
  return isnan(a.v) ? a : Rn(fmaxf(a.v, lo));
}
__device__ __forceinline__ Rn clamp(Rn a, float lo, float hi) {
  return isnan(a.v) ? a : Rn(fminf(fmaxf(a.v, lo), hi));
}
__device__ __forceinline__ Rn sigmoid(Rn a) {
  return Rn(1.0f) / (Rn(1.0f) + Rn(expf(-a.v)));
}

// torch.linalg.norm over the last dimension runs PyTorch's reduce kernel
// (torch 2.11): block.x = 4 threads for a row of 4, one element (its square
// rounded) a thread, combined by a shuffle with offsets 2 then 1; for a row
// of 3, block.x = 2, thread 0 adds elements 0 and 2, then thread 1's
// element 1.  Another torch may sum in another order: chip_smoke.py's
// `norm_order_matches` tells, and its `gate_projection` then holds the
// fields that follow from the quaternion norm within 1e-6, not bitwise.
__device__ __forceinline__ Rn quat_norm(Rn w, Rn x, Rn y, Rn z) {
  return sqrt_rn((w * w + y * y) + (x * x + z * z));
}
__device__ __forceinline__ Rn dir_norm(Rn x, Rn y, Rn z) {
  return sqrt_rn((x * x + z * z) + y * y);
}

// Camera constants a block derives once, in shared memory.
struct Cam {
  float view[12];  // rows 0-2 of V: Rv | Tv
  float fx, fy;
  float centre[3];
};

// Thread 0 of a block fills `cam` from the view matrix and the fields of
// view on the device; the caller synchronises the block before reading it.
__device__ __forceinline__ void load_cam(Cam& cam, const float* view,
                                         const float* fovx,
                                         const float* fovy, int width,
                                         int height) {
#pragma unroll
  for (int k = 0; k < 12; ++k) cam.view[k] = view[k];
  // fx = 0.5 W / tan(FoVx / 2), as the chain computes it: reciprocal of
  // the tangent, times the Python float 0.5 W.
  cam.fx = (Rn(1.0f) / Rn(tanf((Rn(fovx[0]) * Rn(0.5f)).v)) *
            Rn(0.5f * static_cast<float>(width))).v;
  cam.fy = (Rn(1.0f) / Rn(tanf((Rn(fovy[0]) * Rn(0.5f)).v)) *
            Rn(0.5f * static_cast<float>(height))).v;
  // The camera centre -(Rv^T Tv).
#pragma unroll
  for (int j = 0; j < 3; ++j)
    cam.centre[j] = (-(Rn(view[j]) * Rn(view[3]) +
                       Rn(view[4 + j]) * Rn(view[7]) +
                       Rn(view[8 + j]) * Rn(view[11]))).v;
}

// The floats of the block's rows [row0, min(row0 + kBlock, n)) of an
// [n, kRest] array.
__device__ __forceinline__ int block_rest_floats(int64_t row0, int64_t n) {
  const int64_t left = n - row0;
  return (left < kBlock ? static_cast<int>(left) : kBlock) * kRest;
}

// Stage `total` floats from device memory at `src` into the shared tile
// `tile`, the block's threads on consecutive addresses: 16-byte loads where
// `src` is on 16 bytes, 4-byte ones otherwise (a pool cut at a row that is
// not a multiple of 4).
__device__ __forceinline__ void stage_rest(float* tile, const float* src,
                                           int total) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* dst4 = reinterpret_cast<float4*>(tile);
    for (int k = threadIdx.x; k < total / 4; k += kBlock)
      dst4[k] = __ldg(src4 + k);
    done = total / 4 * 4;
  }
  for (int k = done + threadIdx.x; k < total; k += kBlock)
    tile[k] = __ldg(src + k);
}

// The way back: `total` floats of the shared tile to device memory at
// `dst`, 16-byte stores where `dst` is on 16 bytes.
__device__ __forceinline__ void store_rest(float* dst, const float* tile,
                                           int total) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(tile);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int k = threadIdx.x; k < total / 4; k += kBlock)
      dst4[k] = src4[k];
    done = total / 4 * 4;
  }
  for (int k = done + threadIdx.x; k < total; k += kBlock)
    dst[k] = tile[k];
}

}  // namespace
