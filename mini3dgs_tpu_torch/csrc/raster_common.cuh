// What the two tile rasterizers (raster_fwd.cu, raster_bwd.cu) share: the
// per-pair constants, the layout of a block's pixels, the staged-instance
// stride and the per-patch reject rule.  ops/raster_cuda.py mirrors the
// rule (`patch_missed`), the layout (`sub_tile_pixels`, `thread_pixels`) and
// the two reject numbers.

#pragma once

#include <math_constants.h>

namespace {

// A block: kThreads threads, kPix pixels a thread (1 in raster_fwd.cu, 1 or
// 2 in raster_bwd.cu).
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSubW = 16;     // a block's sub-tile is kSubW x 16 kPix pixels:
constexpr int kPatchesX = 2;  // 2 x 4 patches, one a warp, of
constexpr int kPatchW = 8;    // kPatchW x 4 kPix pixels; a lane's kPix pixels
constexpr int kLaneRows = 4;  // lie kLaneRows rows apart
constexpr int kChunk = 64;    // two ballot words a warp
constexpr int kRows = 10;
constexpr int kInstStride = 12;  // floats a staged instance: three float4
constexpr int kAcc = 8;
constexpr float kWEps = 1e-5f;
// The early stop compares the float64 1 - T with the real 0.995, as the
// float64 plain version does.  The float 0.995f (0.99500000477) would pass
// one instance more than float64 wherever T lands within 4.8e-9 below
// 0.005: about one pixel a band of the 1M stream, each moving its tile's
// rows by up to 3.6e-4 (rel-L2) from float64.
constexpr double kEarlyStopA = 0.995;
constexpr unsigned kFullMask = 0xffffffffu;
// The reject rule; ops/raster_cuda.py holds the same two numbers.
constexpr float kRejectL = 11.6f;
constexpr float kRejectGuard = 1e-4f;

// Whether the footprint {w >= 1e-5} of the staged instance `s` surely
// misses the patch of pixels [x0, x0 + w - 1] x [y0, y0 + h - 1]: the least
// of Q = -lw = A dx^2 + B dx dy + C dy^2 over the patch lies above kRejectL.
// Q is convex, so unless the centre lies inside the patch its least value is
// taken on one of the four edges, on each at the clamped stationary point.
// Each value is lowered by kRejectGuard of the sum of its terms' sizes,
// against rounding here and in the kernel's own lw.  Never true for a
// conic that is not positive definite or for non-finite values.
__device__ __forceinline__ bool patch_missed(const float* s, float x0,
                                             float y0, float w, float h) {
  const float x = s[0], y = s[1];
  const float A = -s[2], B = -s[3], C = -s[4];
  const float dx0 = x0 - x, dx1 = x0 + (w - 1.0f) - x;
  const float dy0 = y0 - y, dy1 = y0 + (h - 1.0f) - y;
  const bool ok = A > 0.0f && C > 0.0f && A < CUDART_INF_F &&
                  C < CUDART_INF_F && fabsf(B) < CUDART_INF_F &&
                  4.0f * A * C - B * B > 0.0f && fabsf(x) < CUDART_INF_F &&
                  fabsf(y) < CUDART_INF_F;
  const bool inside =
      dx0 <= 0.0f && dx1 >= 0.0f && dy0 <= 0.0f && dy1 >= 0.0f;
  const float ky = -0.5f * B / C, kx = -0.5f * B / A;
  if (!ok || inside || !(fabsf(ky) < CUDART_INF_F) ||
      !(fabsf(kx) < CUDART_INF_F))
    return false;
  bool missed = true;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float X = e ? dx1 : dx0;
    const float v = fminf(fmaxf(ky * X, dy0), dy1);
    const float q = A * X * X + B * X * v + C * v * v;
    const float m = A * X * X + fabsf(B * X * v) + C * v * v;
    missed = missed && (q - kRejectGuard * m > kRejectL);
    const float Y = e ? dy1 : dy0;
    const float u = fminf(fmaxf(kx * Y, dx0), dx1);
    const float q2 = A * u * u + B * u * Y + C * Y * Y;
    const float m2 = A * u * u + fabsf(B * u * Y) + C * Y * Y;
    missed = missed && (q2 - kRejectGuard * m2 > kRejectL);
  }
  return missed;
}

}  // namespace
