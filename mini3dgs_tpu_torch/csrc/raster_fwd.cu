// Forward tile rasterizer for Hopper (sm_90a).  Its backward is
// raster_bwd.cu, which replays the same alpha and gate arithmetic.
//
// Replaces the TPU kernel mini3dgs_tpu/ops/raster_pallas.py `_fwd_kernel`
// in both builds of `_make_raster_op`: has_t0=False (called from
// `rasterize_tiles`; here kHasT0 = false, `raster_fwd_launch`) and
// has_t0=True (the ring route of parallel/ring.py; kHasT0 = true,
// `raster_fwd_t0_launch`).  Same function: for every image tile, composite
// the tile's depth-sorted slice [tile_start, tile_start + tile_count) of the
// instance stream front to back into raw accumulators [r, g, b, depth, alpha]
// per pixel, written as out[tile][8][P] (rows 5..7 are zero).
//
// With kHasT0 the per-pixel transmittance starts at t0[tile][P] (what the
// depth ranges in front of this stream left) instead of 1, so the gate and
// the early stop read the accumulated alpha of the whole chain, and row 5 of
// the output is the transmittance the pixel ends with: t0 times (1 - alpha)
// of every instance it passed with its gate open.  Without kHasT0 the kernel
// loads no t0 and stores zeros in row 5: the single-pass path pays nothing
// for the chain.
//
// Tile t of the launch is image tile tile0 + t: a launch may cover a band of
// the image (tile0 = the band's first tile, whole tile rows) with tile_start
// and tile_count indexed from the band's first tile.
//
// Per pixel x instance (the conic rows are pre-scaled so the quadratic form
// is log w):
//   lw = dx*dx*qa + dx*dy*qb + dy*dy*qc;   w = min(exp(lw), 1)
//   alpha = (w >= 1e-5) ? min(op*w, 1) : 0
//   contribution = T * alpha, only while (1 - T) < 0.995, where T is the
//   ungated transmittance before the instance; then T *= (1 - alpha).
// Pixel coordinates are the integers px = tx*ts + i % ts, py = ty*ts + i / ts,
// with tx, ty the column and row of image tile tile0 + t.
//
// What bounds it on this card.  A pair whose gate is open needs 22 float32
// operations for the w >= 1e-5 test and, where it passes, 14 more; the stream
// is 40 B an instance and is shared by a tile's pixels.  So the bound is
// float32 instruction throughput, far below the memory's.  The tensor cores
// would not help: the TPU kernel's [8, G] x [G, P] accumulation matmul is
// five FMAs a live pair here, and the test that dominates is not a product.
//
// Design (each part timed on an NVIDIA H100 80GB HBM3, PERF.md).
// - Unit of work: a block of 256 threads, one pixel a thread, covers a
//   sub-tile of 16 x 16 pixels (the layout of raster_bwd.cu at one pixel a
//   thread, raster_common.cuh): the tile at tile 16, one of four quadrants
//   at tile 32.  The blocks of a tile walk the same slice of the stream,
//   each leaves at its own early stop, and each writes only its own pixels:
//   no scratch, no atomics.  A band of a ring step (125 tiles) is 500 blocks
//   and spreads over the card's 132 SMs.
// - Compact warps: a warp owns a patch of 8 x 4 pixels.
// - Reject per warp before any lane computes.  After a chunk is staged, the
//   lanes of a warp test its 64 instances against the warp's own patch
//   (`patch_missed`, the rule raster_bwd.cu uses), two a lane, and ballot
//   the results into two hit words; the warp walks the set bits only.  On a
//   missed patch lw < -11.6, so expf(lw) < 1e-5 and alpha = 0 exactly: T,
//   the gates and the accumulators are what they were, and the output is
//   bitwise that of a kernel without the reject.  A conic that is not
//   positive definite, or any non-finite value, is never rejected.
// - Chunks of 64 instances are staged with cp.async into two buffers:
//   chunk c + 1 is in flight while chunk c is walked.  One barrier a chunk.
// - Early stop at every level: a warp all of whose pixels have stopped skips
//   the chunk (and its tests); a block leaves the chunk loop through
//   __syncthreads_or once all its pixels have stopped; a block whose pixels
//   all arrive closed (with t0), or whose tile is empty, stages nothing and
//   only stores.  Every block writes all 8 rows of its pixels, so the output
//   needs no zero fill.
//
// Tried and dropped, by their times: two pixels a thread for launches of
// more tiles than SMs (no faster than one; one is simpler); two instances
// walked side by side; the block's threads testing every (instance, patch)
// into shared memory behind a second barrier (2-3 % slower than each warp
// testing its own patch); blocks of 128 threads; no reject at tile 16; six
// or eight blocks an SM (spills).
//
// The TPU's log-space prefix (1e-30 floor) and this running product round
// differently, so the early stop can flip on isolated pixels, each by at
// most the remaining transmittance (<= 5e-3).  No fast-math: __expf would
// move the w >= 1e-5 and early-stop gates.
//
// T is a float64 running product (one multiply a pair on the half-rate
// float64 units); the rest of a pair, and the accumulators, are float32.
// Over tiles of tens of thousands of instances a float32 T drifts from the
// product of its factors, and raster_bwd.cu, which replays T to form
// S = total - prefix, amplifies that drift of the accumulators into its
// gradient (scripts/raster_precision_torch.py --band splits it).
// raster_bwd.cu computes the same float64 T, so both kernels close each
// pixel's gate at the same instance.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

// The blocks an SM the launch bound asks for: five, in 43-48 registers
// (without the bound the float64 T took 51 at tile 32, four blocks an SM,
// 2-3 % slower).  Six (40 registers) spill and were slower.
constexpr int kFwdBlocksPerSm = 5;

// kTile = 16: a block a tile.  kTile = 32: kQuads = 4 blocks a tile.
template <int kTile, bool kHasT0>
__global__ void __launch_bounds__(kThreads, kFwdBlocksPerSm)
raster_fwd_kernel(const float* __restrict__ inst, int64_t n_live,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_count, int tiles_x, int tile0,
                  const float* __restrict__ t0, float* __restrict__ out) {
  constexpr int P = kTile * kTile;
  constexpr int kPatchH = kLaneRows;
  constexpr int kSubH = kPatchH * (kWarps / kPatchesX);
  constexpr int kQuadsX = kTile / kSubW;
  constexpr int kQuads = kQuadsX * (kTile / kSubH);
  __shared__ __align__(16) float sh[2 * kChunk * kInstStride];

  const int t = blockIdx.x / kQuads;
  const int q = blockIdx.x % kQuads;
  const int64_t start = tile_start[t];
  const int count = tile_count[t];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // The pixel of this thread: column lane % 8 and row lane / 8 of the
  // warp's patch, patch (warp % 2, warp / 2) of the sub-tile q.
  const int tile_x = ((tile0 + t) % tiles_x) * kTile;
  const int tile_y = ((tile0 + t) / tiles_x) * kTile;
  const int patch_x = (q % kQuadsX) * kSubW + (warp % kPatchesX) * kPatchW;
  const int patch_y = (q / kQuadsX) * kSubH + (warp / kPatchesX) * kPatchH;
  const int i = (patch_y + (lane >> 3)) * kTile + patch_x + (lane & 7);
  const float px = static_cast<float>(tile_x + i % kTile);
  const float py = static_cast<float>(tile_y + i / kTile);
  const float x0 = static_cast<float>(tile_x + patch_x);
  const float y0 = static_cast<float>(tile_y + patch_y);

  double T = kHasT0 ? t0[static_cast<int64_t>(t) * P + i] : 1.0;  // float64
  // The gate reads the transmittance before an instance; T never rises, so
  // once the gate has closed it stays closed.
  bool open = 1.0 - T < kEarlyStopA;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  float acc_a = 0.0f;

  auto stage = [&](int base, int buf) {
    const int n = min(kChunk, count - base);
    const float* src = inst + start + base;
    for (int e = threadIdx.x; e < kRows * kChunk; e += kThreads) {
      const int r = e / kChunk, j = e % kChunk;
      if (j < n)
        __pipeline_memcpy_async(&sh[(buf * kChunk + j) * kInstStride + r],
                                src + r * n_live + j, sizeof(float));
    }
    __pipeline_commit();
  };
  auto hit = [&](const float* chunk, int j, int n) {
    return j < n && !patch_missed(chunk + j * kInstStride, x0, y0,
                                  static_cast<float>(kPatchW),
                                  static_cast<float>(kPatchH));
  };

  // `count` is the same for the whole block.
  if (count > 0 && __syncthreads_or(open)) {
    stage(0, 0);
    for (int base = 0, buf = 0; base < count; base += kChunk, buf ^= 1) {
      const int n = min(kChunk, count - base);
      __pipeline_wait_prior(0);
      // Also the barrier that makes chunk `base` visible and protects the
      // other buffer from the previous chunk's readers.
      if (!__syncthreads_or(open)) break;
      if (base + kChunk < count) stage(base + kChunk, buf ^ 1);
      // A patch all of whose pixels have stopped skips the chunk.
      if (!__any_sync(kFullMask, open)) continue;
      const float* chunk = sh + buf * kChunk * kInstStride;
      const unsigned hits_lo = __ballot_sync(kFullMask, hit(chunk, lane, n));
      const unsigned hits_hi =
          n > 32 ? __ballot_sync(kFullMask, hit(chunk, lane + 32, n)) : 0u;
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        unsigned hits = h == 0 ? hits_lo : hits_hi;
        while (hits) {
          const int bit = __ffs(hits) - 1;
          hits &= hits - 1;
          const float* s = chunk + (h * 32 + bit) * kInstStride;
          const float4 s0 = *reinterpret_cast<const float4*>(s);
          const float4 s1 = *reinterpret_cast<const float4*>(s + 4);
          const float2 s2 = *reinterpret_cast<const float2*>(s + 8);
          const float dx = px - s0.x, dy = py - s0.y;
          const float lw = dx * dx * s0.z + dx * dy * s0.w + dy * dy * s1.x;
          const float w = fminf(expf(lw), 1.0f);
          if (!(open && w >= kWEps)) continue;  // alpha = 0: nothing moves
          const float alpha = fminf(s1.y * w, 1.0f);
          const float c = static_cast<float>(T * alpha);
          acc_r += c * s1.z;
          acc_g += c * s1.w;
          acc_b += c * s2.x;
          acc_d += c * s2.y;
          acc_a += c;
          T *= 1.0 - alpha;
          open = 1.0 - T < kEarlyStopA;
        }
      }
    }
  }

  float* o = out + static_cast<int64_t>(t) * kAcc * P + i;
  o[0 * P] = acc_r;
  o[1 * P] = acc_g;
  o[2 * P] = acc_b;
  o[3 * P] = acc_d;
  o[4 * P] = acc_a;
  o[5 * P] = kHasT0 ? static_cast<float>(T) : 0.0f;
#pragma unroll
  for (int c = 6; c < kAcc; ++c) o[c * P] = 0.0f;
}

template <int kTile, bool kHasT0>
int launch_tiles(const float* inst, int64_t n_live, const int* tile_start,
                 const int* tile_count, int num_tiles, int tiles_x, int tile0,
                 const float* t0, float* out, cudaStream_t s) {
  constexpr int kQuads = kTile * kTile / kThreads;
  raster_fwd_kernel<kTile, kHasT0><<<num_tiles * kQuads, kThreads, 0, s>>>(
      inst, n_live, tile_start, tile_count, tiles_x, tile0, t0, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kHasT0>
int launch(const float* inst, int64_t n_live, const int* tile_start,
           const int* tile_count, int num_tiles, int tiles_x, int tile_size,
           int tile0, const float* t0, float* out, void* stream) {
  if (num_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_size == 16)
    return launch_tiles<16, kHasT0>(inst, n_live, tile_start, tile_count,
                                    num_tiles, tiles_x, tile0, t0, out, s);
  if (tile_size == 32)
    return launch_tiles<32, kHasT0>(inst, n_live, tile_start, tile_count,
                                    num_tiles, tiles_x, tile0, t0, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int kTile, bool kHasT0>
int blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, raster_fwd_kernel<kTile, kHasT0>, kThreads, 0) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

// inst: [10, n_live] float32; tile_start/tile_count: [num_tiles] int32;
// out: [num_tiles, 8, tile_size^2] float32; the blocks of tile t rasterize
// image tile tile0 + t.  Launches on `stream` and returns the cudaError_t of
// the launch (0 on success).
extern "C" int raster_fwd_launch(const float* inst, long long n_live,
                                 const int* tile_start, const int* tile_count,
                                 int num_tiles, int tiles_x, int tile_size,
                                 int tile0, float* out, void* stream) {
  return launch<false>(inst, n_live, tile_start, tile_count, num_tiles,
                       tiles_x, tile_size, tile0, nullptr, out, stream);
}

// The same with the incoming transmittance t0: [num_tiles, tile_size^2]
// float32; row 5 of `out` is the outgoing transmittance.
extern "C" int raster_fwd_t0_launch(const float* inst, long long n_live,
                                    const int* tile_start,
                                    const int* tile_count, int num_tiles,
                                    int tiles_x, int tile_size, int tile0,
                                    const float* t0, float* out,
                                    void* stream) {
  return launch<true>(inst, n_live, tile_start, tile_count, num_tiles,
                      tiles_x, tile_size, tile0, t0, out, stream);
}

// Blocks of the kernel that fit one SM (by registers and shared memory), or
// -1: the build for `tile_size` (16 or 32), without or with t0.
extern "C" int raster_fwd_blocks_per_sm(int tile_size, int has_t0) {
  if (tile_size == 16)
    return has_t0 ? blocks_per_sm<16, true>() : blocks_per_sm<16, false>();
  if (tile_size == 32)
    return has_t0 ? blocks_per_sm<32, true>() : blocks_per_sm<32, false>();
  return -1;
}
