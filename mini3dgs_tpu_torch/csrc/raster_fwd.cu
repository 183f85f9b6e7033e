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
// of every instance it passed with its gate open.  A block whose pixels all
// arrive closed leaves before its first chunk.  Without kHasT0 the kernel
// loads no t0 and stores zeros in row 5: the single-pass path pays nothing
// for the chain.
//
// Block t works on image tile tile0 + t: a launch may cover a band of the
// image (tile0 = the band's first tile, whole tile rows) with tile_start and
// tile_count indexed from the band's first tile.
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
// Design: one block per tile, 256 threads; each thread owns P/256 pixels
// (1 at tile 16, 4 at tile 32, so a block never needs more than 256 threads
// and the register budget stays far below the 255 cap).  The block copies
// its slice of the SoA stream [10, n_live] into shared memory in chunks of
// kChunk instances (coalesced: neighbouring threads read neighbouring
// instances of one row); every thread then walks the chunk sequentially with
// a running product for T, so no prefix scan is needed.  A pixel stops once
// its gate closes; the block leaves the chunk loop through __syncthreads_or
// when all its pixels have stopped.  Every tile writes all 8 rows, so the
// output needs no zero fill.
//
// Bound: each pixel x instance pair costs one expf plus ~30 FP32 operations
// (an FMA as two); the stream is read once per tile (40 bytes per instance)
// and shared by its P pixels, so the kernel is bound by FP32/SFU instruction
// throughput, not by memory.
//
// The TPU's log-space prefix (1e-30 floor) and this running product round
// differently, so the early stop can flip on isolated pixels, each by at
// most the remaining transmittance (<= 5e-3).  No fast-math: __expf would
// move the w >= 1e-5 and early-stop gates.
//
// Left for later work: warp-level skipping of instances no pixel of the
// warp sees, double-buffered (cp.async / TMA) chunk loads that overlap the
// compositing, and load balancing of heavy tiles across blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;
constexpr int kRows = 10;
constexpr int kAcc = 8;
constexpr float kWEps = 1e-5f;
constexpr float kEarlyStopA = 0.995f;

template <int kPix, bool kHasT0>
__global__ void __launch_bounds__(kThreads)
raster_fwd_kernel(const float* __restrict__ inst, int64_t n_live,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_count, int tiles_x,
                  int tile_size, int tile0, const float* __restrict__ t0,
                  float* __restrict__ out) {
  __shared__ float sh[kRows][kChunk];
  constexpr int P = kThreads * kPix;
  const int t = blockIdx.x;
  const int64_t start = tile_start[t];
  const int count = tile_count[t];
  const int tx = (tile0 + t) % tiles_x;
  const int ty = (tile0 + t) / tiles_x;

  float px[kPix], py[kPix], T[kPix], acc[kPix][5];
  bool live[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int i = threadIdx.x + k * kThreads;
    px[k] = static_cast<float>(tx * tile_size + i % tile_size);
    py[k] = static_cast<float>(ty * tile_size + i / tile_size);
    if constexpr (kHasT0) {
      T[k] = t0[static_cast<int64_t>(t) * P + i];
      live[k] = 1.0f - T[k] < kEarlyStopA;
    } else {
      T[k] = 1.0f;
      live[k] = true;
    }
#pragma unroll
    for (int c = 0; c < 5; ++c) acc[k][c] = 0.0f;
  }

  for (int base = 0; base < count; base += kChunk) {
    bool any_live = false;
#pragma unroll
    for (int k = 0; k < kPix; ++k) any_live |= live[k];
    // Also the barrier that protects `sh` from the previous chunk's readers.
    if (!__syncthreads_or(any_live)) break;
    const int n = min(kChunk, count - base);
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int64_t src = start + base + j;
#pragma unroll
      for (int r = 0; r < kRows; ++r) sh[r][j] = inst[r * n_live + src];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float x = sh[0][j], y = sh[1][j];
      const float qa = sh[2][j], qb = sh[3][j], qc = sh[4][j];
      const float op = sh[5][j];
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (!live[k]) continue;
        // The gate reads the transmittance before this instance; T never
        // rises, so once the gate closes it stays closed.
        if (!(1.0f - T[k] < kEarlyStopA)) {
          live[k] = false;
          continue;
        }
        const float dx = px[k] - x;
        const float dy = py[k] - y;
        const float lw = dx * dx * qa + dx * dy * qb + dy * dy * qc;
        const float w = fminf(expf(lw), 1.0f);
        const float alpha = (w >= kWEps) ? fminf(op * w, 1.0f) : 0.0f;
        const float c = T[k] * alpha;
        acc[k][0] += c * sh[6][j];
        acc[k][1] += c * sh[7][j];
        acc[k][2] += c * sh[8][j];
        acc[k][3] += c * sh[9][j];
        acc[k][4] += c;
        T[k] *= 1.0f - alpha;
      }
    }
  }

  float* o = out + static_cast<int64_t>(t) * kAcc * P;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int i = threadIdx.x + k * kThreads;
#pragma unroll
    for (int c = 0; c < 5; ++c) o[c * P + i] = acc[k][c];
    o[5 * P + i] = kHasT0 ? T[k] : 0.0f;
#pragma unroll
    for (int c = 6; c < kAcc; ++c) o[c * P + i] = 0.0f;
  }
}

template <bool kHasT0>
int launch(const float* inst, int64_t n_live, const int* tile_start,
           const int* tile_count, int num_tiles, int tiles_x, int tile_size,
           int tile0, const float* t0, float* out, void* stream) {
  if (num_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_size == 16) {
    raster_fwd_kernel<1, kHasT0><<<num_tiles, kThreads, 0, s>>>(
        inst, n_live, tile_start, tile_count, tiles_x, tile_size, tile0, t0,
        out);
  } else if (tile_size == 32) {
    raster_fwd_kernel<4, kHasT0><<<num_tiles, kThreads, 0, s>>>(
        inst, n_live, tile_start, tile_count, tiles_x, tile_size, tile0, t0,
        out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// inst: [10, n_live] float32; tile_start/tile_count: [num_tiles] int32;
// out: [num_tiles, 8, tile_size^2] float32; block t rasterizes image tile
// tile0 + t.  Launches on `stream` and returns the cudaError_t of the launch
// (0 on success).
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
