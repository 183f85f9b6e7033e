// Backward tile rasterizer for Hopper (sm_90a): the gradient of
// raster_fwd.cu with respect to the instance stream.
//
// Replaces the TPU kernel mini3dgs_tpu/ops/raster_pallas.py `_bwd_kernel`,
// the VJP of `_fwd_kernel`, in both builds of `_make_raster_op`:
// has_t0=False (kHasT0 = false, `raster_bwd_launch`) and has_t0=True (the
// ring route; kHasT0 = true, `raster_bwd_t0_launch`).
// Same function: for every tile, replay the tile's slice
// [tile_start, tile_start + tile_count) front to back with the forward
// kernel's alpha and gate arithmetic and, from the cotangent `gout` of the
// raw accumulators `oraw` (both [tile][8][P], rows 0..4 live), write the
// gradient rows d[x, y, qa, qb, qc, op, r, g, b, depth] of each instance
// into column tile_start + j of d_inst [10, n_live].
//
// Per pixel p and instance j (T = transmittance before j, gate open while
// 1 - T < 0.995):
//   total = <gout[:, p], oraw[:, p]>
//   u     = gout_r*r + gout_g*g + gout_b*b + gout_d*depth + gout_a
//   wgt   = T * alpha
//   S     = total - sum_{i<=j} u_i * wgt_i        (what lies behind j)
//   d_alpha = u*T - S / (1 - alpha)
//   alpha = min(op*w, 1) where w >= 1e-5:  only 0 < op*w < 1 passes d_alpha;
//     d_op += d_alpha * w                  (not gated by w < 1)
//     d_lw  = w * d_alpha * op  where w < 1        (w = min(exp(lw), 1))
//   lw = dx^2 qa + dx dy qb + dy^2 qc, dx = px - x:
//     d_x  += -d_lw (2 dx qa + dy qb)    d_y  += -d_lw (2 dy qc + dx qb)
//     d_qa += d_lw dx^2   d_qb += d_lw dx dy   d_qc += d_lw dy^2
//   d_[r,g,b,depth] += gout_[r,g,b,d] * wgt
// each summed over the tile's P pixels.
//
// With kHasT0 (see raster_fwd.cu) T starts at t0 and row 5 of oraw is the
// transmittance T_end the pixel ended with, row 5 of gout its cotangent.
// Every contribution and T_end are linear in t0 and T_end carries the factor
// (1 - alpha) of every instance passed with the gate open, so
//   total = <gout[0..5, p], oraw[0..5, p]>
// makes S carry the term gout_T * T_end of the ranges behind this stream, and
//   dt0[p] = total / max(t0[p], 1e-30)
// is the cotangent of t0; it is stored for every pixel of every tile, so
// dt0 needs no zero fill.  Without kHasT0 the kernel reads no t0 and no row
// 5 and writes no dt0.  Block t works on image tile tile0 + t.
//
// Design: one block per tile and 256 threads, as in the forward kernel;
// a thread owns P/256 pixels (1 at tile 16, 4 at tile 32) and keeps their
// px, py, T, running sum, total and the five cotangents in registers, so
// dx and dy are exact and the five geometric terms are accumulated
// directly.  T is the forward kernel's running product, so both kernels
// gate identically; a pixel whose gate has closed stops for good and gives
// every later instance exactly 0 (as autograd of the reference does; the
// TPU kernel leaves the rounding residue of S there).  The block stages
// kChunk instances at a time in shared memory and walks them in order.
// Per instance a thread sums its pixels' ten terms, the warp reduces them
// with shuffles, and lane 0 stores the warp's partial to
// part[warp][row][j]; a warp none of whose lanes has alpha > 0 skips the
// reduction and stores zeros.  After the chunk the block sums the 8 warps'
// partials in a fixed order and stores each row coalesced.  No atomics: two
// launches on the same inputs give bitwise-equal gradients.
//
// The block leaves the chunk loop through __syncthreads_or once all its
// pixels have stopped.  It does not write the rest of its slice: the
// wrapper hands in a zero-filled d_inst.
//
// Bound: each pixel x instance pair costs one expf, one division and ~70
// FP32 operations (an FMA as two), and each instance x warp 50 shuffles; the stream (40 B
// per instance) is read once per tile and the gradient written once, gout
// and oraw are 40 B per pixel.  So the kernel is bound by FP32/SFU/shuffle
// instruction throughput, not by memory.
//
// No fast-math: expf and a true division, as the forward kernel, so that
// the w >= 1e-5 and early-stop gates fall where the forward put them.
//
// Left for later work: walking the slice back to front (as the original
// 3DGS backward does) to avoid S as a difference of nearly equal sums, a
// reduction that costs fewer shuffles (transposed butterfly), and load
// balancing of heavy tiles across blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;
constexpr int kRows = 10;
constexpr int kAcc = 8;
constexpr float kWEps = 1e-5f;
constexpr float kEarlyStopA = 0.995f;
constexpr unsigned kFullMask = 0xffffffffu;

template <int kPix, bool kHasT0>
__global__ void __launch_bounds__(kThreads)
raster_bwd_kernel(const float* __restrict__ inst, int64_t n_live,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_count, int tiles_x,
                  int tile_size, int tile0, const float* __restrict__ oraw,
                  const float* __restrict__ gout, const float* __restrict__ t0,
                  float* __restrict__ d_inst, float* __restrict__ dt0) {
  __shared__ float sh[kRows][kChunk];
  __shared__ float part[kWarps][kRows][kChunk];
  constexpr int P = kThreads * kPix;
  const int t = blockIdx.x;
  const int64_t start = tile_start[t];
  const int count = tile_count[t];
  const int tx = (tile0 + t) % tiles_x;
  const int ty = (tile0 + t) / tiles_x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float px[kPix], py[kPix], T[kPix], prefix[kPix], total[kPix];
  float g_r[kPix], g_g[kPix], g_b[kPix], g_d[kPix], g_a[kPix];
  bool live[kPix];
  const float* go = gout + static_cast<int64_t>(t) * kAcc * P;
  const float* oo = oraw + static_cast<int64_t>(t) * kAcc * P;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int i = threadIdx.x + k * kThreads;
    px[k] = static_cast<float>(tx * tile_size + i % tile_size);
    py[k] = static_cast<float>(ty * tile_size + i / tile_size);
    prefix[k] = 0.0f;
    g_r[k] = go[0 * P + i];
    g_g[k] = go[1 * P + i];
    g_b[k] = go[2 * P + i];
    g_d[k] = go[3 * P + i];
    g_a[k] = go[4 * P + i];
    total[k] = g_r[k] * oo[0 * P + i] + g_g[k] * oo[1 * P + i] +
               g_b[k] * oo[2 * P + i] + g_d[k] * oo[3 * P + i] +
               g_a[k] * oo[4 * P + i];
    if constexpr (kHasT0) {
      const float t_in = t0[static_cast<int64_t>(t) * P + i];
      total[k] += go[5 * P + i] * oo[5 * P + i];
      dt0[static_cast<int64_t>(t) * P + i] = total[k] / fmaxf(t_in, 1e-30f);
      T[k] = t_in;
      live[k] = 1.0f - t_in < kEarlyStopA;
    } else {
      T[k] = 1.0f;
      live[k] = true;
    }
  }

  for (int base = 0; base < count; base += kChunk) {
    bool any_live = false;
#pragma unroll
    for (int k = 0; k < kPix; ++k) any_live |= live[k];
    // Also the barrier that protects `sh` and `part` from the previous
    // chunk's readers.
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
      const float cr = sh[6][j], cg = sh[7][j], cb = sh[8][j], cd = sh[9][j];
      float d[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) d[r] = 0.0f;
      bool touched = false;
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
        if (!(w >= kWEps)) continue;  // alpha = 0: nothing moves
        const float a_raw = op * w;
        const float alpha = fminf(a_raw, 1.0f);
        const float wgt = T[k] * alpha;
        const float u =
            g_r[k] * cr + g_g[k] * cg + g_b[k] * cb + g_d[k] * cd + g_a[k];
        prefix[k] += u * wgt;
        touched = true;
        d[6] += g_r[k] * wgt;
        d[7] += g_g[k] * wgt;
        d[8] += g_b[k] * wgt;
        d[9] += g_d[k] * wgt;
        if (a_raw < 1.0f && a_raw > 0.0f) {
          const float d_alpha =
              u * T[k] - (total[k] - prefix[k]) / (1.0f - alpha);
          d[5] += d_alpha * w;
          if (w < 1.0f) {
            const float d_lw = w * d_alpha * op;
            d[0] -= d_lw * (2.0f * dx * qa + dy * qb);
            d[1] -= d_lw * (2.0f * dy * qc + dx * qb);
            d[2] += d_lw * dx * dx;
            d[3] += d_lw * dx * dy;
            d[4] += d_lw * dy * dy;
          }
        }
        T[k] *= 1.0f - alpha;
      }
      if (!__any_sync(kFullMask, touched)) {
        if (lane < kRows) part[warp][lane][j] = 0.0f;
        continue;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float v = d[r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_down_sync(kFullMask, v, off);
        if (lane == 0) part[warp][r][j] = v;
      }
    }
    __syncthreads();

    // Fixed-order sum over the warps, one coalesced store per row.
    for (int idx = threadIdx.x; idx < kRows * n; idx += kThreads) {
      const int r = idx / n;
      const int j = idx - r * n;
      float v = part[0][r][j];
#pragma unroll
      for (int wi = 1; wi < kWarps; ++wi) v += part[wi][r][j];
      d_inst[r * n_live + start + base + j] = v;
    }
  }
}

template <bool kHasT0>
int launch(const float* inst, int64_t n_live, const int* tile_start,
           const int* tile_count, int num_tiles, int tiles_x, int tile_size,
           int tile0, const float* oraw, const float* gout, const float* t0,
           float* d_inst, float* dt0, void* stream) {
  if (num_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_size == 16) {
    raster_bwd_kernel<1, kHasT0><<<num_tiles, kThreads, 0, s>>>(
        inst, n_live, tile_start, tile_count, tiles_x, tile_size, tile0, oraw,
        gout, t0, d_inst, dt0);
  } else if (tile_size == 32) {
    raster_bwd_kernel<4, kHasT0><<<num_tiles, kThreads, 0, s>>>(
        inst, n_live, tile_start, tile_count, tiles_x, tile_size, tile0, oraw,
        gout, t0, d_inst, dt0);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// inst: [10, n_live] float32; tile_start/tile_count: [num_tiles] int32;
// oraw, gout: [num_tiles, 8, tile_size^2] float32; d_inst: [10, n_live]
// float32, zero-filled by the caller; block t works on image tile tile0 + t.
// Launches on `stream` and returns the cudaError_t of the launch (0 on
// success).
extern "C" int raster_bwd_launch(const float* inst, long long n_live,
                                 const int* tile_start, const int* tile_count,
                                 int num_tiles, int tiles_x, int tile_size,
                                 int tile0, const float* oraw,
                                 const float* gout, float* d_inst,
                                 void* stream) {
  return launch<false>(inst, n_live, tile_start, tile_count, num_tiles,
                       tiles_x, tile_size, tile0, oraw, gout, nullptr, d_inst,
                       nullptr, stream);
}

// The same with the incoming transmittance t0: [num_tiles, tile_size^2]
// float32; also writes its cotangent dt0, of the same shape (every element).
extern "C" int raster_bwd_t0_launch(const float* inst, long long n_live,
                                    const int* tile_start,
                                    const int* tile_count, int num_tiles,
                                    int tiles_x, int tile_size, int tile0,
                                    const float* oraw, const float* gout,
                                    const float* t0, float* d_inst,
                                    float* dt0, void* stream) {
  return launch<true>(inst, n_live, tile_start, tile_count, num_tiles,
                      tiles_x, tile_size, tile0, oraw, gout, t0, d_inst, dt0,
                      stream);
}
