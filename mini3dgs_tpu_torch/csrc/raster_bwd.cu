// Backward tile rasterizer for Hopper (sm_90a): the gradient of
// raster_fwd.cu with respect to the instance stream.
//
// Replaces the TPU kernel mini3dgs_tpu/ops/raster_pallas.py `_bwd_kernel`,
// the VJP of `_fwd_kernel`, in both builds of `_make_raster_op`:
// has_t0=False (kHasT0 = false, `raster_bwd_launch`) and has_t0=True (the
// ring route; kHasT0 = true, `raster_bwd_t0_launch`).
// Same function: for every tile, replay the tile's slice
// [tile_start, tile_start + tile_count) front to back with the forward
// kernel's alpha and gate arithmetic and, from the cotangent `gout`
// [tile][8][P] of the forward's raw accumulators `oraw` (rows 0..4 live),
// write the gradient rows d[x, y, qa, qb, qc, op, r, g, b, depth] of each
// instance into column tile_start + j of d_inst [10, n_live].  The kernel
// takes no `oraw`: it sums `total` itself.
//
// Per pixel p and instance j (T = transmittance before j, gate open while
// 1 - T < 0.995):
//   total = sum over the pixel's list of u * wgt  (= <gout[:, p], oraw[:, p]>)
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
// (1 - alpha) of every instance passed with the gate open, so total adds
// gout_T * T_end (= <gout[0..5, p], oraw[0..5, p]>; T_end is what the first
// pass leaves of T), S carries that term of the ranges behind this stream, and
//   dt0[p] = total / max(t0[p], 1e-30)
// is the cotangent of t0; it is stored for every pixel of every tile, so
// dt0 needs no zero fill.  Without kHasT0 the kernel reads no t0 and no row
// 5 and writes no dt0.  Tile t of the launch is image tile tile0 + t.
//
// What bounds it on this card.  The function needs little: a pixel x
// instance pair whose gate is open costs 22 float32 operations for the
// w >= 1e-5 test, and only the pairs that pass it (about half on a trained
// scene) up to 63 more; the stream is 40 B an instance.  So the bound is
// float32 instruction throughput, far below the memory's.  A kernel pays more than the
// function needs: it runs per warp, not per pair, so an instance that
// touches one lane costs the whole warp the full path; the sum over the
// tile's pixels of ten rows per instance is a reduction the bound does not
// count (in this kernel about 80 of the 205 instructions a warp executes for
// an instance all of whose lanes are live, at one pixel a thread); and a
// launch lasts as long as its busiest SM.  Measured on an NVIDIA H100 80GB
// HBM3 the kernel is bound by instruction throughput, not by its barriers (half
// the chunk, twice the barriers: 2 % slower) and not by memory.
//
// Design.
// - Unit of work: a block of 256 threads covers a sub-tile 16 pixels wide
//   and 16 kPix high, kPix pixels a thread.  At tile 16 that is the tile
//   (kPix = 1).  At tile 32 a launch of more tiles than the card has SMs
//   takes kPix = 2 (two blocks a tile, 80 registers, three blocks an SM):
//   one fetch of the instance, one reduction and one store then serve 64
//   pixels.  A launch of fewer tiles (a band of a ring step) takes kPix = 1
//   (four blocks a tile, 60-64 registers, four blocks an SM): all its blocks
//   are resident at once anyway, and the smaller ones spread better over the
//   SMs.  The blocks of a tile walk the same slice of the stream and each
//   leave at their own early stop.
// - Compact warps: a warp owns a patch of 8 x 4 kPix pixels, so an instance
//   touches few warps of a block.
// - Reject per warp before any lane computes.  After a chunk is staged,
//   every thread tests one instance against two of the block's eight
//   patches (`patch_missed` in raster_common.cuh, which raster_fwd.cu
//   shares): the least value over the patch of the convex
//   form Q = -lw, found on the patch's edges, against L = 11.6 >
//   -ln(1e-5) = 11.513, with a guard against rounding.  A warp ballots the
//   64 results for its patch into two words and walks the set bits only: a
//   rejected instance costs the warp nothing.  On a missed patch lw < -L,
//   so expf(lw) < 1e-5 and alpha = 0 exactly: rows, T and gates are what
//   they were.  A conic that is not positive definite, or any non-finite
//   value, is never rejected.  `patch_missed` in ops/raster_cuda.py is the
//   same rule in plain PyTorch, tested on the CPU.
// - A lane first computes w for all of its pixels side by side (independent
//   chains of expf), then walks the pixels that pass through the dependent
//   part (T, the running sum, the division).
// - Reduction: the ten rows of a touched instance are reduced over the
//   warp's 32 lanes together by a transposed butterfly.  At each of the steps
//   xor 16, 8, 4, 2 a lane hands half of the rows it holds to its partner and
//   keeps the sum of the other half (10 -> 5 -> 3 -> 2 -> 1 rows), the step
//   xor 1 adds the last pair: 12 shuffles instead of 50.  Lane l (even) ends
//   with row 5*b4 + 3*b3 + 2*b2 + b1 of its bits.  The order of every sum is
//   fixed.  A warp none of whose lanes has alpha > 0 skips it.
// - The warps' partial rows go to shared memory part[warp][j][row] (23 KB
//   for a chunk of 64), with a bit per (warp, j) that says whether the warp
//   wrote; after the chunk the block adds the written partials in warp
//   order and stores each row coalesced.
// - Chunks of 64 instances are staged with cp.async into two buffers:
//   chunk c + 1 is in flight while chunk c is walked.
// - At tile 32 a block stores its sub-tile's rows to part_g[q][10][n_live]
//   and the number of instances it got through to qdone; it then counts
//   itself in arrived[tile] (an integer atomic behind a fence), and the last
//   block of the tile adds the sub-tiles' rows in the order q = 0, 1, ...
//   into d_inst.  Whichever block comes last, the sum is the same: two
//   launches on the same inputs give bitwise-equal gradients.  No atomics on
//   floats.
// - The block leaves the chunk loop through __syncthreads_or once all its
//   pixels have stopped; a warp all of whose pixels have stopped skips the
//   chunk.  A tile with count 0, and a block whose pixels all arrive closed,
//   write dt0 and nothing else.  Rows that nobody writes are the wrapper's
//   zero fill of d_inst: exact zeros behind an early exit and for closed
//   tiles.
//
// No fast-math: expf and a true division, as the forward kernel, and T is
// its running product in stream order, so that the w >= 1e-5 and early-stop
// gates fall where the forward put them.
//
// Precision on long lists.  T, the running sum `prefix` and `total` are
// float64 (T is in raster_fwd.cu too, so both kernels close a pixel's gate
// at the same instance and weigh it alike), the rest of a pair float32.
// S = total - prefix subtracts two sums of tens of thousands of terms of
// either sign whose difference, for an instance deep in the list, is
// small.  With a float32 T, whose rounding drifts along the list and
// reaches the forward's sums, the gradient lay 5e-4 to 3e-3 (rel-L2 a row)
// from float64 on the 1M stream's tiles of 46K instances, as far as the
// float32 plain version lies; scripts/raster_precision_torch.py --band
// splits that distance by where float32 enters.  With T in float64 but
// `total` taken from the forward's float32 accumulators, the two sums were
// of different terms (the accumulators' rounding, a part the float32 plain
// version shares), and the gradient still lay 1e-4 to 6e-4 from float64,
// sometimes farther than the plain version.  So a first pass walks the
// list with the main pass's gates and arithmetic and sums `total` from the
// very terms `prefix` adds: S is then the float64 sum of the terms behind
// j, up to float64 rounding.  The first pass costs about what the forward
// kernel's walk does.  The early stop compares the float64 1 - T with the
// real 0.995 (raster_common.cuh), so that the kernel closes a pixel where
// float64 does.  Float64 costs a multiply and a fused multiply-add
// more a pair on the half-rate float64 units; the outputs, masks, zeros
// and reproducibility are as before.
//
// Tried and dropped (timed on the card, see PERF.md): independent warps of
// 16 x 8 pixels with four pixels a thread and no block barrier (128
// registers, 16 warps an SM: slower than this by a fifth); a vote after
// every instance that lets a warp leave its chunk early (7 % slower than
// without); the bounding box of the footprint instead of the exact test
// (4 % slower); a smaller chunk.
//
// Still left: on a scene whose splats are as wide as a tile most patches
// are hit, and the kernel executes about 200 instructions a hit where the
// function needs about 85 operations a pair; lanes of a touched warp that
// are closed or fail the test idle through the arithmetic; S is a
// difference of nearly equal sums, kept in float64 (the original 3DGS
// backward walks back to front instead); a launch of few tiles lasts as
// long as its busiest SM.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_common.cuh"

namespace {

constexpr int kPartStride = 11;  // odd: no bank conflict across j or rows

// Sum of each of the ten rows d[0..9] over the warp's 32 lanes, by a
// transposed butterfly: returns, on lane l, the sum of row
// 5*b4 + 3*b3 + 2*b2 + b1 (b_k = bit k of l; both lanes of a pair l, l ^ 1
// hold the same).  Lanes with b2 and (b1 or b3) hold padding.
__device__ __forceinline__ float reduce_rows(const float (&d)[kRows],
                                             int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float a[6], b[4], c[2];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float keep = b4 ? d[k + 5] : d[k];
    const float send = b4 ? d[k] : d[k + 5];
    a[k] = keep + __shfl_xor_sync(kFullMask, send, 16);
  }
  a[5] = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float keep = b3 ? a[k + 3] : a[k];
    const float send = b3 ? a[k] : a[k + 3];
    b[k] = keep + __shfl_xor_sync(kFullMask, send, 8);
  }
  b[3] = 0.0f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float keep = b2 ? b[k + 2] : b[k];
    const float send = b2 ? b[k] : b[k + 2];
    c[k] = keep + __shfl_xor_sync(kFullMask, send, 4);
  }
  const float keep = b1 ? c[1] : c[0];
  const float send = b1 ? c[0] : c[1];
  float v = keep + __shfl_xor_sync(kFullMask, send, 2);
  v += __shfl_xor_sync(kFullMask, v, 1);
  return v;
}

// w = min(exp(lw), 1) of a pixel x instance pair, lw the quadratic form;
// both passes take it from here, so that they gate and weigh alike.
__device__ __forceinline__ float pair_weight(float dx, float dy, float qa,
                                             float qb, float qc) {
  const float lw = dx * dx * qa + dx * dy * qb + dy * dy * qc;
  return fminf(expf(lw), 1.0f);
}

// u = <gout, (r, g, b, depth, 1)> of an instance's colour and depth.
__device__ __forceinline__ float pair_u(float g_r, float g_g, float g_b,
                                        float g_d, float g_a, float cr,
                                        float cg, float cb, float cd) {
  return g_r * cr + g_g * cg + g_b * cb + g_d * cd + g_a;
}

// Blocks an SM the launch bound asks for: four at one pixel a thread (64
// registers), three at two (85).
constexpr int blocks_per_sm_asked(int pix) { return pix == 1 ? 4 : 3; }

// kTile = 16: a block a tile, one pixel a thread, rows go straight to d_inst.
// kTile = 32: kPix pixels a thread, kQuads = 4 / kPix blocks a tile; rows go
// to part_g and the last block of a tile adds them into d_inst.
template <int kTile, int kPix, bool kHasT0>
__global__ void __launch_bounds__(kThreads, blocks_per_sm_asked(kPix))
raster_bwd_kernel(const float* __restrict__ inst, int64_t n_live,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_count, int tiles_x, int tile0,
                  const float* __restrict__ gout, const float* __restrict__ t0,
                  float* __restrict__ d_inst, float* __restrict__ dt0,
                  float* __restrict__ part_g, int* __restrict__ arrived,
                  int* __restrict__ qdone) {
  constexpr int P = kTile * kTile;
  constexpr int kPatchH = kLaneRows * kPix;
  constexpr int kSubH = kPatchH * (kWarps / kPatchesX);
  constexpr int kQuadsX = kTile / kSubW;
  constexpr int kQuads = kQuadsX * (kTile / kSubH);
  __shared__ __align__(16) float sh[2 * kChunk * kInstStride];
  __shared__ unsigned char s_hit[kWarps][kChunk];
  __shared__ float part[kWarps * kChunk * kPartStride];
  __shared__ unsigned swrote[kWarps][2];
  __shared__ int s_last;

  const int t = blockIdx.x / kQuads;
  const int q = blockIdx.x % kQuads;
  const int64_t start = tile_start[t];
  const int count = tile_count[t];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // The pixels of this thread: patch (warp % 2, warp / 2) of the sub-tile,
  // column lane % 8 and rows lane / 8 + kLaneRows k of the patch.
  const int tile_x = ((tile0 + t) % tiles_x) * kTile;
  const int tile_y = ((tile0 + t) / tiles_x) * kTile;
  const int sub_x = (q % kQuadsX) * kSubW;
  const int sub_y = (q / kQuadsX) * kSubH;
  const int ix = sub_x + (warp % kPatchesX) * kPatchW + (lane & 7);
  const int iy = sub_y + (warp / kPatchesX) * kPatchH + (lane >> 3);
  const float px = static_cast<float>(tile_x + ix);

  float py[kPix];
  double T[kPix], prefix[kPix], total[kPix];  // float64: see the header
  float g_r[kPix], g_g[kPix], g_b[kPix], g_d[kPix], g_a[kPix];
  bool open[kPix];
  const float* go = gout + static_cast<int64_t>(t) * kAcc * P;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int i = (iy + kLaneRows * k) * kTile + ix;
    py[k] = static_cast<float>(tile_y + iy + kLaneRows * k);
    prefix[k] = 0.0;
    g_r[k] = go[0 * P + i];
    g_g[k] = go[1 * P + i];
    g_b[k] = go[2 * P + i];
    g_d[k] = go[3 * P + i];
    g_a[k] = go[4 * P + i];
    total[k] = 0.0;
    T[k] = 1.0;
    if constexpr (kHasT0) T[k] = t0[static_cast<int64_t>(t) * P + i];
    // The gate reads the transmittance before an instance; T never rises,
    // so once the gate has closed it stays closed.
    open[k] = 1.0 - T[k] < kEarlyStopA;
  }
  auto any_open = [&]() {
    bool any = false;
#pragma unroll
    for (int k = 0; k < kPix; ++k) any |= open[k];
    return any;
  };

  // The row this lane holds after reduce_rows, if any.
  const int my_row = ((lane >> 4) & 1) * 5 + ((lane >> 3) & 1) * 3 +
                     ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);
  const bool holds_row =
      !(lane & 1) && !((lane & 4) && (lane & (2 | 8)));

  const int part_at = warp * kChunk * kPartStride + my_row;

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

  // Thread (j, i) tests instance j of the staged chunk against the
  // patches i and i + 4.
  auto test_hits = [&](const float* chunk, int n) {
    const int j = threadIdx.x % kChunk;
#pragma unroll
    for (int k = 0; k < kWarps * kChunk / kThreads; ++k) {
      const int w = threadIdx.x / kChunk + k * (kThreads / kChunk);
      s_hit[w][j] =
          j < n &&
          !patch_missed(
              chunk + j * kInstStride,
              static_cast<float>(tile_x + sub_x + (w % kPatchesX) * kPatchW),
              static_cast<float>(tile_y + sub_y + (w / kPatchesX) * kPatchH),
              static_cast<float>(kPatchW), static_cast<float>(kPatchH));
    }
  };

  // Pass 1: total = the sum over the pixel's list of u * T * alpha, the
  // terms the main pass adds to `prefix`, by the same walk and arithmetic
  // (`pair_weight`, `pair_u`, one fused multiply-add in float64 a term).
  // S = total - prefix is then a difference of two sums of the same terms.
  stage(0, 0);
  for (int base = 0, buf = 0; base < count; base += kChunk, buf ^= 1) {
    const int n = min(kChunk, count - base);
    __pipeline_wait_prior(0);
    if (!__syncthreads_or(any_open())) break;
    if (base + kChunk < count) stage(base + kChunk, buf ^ 1);
    const float* chunk = sh + buf * kChunk * kInstStride;
    test_hits(chunk, n);
    __syncthreads();
    const unsigned hits_lo = __ballot_sync(kFullMask, s_hit[warp][lane]);
    const unsigned hits_hi = __ballot_sync(kFullMask, s_hit[warp][lane + 32]);
    const bool warp_open = __any_sync(kFullMask, any_open());
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      unsigned hits = warp_open ? (h == 0 ? hits_lo : hits_hi) : 0u;
      while (hits) {
        const int j = h * 32 + __ffs(hits) - 1;
        hits &= hits - 1;
        const float* s = chunk + j * kInstStride;
        const float dx = px - s[0];
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          const float w = pair_weight(dx, py[k] - s[1], s[2], s[3], s[4]);
          if (!(open[k] && w >= kWEps)) continue;
          const float alpha = fminf(s[5] * w, 1.0f);
          const float u = pair_u(g_r[k], g_g[k], g_b[k], g_d[k], g_a[k],
                                 s[6], s[7], s[8], s[9]);
          total[k] = fma(static_cast<double>(u), T[k] * alpha, total[k]);
          T[k] *= 1.0 - alpha;
          open[k] = 1.0 - T[k] < kEarlyStopA;
        }
      }
    }
  }
  // With t0, row 5 of the output is T_end, what the walk left of T.
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if constexpr (kHasT0) {
      const int i = (iy + kLaneRows * k) * kTile + ix;
      const float t_in = t0[static_cast<int64_t>(t) * P + i];
      total[k] = fma(static_cast<double>(go[5 * P + i]), T[k], total[k]);
      dt0[static_cast<int64_t>(t) * P + i] =
          static_cast<float>(total[k]) / fmaxf(t_in, 1e-30f);
      T[k] = t_in;
    } else {
      T[k] = 1.0;
    }
    open[k] = 1.0 - T[k] < kEarlyStopA;
  }
  if (count == 0) return;  // the same for all blocks of the tile
  __syncthreads();  // pass 1's last chunk is read before the main pass stages

  int done = 0;  // instances of the slice whose rows this block has stored
  stage(0, 0);
  for (int base = 0, buf = 0; base < count; base += kChunk, buf ^= 1) {
    const int n = min(kChunk, count - base);
    __pipeline_wait_prior(0);
    // Also the barrier that makes chunk `base` visible and protects `part`,
    // `swrote` and `s_hit` from the previous chunk's readers.
    if (!__syncthreads_or(any_open())) break;
    if (base + kChunk < count) stage(base + kChunk, buf ^ 1);
    const float* chunk = sh + buf * kChunk * kInstStride;
    test_hits(chunk, n);
    __syncthreads();

    const unsigned hits_lo = __ballot_sync(kFullMask, s_hit[warp][lane]);
    const unsigned hits_hi = __ballot_sync(kFullMask, s_hit[warp][lane + 32]);
    // A patch all of whose pixels have stopped skips the chunk.
    const bool warp_open = __any_sync(kFullMask, any_open());
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      unsigned hits = warp_open ? (h == 0 ? hits_lo : hits_hi) : 0u;
      unsigned wrote = 0;
      while (hits) {
        const int bit = __ffs(hits) - 1;
        hits &= hits - 1;
        const int j = h * 32 + bit;
        const float4 s0 =
            *reinterpret_cast<const float4*>(chunk + j * kInstStride);
        const float4 s1 =
            *reinterpret_cast<const float4*>(chunk + j * kInstStride + 4);
        const float2 s2 =
            *reinterpret_cast<const float2*>(chunk + j * kInstStride + 8);
        const float x = s0.x, y = s0.y, qa = s0.z, qb = s0.w;
        const float qc = s1.x, op = s1.y, cr = s1.z, cg = s1.w;
        const float cb = s2.x, cd = s2.y;
        float d[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) d[r] = 0.0f;
        bool touched = false;
        const float dx = px - x;
        float dys[kPix], ws[kPix];
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          dys[k] = py[k] - y;
          ws[k] = pair_weight(dx, dys[k], qa, qb, qc);
        }
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          const float dy = dys[k], w = ws[k];
          if (!(open[k] && w >= kWEps)) continue;  // alpha = 0: nothing moves
          const float a_raw = op * w;
          const float alpha = fminf(a_raw, 1.0f);
          const double wgt64 = T[k] * alpha;
          const float wgt = static_cast<float>(wgt64);
          const float u = pair_u(g_r[k], g_g[k], g_b[k], g_d[k], g_a[k], cr,
                                 cg, cb, cd);
          prefix[k] = fma(static_cast<double>(u), wgt64, prefix[k]);
          touched = true;
          d[6] += g_r[k] * wgt;
          d[7] += g_g[k] * wgt;
          d[8] += g_b[k] * wgt;
          d[9] += g_d[k] * wgt;
          if (a_raw < 1.0f && a_raw > 0.0f) {
            const float d_alpha =
                u * static_cast<float>(T[k]) -
                static_cast<float>(total[k] - prefix[k]) / (1.0f - alpha);
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
          T[k] *= 1.0 - alpha;
          open[k] = 1.0 - T[k] < kEarlyStopA;
        }
        if (__any_sync(kFullMask, touched)) {
          const float v = reduce_rows(d, lane);
          if (holds_row) part[part_at + j * kPartStride] = v;
          wrote |= 1u << bit;
        }
      }
      if (lane == 0) swrote[warp][h] = wrote;
    }
    __syncthreads();

    // Fixed-order sum over the warps that wrote, one coalesced store a row.
    for (int e = threadIdx.x; e < kRows * kChunk; e += kThreads) {
      const int r = e / kChunk, j = e % kChunk;
      if (j >= n) continue;
      float v = 0.0f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi)
        if ((swrote[wi][j >> 5] >> (j & 31)) & 1u)
          v += part[(wi * kChunk + j) * kPartStride + r];
      if constexpr (kQuads == 1)
        d_inst[r * n_live + start + base + j] = v;
      else
        part_g[(static_cast<int64_t>(q) * kRows + r) * n_live + start + base +
               j] = v;
    }
    done = base + n;
  }

  if constexpr (kQuads > 1) {
    // Hand this quadrant's rows over; the last block of the tile adds the
    // four quadrants in the order 0..3, each as far as it got.
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      qdone[t * kQuads + q] = done;
      __threadfence();
      s_last = atomicAdd(&arrived[t], 1) == kQuads - 1;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    int qd[kQuads];
    int most = 0;
#pragma unroll
    for (int k = 0; k < kQuads; ++k) {
      qd[k] = k == q ? done : __ldcg(&qdone[t * kQuads + k]);
      most = max(most, qd[k]);
    }
    for (int base = 0; base < most; base += kThreads) {
      const int j = base + threadIdx.x;
      if (j >= most) break;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float v = 0.0f;
#pragma unroll
        for (int k = 0; k < kQuads; ++k)
          if (j < qd[k])
            v += __ldcg(&part_g[(static_cast<int64_t>(k) * kRows + r) * n_live +
                                start + j]);
        d_inst[r * n_live + start + j] = v;
      }
    }
  }
}

template <int kTile, int kPix, bool kHasT0>
int launch_tiles(const float* inst, int64_t n_live, const int* tile_start,
                 const int* tile_count, int num_tiles, int tiles_x, int tile0,
                 const float* gout, const float* t0, float* d_inst,
                 float* dt0, float* part_g, int* sync, cudaStream_t s) {
  constexpr int kQuads = kTile * kTile / (kThreads * kPix);
  // part_g may be null with an empty stream: no block then gets that far.
  if (kQuads > 1 && sync == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = raster_bwd_kernel<kTile, kPix, kHasT0>;
  // Ask for the shared memory that three or four blocks an SM need (a hint).
  static const cudaError_t carveout = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (carveout != cudaSuccess) return static_cast<int>(carveout);
  // sync: arrived [num_tiles] (zero-filled), then qdone [num_tiles][kQuads].
  kernel<<<num_tiles * kQuads, kThreads, 0, s>>>(
      inst, n_live, tile_start, tile_count, tiles_x, tile0, gout, t0,
      d_inst, dt0, part_g, sync, sync == nullptr ? nullptr : sync + num_tiles);
  return static_cast<int>(cudaGetLastError());
}

// Whether a tile-32 launch over `num_tiles` tiles takes two pixels a
// thread.  Two pixels a thread cost fewer instructions a pixel (one fetch,
// one reduction and one store per 64 pixels); one pixel a thread gives four
// blocks a tile instead of two.  While even those would all be resident at
// once (a band of a ring step: 125 tiles on 132 SMs) the launch lasts as
// long as its busiest SM, and the smaller blocks spread better.
bool two_pixels_a_thread(int num_tiles) {
  static const int sms = [] {
    int device = 0, n = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess)
      return 0;
    return n;
  }();
  return num_tiles > sms;
}

template <bool kHasT0>
int launch(const float* inst, int64_t n_live, const int* tile_start,
           const int* tile_count, int num_tiles, int tiles_x, int tile_size,
           int tile0, const float* gout, const float* t0, float* d_inst,
           float* dt0, float* part_g, int* sync, void* stream) {
  if (num_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_size == 16)
    return launch_tiles<16, 1, kHasT0>(inst, n_live, tile_start, tile_count,
                                       num_tiles, tiles_x, tile0, gout, t0,
                                       d_inst, dt0, part_g, sync, s);
  if (tile_size == 32 && two_pixels_a_thread(num_tiles))
    return launch_tiles<32, 2, kHasT0>(inst, n_live, tile_start, tile_count,
                                       num_tiles, tiles_x, tile0, gout, t0,
                                       d_inst, dt0, part_g, sync, s);
  if (tile_size == 32)
    return launch_tiles<32, 1, kHasT0>(inst, n_live, tile_start, tile_count,
                                       num_tiles, tiles_x, tile0, gout, t0,
                                       d_inst, dt0, part_g, sync, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int kTile, int kPix, bool kHasT0>
int blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, raster_bwd_kernel<kTile, kPix, kHasT0>, kThreads, 0) !=
      cudaSuccess)
    return -1;
  return n;
}

}  // namespace

// inst: [10, n_live] float32; tile_start/tile_count: [num_tiles] int32;
// gout: [num_tiles, 8, tile_size^2] float32; d_inst: [10, n_live]
// float32, zero-filled by the caller; block t works on image tile tile0 + t.
// At tile 32 also two scratch buffers: part_g, [4, 10, n_live] float32, not
// initialised, and sync, [5 * num_tiles] int32, zero-filled (room for four
// blocks a tile; a launch may use two); at tile 16 both may be null.  Launches on `stream` and returns the cudaError_t of the
// launch (0 on success).
extern "C" int raster_bwd_launch(const float* inst, long long n_live,
                                 const int* tile_start, const int* tile_count,
                                 int num_tiles, int tiles_x, int tile_size,
                                 int tile0, const float* gout,
                                 float* d_inst, float* part_g, int* sync,
                                 void* stream) {
  return launch<false>(inst, n_live, tile_start, tile_count, num_tiles,
                       tiles_x, tile_size, tile0, gout, nullptr, d_inst,
                       nullptr, part_g, sync, stream);
}

// The same with the incoming transmittance t0: [num_tiles, tile_size^2]
// float32; also writes its cotangent dt0, of the same shape (every element).
extern "C" int raster_bwd_t0_launch(const float* inst, long long n_live,
                                    const int* tile_start,
                                    const int* tile_count, int num_tiles,
                                    int tiles_x, int tile_size, int tile0,
                                    const float* gout, const float* t0,
                                    float* d_inst,
                                    float* dt0, float* part_g, int* sync,
                                    void* stream) {
  return launch<true>(inst, n_live, tile_start, tile_count, num_tiles,
                      tiles_x, tile_size, tile0, gout, t0, d_inst, dt0,
                      part_g, sync, stream);
}

// Blocks of the kernel that fit one SM (by registers and shared memory), or
// -1: the build for `tile_size` (16 or 32) with `pix` pixels a thread (1, or
// 2 at tile 32), without or with t0.
extern "C" int raster_bwd_blocks_per_sm(int tile_size, int pix, int has_t0) {
  if (tile_size == 16 && pix == 1)
    return has_t0 ? blocks_per_sm<16, 1, true>()
                  : blocks_per_sm<16, 1, false>();
  if (tile_size == 32 && pix == 1)
    return has_t0 ? blocks_per_sm<32, 1, true>()
                  : blocks_per_sm<32, 1, false>();
  if (tile_size == 32 && pix == 2)
    return has_t0 ? blocks_per_sm<32, 2, true>()
                  : blocks_per_sm<32, 2, false>();
  return -1;
}
