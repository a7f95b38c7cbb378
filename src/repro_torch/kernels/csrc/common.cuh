// Device code shared by segmented.cu (the flat-arena kernels) and leaf.cu
// (the per-leaf kernels): the pinned summation tree of selection.pinned_sum
// as column folds, and the in-row survivor ranking of the bucketed
// compaction. Included by both sources; each library gets its own copy.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int ROW = 1024;             // row width (ARENA_BLOCK, DEFAULT_BLOCK)
constexpr int COLFOLD_THREADS = 256;
constexpr int FINISH_THREADS = 1024;  // columns folded in phase 2

__device__ __forceinline__ int bitrev(int j, int logr) {
  return logr ? static_cast<int>(__brev(static_cast<unsigned>(j)) >> (32 - logr))
              : 0;
}

// The halving fold (v[t] + v[t + R/2], then again ...) of one column of R =
// 2^logr values equals the left-to-right pairwise sum of the column read in
// bit-reversed row order. Rows are read in that order and merged on a
// binary-counter stack, so a warp's loads of one row stay coalesced across
// its 32 columns. load(t) returns row t's value; mx gets the column max.
template <class Load>
__device__ __forceinline__ void fold_column(int logr, Load load, float& sum,
                                            float& mx) {
  const int R = 1 << logr;
  float stack[32];
  int top = 0;
  mx = 0.f;
  if (R >= 8) {
    // eight independent loads in flight, summed as the bottom three levels
    for (int j0 = 0; j0 < R; j0 += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        v[u] = load(bitrev(j0 + u, logr));
        mx = fmaxf(mx, v[u]);
      }
      float a = __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3])),
                          __fadd_rn(__fadd_rn(v[4], v[5]), __fadd_rn(v[6], v[7])));
      for (unsigned m = static_cast<unsigned>(j0 >> 3); m & 1u; m >>= 1)
        a = __fadd_rn(stack[--top], a);
      stack[top++] = a;
    }
  } else {
    for (int j = 0; j < R; ++j) {
      float a = load(bitrev(j, logr));
      mx = fmaxf(mx, a);
      for (unsigned m = static_cast<unsigned>(j); m & 1u; m >>= 1)
        a = __fadd_rn(stack[--top], a);
      stack[top++] = a;
    }
  }
  sum = stack[0];
}

// Phase 2 of the pinned statistics, for one vector in one block of
// FINISH_THREADS threads: the remaining logc levels fold its C = 2^logc
// column partials (ps: sums, pm: maxima) by halving — again as [R2, C2]
// column folds, then a shared-memory halving — into *out_sum / *out_max.
__device__ __forceinline__ void finish_partials(int logc,
                                                const float* __restrict__ ps,
                                                const float* __restrict__ pm,
                                                float* out_sum, float* out_max) {
  __shared__ float ssum[FINISH_THREADS];
  __shared__ float smax[FINISH_THREADS];
  const int i = threadIdx.x;
  const int log2c = logc < 10 ? logc : 10;
  const int C2 = 1 << log2c;
  const int logr2 = logc - log2c;
  if (i < C2) {
    float sum, unused;
    fold_column(logr2, [&](int t) { return ps[t * C2 + i]; }, sum, unused);
    float mx = 0.f;
    for (int t = 0; t < (1 << logr2); ++t) mx = fmaxf(mx, pm[t * C2 + i]);
    ssum[i] = sum;
    smax[i] = mx;
  }
  __syncthreads();
  for (int h = C2 >> 1; h >= 1; h >>= 1) {
    if (i < h) {
      ssum[i] = __fadd_rn(ssum[i], ssum[i + h]);
      smax[i] = fmaxf(smax[i], smax[i + h]);
    }
    __syncthreads();
  }
  if (i == 0) {
    *out_sum = ssum[0];
    *out_max = smax[0];
  }
}

// In a block of ROW threads, one per element of a row: the rank of this
// thread's flag m among the row's set flags in element order (a warp
// ballot/popc prefix plus the prefix of the warp totals), with the row's
// total in `total`. Every thread of the block must call it.
__device__ __forceinline__ int row_rank(bool m, int& total) {
  __shared__ int wpre[ROW / 32];
  __shared__ int total_s;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned bal = __ballot_sync(0xffffffffu, m);
  if (lane == 0) wpre[warp] = __popc(bal);
  __syncthreads();
  if (warp == 0) {
    const int own = wpre[lane];
    int inc = own;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += y;
    }
    wpre[lane] = inc - own;
    if (lane == 31) total_s = inc;
  }
  __syncthreads();
  total = total_s;
  return wpre[warp] + __popc(bal & ((1u << lane) - 1u));
}

}  // namespace
