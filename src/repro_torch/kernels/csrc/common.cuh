// Device code shared by segmented.cu (the flat-arena kernels) and leaf.cu
// (the per-leaf kernels): the pinned summation tree of selection.pinned_sum
// as column folds, and the bucketed compaction of one row by one warp.
// Included by both sources; each library gets its own copy.
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

// ---- the bucketed compaction, one warp per row ---------------------------
// A warp owns one ROW-element row. Lane l holds the row's elements
// j*128 + 4*l + c (step j < CR_VEC, component c < 4), so each of the warp's
// CR_VEC float4 loads covers 512 contiguous bytes, and keeps only their
// survivor flags, bit 4*j + c of one 32-bit word. Element order is
// (j, lane, c). Used by seg_compact_gt (segmented.cu) and compact_gt
// (leaf.cu).
constexpr unsigned FULL = 0xffffffffu;
constexpr int CR_VEC = ROW / 128;          // float4 loads per lane and row
constexpr int CR_THREADS = 256;            // a block takes eight rows
constexpr int CR_ROWS = CR_THREADS / 32;

// The flags of v = the row's elements e .. e+3: |v| > t and position < lim.
__device__ __forceinline__ unsigned gt_bits4(float4 v, float t, int e,
                                             int lim) {
  return static_cast<unsigned>(e < lim && fabsf(v.x) > t) |
         static_cast<unsigned>(e + 1 < lim && fabsf(v.y) > t) << 1 |
         static_cast<unsigned>(e + 2 < lim && fabsf(v.z) > t) << 2 |
         static_cast<unsigned>(e + 3 < lim && fabsf(v.w) > t) << 3;
}

// The row's bucket from the lanes' flags (bits): its first cap survivors
// in element order as (xr[e], first + e), then (0, pad) up to cap, and its
// pre-clamp count in *cnt. A survivor's rank is the row's survivors in
// earlier steps (warp-uniform), plus those of the lanes before it in its
// step (a ballot per component, popc below the lane), plus its own earlier
// components. Survivors are few, so their values are read again here
// rather than held in registers across the ballots. No shared memory and
// no block barrier: every lane of the warp calls this, and the other warps
// of the block never wait for it.
__device__ __forceinline__ void warp_bucket(unsigned bits,
                                            const float* __restrict__ xr,
                                            int first, int pad, int cap,
                                            float* __restrict__ vr,
                                            int* __restrict__ ir,
                                            int* __restrict__ cnt) {
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  const int total = static_cast<int>(__reduce_add_sync(FULL, __popc(bits)));
  int done = 0;   // the row's survivors in the steps before j
#pragma unroll
  for (int j = 0; j < CR_VEC; ++j) {
    if (done >= cap) break;   // warp-uniform: the bucket is full
    const unsigned mj = (bits >> (4 * j)) & 15u;
    if (!__any_sync(FULL, mj)) continue;
    int pre = 0, tot = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned bal = __ballot_sync(FULL, (mj >> c) & 1u);
      tot += __popc(bal);
      pre += __popc(bal & lower);
    }
    int p = done + pre;
    if (mj && p < cap) {
      const int e = j * 128 + 4 * lane;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if ((mj >> c) & 1u) {
          if (p < cap) {
            vr[p] = xr[e + c];
            ir[p] = first + e + c;
          }
          ++p;
        }
      }
    }
    done += tot;
  }
  for (int q = (total < cap ? total : cap) + lane; q < cap; q += 32) {
    vr[q] = 0.f;
    ir[q] = pad;
  }
  if (lane == 0) *cnt = total;
}

}  // namespace
