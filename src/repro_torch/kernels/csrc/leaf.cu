// Hand-written Hopper (sm_90a) kernels of the per-leaf selection path
// (GradientSync with fuse_leaves=False) and of the per-leaf residual update.
// Each takes one flat f32 leaf of true length n and masks its ragged tail
// itself, so no zero-padded [nb, 1024] copy of a leaf is ever made; the
// plain twins (kernels/ref.py) work on that padded view, as the reference.
//
// Replaces (src/repro/kernels/):
//   count_gt_leaf    <- threshold_count.count_gt   (:28, _kernel :17)
//   abs_sum_max_leaf <- block_stats.abs_sum_max    (:28, _kernel :15)
//   compact_gt_leaf  <- compact.compact_gt         (:51, _kernel :30)
//   compact_gt_exact_leaf: compact_gt's exact form, for a leaf whose buckets
//                    overflowed (the reference falls back to jnp there)
//   residual_update_leaf <- residual_update.residual_update (:28, _kernel :18)
//
// Bound on this card: bytes. Each kernel streams its leaf once (60 MB for
// the 15M-element embedding / softmax leaves of the paper's LSTM, 36 MB for
// a 9M-element gate matrix) at ~1 op per element; the residual update moves
// five f32 streams (g, U, V in; U', V' out). At 3.35 TB/s that is 18 / 11
// us per pass and 90 / 54 us for the update. count_gt and the update are
// the simple designs: float4 loads where the pointers allow, a grid-stride
// loop sized to the card, one integer atomic per block. abs_sum_max,
// compact_gt and compact_gt_exact are redesigned for this card (the
// comments above each say how): 8 float4 loads in flight per thread before
// any is used, survivors ranked by ballots inside a warp, and one launch
// each, with no second pass over the leaf or its partials.
//
// Numerics follow the reference's default jnp backend, not the Pallas
// bodies: abs_sum_max's sum is selection.pinned_sum's halving tree over the
// leaf's true length (the Pallas body adds block sums in sequence); counts
// and compaction are integer / bit moves; the update rounds every product
// and sum on its own (__fmul_rn / __fadd_rn, and -fmad=false), as
// residual.accumulate's pinned arithmetic does.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;   // H100: 132 SMs, 8 blocks of 256 each

int grid_for(long long work) {
  long long b = (work + THREADS - 1) / THREADS;
  return static_cast<int>(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

// nnz(|x| > t) over x[0, n). The loops are warp-uniform (a warp's lanes
// take consecutive positions and leave together), so each step's flags are
// counted with a ballot and popc; lane 0 keeps its warp's count, and each
// block adds its total to *out with one integer atomicAdd (order-free, so
// exact). vec: x is 16-byte aligned and the body is read as float4. The
// twin counts the zero padding of its [nb, 1024] view when 0 > t; so does
// this kernel (pad elements), so the two agree for every threshold.
__global__ void __launch_bounds__(THREADS)
count_gt_leaf(const float* __restrict__ x, long long n, int vec,
              const float* __restrict__ thr, int pad, int* __restrict__ out) {
  __shared__ int wsum[THREADS / 32];
  const float t = *thr;
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long warp0 =
      static_cast<long long>(blockIdx.x) * THREADS + (threadIdx.x & ~31);
  int c = 0;
  long long done = 0;
  if (vec) {
    const long long nv = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (long long b = warp0; b < nv; b += stride) {
      const long long i = b + lane;
      const bool ok = i < nv;
      const float4 v = ok ? x4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      c += __popc(__ballot_sync(FULL, ok && fabsf(v.x) > t)) +
           __popc(__ballot_sync(FULL, ok && fabsf(v.y) > t)) +
           __popc(__ballot_sync(FULL, ok && fabsf(v.z) > t)) +
           __popc(__ballot_sync(FULL, ok && fabsf(v.w) > t));
    }
    done = nv << 2;
  }
  // the scalar tail (< 4 elements), or the whole leaf when not aligned
  for (long long b = done + warp0; b < n; b += stride) {
    const long long i = b + lane;
    const bool f = i < n && fabsf(x[i]) > t;
    c += __popc(__ballot_sync(FULL, f));
  }
  if (lane == 0) wsum[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int tot = 0;
    for (int w = 0; w < THREADS / 32; ++w) tot += wsum[w];
    if (blockIdx.x == 0 && 0.f > t) tot += pad;
    if (tot) atomicAdd(out, tot);
  }
}

// ---- abs_sum_max ---------------------------------------------------------
// (sum|x|, max|x|) of the leaf in one launch. The sum is selection.pinned_sum:
// the halving tree over the leaf zero-padded to P = 2^logp (padding P past
// next_pow2(n) adds zero leaves and changes no bit). Viewed as [R, M] with
// R = 2^logr rows and M = 2^logm columns, element e = t*M + c, the tree's
// first logr levels fold each column over its rows in bit-reversed row order
// (fold_column, common.cuh) and the last logm levels halve the M column
// partials; any split gives the same bits. The max is order-free.
//
// The old design (one thread per column, 2^16 columns, scalar loads) kept
// ~16 KB of loads in flight per SM and finished on one SM in a second
// launch. Here a block owns 32 adjacent columns (8 lanes x float4, 128
// bytes per row) and 32 row groups; group g folds the rows at bit-reversed
// positions [g 2^h, (g+1) 2^h) (h = logr - 5), i.e. rows bitrev5(g) +
// 32 bitrev_h(u), eight rows a step: each thread issues its 8 float4 loads
// (4 independent columns each) before it uses any, and merges the step on a
// binary counter held in registers. The 32 groups' subtrees are then added
// pairwise in shared memory, so the block writes its 32 finished columns.
// The last block to finish (a counter the launch zeroes) folds the M <= 8192
// column partials (all its loads issued at once) and the block maxima, in
// the same launch. Rows past the leaf (P > n) issue no loads: each load is
// predicated.
constexpr int AS_THREADS = 256;
constexpr int AS_COLS = 32;      // columns per block
constexpr int AS_GROUPS = 32;    // row groups per block (AS_THREADS / 8)
constexpr int AS_BATCH = 8;      // rows per step of a group
constexpr int AS_TAIL = 32;      // column partials per thread in the finish

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// x[e .. e+3] as one float4 load (read-only path) when pred, else zeros and
// no memory request: a predicated load, so no branch sits between a step's
// loads and a row past the leaf costs nothing.
__device__ __forceinline__ float4 ldg4_if(const float* p, bool pred) {
  float4 v;
  asm volatile(
      "{\n\t.reg .pred q;\n\t"
      "setp.ne.b32 q, %5, 0;\n\t"
      "mov.f32 %0, 0f00000000;\n\tmov.f32 %1, 0f00000000;\n\t"
      "mov.f32 %2, 0f00000000;\n\tmov.f32 %3, 0f00000000;\n\t"
      "@q ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n\t}"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}

// |x[e .. e+3]| by scalar loads, zero at and past n: the ragged row of the
// leaf, or a leaf that is not 16-byte aligned.
__device__ __forceinline__ float4 abs4_scalar(const float* __restrict__ x,
                                              unsigned e, unsigned n) {
  return make_float4(e < n ? fabsf(x[e]) : 0.f,
                     e + 1 < n ? fabsf(x[e + 1]) : 0.f,
                     e + 2 < n ? fabsf(x[e + 2]) : 0.f,
                     e + 3 < n ? fabsf(x[e + 3]) : 0.f);
}

// part: M column partials, then gridDim.x block maxima, then the
// blocks-done counter (zeroed by the launch); out: (sum|x|, max|x|).
// DEPTH: binary-counter levels, enough for 2^(logr - 8) steps. Offsets are
// 32-bit: P <= 2^31.
template <int DEPTH>
__global__ void __launch_bounds__(AS_THREADS, 2)
abs_sum_max_leaf(const float* __restrict__ x, unsigned n, int vec, int logm,
                 int logr, float* __restrict__ part, float* __restrict__ out) {
  __shared__ float s_sum[AS_GROUPS][AS_COLS + 1];
  __shared__ float s_max[AS_THREADS / 32];
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = tid >> 3;
  const int h = logr - 5;
  const unsigned M = 1u << logm;
  const unsigned col = blockIdx.x * AS_COLS + 4 * (tid & 7);
  const unsigned row0 = __brev(static_cast<unsigned>(g)) >> 27;
  float4 lvl[DEPTH];
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) lvl[d] = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float mx = 0.f;
  const int steps = 1 << (h - 3);
  for (int b = 0; b < steps; ++b) {
    unsigned off[AS_BATCH];
    bool whole = vec;   // no load of the step straddles n
#pragma unroll
    for (int u = 0; u < AS_BATCH; ++u) {
      const unsigned j = static_cast<unsigned>(b * AS_BATCH + u);
      off[u] = (row0 + 32u * (__brev(j) >> (32 - h))) * M + col;
      whole &= off[u] + 3 < n || off[u] >= n;
    }
    float4 v[AS_BATCH];
    if (whole) {
      // all eight loads issued before any is used; rows past n load nothing
#pragma unroll
      for (int u = 0; u < AS_BATCH; ++u) v[u] = ldg4_if(x + off[u], off[u] < n);
#pragma unroll
      for (int u = 0; u < AS_BATCH; ++u)
        v[u] = make_float4(fabsf(v[u].x), fabsf(v[u].y), fabsf(v[u].z),
                           fabsf(v[u].w));
    } else {
#pragma unroll
      for (int u = 0; u < AS_BATCH; ++u) v[u] = abs4_scalar(x, off[u], n);
    }
#pragma unroll
    for (int u = 0; u < AS_BATCH; ++u)
      mx = fmaxf(mx, fmaxf(fmaxf(v[u].x, v[u].y), fmaxf(v[u].z, v[u].w)));
    acc = add4(add4(add4(v[0], v[1]), add4(v[2], v[3])),
               add4(add4(v[4], v[5]), add4(v[6], v[7])));
    // binary counter: level d holds the pending left subtree of 2^d steps
    bool placed = false;
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      if (!placed) {
        if ((b >> d) & 1) {
          acc = add4(lvl[d], acc);
        } else {
          lvl[d] = acc;
          placed = true;
        }
      }
    }
  }
  // acc: group g's subtree of each of its 4 columns
  const int c0 = 4 * (tid & 7);
  s_sum[g][c0] = acc.x;
  s_sum[g][c0 + 1] = acc.y;
  s_sum[g][c0 + 2] = acc.z;
  s_sum[g][c0 + 3] = acc.w;
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
  if (lane == 0) s_max[tid >> 5] = mx;
  __syncthreads();
  for (int step = 1; step < AS_GROUPS; step <<= 1) {
    for (int i = tid; i < AS_GROUPS / (2 * step) * AS_COLS; i += AS_THREADS) {
      const int gl = (i / AS_COLS) * 2 * step;
      const int c = i % AS_COLS;
      s_sum[gl][c] = __fadd_rn(s_sum[gl][c], s_sum[gl + step][c]);
    }
    __syncthreads();
  }
  float* part_max = part + M;
  unsigned* done = reinterpret_cast<unsigned*>(part_max + gridDim.x);
  if (tid < AS_COLS) part[blockIdx.x * AS_COLS + tid] = s_sum[0][tid];
  if (tid == 0) {
    float bm = s_max[0];
    for (int w = 1; w < AS_THREADS / 32; ++w) bm = fmaxf(bm, s_max[w]);
    part_max[blockIdx.x] = bm;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last logm levels: the M partials as [M / C2, C2] column folds (the
  // column's 2^logr2 <= 32 partials loaded at once, in bit-reversed order,
  // and added pairwise; zeros past 2^logr2 add nothing), then a halving of
  // the C2 <= 256 results in shared memory
  const int logc2 = logm < 8 ? logm : 8;
  const int C2 = 1 << logc2;
  const int logr2 = logm - logc2;
  float r[AS_TAIL];
#pragma unroll
  for (int j = 0; j < AS_TAIL; ++j) {
    const unsigned jr = __brev(static_cast<unsigned>(j));
    const int row = logr2 ? static_cast<int>(jr >> (32 - logr2)) : 0;
    r[j] = tid < C2 && j < (1 << logr2) ? __ldcg(part + row * C2 + tid) : 0.f;
  }
#pragma unroll
  for (int s = 1; s < AS_TAIL; s <<= 1) {
#pragma unroll
    for (int i = 0; i < AS_TAIL; i += 2 * s) r[i] = __fadd_rn(r[i], r[i + s]);
  }
  float bm = 0.f;
  for (int i = tid; i < static_cast<int>(gridDim.x); i += AS_THREADS)
    bm = fmaxf(bm, __ldcg(part_max + i));
  for (int off = 16; off > 0; off >>= 1)
    bm = fmaxf(bm, __shfl_xor_sync(FULL, bm, off));
  float* red = &s_sum[0][0];
  __syncthreads();
  if (tid < C2) red[tid] = r[0];
  if (lane == 0) s_max[tid >> 5] = bm;
  __syncthreads();
  for (int hh = C2 >> 1; hh >= 1; hh >>= 1) {
    if (tid < hh) red[tid] = __fadd_rn(red[tid], red[tid + hh]);
    __syncthreads();
  }
  if (tid == 0) {
    for (int w = 1; w < AS_THREADS / 32; ++w) bm = fmaxf(bm, s_max[w]);
    out[0] = red[0];
    out[1] = fmaxf(bm, s_max[0]);
  }
}

// ---- compact_gt ----------------------------------------------------------
// Per 1024-element row of the leaf, the first cap survivors as (x, global
// index), padded with (0, n), and the row's count before clamping. One warp
// per row, eight rows per block (warp_bucket, common.cuh): each lane issues
// its 8 float4 loads of the row (streaming, evict-first) before it uses
// any, so a warp has 4 KB in flight, and ranks the survivors by ballots
// inside the warp. The old design (one 1024-thread block per row, scalar
// loads, two block barriers and a serial scan of the warp totals) kept at
// most 8 KB of loads in flight per SM. A leaf that is not 16-byte aligned,
// and the ragged last row, take scalar loads; positions >= n are neither
// read nor counted.
__global__ void __launch_bounds__(CR_THREADS, 6)
compact_gt_leaf(const float* __restrict__ x, long long n, int vec,
                const float* __restrict__ thr, int cap, float* __restrict__ vals,
                int* __restrict__ idx, int* __restrict__ cnt) {
  const long long row =
      static_cast<long long>(blockIdx.x) * CR_ROWS + (threadIdx.x >> 5);
  const long long r0 = row * ROW;
  if (r0 >= n) return;   // warp-uniform
  const int lane = threadIdx.x & 31;
  const float* xr = x + r0;
  const int lim = n - r0 < ROW ? static_cast<int>(n - r0) : ROW;
  const float t = *thr;
  unsigned bits = 0;
  if (vec && lim == ROW) {
    float4 v[CR_VEC];
#pragma unroll
    for (int j = 0; j < CR_VEC; ++j)
      v[j] = __ldcs(reinterpret_cast<const float4*>(xr + j * 128) + lane);
#pragma unroll
    for (int j = 0; j < CR_VEC; ++j)
      bits |= gt_bits4(v[j], t, j * 128 + 4 * lane, ROW) << (4 * j);
  } else {
#pragma unroll
    for (int j = 0; j < CR_VEC; ++j) {
      const int e = j * 128 + 4 * lane;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        bits |= static_cast<unsigned>(e + c < lim && fabsf(xr[e + c]) > t)
                << (4 * j + c);
    }
  }
  warp_bucket(bits, xr, static_cast<int>(r0), static_cast<int>(n), cap,
              vals + row * cap, idx + row * cap, cnt + row);
}

// ---- compact_gt_exact ----------------------------------------------------
// The exact form of compact_gt, run when some row's survivors overflowed
// its bucket: the first len survivors of the leaf in index order, in one
// dense list padded with (0, n), in a single pass over the leaf (a chained
// scan with decoupled look-back, Merrill & Garland 2016). The old design
// ranked each 1024-element row in its own block from compact_gt's row
// counts and their cumsum, so an overflow read the leaf twice in three
// launches.
//
// A tile is CE_TILE = 8192 elements: each thread issues 8 float4 loads
// (streaming, evict-first) before it uses any (scalar loads for a
// misaligned leaf or the tile that ends the leaf), element
// base + j*1024 + 4*tid + c, and keeps only the 4-bit survivor masks: the
// few survivors' values are read again when they are written (0.6% of the
// elements at the main path's thresholds), so a thread holds 40 registers
// and six blocks fit on an SM, whose loads cover the others' waits. Tiles
// are taken in launch order from a counter, so every tile a block waits for
// is already held by a running block. A tile counts its survivors
// (ballot/popc per warp and component, a scan of the 64 warp totals),
// publishes its count (FLAG_AGG), looks back over the flags of the tiles
// before it, 32 at a time, until one carries its inclusive prefix
// (FLAG_INCL), publishes its own inclusive prefix, and writes its survivors
// at exclusive prefix + rank, none at or past len. The tile that ends the
// leaf pads [total, len), 16 bytes a store. Integer moves only, so the list
// is exact.
constexpr int CE_THREADS = 256;
constexpr int CE_WARPS = CE_THREADS / 32;
constexpr int CE_VEC = 8;                           // float4 per thread
constexpr int CE_SUB = CE_THREADS * 4;              // elements per sub-row
constexpr int CE_TILE = CE_SUB * CE_VEC;            // compact.EXACT_TILE
constexpr unsigned long long FLAG_AGG = 1ull << 32;   // the tile's count
constexpr unsigned long long FLAG_INCL = 2ull << 32;  // its inclusive prefix

__device__ __forceinline__ unsigned long long load_flag(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_flag(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// flags: one word per tile (status << 32 | value), then the tile counter;
// all zeroed by the launch. vals, idx: 16-byte aligned.
__global__ void __launch_bounds__(CE_THREADS, 6)
compact_gt_exact_leaf(const float* __restrict__ x, long long n, int vec,
                      const float* __restrict__ thr, int len,
                      float* __restrict__ vals, int* __restrict__ idx,
                      unsigned long long* __restrict__ flags,
                      unsigned* __restrict__ next_tile, int tiles) {
  __shared__ int s_tile;
  __shared__ int s_excl;
  __shared__ int s_total;
  __shared__ int s_woff[CE_VEC * CE_WARPS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float t = *thr;
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(next_tile, 1u));
  __syncthreads();
  const int tile = s_tile;
  const long long base = static_cast<long long>(tile) * CE_TILE;
  unsigned m[CE_VEC];   // survivor bits of the thread's 4 elements, per j
  if (vec && base + CE_TILE <= n) {
    float4 v[CE_VEC];
#pragma unroll
    for (int j = 0; j < CE_VEC; ++j)
      v[j] = __ldcs(reinterpret_cast<const float4*>(x + base + j * CE_SUB) +
                    tid);
#pragma unroll
    for (int j = 0; j < CE_VEC; ++j)
      m[j] = static_cast<unsigned>(fabsf(v[j].x) > t) |
             static_cast<unsigned>(fabsf(v[j].y) > t) << 1 |
             static_cast<unsigned>(fabsf(v[j].z) > t) << 2 |
             static_cast<unsigned>(fabsf(v[j].w) > t) << 3;
  } else {
    // the tile that ends the leaf, or a leaf that is not 16-byte aligned
#pragma unroll
    for (int j = 0; j < CE_VEC; ++j) {
      const long long e = base + j * CE_SUB + 4 * tid;
      m[j] = static_cast<unsigned>(e < n && fabsf(x[e]) > t) |
             static_cast<unsigned>(e + 1 < n && fabsf(x[e + 1]) > t) << 1 |
             static_cast<unsigned>(e + 2 < n && fabsf(x[e + 2]) > t) << 2 |
             static_cast<unsigned>(e + 3 < n && fabsf(x[e + 3]) > t) << 3;
    }
  }
  // rank inside the warp: survivors of the lanes before, all components
  int before[CE_VEC];
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < CE_VEC; ++j) {
    int tot = 0, pre = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned bal = __ballot_sync(FULL, (m[j] >> c) & 1u);
      tot += __popc(bal);
      pre += __popc(bal & lower);
    }
    before[j] = pre;
    if (lane == 0) s_woff[j * CE_WARPS + warp] = tot;
  }
  __syncthreads();
  if (warp == 0) {
    // exclusive scan of the 64 warp totals in element order, two per lane
    const int a0 = s_woff[2 * lane];
    const int a1 = s_woff[2 * lane + 1];
    int inc = a0 + a1;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, inc, off);
      if (lane >= off) inc += y;
    }
    s_woff[2 * lane] = inc - a0 - a1;
    s_woff[2 * lane + 1] = inc - a1;
    const long long agg = __shfl_sync(FULL, inc, 31);
    long long excl = 0;
    if (tile > 0) {
      if (lane == 0) store_flag(flags + tile, FLAG_AGG | agg);
      for (int pred = tile - 1;; pred -= 32) {
        const int i = pred - lane;
        unsigned long long f = i >= 0 ? load_flag(flags + i) : FLAG_INCL;
        while (__any_sync(FULL, (f >> 32) == 0)) {
          if ((f >> 32) == 0) f = load_flag(flags + i);
        }
        const unsigned incl = __ballot_sync(FULL, (f >> 32) == 2);
        const int stop = incl ? __ffs(incl) - 1 : 31;
        long long add =
            lane <= stop ? static_cast<long long>(f & 0xffffffffull) : 0;
        for (int off = 16; off > 0; off >>= 1)
          add += __shfl_xor_sync(FULL, add, off);
        excl += add;
        if (incl) break;
      }
    }
    if (lane == 0) {
      store_flag(flags + tile,
                 FLAG_INCL | static_cast<unsigned long long>(excl + agg));
      s_excl = static_cast<int>(excl);
      s_total = static_cast<int>(excl + agg < len ? excl + agg : len);
    }
  }
  __syncthreads();
  const long long excl = s_excl;
  if (excl < len) {
#pragma unroll
    for (int j = 0; j < CE_VEC; ++j) {
      if (!m[j]) continue;
      const long long e = base + j * CE_SUB + 4 * tid;
      long long p = excl + s_woff[j * CE_WARPS + warp] + before[j];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if ((m[j] >> c) & 1u) {
          if (p < len) {
            vals[p] = x[e + c];
            idx[p] = static_cast<int>(e + c);
          }
          ++p;
        }
      }
    }
  }
  if (tile == tiles - 1) {
    // [total, len): scalars up to a multiple of 4, then 16-byte stores
    const long long total = s_total;
    const long long a = (total + 3) & ~3LL;
    const int pad = static_cast<int>(n);
    if (total + tid < a && total + tid < len) {
      vals[total + tid] = 0.f;
      idx[total + tid] = pad;
    }
    for (long long q = a + 4 * tid; q + 3 < len; q += 4 * CE_THREADS) {
      *reinterpret_cast<float4*>(vals + q) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<int4*>(idx + q) = make_int4(pad, pad, pad, pad);
    }
    const long long rest = a + ((len - a) & ~3LL);
    if (a < len && rest + tid < len) {
      vals[rest + tid] = 0.f;
      idx[rest + tid] = pad;
    }
  }
}

// Alg 4 lines 11-19 on one element, rounded as residual.accumulate rounds
// it: U' = rn(rn(m * U) + g), V' = rn(V + U'), with nesterov rn(V' + g).
struct Update {
  float m;
  int nesterov;
  __device__ __forceinline__ void operator()(float g, float u, float v,
                                             float& uo, float& vo) const {
    uo = __fadd_rn(__fmul_rn(m, u), g);
    vo = __fadd_rn(v, uo);
    if (nesterov) vo = __fadd_rn(vo, g);
  }
};

// Elementwise over [0, n): float4 over the body when every pointer is
// 16-byte aligned (vec), scalars for the tail or the whole leaf otherwise.
// Writes fresh outputs; the inputs are only read.
__global__ void __launch_bounds__(THREADS)
residual_update_leaf(const float* __restrict__ g, const float* __restrict__ u,
                     const float* __restrict__ v, float* __restrict__ uo,
                     float* __restrict__ vo, long long n, int vec, Update up) {
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  long long done = 0;
  if (vec) {
    const long long nv = n >> 2;
    for (long long i = tid; i < nv; i += stride) {
      const float4 g4 = reinterpret_cast<const float4*>(g)[i];
      const float4 u4 = reinterpret_cast<const float4*>(u)[i];
      const float4 v4 = reinterpret_cast<const float4*>(v)[i];
      float4 a, b;
      up(g4.x, u4.x, v4.x, a.x, b.x);
      up(g4.y, u4.y, v4.y, a.y, b.y);
      up(g4.z, u4.z, v4.z, a.z, b.z);
      up(g4.w, u4.w, v4.w, a.w, b.w);
      reinterpret_cast<float4*>(uo)[i] = a;
      reinterpret_cast<float4*>(vo)[i] = b;
    }
    done = nv << 2;
  }
  for (long long i = done + tid; i < n; i += stride)
    up(g[i], u[i], v[i], uo[i], vo[i]);
}

// Zeroes n 32-bit words: the scratch counters and flags of abs_sum_max and
// compact_gt_exact, as a kernel launched just before them; in a CUDA graph
// a memset node (cudaMemsetAsync) took longer (PERF.md §6).
__global__ void __launch_bounds__(THREADS)
zero_words(unsigned* __restrict__ p, int n) {
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n;
       i += gridDim.x * THREADS)
    p[i] = 0u;
}

cudaError_t zero(unsigned* p, int n, cudaStream_t st) {
  const int blocks = (n + THREADS - 1) / THREADS;
  zero_words<<<blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS, THREADS, 0, st>>>(
      p, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() (0 = launched). Thresholds stay on the device.

int count_gt_launch(const float* x, long long n, int vec, const float* thr,
                    int pad, int* out, void* stream) {
  const long long work = vec ? n / 4 : n;
  count_gt_leaf<<<grid_for(work), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, vec, thr, pad, out);
  return static_cast<int>(cudaGetLastError());
}

// part: 2^logm + 2^(logm - 5) + 1 floats of scratch (column partials,
// block maxima, the blocks-done counter, which this zeroes); out: 2 floats
// (sum|x|, max|x|). logp: log2 of the padded length (>= log2
// next_pow2(n), <= 31); logm: log2 of the columns, 5 <= logm <= 13,
// 8 <= logp - logm <= 18.
int abs_sum_max_launch(const float* x, long long n, int vec, int logp,
                       int logm, float* part, float* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int logr = logp - logm;
  if (logm < 5 || logm > 13 || logr < 8 || logr > 18 || logp > 31 ||
      (1LL << logp) < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = 1 << (logm - 5);
  const cudaError_t err = zero(
      reinterpret_cast<unsigned*>(part + (1 << logm) + blocks), 1, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned un = static_cast<unsigned>(n);
  if (logr <= 11)   // up to 8 steps a group: P <= 2^24 at 2^13 columns
    abs_sum_max_leaf<3><<<blocks, AS_THREADS, 0, st>>>(x, un, vec, logm, logr,
                                                       part, out);
  else
    abs_sum_max_leaf<10><<<blocks, AS_THREADS, 0, st>>>(x, un, vec, logm,
                                                        logr, part, out);
  return static_cast<int>(cudaGetLastError());
}

// vec: x is 16-byte aligned (float4 loads).
int compact_gt_launch(const float* x, long long n, int vec, const float* thr,
                      int cap, float* vals, int* idx, int* cnt, void* stream) {
  const long long nb = (n + ROW - 1) / ROW;
  const int blocks = static_cast<int>((nb + CR_ROWS - 1) / CR_ROWS);
  compact_gt_leaf<<<blocks, CR_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, vec, thr, cap, vals, idx, cnt);
  return static_cast<int>(cudaGetLastError());
}

// vals, idx: len slots; scratch: tiles + 1 words (the tile flags, then the
// tile counter), zeroed here; tiles = ceil(n / CE_TILE).
int compact_gt_exact_launch(const float* x, long long n, int vec,
                            const float* thr, int len, float* vals, int* idx,
                            unsigned long long* scratch, int tiles,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tiles != static_cast<int>((n + CE_TILE - 1) / CE_TILE))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      zero(reinterpret_cast<unsigned*>(scratch), 2 * (tiles + 1), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_gt_exact_leaf<<<tiles, CE_THREADS, 0, st>>>(
      x, n, vec, thr, len, vals, idx, scratch,
      reinterpret_cast<unsigned*>(scratch + tiles), tiles);
  return static_cast<int>(cudaGetLastError());
}

int residual_update_launch(const float* g, const float* u, const float* v,
                           float* uo, float* vo, long long n, int vec,
                           float momentum, int nesterov, void* stream) {
  const long long work = vec ? n / 4 : n;
  residual_update_leaf<<<grid_for(work), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      g, u, v, uo, vo, n, vec, Update{momentum, nesterov});
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
