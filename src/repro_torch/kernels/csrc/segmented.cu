// Hand-written Hopper (sm_90a) kernels of the flat-residual-arena selection
// path: one multi_select per RGC step runs seg_abs_sum_max once (or takes
// its statistics from seg_residual_update_stats), seg_count_gt once per
// search iteration (plus the warm probe and the final count) and
// seg_compact_gt once.
//
// Arena layout: x is [nb, 1024] f32 rows; row b belongs to segment (slot)
// block_seg[b]; each slot starts on a row boundary and is zero-padded.
//
// Replaces (src/repro/kernels/segmented.py):
//   seg_abs_sum_max  <- seg_abs_sum_max (:113, _stats_kernel :76)
//   seg_count_gt     <- seg_count_gt    (:182, _count_kernel :151)
//   stats_sampled    <- seg_abs_sum_max with a stride per segment
//                       (_stats_kernel_strided :91)
//   count_sampled    <- seg_count_gt with stride_b (_count_kernel_strided
//                       :165)
//   seg_compact_gt   <- seg_compact_gt  (:242, _compact_kernel :219)
//   resid_colfold    <- seg_residual_update_stats (:328, _resid_kernel :285)
//
// Bound: the exact forms stream the arena once (264 MB per pass for the
// paper's 2-layer 1500-unit LSTM) and do ~1 op per element, so HBM
// bandwidth bounds them (~79 us at 3.35 TB/s). The fused residual update
// moves five or six f32 streams (g, V, U, p in; V', U' out).
// seg_compact_gt is redesigned for this card (one warp per row, all of a
// row's loads in flight before any is used, ranks by ballots inside the
// warp); the other exact forms are the first, simple designs.
//
// The strided forms (stats_sampled, count_sampled) read only each
// segment's [::stride] samples: ~151K floats for the paper LSTM's sampled
// arena, nearly all in a 32-byte sector of their own (4.2 MB of sectors,
// 0.6 MB of useful bytes). Bandwidth does not bound them there; a launch
// and the chain of dependent round trips do: the segment's maps, then its
// samples, then the reductions. So each is one launch with no memset and
// no per-call scratch: thread-block clusters of 8 blocks (the portable
// size; cudaLaunchKernelEx), G per segment (seg_strided_log_g: the fewest
// G, at most 64, that leave each thread at most two batches of 8 loads),
// each batch issued before any of its loads is used; larger
// segments loop over more batches. The blocks' partials meet in rank 0's
// distributed shared memory behind one blocking cluster wait; with G > 1
// the last of a segment's clusters folds their partials. A warp's lanes
// take consecutive samples, so a segment at stride 1 streams coalesced.
// Their floor is an empty launch of the same grid (empty_kernel,
// launch_floor_launch).
//
// Numerics follow the reference's default jnp backend, not the Pallas
// bodies: the sums reproduce selection.pinned_sum bitwise (see
// fold_column); counts and compaction are integer / bit moves. The file is
// compiled with -fmad=false and the adds use __fadd_rn, so no product is
// ever contracted into an add.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

// Phase 1 of seg_abs_sum_max. Segment s is the vector of its n sampled
// elements, element e at slot position e * stride (stride 1: the whole slot;
// stride > 1: the slot's [::stride] subsample, n = ceil(size / stride)).
// With P = next_pow2(n) = 2^(logc + logr) it is viewed as [R, C] with
// element e = t*C + i; thread i folds column i. Elements at e >= n are the
// pinned tree's zero padding and are not read, nor is any slot position off
// the stride grid. The first logr levels of the tree are exactly these
// column folds.
__global__ void __launch_bounds__(COLFOLD_THREADS)
stats_colfold(const float* __restrict__ x, const long long* __restrict__ seg_off,
              const int* __restrict__ seg_n, const int* __restrict__ seg_stride,
              const int* __restrict__ seg_logc, const int* __restrict__ seg_logr,
              int cmax, float* __restrict__ part_sum,
              float* __restrict__ part_max) {
  const int s = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int logc = seg_logc[s];
  if (i >= (1 << logc)) return;
  const long long C = 1LL << logc;
  const long long n = seg_n[s];
  const long long st = seg_stride[s];
  const float* base = x + seg_off[s];
  float sum, mx;
  fold_column(seg_logr[s], [&](int t) {
    const long long e = static_cast<long long>(t) * C + i;
    return e < n ? fabsf(base[e * st]) : 0.f;
  }, sum, mx);
  part_sum[static_cast<long long>(s) * cmax + i] = sum;
  part_max[static_cast<long long>(s) * cmax + i] = mx;
}

// Phase 2: the remaining logc levels fold segment s's C column partials
// (finish_partials, common.cuh).
__global__ void __launch_bounds__(FINISH_THREADS)
stats_finish(const int* __restrict__ seg_logc, int cmax,
             const float* __restrict__ part_sum,
             const float* __restrict__ part_max, float* __restrict__ out_sum,
             float* __restrict__ out_max) {
  const int s = blockIdx.x;
  finish_partials(seg_logc[s], part_sum + static_cast<long long>(s) * cmax,
                  part_max + static_cast<long long>(s) * cmax, out_sum + s,
                  out_max + s);
}

// One block per arena row: 256 threads x float4; the row's count goes to
// its segment with one integer atomicAdd (order-free).
__global__ void __launch_bounds__(ROW / 4)
count_gt(const float* __restrict__ x, const int* __restrict__ block_seg,
         const float* __restrict__ thr, int* __restrict__ out) {
  __shared__ int wsum[ROW / 4 / 32];
  const int row = blockIdx.x;
  const int s = block_seg[row];
  const float t = thr[s];
  const float4 v =
      reinterpret_cast<const float4*>(x + static_cast<long long>(row) * ROW)[threadIdx.x];
  int c = (fabsf(v.x) > t) + (fabsf(v.y) > t) + (fabsf(v.z) > t) + (fabsf(v.w) > t);
  for (int off = 16; off; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int tot = 0;
    for (int w = 0; w < ROW / 4 / 32; ++w) tot += wsum[w];
    if (tot) atomicAdd(out + s, tot);
  }
}

// ---- the strided forms: thread-block clusters per segment ---------------
// Grid (SAMPLE_CS * G, n_seg), clusters of SAMPLE_CS blocks: segment s
// takes G = 2^log_g clusters, cluster g of blocks [g * CS, (g + 1) * CS),
// whose blocks split the segment's samples. Inside a cluster each block
// arrives (relaxed) at the cluster barrier as it starts and waits on it
// only once its own partial is ready, which proves rank 0 resident; it then
// stores the partial into rank 0's shared memory (distributed shared
// memory), arrives again with release semantics and exits. Only rank 0
// waits for that second phase. With G = 1 rank 0 stores the segment's
// result. With G > 1 rank 0 stores its cluster's partial, and the last of
// the segment's clusters (a ticket, which it resets to 0 itself) folds the
// G partials and stores the result. The partials and tickets live as long
// as the geometry's maps: calls on one geometry must be stream-ordered.
namespace cg = cooperative_groups;

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

constexpr int SAMPLE_CS = 8;          // blocks per cluster (the portable most)
constexpr int SAMPLE_THREADS = 256;   // per block
constexpr int SAMPLE_WARPS = SAMPLE_THREADS / 32;
constexpr int SAMPLE_BATCH = 8;       // loads a thread issues before using any
constexpr int LOG_CT = 11;            // log2(SAMPLE_CS * SAMPLE_THREADS)

// True for the one cluster of segment s that arrives last at ticket[s],
// after every cluster of s has stored its partial; that one resets the
// ticket for the next launch. Called by one whole warp after its lanes'
// stores.
__device__ __forceinline__ bool last_cluster(int* ticket, int s, int n) {
  __threadfence();
  __syncwarp();
  int t = 0;
  if ((threadIdx.x & 31) == 0) t = atomicAdd(ticket + s, 1);
  const bool last = __shfl_sync(FULL, t, 0) == n - 1;
  if (last && (threadIdx.x & 31) == 0) ticket[s] = 0;
  __threadfence();
  return last;
}

// fold_column for any R = 2^logr: below 8 rows the R loads are issued
// together and the column is summed as an 8-row tree whose missing rows
// are +0 (x + 0 = x for the sums of |x|, so the bits are the R-row tree's).
template <class Load>
__device__ __forceinline__ void fold_rows(int logr, Load load, float& sum,
                                          float& mx) {
  if (logr >= 3) {
    fold_column(logr, load, sum, mx);
    return;
  }
  float v[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) v[u] = u < (1 << logr) ? load(bitrev(u, logr)) : 0.f;
  mx = 0.f;
#pragma unroll
  for (int u = 0; u < 8; ++u) mx = fmaxf(mx, v[u]);
  sum = __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3])),
                  __fadd_rn(__fadd_rn(v[4], v[5]), __fadd_rn(v[6], v[7])));
}

// seg_abs_sum_max with a stride per segment, in one launch. Segment s's n
// sampled elements (element e at slot position e * stride), zero-padded to
// P = next_pow2(n), are viewed as [R, C] with C = the segment's G * 2048
// threads (a pinned tree over P padded further with zeros has the same
// bits, so C may exceed P) and R = max(1, P / C). Thread (warp w, lane l)
// of rank r in cluster g folds column i = ((w * CS + r) * G + g) * 32 + l:
// a warp's lanes read consecutive samples (coalesced at stride 1), and the
// tree's levels after the column folds (pairs i, i + h for h = C/2 .. 1)
// pair first the warps of a block, then the cluster's ranks, then the
// segment's clusters, and last the lanes — each level per lane until the
// last, so a block hands on 32 partials, not one.
__global__ void __launch_bounds__(SAMPLE_THREADS)
stats_sampled(const float* __restrict__ x, const long long* __restrict__ seg_off,
              const int* __restrict__ seg_n, const int* __restrict__ seg_stride,
              int log_g, float* __restrict__ part, int* __restrict__ ticket,
              float* __restrict__ out_sum, float* __restrict__ out_max) {
  __shared__ float wsum[SAMPLE_WARPS][32];
  __shared__ float wmax[SAMPLE_WARPS][32];
  __shared__ float red[2][SAMPLE_CS][32];   // rank 0's: the blocks' partials
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int rank = static_cast<int>(cluster.block_rank());
  const int g = blockIdx.x / SAMPLE_CS;
  const int s = blockIdx.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int log_c = LOG_CT + log_g;
  const int i = ((((w * SAMPLE_CS + rank) << log_g) + g) << 5) + lane;
  const int n = seg_n[s];
  const long long st = seg_stride[s];
  const float* base = x + seg_off[s];
  const int logp = n > 1 ? 32 - __clz(n - 1) : 0;
  float sum, mx;
  fold_rows(logp > log_c ? logp - log_c : 0, [&](int t) {
    const long long e = (static_cast<long long>(t) << log_c) + i;
    return e < n ? fabsf(base[e * st]) : 0.f;
  }, sum, mx);
  // the block's levels: across warps (w, w + h), per lane
  wsum[w][lane] = sum;
  wmax[w][lane] = mx;
  __syncthreads();
  if (w == 0) {
    float a[SAMPLE_WARPS];
#pragma unroll
    for (int q = 0; q < SAMPLE_WARPS; ++q) {
      a[q] = wsum[q][lane];
      mx = fmaxf(mx, wmax[q][lane]);
    }
#pragma unroll
    for (int h = SAMPLE_WARPS / 2; h; h >>= 1)
#pragma unroll
      for (int q = 0; q < h; ++q) a[q] = __fadd_rn(a[q], a[q + h]);
    sum = a[0];
  }
  cluster_wait();
  if (w == 0) {
    float (*r0)[SAMPLE_CS][32] = cluster.map_shared_rank(red, 0);
    r0[0][rank][lane] = sum;
    r0[1][rank][lane] = mx;
  }
  cluster_arrive_release();
  if (rank != 0) return;
  cluster_wait();
  if (w != 0) return;
  // the cluster's levels: ranks (r, r + h), per lane
  float a[SAMPLE_CS];
  mx = 0.f;
#pragma unroll
  for (int r = 0; r < SAMPLE_CS; ++r) {
    a[r] = red[0][r][lane];
    mx = fmaxf(mx, red[1][r][lane]);
  }
#pragma unroll
  for (int h = SAMPLE_CS / 2; h; h >>= 1)
#pragma unroll
    for (int r = 0; r < h; ++r) a[r] = __fadd_rn(a[r], a[r + h]);
  sum = a[0];
  if (log_g) {
    // the segment's levels: clusters (g, g + h), per lane, by the last one
    float* ps = part + (static_cast<long long>(s) << (log_g + 6));
    ps[(g << 6) + lane] = sum;
    ps[(g << 6) + 32 + lane] = mx;
    if (!last_cluster(ticket, s, 1 << log_g)) return;
    fold_column(log_g, [&](int t) { return __ldcg(ps + (t << 6) + lane); },
                sum, mx);
    mx = 0.f;
    for (int t = 0; t < (1 << log_g); ++t)
      mx = fmaxf(mx, __ldcg(ps + (t << 6) + 32 + lane));
  }
  // the lanes' levels
  for (int off = 16; off; off >>= 1) {
    sum = __fadd_rn(sum, __shfl_down_sync(FULL, sum, off));
    mx = fmaxf(mx, __shfl_down_sync(FULL, mx, off));
  }
  if (lane == 0) {
    out_sum[s] = sum;
    out_max[s] = mx;
  }
}

// seg_count_gt with a stride per segment, in one launch. Segment s's stride
// grid is the slot-local vector of positions e * stride, e < pad / stride,
// padding included as the twin counts it. The segment's G * 2048 threads
// take consecutive grid positions, each issuing a batch of 8 loads before
// counting any; the count is reduced in the warp, the block, through
// distributed shared memory the cluster, and with G > 1 by the last cluster
// (integer adds: order-free).
__global__ void __launch_bounds__(SAMPLE_THREADS)
count_sampled(const float* __restrict__ x, const long long* __restrict__ seg_off,
              const int* __restrict__ seg_stride, const int* __restrict__ seg_pad,
              const float* __restrict__ thr, int log_g, int* __restrict__ part,
              int* __restrict__ ticket, int* __restrict__ out) {
  __shared__ int wcnt[SAMPLE_WARPS];
  __shared__ int red[SAMPLE_CS];   // rank 0's: the blocks' counts
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int rank = static_cast<int>(cluster.block_rank());
  const int s = blockIdx.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int ct = 1 << (LOG_CT + log_g);
  const long long st = seg_stride[s];
  const int grid_n = seg_pad[s] / static_cast<int>(st);
  const float t = thr[s];
  const float* base = x + seg_off[s];
  int c = 0;
  for (int e0 = blockIdx.x * SAMPLE_THREADS + threadIdx.x; e0 < grid_n;
       e0 += SAMPLE_BATCH * ct) {
    float v[SAMPLE_BATCH];
#pragma unroll
    for (int u = 0; u < SAMPLE_BATCH; ++u) {
      const int e = e0 + u * ct;
      v[u] = e < grid_n ? base[e * st] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < SAMPLE_BATCH; ++u)
      c += (e0 + u * ct < grid_n) & (fabsf(v[u]) > t);
  }
  c = static_cast<int>(__reduce_add_sync(FULL, static_cast<unsigned>(c)));
  if (lane == 0) wcnt[w] = c;
  __syncthreads();
  if (w == 0)
    c = static_cast<int>(__reduce_add_sync(
        FULL, static_cast<unsigned>(lane < SAMPLE_WARPS ? wcnt[lane] : 0)));
  cluster_wait();
  if (threadIdx.x == 0) cluster.map_shared_rank(red, 0)[rank] = c;
  cluster_arrive_release();
  if (rank != 0) return;
  cluster_wait();
  if (w != 0) return;
  c = static_cast<int>(__reduce_add_sync(
      FULL, static_cast<unsigned>(lane < SAMPLE_CS ? red[lane] : 0)));
  if (log_g) {
    int* pc = part + (static_cast<long long>(s) << log_g);
    if (lane == 0) pc[blockIdx.x / SAMPLE_CS] = c;
    if (!last_cluster(ticket, s, 1 << log_g)) return;
    c = 0;
    for (int q = lane; q < (1 << log_g); q += 32) c += __ldcg(pc + q);
    c = static_cast<int>(__reduce_add_sync(FULL, static_cast<unsigned>(c)));
  }
  if (lane == 0) out[s] = c;
}

// The launch floor: a kernel that does nothing, launched as the strided
// forms are (or as one plain block).
__global__ void empty_kernel(int) {}

// Launch kernel on grid (SAMPLE_CS << log_g, n_y) in clusters of SAMPLE_CS
// blocks of SAMPLE_THREADS threads; returns the launch's error (0 =
// launched).
template <class... Params, class... Args>
int launch_clusters(void (*kernel)(Params...), int log_g, int n_y,
                    cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(SAMPLE_CS << log_g, n_y, 1);
  cfg.blockDim = dim3(SAMPLE_THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SAMPLE_CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// Alg 4 lines 8-19 on one arena element k, exactly as the plain twin
// (residual.accumulate_arena) rounds it: every product and sum rounded on
// its own (__fmul_rn / __fadd_rn, and -fmad=false), then the optional bf16
// round of V'. Stores V' (and U' when momentum is set) and returns V'.
struct Accum {
  const float* __restrict__ g;
  const float* __restrict__ v;
  const float* __restrict__ u;   // null unless momentum != 0
  const float* __restrict__ p;   // null unless weight_decay != 0
  float* __restrict__ vo;
  float* __restrict__ uo;        // null unless momentum != 0
  float momentum, weight_decay;
  int nesterov, round_bf16;

  __device__ __forceinline__ float operator()(long long k) const {
    float gk = g[k];
    if (p) gk = __fadd_rn(gk, __fmul_rn(weight_decay, p[k]));
    float vk;
    if (u) {
      const float uk = __fadd_rn(__fmul_rn(momentum, u[k]), gk);
      uo[k] = uk;
      vk = __fadd_rn(v[k], uk);
      if (nesterov) vk = __fadd_rn(vk, gk);
    } else {
      vk = __fadd_rn(v[k], gk);
    }
    if (round_bf16) vk = __bfloat162float(__float2bfloat16_rn(vk));
    vo[k] = vk;
    return vk;
  }
};

// Phase 1 of seg_residual_update_stats: the stats_colfold fold of |V'| over
// each segment's sampled vector, where computing a sample also computes and
// stores V' (and U') for the slot positions it owns, so the arena is read
// and written once.
//  * stride 1: thread i's load of element e updates position e, as in
//    stats_colfold (coalesced across the warp's consecutive columns).
//  * stride > 1: sample e owns positions [e*stride, (e+1)*stride). At each
//    fold row the warp's 32 consecutive samples own one contiguous run of
//    32*stride positions, which the warp updates together, coalesced; the
//    lanes that hit a sample position leave |V'| in shared memory for the
//    lane that folds it.
// Positions past the last sample's group (the slot's zero padding) are
// updated by a short tail loop and add nothing to the statistics. Padding is
// 0 in and so 0 out.
__global__ void __launch_bounds__(COLFOLD_THREADS)
resid_colfold(Accum acc, const long long* __restrict__ seg_off,
              const int* __restrict__ seg_n, const int* __restrict__ seg_stride,
              const int* __restrict__ seg_pad, const int* __restrict__ seg_logc,
              const int* __restrict__ seg_logr, int cmax,
              float* __restrict__ part_sum, float* __restrict__ part_max) {
  __shared__ float samp[COLFOLD_THREADS];
  const int s = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int i0 = i - lane;                 // the warp's first column
  const int logc = seg_logc[s];
  const int C = 1 << logc;
  if (i0 >= C) return;                     // warp-uniform
  const long long off = seg_off[s];
  const int n = seg_n[s];
  const int st = seg_stride[s];
  const int pad = seg_pad[s];
  const int logr = seg_logr[s];
  float sum = 0.f, mx = 0.f;
  if (st == 1) {
    if (i < C)
      fold_column(logr, [&](int t) {
        const int e = t * C + i;
        return e < n ? fabsf(acc(off + e)) : 0.f;
      }, sum, mx);
  } else {
    const int lgst = __ffs(st) - 1;        // strides are powers of two
    const int nvalid = C - i0 < 32 ? C - i0 : 32;
    float* ws = samp + (threadIdx.x - lane);
    fold_column(logr, [&](int t) {
      const int e0 = t * C + i0;
      const int e1 = e0 + nvalid < n ? e0 + nvalid : n;
      if (e0 < e1) {
#pragma unroll 4
        for (int q = e0 * st + lane; q < e1 * st; q += 32) {
          const float vq = acc(off + q);
          if ((q & (st - 1)) == 0) ws[(q >> lgst) - e0] = fabsf(vq);
        }
      }
      __syncwarp();
      const float r = (lane < nvalid && e0 + lane < n) ? ws[lane] : 0.f;
      __syncwarp();
      return r;
    }, sum, mx);
  }
  if (i >= C) return;
  for (int q = n * st + i; q < pad; q += C) acc(off + q);
  part_sum[static_cast<long long>(s) * cmax + i] = sum;
  part_max[static_cast<long long>(s) * cmax + i] = mx;
}

// Per arena row, the first cap survivors of |x| > thr[block_seg[row]] at
// slot-local index < slot size, as (x, slot-local index), padded with
// (0, slot size), and the row's count before clamping. One warp per row,
// eight rows per block (warp_bucket, common.cuh): each lane issues its 8
// float4 loads of the row (streaming, evict-first) first, then the row's
// maps and its slot's threshold, so the dependent block_seg -> thr chain
// waits while the row's 4 KB are in flight. The old design (one 1024-thread
// block per row, scalar loads, two block barriers and a serial scan of the
// warp totals) kept at most 8 KB of loads in flight per SM. Arena rows are
// whole, zero-padded rows, so every row takes float4 loads; positions past
// the slot's end are masked.
__global__ void __launch_bounds__(CR_THREADS, 6)
compact_gt(const float* __restrict__ x, const int* __restrict__ block_seg,
           const int* __restrict__ block_base, const int* __restrict__ block_size,
           const float* __restrict__ thr, int nb, int cap,
           float* __restrict__ vals, int* __restrict__ idx,
           int* __restrict__ cnt) {
  const int row = blockIdx.x * CR_ROWS + (threadIdx.x >> 5);
  if (row >= nb) return;   // warp-uniform
  const int lane = threadIdx.x & 31;
  const float* xr = x + static_cast<long long>(row) * ROW;
  float4 v[CR_VEC];
#pragma unroll
  for (int j = 0; j < CR_VEC; ++j)
    v[j] = __ldcs(reinterpret_cast<const float4*>(xr + j * 128) + lane);
  const int base = block_base[row];
  const int size = block_size[row];
  const float t = thr[block_seg[row]];
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < CR_VEC; ++j)
    bits |= gt_bits4(v[j], t, j * 128 + 4 * lane, size - base) << (4 * j);
  const long long out = static_cast<long long>(row) * cap;
  warp_bucket(bits, xr, base, size, cap, vals + out, idx + out, cnt + row);
}

}  // namespace

extern "C" {

// Each entry launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() (0 = launched).

int seg_abs_sum_max_launch(const float* x, const long long* seg_off,
                           const int* seg_n, const int* seg_stride,
                           const int* seg_logc, const int* seg_logr, int n_seg,
                           int cmax, float* part_sum, float* part_max,
                           float* out_sum, float* out_max, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((cmax + COLFOLD_THREADS - 1) / COLFOLD_THREADS, n_seg);
  stats_colfold<<<grid, COLFOLD_THREADS, 0, st>>>(
      x, seg_off, seg_n, seg_stride, seg_logc, seg_logr, cmax, part_sum,
      part_max);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_finish<<<n_seg, FINISH_THREADS, 0, st>>>(seg_logc, cmax, part_sum,
                                                   part_max, out_sum, out_max);
  return static_cast<int>(cudaGetLastError());
}

int seg_count_gt_launch(const float* x, const int* block_seg, const float* thr,
                        int nb, int* out, void* stream) {
  count_gt<<<nb, ROW / 4, 0, static_cast<cudaStream_t>(stream)>>>(
      x, block_seg, thr, out);
  return static_cast<int>(cudaGetLastError());
}

// The strided forms run 2^log_g clusters of 8 blocks per segment (log_g
// <= 6). part holds n_seg << (log_g + 6) floats (stats) or n_seg << log_g
// ints (count), ticket n_seg ints that are 0 before the launch and are 0
// again after it; neither is read when log_g is 0. Each is one launch and
// writes every output element with a plain store.
int seg_abs_sum_max_strided_launch(const float* x, const long long* seg_off,
                                   const int* seg_n, const int* seg_stride,
                                   int n_seg, int log_g, float* part,
                                   int* ticket, float* out_sum, float* out_max,
                                   void* stream) {
  if (log_g < 0 || log_g > 6) return static_cast<int>(cudaErrorInvalidValue);
  return launch_clusters(stats_sampled, log_g, n_seg,
                         static_cast<cudaStream_t>(stream), x, seg_off, seg_n,
                         seg_stride, log_g, part, ticket, out_sum, out_max);
}

int seg_count_gt_strided_launch(const float* x, const long long* seg_off,
                                const int* seg_stride, const int* seg_pad,
                                const float* thr, int n_seg, int log_g,
                                int* part, int* ticket, int* out,
                                void* stream) {
  if (log_g < 0 || log_g > 6) return static_cast<int>(cudaErrorInvalidValue);
  return launch_clusters(count_sampled, log_g, n_seg,
                         static_cast<cudaStream_t>(stream), x, seg_off,
                         seg_stride, seg_pad, thr, log_g, part, ticket, out);
}

// log2 of the clusters per segment for the strided forms whose largest
// segment has `work` samples (padded to a power of two, or its stride
// grid): the fewest that leave each thread at most two batches of loads,
// at most 64. On the paper LSTM's sampled arena (H100) one cluster per
// segment with two batches beat two clusters with one batch each and the
// clusters' combine.
int seg_strided_log_g(long long work) {
  const long long per = 2LL * SAMPLE_BATCH * SAMPLE_CS * SAMPLE_THREADS;
  int log_g = 0;
  while (log_g < 6 && (per << log_g) < work) ++log_g;
  return log_g;
}

// The launch floor: empty_kernel on one plain block (log_g < 0), or on the
// strided forms' grid for log_g.
int launch_floor_launch(int n_seg, int log_g, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (log_g < 0) {
    empty_kernel<<<1, 32, 0, st>>>(0);
    return static_cast<int>(cudaGetLastError());
  }
  return launch_clusters(empty_kernel, log_g, n_seg, st, 0);
}

int seg_residual_update_stats_launch(
    const float* g, const float* v, const float* u, const float* p, float* vo,
    float* uo, float momentum, int nesterov, float weight_decay, int round_bf16,
    const long long* seg_off, const int* seg_n, const int* seg_stride,
    const int* seg_pad, const int* seg_logc, const int* seg_logr, int n_seg,
    int cmax, float* part_sum, float* part_max, float* out_sum, float* out_max,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Accum acc{g, v, u, p, vo, uo, momentum, weight_decay, nesterov, round_bf16};
  const dim3 grid((cmax + COLFOLD_THREADS - 1) / COLFOLD_THREADS, n_seg);
  resid_colfold<<<grid, COLFOLD_THREADS, 0, st>>>(
      acc, seg_off, seg_n, seg_stride, seg_pad, seg_logc, seg_logr, cmax,
      part_sum, part_max);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_finish<<<n_seg, FINISH_THREADS, 0, st>>>(seg_logc, cmax, part_sum,
                                                   part_max, out_sum, out_max);
  return static_cast<int>(cudaGetLastError());
}

int seg_compact_gt_launch(const float* x, const int* block_seg,
                          const int* block_base, const int* block_size,
                          const float* thr, int nb, int cap, float* vals,
                          int* idx, int* cnt, void* stream) {
  compact_gt<<<(nb + CR_ROWS - 1) / CR_ROWS, CR_THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(
      x, block_seg, block_base, block_size, thr, nb, cap, vals, idx, cnt);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
