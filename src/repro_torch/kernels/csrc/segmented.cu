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
//   seg_abs_sum_max  <- seg_abs_sum_max (:113, _stats_kernel :76 and, with
//                       a stride per segment, _stats_kernel_strided :91)
//   seg_count_gt     <- seg_count_gt    (:182, _count_kernel :151)
//   count_gt_strided <- seg_count_gt with stride_b (_count_kernel_strided
//                       :165)
//   seg_compact_gt   <- seg_compact_gt  (:242, _compact_kernel :219)
//   resid_colfold    <- seg_residual_update_stats (:328, _resid_kernel :285)
//
// Bound: the exact forms stream the arena once (264 MB per pass for the
// paper's 2-layer 1500-unit LSTM) and do ~1 op per element, so HBM
// bandwidth bounds them (~79 us at 3.35 TB/s). The strided forms read only
// each segment's [::stride] samples (1/512 of a large slot); at that size
// launch latency and 32-byte sectors, not bandwidth, set their time. The
// fused residual update moves five or six f32 streams (g, V, U, p in; V',
// U' out). seg_compact_gt is redesigned for this card (one warp per row,
// all of a row's loads in flight before any is used, ranks by ballots
// inside the warp); the others are the first, simple designs.
//
// Numerics follow the reference's default jnp backend, not the Pallas
// bodies: the sums reproduce selection.pinned_sum bitwise (see
// fold_column); counts and compaction are integer / bit moves. The file is
// compiled with -fmad=false and the adds use __fadd_rn, so no product is
// ever contracted into an add.
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

__device__ __forceinline__ int warp_sum(int c) {
  for (int off = 16; off; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
  return c;
}

// The sampled count. Segment s's stride grid (col % stride == 0 in each of
// its rows) is the slot-local vector of positions e * stride, e < pad /
// stride, padding included as the twin counts it. Blocks (x, s) walk that
// vector, one sample per thread and step, so only grid positions are
// loaded and a warp's loads are in flight together; each warp then adds
// its count with one integer atomicAdd (order-free, so exact).
constexpr int COUNT_THREADS = 256;
constexpr int COUNT_MAX_BLOCKS = 256;   // per segment; the rest loops

__global__ void __launch_bounds__(COUNT_THREADS)
count_gt_strided(const float* __restrict__ x, const long long* __restrict__ seg_off,
                 const int* __restrict__ seg_stride, const int* __restrict__ seg_pad,
                 const float* __restrict__ thr, int* __restrict__ out) {
  const int s = blockIdx.y;
  const int st = seg_stride[s];
  const int grid_n = seg_pad[s] / st;
  const float t = thr[s];
  const float* base = x + seg_off[s];
  int c = 0;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < grid_n;
       e += gridDim.x * blockDim.x)
    c += fabsf(base[static_cast<long long>(e) * st]) > t;
  c = warp_sum(c);
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(out + s, c);
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

int seg_count_gt_strided_launch(const float* x, const long long* seg_off,
                                const int* seg_stride, const int* seg_pad,
                                const float* thr, int n_seg, int grid_max,
                                int* out, void* stream) {
  int bx = (grid_max + COUNT_THREADS - 1) / COUNT_THREADS;
  bx = bx < COUNT_MAX_BLOCKS ? (bx > 0 ? bx : 1) : COUNT_MAX_BLOCKS;
  const dim3 grid(bx, n_seg);
  count_gt_strided<<<grid, COUNT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, seg_off, seg_stride, seg_pad, thr, out);
  return static_cast<int>(cudaGetLastError());
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
