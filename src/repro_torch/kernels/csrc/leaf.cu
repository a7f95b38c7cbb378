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
// us per pass and 90 / 54 us for the update. The designs are the simple
// ones: float4 loads where the pointers allow, a grid-stride loop sized to
// the card, one integer atomic per block; speed work comes later.
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
constexpr unsigned FULL = 0xffffffffu;

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

// Phase 1 of the leaf's pinned statistics. With P = next_pow2(n) =
// 2^(logc + logr) the leaf is viewed as [R, C], element e = t*C + i; thread
// i folds column i (fold_column, common.cuh). Elements e >= n are the
// pinned tree's zero padding and are not read. Phase 2 is finish_partials.
__global__ void __launch_bounds__(COLFOLD_THREADS)
abs_colfold_leaf(const float* __restrict__ x, long long n, int logc, int logr,
                 float* __restrict__ part_sum, float* __restrict__ part_max) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (1 << logc)) return;
  const long long C = 1LL << logc;
  float sum, mx;
  fold_column(logr, [&](int t) {
    const long long e = static_cast<long long>(t) * C + i;
    return e < n ? fabsf(x[e]) : 0.f;
  }, sum, mx);
  part_sum[i] = sum;
  part_max[i] = mx;
}

__global__ void __launch_bounds__(FINISH_THREADS)
abs_finish_leaf(int logc, const float* __restrict__ part_sum,
                const float* __restrict__ part_max, float* __restrict__ out) {
  finish_partials(logc, part_sum, part_max, out, out + 1);
}

// One block per 1024-element row of the leaf, one thread per element. A
// survivor's rank in its row is row_rank's ballot/popc prefix; survivors
// with rank < cap are stored as (x, global index). Unfilled bucket slots
// get (0, n); cnt is the row's count before clamping. Positions >= n (the
// last row's ragged tail) are never survivors and are not read.
__global__ void __launch_bounds__(ROW)
compact_gt_leaf(const float* __restrict__ x, long long n,
                const float* __restrict__ thr, int cap, float* __restrict__ vals,
                int* __restrict__ idx, int* __restrict__ cnt) {
  const int row = blockIdx.x;
  const int col = threadIdx.x;
  const float t = *thr;
  const long long g = static_cast<long long>(row) * ROW + col;
  const float v = g < n ? x[g] : 0.f;
  const bool m = g < n && fabsf(v) > t;
  int total;
  const int pos = row_rank(m, total);
  float* vr = vals + static_cast<long long>(row) * cap;
  int* ir = idx + static_cast<long long>(row) * cap;
  if (m && pos < cap) {
    vr[pos] = v;
    ir[pos] = static_cast<int>(g);
  }
  const int filled = total < cap ? total : cap;
  if (col >= filled && col < cap) {
    vr[col] = 0.f;
    ir[col] = static_cast<int>(n);
  }
  if (col == 0) cnt[row] = total;
}

// The exact form, run when some row's survivors overflowed its bucket: the
// same ranking, but survivor pos of a row goes to slot base + pos of one
// dense list of len slots, where base = incl[row] - cnt[row] is the number
// of survivors in the rows before it (cnt: the per-row counts compact_gt
// returned; incl: their inclusive prefix sum). So the list holds the first
// len survivors of the leaf in index order, whatever their rows. A row
// whose base is at or past len returns before it reads x (the test is
// uniform over the block, so row_rank's barriers stay whole); the last row
// pads the slots after the last survivor with (0, n).
__global__ void __launch_bounds__(ROW)
compact_gt_exact_leaf(const float* __restrict__ x, long long n,
                      const float* __restrict__ thr,
                      const int* __restrict__ cnt, const int* __restrict__ incl,
                      int len, float* __restrict__ vals,
                      int* __restrict__ idx) {
  const int row = blockIdx.x;
  const int col = threadIdx.x;
  const int end = incl[row];
  const int base = end - cnt[row];
  if (row == static_cast<int>(gridDim.x) - 1) {
    for (int p = end + col; p < len; p += ROW) {
      vals[p] = 0.f;
      idx[p] = static_cast<int>(n);
    }
  }
  if (base >= len) return;
  const float t = *thr;
  const long long g = static_cast<long long>(row) * ROW + col;
  const float v = g < n ? x[g] : 0.f;
  const bool m = g < n && fabsf(v) > t;
  int total;
  const int p = base + row_rank(m, total);
  if (m && p < len) {
    vals[p] = v;
    idx[p] = static_cast<int>(g);
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

// part: 2 << logc floats of scratch (sums, then maxima); out: 2 floats
// (sum|x|, max|x|).
int abs_sum_max_launch(const float* x, long long n, int logc, int logr,
                       float* part, float* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cols = 1 << logc;
  abs_colfold_leaf<<<(cols + COLFOLD_THREADS - 1) / COLFOLD_THREADS,
                     COLFOLD_THREADS, 0, st>>>(x, n, logc, logr, part,
                                               part + cols);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  abs_finish_leaf<<<1, FINISH_THREADS, 0, st>>>(logc, part, part + cols, out);
  return static_cast<int>(cudaGetLastError());
}

int compact_gt_launch(const float* x, long long n, const float* thr, int cap,
                      float* vals, int* idx, int* cnt, void* stream) {
  const int nb = static_cast<int>((n + ROW - 1) / ROW);
  compact_gt_leaf<<<nb, ROW, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, thr, cap, vals, idx, cnt);
  return static_cast<int>(cudaGetLastError());
}

// cnt, incl: nb = ceil(n / 1024) ints each (see compact_gt_exact_leaf);
// vals, idx: len slots.
int compact_gt_exact_launch(const float* x, long long n, const float* thr,
                            const int* cnt, const int* incl, int len,
                            float* vals, int* idx, void* stream) {
  const int nb = static_cast<int>((n + ROW - 1) / ROW);
  compact_gt_exact_leaf<<<nb, ROW, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, thr, cnt, incl, len, vals, idx);
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
