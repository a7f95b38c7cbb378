// Hand-written Hopper (sm_90a) kernels of the flat-residual-arena selection
// path: one multi_select per RGC step runs seg_abs_sum_max once,
// seg_count_gt once per search iteration (plus the warm probe and the final
// count) and seg_compact_gt once.
//
// Arena layout: x is [nb, 1024] f32 rows; row b belongs to segment (slot)
// block_seg[b]; each slot starts on a row boundary and is zero-padded.
//
// Replaces (src/repro/kernels/segmented.py, exact forms):
//   seg_abs_sum_max  <- seg_abs_sum_max (:113, _stats_kernel :76)
//   seg_count_gt     <- seg_count_gt    (:182, _count_kernel :151)
//   seg_compact_gt   <- seg_compact_gt  (:242, _compact_kernel :219)
//
// Bound: all three only stream the arena once (264 MB per pass for the
// paper's 2-layer 1500-unit LSTM) and do ~1 op per element, so HBM
// bandwidth bounds them (~79 us at 3.35 TB/s). The designs below are the
// simple ones; speed work comes later.
//
// Numerics follow the reference's default jnp backend, not the Pallas
// bodies: the sums reproduce selection.pinned_sum bitwise (see
// fold_column); counts and compaction are integer / bit moves. The file is
// compiled with -fmad=false and the adds use __fadd_rn, so no product is
// ever contracted into an add.
#include <cuda_runtime.h>

namespace {

constexpr int ROW = 1024;             // arena row width (ARENA_BLOCK)
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

// Phase 1 of seg_abs_sum_max. Segment s (true size n, P = next_pow2(n) =
// 2^(logc + logr)) is viewed as [R, C] with element e = t*C + i; thread i
// folds column i. Elements at e >= n are the pinned tree's zero padding and
// are not read. The first logr levels of the tree are exactly these column
// folds.
__global__ void __launch_bounds__(COLFOLD_THREADS)
stats_colfold(const float* __restrict__ x, const long long* __restrict__ seg_off,
              const int* __restrict__ seg_n, const int* __restrict__ seg_logc,
              const int* __restrict__ seg_logr, int cmax,
              float* __restrict__ part_sum, float* __restrict__ part_max) {
  const int s = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int logc = seg_logc[s];
  if (i >= (1 << logc)) return;
  const long long C = 1LL << logc;
  const long long n = seg_n[s];
  const float* base = x + seg_off[s];
  float sum, mx;
  fold_column(seg_logr[s], [&](int t) {
    const long long e = static_cast<long long>(t) * C + i;
    return e < n ? fabsf(base[e]) : 0.f;
  }, sum, mx);
  part_sum[static_cast<long long>(s) * cmax + i] = sum;
  part_max[static_cast<long long>(s) * cmax + i] = mx;
}

// Phase 2: the remaining logc levels fold segment s's C column partials by
// halving — again as [R2, C2] column folds, then a shared-memory halving.
__global__ void __launch_bounds__(FINISH_THREADS)
stats_finish(const int* __restrict__ seg_logc, int cmax,
             const float* __restrict__ part_sum,
             const float* __restrict__ part_max, float* __restrict__ out_sum,
             float* __restrict__ out_max) {
  __shared__ float ssum[FINISH_THREADS];
  __shared__ float smax[FINISH_THREADS];
  const int s = blockIdx.x;
  const int i = threadIdx.x;
  const int logc = seg_logc[s];
  const int log2c = logc < 10 ? logc : 10;
  const int C2 = 1 << log2c;
  const int logr2 = logc - log2c;
  const float* ps = part_sum + static_cast<long long>(s) * cmax;
  const float* pm = part_max + static_cast<long long>(s) * cmax;
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
    out_sum[s] = ssum[0];
    out_max[s] = smax[0];
  }
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

// One block per arena row, one thread per element. The survivor's rank in
// the row is a warp ballot/popc prefix plus the prefix of the warp totals;
// survivors with rank < cap are stored directly (the TPU's cumsum and
// one-hot matmul existed only because it has no scatter). Unfilled bucket
// slots get value 0 and index == slot size; cnt is the pre-clamp count.
__global__ void __launch_bounds__(ROW)
compact_gt(const float* __restrict__ x, const int* __restrict__ block_seg,
           const int* __restrict__ block_base, const int* __restrict__ block_size,
           const float* __restrict__ thr, int cap, float* __restrict__ vals,
           int* __restrict__ idx, int* __restrict__ cnt) {
  __shared__ int wpre[ROW / 32];
  __shared__ int total_s;
  const int row = blockIdx.x;
  const int col = threadIdx.x;
  const int lane = col & 31;
  const int warp = col >> 5;
  const float t = thr[block_seg[row]];
  const int size = block_size[row];
  const int lidx = block_base[row] + col;
  const float v = x[static_cast<long long>(row) * ROW + col];
  const bool m = (fabsf(v) > t) && (lidx < size);
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
  const int pos = wpre[warp] + __popc(bal & ((1u << lane) - 1u));
  const int total = total_s;
  float* vr = vals + static_cast<long long>(row) * cap;
  int* ir = idx + static_cast<long long>(row) * cap;
  if (m && pos < cap) {
    vr[pos] = v;
    ir[pos] = lidx;
  }
  const int filled = total < cap ? total : cap;
  if (col >= filled && col < cap) {
    vr[col] = 0.f;
    ir[col] = size;
  }
  if (col == 0) cnt[row] = total;
}

}  // namespace

extern "C" {

// Each entry launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() (0 = launched).

int seg_abs_sum_max_launch(const float* x, const long long* seg_off,
                           const int* seg_n, const int* seg_logc,
                           const int* seg_logr, int n_seg, int cmax,
                           float* part_sum, float* part_max, float* out_sum,
                           float* out_max, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((cmax + COLFOLD_THREADS - 1) / COLFOLD_THREADS, n_seg);
  stats_colfold<<<grid, COLFOLD_THREADS, 0, st>>>(
      x, seg_off, seg_n, seg_logc, seg_logr, cmax, part_sum, part_max);
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

int seg_compact_gt_launch(const float* x, const int* block_seg,
                          const int* block_base, const int* block_size,
                          const float* thr, int nb, int cap, float* vals,
                          int* idx, int* cnt, void* stream) {
  compact_gt<<<nb, ROW, 0, static_cast<cudaStream_t>(stream)>>>(
      x, block_seg, block_base, block_size, thr, cap, vals, idx, cnt);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
