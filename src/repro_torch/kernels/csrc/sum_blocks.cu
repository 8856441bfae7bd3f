// The cross-block sums of every leg with f32 block partials: the partials
// kernels K2 (`fg_batched.cu`) and K4 (`fg_multi.cu`), and the histogram
// legs with rows, K1w/K1s/K1ws (`hist_batched.cu`) and K3w/K3s/K3ws
// (`hist_multi.cu`): f32 per-block partials part (outer, nblk, inner) ->
// out (outer, inner), summed over the block axis.
//
// Replaces the `jnp.sum(..., axis=0 or 1)` after the TPU kernels' grids in
// src/repro/kernels/cp_objective.py (`_fg_call_multi`, `_fg_call_batched`,
// `_hist_call_multi`, `_hist_call_batched`).  torch.sum would do it in one
// call, but its order of additions may depend on the shape of the whole
// tensor, so a pivot's sums would change with K and differ between K4 at
// K = 1 and K2's row, and a histogram row's or ladder's masses would follow
// the other rows or ladders of its launch.  Here the order depends on nblk
// alone: for each output, "lane" l adds blocks l, l + 32, l + 64, ... in
// that order, then the 32 lane sums meet in a fixed shuffle tree.  No float
// atomics: two launches give the same bits.
//
// A block sums 32 consecutive outputs: thread (warp l, lane c) runs lane
// l's serial sum for output c, so that a warp reads 32 neighbouring
// partials of one block at a time (coalesced); the 32 x 32 lane sums pass
// through shared memory to warp c, whose lane l holds lane l's sum, and
// meet there in the shuffle tree.
//
// Bound: bytes; the partials are at most a few MB (1024 blocks x K x 4
// floats, or x 130 slots x a row or two per ladder), read once.
//
// Row sums (`row_partials_kernel`): the per-block partials of the rows
// path's f32 sums over a (B, n) block, which the wrapper hands to
// `sum_blocks`: a row's total mass, its weighted sum of x, its sum of x
// (the means that seed the engine) and its masses at or below, or below, a
// per-row value (the finalize's probes).  Not a TPU kernel: it replaces
// the `jnp.sum(..., axis=1)` calls of src/repro/core/objective.py
// (`RowsEvaluator`) and src/repro/core/selection.py (`_compact_interval`,
// `_finalize_rows`), where torch.sum's order of additions would follow the
// shape of the whole block, so a row alone would get other bits than in a
// batch.  Here block b of a row takes elements b*256 + t + j*nblk*256 (a
// thread adds its elements in data order), the 256 thread sums meet in a
// warp shuffle tree and then the 8 warps in order, and nblk = fg_blocks(n):
// the order depends on n alone.  w*x is rounded on its own (__fmul_rn;
// rounded to bf16 when both are bf16, as torch's product is), so no
// product is contracted into the sum.  Bound: bytes, one read of x (and
// w).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;  // lane sums per output, and outputs per block

__global__ void __launch_bounds__(kLanes * 32)
sum_blocks_kernel(const float* __restrict__ part, float* __restrict__ out,
                  int nblk, long long inner) {
  __shared__ float tile[kLanes][kLanes + 1];  // [lane l][output c]
  const int l = threadIdx.x >> 5;   // which lane sum
  const int c = threadIdx.x & 31;   // which output of the block's 32
  const long long o = blockIdx.y;
  const long long i = (long long)blockIdx.x * kLanes + c;
  float s = 0.f;
  if (i < inner) {
    const float* p = part + o * nblk * inner + i;
    for (int b = l; b < nblk; b += kLanes) s += p[(long long)b * inner];
  }
  tile[l][c] = s;
  __syncthreads();
  s = tile[c][l];  // warp l now holds output l's 32 lane sums, lane c's
  for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(0xffffffffu, s, d);
  const long long j = (long long)blockIdx.x * kLanes + l;
  if (c == 0 && j < inner) out[o * inner + j] = s;
}

constexpr int kRowThreads = 256;
constexpr int kRowUnroll = 4;

// What a row sum adds per element: x (the counting mean), or of the
// weights w: all of them, w*x, those over x <= c, those over x < c.
enum RowMode { kRowX = -1, kRowW = 0, kRowWX = 1, kRowLe = 2, kRowLt = 3 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, typename W>
__device__ __forceinline__ float product(T xv, W wv) {
  const float p = __fmul_rn(to_f32(xv), to_f32(wv));
  if (sizeof(T) == 2 && sizeof(W) == 2)  // bf16 * bf16 is a bf16
    return __bfloat162float(__float2bfloat16_rn(p));
  return p;
}

template <typename T, typename W, int M>
__device__ __forceinline__ float row_term(const T* x, const W* w,
                                          long long i, float c) {
  if (M == kRowX) return to_f32(x[i]);
  if (M == kRowW) return to_f32(w[i]);
  if (M == kRowWX) return product(x[i], w[i]);
  const float v = to_f32(x[i]);
  const bool in = M == kRowLe ? v <= c : v < c;
  return in ? to_f32(w[i]) : 0.f;
}

template <typename T, typename W, int M>
__global__ void __launch_bounds__(kRowThreads)
row_partials_kernel(const T* __restrict__ x, const W* __restrict__ w,
                    const float* __restrict__ c, float* __restrict__ part,
                    long long n, int nblk) {
  __shared__ float wsum[kRowThreads / 32];
  const long long row = blockIdx.y;
  const T* xr = x + row * n;
  const W* wr = M == kRowX ? w : w + row * n;
  const float cr = M >= kRowLe ? c[row] : 0.f;
  const long long stride = (long long)nblk * kRowThreads;
  long long i = (long long)blockIdx.x * kRowThreads + threadIdx.x;
  float s = 0.f;
  for (; i + (kRowUnroll - 1) * stride < n; i += kRowUnroll * stride) {
    float t[kRowUnroll];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u)
      t[u] = row_term<T, W, M>(xr, wr, i + u * stride, cr);
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) s += t[u];  // data order
  }
  for (; i < n; i += stride) s += row_term<T, W, M>(xr, wr, i, cr);
  for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(0xffffffffu, s, d);
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = 0.f;
    for (int k = 0; k < kRowThreads / 32; ++k) b += wsum[k];
    part[row * nblk + blockIdx.x] = b;
  }
}

template <typename T, typename W, int M>
int row_launch(const void* x, const void* w, const void* c, void* part,
               long long rows, long long n, int nblk, void* stream) {
  const dim3 grid((unsigned)nblk, (unsigned)rows);
  row_partials_kernel<T, W, M><<<grid, kRowThreads, 0,
                                 (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const float*>(c), static_cast<float*>(part), n, nblk);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int wrow_launch(const void* x, const void* w, const void* c, void* part,
                long long rows, long long n, int nblk, int mode,
                void* stream) {
  switch (mode) {
    case kRowW: return row_launch<T, W, kRowW>(x, w, c, part, rows, n, nblk,
                                               stream);
    case kRowWX: return row_launch<T, W, kRowWX>(x, w, c, part, rows, n,
                                                 nblk, stream);
    case kRowLe: return row_launch<T, W, kRowLe>(x, w, c, part, rows, n,
                                                 nblk, stream);
    case kRowLt: return row_launch<T, W, kRowLt>(x, w, c, part, rows, n,
                                                 nblk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Row sums, counting leg: part (rows, nblk) f32 per-block sums of x (rows,
// n); rows <= 65535.  Returns the launch's cudaGetLastError() code.
extern "C" int row_sums_f32(const void* x, void* part, long long rows,
                            long long n, int nblk, void* stream) {
  return row_launch<float, float, kRowX>(x, nullptr, nullptr, part, rows, n,
                                         nblk, stream);
}

extern "C" int row_sums_bf16(const void* x, void* part, long long rows,
                             long long n, int nblk, void* stream) {
  return row_launch<__nv_bfloat16, float, kRowX>(x, nullptr, nullptr, part,
                                                 rows, n, nblk, stream);
}

// Row sums of the weights, one entry per (x, w) type pair: `mode` 0 sums
// w, 1 w*x, 2 w over x <= c[row], 3 w over x < c[row] (`c` f32 (rows,),
// read only by modes 2 and 3).
#define WROW_SUMS(XN, XT, WN, WT)                                           \
  extern "C" int wrow_sums_##XN##_##WN(const void* x, const void* w,        \
                                       const void* c, void* part,           \
                                       long long rows, long long n,         \
                                       int nblk, int mode, void* stream) {  \
    return wrow_launch<XT, WT>(x, w, c, part, rows, n, nblk, mode, stream); \
  }
WROW_SUMS(f32, float, f32, float)
WROW_SUMS(f32, float, bf16, __nv_bfloat16)
WROW_SUMS(bf16, __nv_bfloat16, f32, float)
WROW_SUMS(bf16, __nv_bfloat16, bf16, __nv_bfloat16)

// Returns the launch's cudaGetLastError() code.
extern "C" int sum_blocks_f32(const void* part, void* out, long long outer,
                              int nblk, long long inner, void* stream) {
  const dim3 grid((unsigned)((inner + kLanes - 1) / kLanes),
                  (unsigned)outer);
  sum_blocks_kernel<<<grid, kLanes * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(part), static_cast<float*>(out), nblk,
      inner);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
