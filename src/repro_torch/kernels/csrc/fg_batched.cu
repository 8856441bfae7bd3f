// K2: row-batched partials of the selection objective at one pivot per row.
//
// Replaces the TPU kernel src/repro/kernels/cp_objective.py
// `_fg_kernel_batched` (tile math `_fg_tile`) on both of its legs, as one
// kernel body statically specialized on the weight type (`NoWeights`: the
// counting leg, which reads no weights):
// - counting leg: x (B, n) f32 or bf16, pivots y (B,) f32 -> per-block
//   partials fsum (B, nblk, 2) f32 = (sum max(d, 0), sum max(-d, 0)) and
//   cnt (B, nblk, 2) int32 = (#(d < 0), #(d <= 0)) with d = x - y;
// - weighted leg (K2w): x and w (B, n), each f32 or bf16 -> fsum (B, nblk,
//   4) f32 = (sum w*d over d > 0, sum -w*d over d < 0, sum w over d < 0,
//   sum w over d <= 0) and the same counts.
// The wrapper sums over blocks, as the plain versions
// `kernels/ref.py:cp_partials_batched_ref` / `wcp_partials_batched_ref` sum
// over the row.
//
// Bound on an H100 SXM: memory.  One pass reads x once (4 bytes per f32
// element, 2 per bf16), and w once on the weighted leg: 512 MiB (1 GiB
// with f32 weights) at n = 2^27 against 3.35 TB/s is 0.16 ms (0.32 ms);
// the arithmetic is one subtract, two compares and two adds per element
// (two multiplies, four selects and four adds more with weights).
//
// Design:
// - grid (nblk, B); each block strides over its share of row r with 64-bit
//   offsets, four independent loads (of x, and of w) in flight per thread;
// - per-thread f32 sums and int counts, then a fixed-order warp-shuffle and
//   shared-memory block reduce; one partial per block, no float atomics.
//   The wrapper picks nblk from n alone, so the sums (and the masses that
//   decide the weighted narrowing) repeat bit for bit from run to run;
// - NaN behaviour of the plain versions: on the counting leg max(d, 0)
//   propagates NaN into both sums (CUDA's fmaxf would drop it); on the
//   weighted leg every term is a select on d, so an element with d = NaN
//   adds nothing.  The counts compare d itself, so x - y = NaN (NaN data,
//   inf - inf) counts in neither;
// - the weighted products are __fmul_rn, never contracted into the sum.
// Built without fast-math, so denormal differences are kept (no flush).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the weight type of the counting leg: no weights are read
struct NoWeights {};

// NF f32 sums (2 counting, 4 weighted) and the two counts
template <int NF>
struct Partials {
  float s[NF];
  int lt, le;
};

template <typename W>
constexpr int kSums = std::is_same<W, NoWeights>::value ? 2 : 4;

__device__ __forceinline__ void accumulate(float xv, float, float y,
                                           Partials<2>& p) {
  const float d = xv - y;
  const bool nan = d != d;
  p.s[0] += d > 0.f ? d : (nan ? d : 0.f);
  p.s[1] += d < 0.f ? -d : (nan ? d : 0.f);
  p.lt += d < 0.f;
  p.le += d <= 0.f;
}

__device__ __forceinline__ void accumulate(float xv, float wv, float y,
                                           Partials<4>& p) {
  const float d = xv - y;
  p.s[0] += d > 0.f ? __fmul_rn(wv, d) : 0.f;
  p.s[1] += d < 0.f ? __fmul_rn(-wv, d) : 0.f;
  p.s[2] += d < 0.f ? wv : 0.f;
  p.s[3] += d <= 0.f ? wv : 0.f;
  p.lt += d < 0.f;
  p.le += d <= 0.f;
}

template <int NF>
__device__ __forceinline__ void warp_reduce(Partials<NF>& p) {
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int f = 0; f < NF; ++f)
      p.s[f] += __shfl_down_sync(0xffffffffu, p.s[f], o);
    p.lt += __shfl_down_sync(0xffffffffu, p.lt, o);
    p.le += __shfl_down_sync(0xffffffffu, p.le, o);
  }
}

template <typename W>
__device__ __forceinline__ float weight(const W* w, long long i) {
  return to_f32(w[i]);
}
__device__ __forceinline__ float weight(const NoWeights*, long long) {
  return 0.f;
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
fg_batched_kernel(const T* __restrict__ x, const W* __restrict__ w,
                  const float* __restrict__ y, float* __restrict__ fsum,
                  int* __restrict__ cnt, long long n) {
  constexpr int NF = kSums<W>;
  __shared__ Partials<NF> warp_parts[kThreads / 32];
  const long long row = blockIdx.y;
  const float yv = y[row];
  const T* xr = x + row * n;
  const W* wr = kSums<W> == 4 ? w + row * n : w;  // null when counting
  Partials<NF> p = {};
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    float v[kUnroll], wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = to_f32(xr[i + u * stride]);
      wv[u] = weight(wr, i + u * stride);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) accumulate(v[u], wv[u], yv, p);
  }
  for (; i < n; i += stride)
    accumulate(to_f32(xr[i]), weight(wr, i), yv, p);

  warp_reduce(p);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) warp_parts[warp] = p;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    p = lane < nwarps ? warp_parts[lane] : Partials<NF>{};
    warp_reduce(p);
    if (lane == 0) {
      const long long b = row * gridDim.x + blockIdx.x;
#pragma unroll
      for (int f = 0; f < NF; ++f) fsum[b * NF + f] = p.s[f];
      cnt[b * 2] = p.lt;
      cnt[b * 2 + 1] = p.le;
    }
  }
}

template <typename T, typename W>
int launch(const void* x, const void* w, const void* y, void* fsum,
           void* cnt, long long rows, long long n, int nblk, void* stream) {
  const dim3 grid((unsigned)nblk, (unsigned)rows);
  fg_batched_kernel<T, W><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const float*>(y), static_cast<float*>(fsum),
      static_cast<int*>(cnt), n);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns the launch's cudaGetLastError() code.  Counting leg:
extern "C" int fg_batched_f32(const void* x, const void* y, void* fsum,
                              void* cnt, long long rows, long long n,
                              int nblk, void* stream) {
  return launch<float, NoWeights>(x, nullptr, y, fsum, cnt, rows, n, nblk,
                                  stream);
}

extern "C" int fg_batched_bf16(const void* x, const void* y, void* fsum,
                               void* cnt, long long rows, long long n,
                               int nblk, void* stream) {
  return launch<__nv_bfloat16, NoWeights>(x, nullptr, y, fsum, cnt, rows, n,
                                          nblk, stream);
}

// Weighted leg, one entry per (x, w) type pair:
#define WFG_BATCHED(XN, XT, WN, WT)                                        \
  extern "C" int wfg_batched_##XN##_##WN(                                  \
      const void* x, const void* w, const void* y, void* fsum, void* cnt,  \
      long long rows, long long n, int nblk, void* stream) {               \
    return launch<XT, WT>(x, w, y, fsum, cnt, rows, n, nblk, stream);      \
  }
WFG_BATCHED(f32, float, f32, float)
WFG_BATCHED(f32, float, bf16, __nv_bfloat16)
WFG_BATCHED(bf16, __nv_bfloat16, f32, float)
WFG_BATCHED(bf16, __nv_bfloat16, bf16, __nv_bfloat16)

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
