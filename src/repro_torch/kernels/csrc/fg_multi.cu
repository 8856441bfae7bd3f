// K4: partials of the selection objective at K pivots from one shared x.
//
// Replaces the TPU kernel src/repro/kernels/cp_objective.py
// `_fg_kernel_multi` (tile math `_fg_tile`) on both of its legs, one body
// statically specialized on the weight type (`NoWeights`: the counting leg,
// which reads no weights):
// - counting leg: x (n,) f32 or bf16, pivots y (K,) f32 -> per-block
//   partials fsum (nblk, K, 2) f32 = (sum max(d, 0), sum max(-d, 0)) and
//   cnt (nblk, K, 2) int32 = (#(d < 0), #(d <= 0)) with d = x - y_k;
// - weighted leg (K4w): x and w (n,), each f32 or bf16 -> fsum (nblk, K, 4)
//   f32 = (sum w*d over d > 0, sum -w*d over d < 0, sum w over d < 0, sum w
//   over d <= 0) and the same counts.
// The wrapper sums over blocks in a fixed order, as the plain versions
// `kernels/ref.py:cp_partials_multi_ref` / `wcp_partials_multi_ref` sum over
// the array.
//
// Bound on an H100 SXM: one read of x (4 bytes per f32 element, 2 per
// bf16), and of w on the weighted leg: 512 MiB (1 GiB with f32 weights) at
// n = 2^27 against 3.35 TB/s is 0.16 ms (0.32 ms); against that, per
// element and pivot one subtract, two compares, two selects and four adds
// (weighted: two multiplies, four selects and six adds), which at K = 16 and
// n = 2^27 is 0.29 ms (0.45 ms) of f32 operations.
//
// Design:
// - a block holds G pivots (G in {1, 2, 4, 8, 16}, a template parameter, the
//   smallest that covers K up to 16) with its accumulators in registers;
//   K > 16 splits into groups of 16 along grid.y, and each group reads x
//   (and w) again (ceil(K / 16) times);
// - grid (nblk, groups); each block strides over its share of x with 64-bit
//   offsets, four independent loads in flight per thread;
// - per-thread f32 sums and int counts, then the fixed-order warp-shuffle
//   and shared-memory block reduce of K2 (`fg_batched.cu`), pivot by pivot:
//   one partial per block and pivot, no float atomics.  Every pivot sees
//   the elements in K2's order, so its partials do not depend on K or on
//   its group, and at K = 1 they equal K2's bit for bit.  The wrapper picks
//   nblk from n alone, so the sums repeat bit for bit from run to run;
// - NaN as K2: on the counting leg max(d, 0) propagates NaN into both sums,
//   on the weighted leg a NaN d adds nothing, and the counts compare d
//   itself, so x - y = NaN counts in neither;
// - the weighted products are __fmul_rn, never contracted into the sum.
// Built without fast-math, so denormal differences are kept (no flush).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxGroup = 16;

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

// K2's accumulation, term for term (`fg_batched.cu`)
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

template <typename T, typename W, int G>
__global__ void __launch_bounds__(kThreads)
fg_multi_kernel(const T* __restrict__ x, const W* __restrict__ w,
                const float* __restrict__ y, float* __restrict__ fsum,
                int* __restrict__ cnt, long long n, int npiv) {
  constexpr int NF = kSums<W>;
  __shared__ Partials<NF> warp_parts[kThreads / 32][G];
  const int first = blockIdx.y * G;
  const int np = min(G, npiv - first);
  float yv[G];
  Partials<NF> p[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    // a group's unused slots repeat its first pivot and are never written
    yv[g] = y[first + (g < np ? g : 0)];
    p[g] = Partials<NF>{};
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    float v[kUnroll], wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = to_f32(x[i + u * stride]);
      wv[u] = weight(w, i + u * stride);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) accumulate(v[u], wv[u], yv[g], p[g]);
    }
  }
  for (; i < n; i += stride) {
    const float v = to_f32(x[i]);
    const float wv = weight(w, i);
#pragma unroll
    for (int g = 0; g < G; ++g) accumulate(v, wv, yv[g], p[g]);
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    warp_reduce(p[g]);
    if (lane == 0) warp_parts[warp][g] = p[g];
  }
  __syncthreads();
  if (warp == 0) {
    for (int g = 0; g < np; ++g) {
      Partials<NF> s = lane < kThreads / 32 ? warp_parts[lane][g]
                                            : Partials<NF>{};
      warp_reduce(s);
      if (lane == 0) {
        const long long b = (long long)blockIdx.x * npiv + first + g;
#pragma unroll
        for (int f = 0; f < NF; ++f) fsum[b * NF + f] = s.s[f];
        cnt[b * 2] = s.lt;
        cnt[b * 2 + 1] = s.le;
      }
    }
  }
}

template <typename T, typename W, int G>
int launch_group(const void* x, const void* w, const void* y, void* fsum,
                 void* cnt, long long n, int npiv, int nblk, void* stream) {
  const dim3 grid((unsigned)nblk, (unsigned)((npiv + G - 1) / G));
  fg_multi_kernel<T, W, G><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const float*>(y), static_cast<float*>(fsum),
      static_cast<int*>(cnt), n, npiv);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int launch(const void* x, const void* w, const void* y, void* fsum,
           void* cnt, long long n, int npiv, int nblk, void* stream) {
  if (npiv <= 1) return launch_group<T, W, 1>(x, w, y, fsum, cnt, n, npiv,
                                             nblk, stream);
  if (npiv <= 2) return launch_group<T, W, 2>(x, w, y, fsum, cnt, n, npiv,
                                             nblk, stream);
  if (npiv <= 4) return launch_group<T, W, 4>(x, w, y, fsum, cnt, n, npiv,
                                             nblk, stream);
  if (npiv <= 8) return launch_group<T, W, 8>(x, w, y, fsum, cnt, n, npiv,
                                             nblk, stream);
  return launch_group<T, W, kMaxGroup>(x, w, y, fsum, cnt, n, npiv, nblk,
                                       stream);
}

}  // namespace

// Each returns the launch's cudaGetLastError() code.  Counting leg:
extern "C" int fg_multi_f32(const void* x, const void* y, void* fsum,
                            void* cnt, long long n, int npiv, int nblk,
                            void* stream) {
  return launch<float, NoWeights>(x, nullptr, y, fsum, cnt, n, npiv, nblk,
                                  stream);
}

extern "C" int fg_multi_bf16(const void* x, const void* y, void* fsum,
                             void* cnt, long long n, int npiv, int nblk,
                             void* stream) {
  return launch<__nv_bfloat16, NoWeights>(x, nullptr, y, fsum, cnt, n, npiv,
                                          nblk, stream);
}

// Weighted leg, one entry per (x, w) type pair:
#define WFG_MULTI(XN, XT, WN, WT)                                          \
  extern "C" int wfg_multi_##XN##_##WN(                                    \
      const void* x, const void* w, const void* y, void* fsum, void* cnt,  \
      long long n, int npiv, int nblk, void* stream) {                     \
    return launch<XT, WT>(x, w, y, fsum, cnt, n, npiv, nblk, stream);      \
  }
WFG_MULTI(f32, float, f32, float)
WFG_MULTI(f32, float, bf16, __nv_bfloat16)
WFG_MULTI(bf16, __nv_bfloat16, f32, float)
WFG_MULTI(bf16, __nv_bfloat16, bf16, __nv_bfloat16)

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
