// K4: partials of the selection objective at K pivots from one shared x.
//
// Replaces the TPU kernel src/repro/kernels/cp_objective.py
// `_fg_kernel_multi` (tile math `_fg_tile`), on its counting leg: x (n,)
// f32 or bf16, pivots y (K,) f32 -> per-block partials fsum (nblk, K, 2)
// f32 = (sum max(d, 0), sum max(-d, 0)) and cnt (nblk, K, 2) int32 =
// (#(d < 0), #(d <= 0)) with d = x - y_k.  The wrapper sums over blocks in a
// fixed order, as the plain version `kernels/ref.py:cp_partials_multi_ref`
// sums over the array.
//
// Bound on an H100 SXM: one read of x (4 bytes per f32 element, 2 per
// bf16), 512 MiB at n = 2^27 against 3.35 TB/s is 0.16 ms; against that,
// per element and pivot one subtract, two compares, two selects and four
// adds, which at K = 16 and n = 2^27 is 0.29 ms of f32 operations.
//
// Design:
// - a block holds G pivots (G in {1, 2, 4, 8, 16}, a template parameter, the
//   smallest that covers K up to 16) with four accumulators each in
//   registers; K > 16 splits into groups of 16 along grid.y, and each group
//   reads x again (x is read ceil(K / 16) times);
// - grid (nblk, groups); each block strides over its share of x with 64-bit
//   offsets, four independent loads in flight per thread;
// - per-thread f32 sums and int counts, then the fixed-order warp-shuffle
//   and shared-memory block reduce of K2 (`fg_batched.cu`), pivot by pivot:
//   one partial per block and pivot, no float atomics.  Every pivot sees
//   the elements in K2's order, so its partials do not depend on K or on
//   its group, and at K = 1 they equal K2's bit for bit.  The wrapper picks
//   nblk from n alone, so the sums repeat bit for bit from run to run;
// - NaN as K2: max(d, 0) propagates NaN into both sums and the counts
//   compare d itself, so x - y = NaN counts in neither.
// Built without fast-math, so denormal differences are kept (no flush).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxGroup = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Partials {
  float sp, sn;
  int lt, le;
};

__device__ __forceinline__ void accumulate(float xv, float y, Partials& p) {
  const float d = xv - y;
  const bool nan = d != d;
  p.sp += d > 0.f ? d : (nan ? d : 0.f);
  p.sn += d < 0.f ? -d : (nan ? d : 0.f);
  p.lt += d < 0.f;
  p.le += d <= 0.f;
}

__device__ __forceinline__ void warp_reduce(Partials& p) {
  for (int o = 16; o > 0; o >>= 1) {
    p.sp += __shfl_down_sync(0xffffffffu, p.sp, o);
    p.sn += __shfl_down_sync(0xffffffffu, p.sn, o);
    p.lt += __shfl_down_sync(0xffffffffu, p.lt, o);
    p.le += __shfl_down_sync(0xffffffffu, p.le, o);
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
fg_multi_kernel(const T* __restrict__ x, const float* __restrict__ y,
                float* __restrict__ fsum, int* __restrict__ cnt, long long n,
                int npiv) {
  __shared__ Partials warp_parts[kThreads / 32][G];
  const int first = blockIdx.y * G;
  const int np = min(G, npiv - first);
  float yv[G];
  Partials p[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    // a group's unused slots repeat its first pivot and are never written
    yv[g] = y[first + (g < np ? g : 0)];
    p[g] = Partials{0.f, 0.f, 0, 0};
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = to_f32(x[i + u * stride]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) accumulate(v[u], yv[g], p[g]);
    }
  }
  for (; i < n; i += stride) {
    const float v = to_f32(x[i]);
#pragma unroll
    for (int g = 0; g < G; ++g) accumulate(v, yv[g], p[g]);
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
      Partials s = lane < kThreads / 32 ? warp_parts[lane][g]
                                        : Partials{0.f, 0.f, 0, 0};
      warp_reduce(s);
      if (lane == 0) {
        const long long o = ((long long)blockIdx.x * npiv + first + g) * 2;
        fsum[o] = s.sp;
        fsum[o + 1] = s.sn;
        cnt[o] = s.lt;
        cnt[o + 1] = s.le;
      }
    }
  }
}

template <typename T, int G>
int launch_group(const void* x, const void* y, void* fsum, void* cnt,
                 long long n, int npiv, int nblk, void* stream) {
  const dim3 grid((unsigned)nblk, (unsigned)((npiv + G - 1) / G));
  fg_multi_kernel<T, G><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(y),
      static_cast<float*>(fsum), static_cast<int*>(cnt), n, npiv);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* y, void* fsum, void* cnt, long long n,
           int npiv, int nblk, void* stream) {
  if (npiv <= 1) return launch_group<T, 1>(x, y, fsum, cnt, n, npiv, nblk,
                                          stream);
  if (npiv <= 2) return launch_group<T, 2>(x, y, fsum, cnt, n, npiv, nblk,
                                          stream);
  if (npiv <= 4) return launch_group<T, 4>(x, y, fsum, cnt, n, npiv, nblk,
                                          stream);
  if (npiv <= 8) return launch_group<T, 8>(x, y, fsum, cnt, n, npiv, nblk,
                                          stream);
  return launch_group<T, kMaxGroup>(x, y, fsum, cnt, n, npiv, nblk, stream);
}

}  // namespace

// Returns the launch's cudaGetLastError() code.
extern "C" int fg_multi_f32(const void* x, const void* y, void* fsum,
                            void* cnt, long long n, int npiv, int nblk,
                            void* stream) {
  return launch<float>(x, y, fsum, cnt, n, npiv, nblk, stream);
}

extern "C" int fg_multi_bf16(const void* x, const void* y, void* fsum,
                             void* cnt, long long n, int npiv, int nblk,
                             void* stream) {
  return launch<__nv_bfloat16>(x, y, fsum, cnt, n, npiv, nblk, stream);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
