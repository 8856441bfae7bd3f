// K2: row-batched partials of the selection objective at one pivot per row.
//
// Replaces the TPU kernel src/repro/kernels/cp_objective.py
// `_fg_kernel_batched` (tile math `_fg_tile`), on its counting leg: x (B, n)
// f32 or bf16, pivots y (B,) f32 -> per-block partials fsum (B, nblk, 2) f32
// = (sum max(d, 0), sum max(-d, 0)) and cnt (B, nblk, 2) int32 =
// (#(d < 0), #(d <= 0)) with d = x - y.  The wrapper sums over blocks, as the
// plain version `kernels/ref.py:cp_partials_batched_ref` sums over the row.
//
// Bound on an H100 SXM: memory.  One pass reads x once (4 bytes per f32
// element, 2 per bf16): 512 MiB at n = 2^27 against 3.35 TB/s is 0.16 ms;
// the arithmetic is one subtract, two compares and two adds per element.
//
// Design:
// - grid (nblk, B); each block strides over its share of row r with 64-bit
//   offsets, four independent loads in flight per thread;
// - per-thread f32 sums and int counts, then a fixed-order warp-shuffle and
//   shared-memory block reduce; one partial per block, no float atomics.
//   The wrapper picks nblk from n alone, so the sums repeat bit for bit from
//   run to run;
// - NaN behaviour of the plain version: max(d, 0) propagates NaN into both
//   sums (CUDA's fmaxf would drop it), and the counts compare d itself, so
//   an element with x - y = NaN (NaN data, inf - inf) counts in neither.
// Built without fast-math, so denormal differences are kept (no flush).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
fg_batched_kernel(const T* __restrict__ x, const float* __restrict__ y,
                  float* __restrict__ fsum, int* __restrict__ cnt,
                  long long n) {
  __shared__ Partials warp_parts[kThreads / 32];
  const long long row = blockIdx.y;
  const float yv = y[row];
  const T* xr = x + row * n;
  Partials p = {0.f, 0.f, 0, 0};
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = to_f32(xr[i + u * stride]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) accumulate(v[u], yv, p);
  }
  for (; i < n; i += stride) accumulate(to_f32(xr[i]), yv, p);

  warp_reduce(p);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) warp_parts[warp] = p;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    p = lane < nwarps ? warp_parts[lane] : Partials{0.f, 0.f, 0, 0};
    warp_reduce(p);
    if (lane == 0) {
      const long long o = (row * gridDim.x + blockIdx.x) * 2;
      fsum[o] = p.sp;
      fsum[o + 1] = p.sn;
      cnt[o] = p.lt;
      cnt[o + 1] = p.le;
    }
  }
}

template <typename T>
int launch(const void* x, const void* y, void* fsum, void* cnt,
           long long rows, long long n, int nblk, void* stream) {
  const dim3 grid((unsigned)nblk, (unsigned)rows);
  fg_batched_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(y),
      static_cast<float*>(fsum), static_cast<int*>(cnt), n);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaGetLastError() code.
extern "C" int fg_batched_f32(const void* x, const void* y, void* fsum,
                              void* cnt, long long rows, long long n,
                              int nblk, void* stream) {
  return launch<float>(x, y, fsum, cnt, rows, n, nblk, stream);
}

extern "C" int fg_batched_bf16(const void* x, const void* y, void* fsum,
                               void* cnt, long long rows, long long n,
                               int nblk, void* stream) {
  return launch<__nv_bfloat16>(x, y, fsum, cnt, rows, n, nblk, stream);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
