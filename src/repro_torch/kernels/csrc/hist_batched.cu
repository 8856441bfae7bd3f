// K1: row-batched slot histogram against realized bin edges.
//
// Replaces the TPU kernel src/repro/kernels/cp_objective.py
// `_hist_kernel_batched` (tile math `_bin_tile`), on its counting leg without
// per-slot sums: x (B, n) f32 or bf16, edges (B, nbins+1) f32, out int32
// counts (B, nbins+2).  Slot layout: slot 0 is x <= e_0 (with -inf), slot j
// is e_{j-1} < x <= e_j, slot nbins+1 is x > e_nbins and NaN — exactly
// `searchsorted(edges, x, side='left')` with NaN pinned to the top slot, as
// the plain version `kernels/ref.py:cp_histogram_batched_ref` computes it.
//
// Bound on an H100 SXM: memory.  One sweep reads x once (4 bytes per f32
// element, 2 per bf16): 512 MiB at n = 2^27 against 3.35 TB/s is 0.16 ms.
// Per element the work is one or two compares, or for in-bracket elements a
// binary search over the shared-memory edges (7 steps at nbins = 128).
//
// Design:
// - grid (blocks_per_row, B); each block strides over its share of row r
//   with 64-bit offsets, four independent loads in flight per thread;
// - the row's realized edges are staged in shared memory and the kernel only
//   COMPARES against them: it never recomputes lo + w*j, so its counts agree
//   with the engine's later `x <= e_j` narrowing and finalize comparisons;
// - elements outside the bracket (after the first sweep nearly all of them)
//   are counted in per-thread registers; only in-bracket elements take a
//   shared-memory atomic, so the two end slots see no contention;
// - a per-block shared int histogram is flushed with integer atomicAdd into
//   the zeroed output: exact and independent of the order of blocks.
// Built without fast-math, so denormals are compared exactly (no flush).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// slot = count(edges < v); e[0] and e[nedges-1] are the bracket ends
__device__ __forceinline__ void bin_one(float v, const float* e, int nedges,
                                        int* hist, int& below, int& above) {
  if (v <= e[0]) {
    ++below;
  } else if (!(v <= e[nedges - 1])) {  // v > e_nbins, or NaN
    ++above;
  } else {
    // invariant: e[a-1] < v <= e[b]; the answer lies in [1, nedges-1]
    int a = 1, b = nedges - 1;
    while (a < b) {
      const int m = (a + b) >> 1;
      if (e[m] < v) a = m + 1; else b = m;
    }
    atomicAdd(&hist[a], 1);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hist_batched_kernel(const T* __restrict__ x, const float* __restrict__ edges,
                    int* __restrict__ cnt, long long n, int nedges) {
  extern __shared__ float smem[];
  float* e = smem;
  int* hist = reinterpret_cast<int*>(smem + nedges);
  const int nslots = nedges + 1;
  const long long row = blockIdx.y;
  for (int i = threadIdx.x; i < nedges; i += blockDim.x)
    e[i] = edges[row * nedges + i];
  for (int i = threadIdx.x; i < nslots; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  const T* xr = x + row * n;
  int below = 0, above = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = to_f32(xr[i + u * stride]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      bin_one(v[u], e, nedges, hist, below, above);
  }
  for (; i < n; i += stride)
    bin_one(to_f32(xr[i]), e, nedges, hist, below, above);

  below = warp_sum(below);
  above = warp_sum(above);
  if ((threadIdx.x & 31) == 0) {
    if (below) atomicAdd(&hist[0], below);
    if (above) atomicAdd(&hist[nslots - 1], above);
  }
  __syncthreads();
  int* out = cnt + row * nslots;
  for (int s = threadIdx.x; s < nslots; s += blockDim.x)
    if (hist[s]) atomicAdd(&out[s], hist[s]);
}

template <typename T>
int launch(const void* x, const void* edges, void* cnt, long long rows,
           long long n, int nedges, int blocks_per_row, void* stream) {
  const size_t smem = (size_t)(2 * nedges + 1) * sizeof(float);
  const dim3 grid((unsigned)blocks_per_row, (unsigned)rows);
  hist_batched_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(edges),
      static_cast<int*>(cnt), n, nedges);
  return (int)cudaGetLastError();
}

}  // namespace

// `cnt` must be zeroed by the caller (the blocks add into it).  Returns the
// launch's cudaGetLastError() code.
extern "C" int hist_batched_f32(const void* x, const void* edges, void* cnt,
                                long long rows, long long n, int nedges,
                                int blocks_per_row, void* stream) {
  return launch<float>(x, edges, cnt, rows, n, nedges, blocks_per_row,
                       stream);
}

extern "C" int hist_batched_bf16(const void* x, const void* edges, void* cnt,
                                 long long rows, long long n, int nedges,
                                 int blocks_per_row, void* stream) {
  return launch<__nv_bfloat16>(x, edges, cnt, rows, n, nedges,
                               blocks_per_row, stream);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
