// K1: row-batched slot histogram against realized bin edges.
//
// Replaces the TPU kernel src/repro/kernels/cp_objective.py
// `_hist_kernel_batched` (tile math `_bin_tile`) without per-slot sums, on
// both of its legs:
// - counting leg: x (B, n) f32 or bf16, edges (B, nbins+1) f32, out int32
//   counts (B, nbins+2);
// - weighted leg (K1w): x and w (B, n), each f32 or bf16 -> the int32
//   counts and per-block f32 slot masses (B, nblk, nbins+2), summed over
//   blocks by the wrapper.
// Slot layout: slot 0 is x <= e_0 (with -inf), slot j is e_{j-1} < x <= e_j,
// slot nbins+1 is x > e_nbins and NaN — exactly `searchsorted(edges, x,
// side='left')` with NaN pinned to the top slot, as the plain versions
// `kernels/ref.py:cp_histogram_batched_ref` / `wcp_histogram_batched_ref`
// compute it.
//
// Bound on an H100 SXM: memory.  One sweep reads x once (4 bytes per f32
// element, 2 per bf16), and w once on the weighted leg: 512 MiB (1 GiB with
// f32 weights) at n = 2^27 against 3.35 TB/s is 0.16 ms (0.32 ms).  Per
// element the work is one or two compares, or for in-bracket elements a
// binary search over the shared-memory edges (7 steps at nbins = 128).
//
// Design, counting leg:
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
// Design, weighted leg: the masses decide every narrowing step, so they are
// summed in an order fixed by n and the launch shape alone, never with
// float atomics:
// - out-of-bracket mass goes to per-thread registers, beside the counts;
// - in-bracket elements go to a per-warp f32 row in shared memory: in each
//   step the lanes that share a slot are grouped with __match_any_sync, the
//   group's lowest lane sums their weights in lane order and adds the sum
//   to the warp's row — one writer per row entry, no atomic.  The loops are
//   warp-uniform (a lane past the end takes part with no element), so the
//   whole warp meets at every grouping;
// - after the loop the block sums its warps' rows in warp order and writes
//   one (nbins+2)-slot partial; the wrapper picks the block count from n
//   alone and reduces the partials over blocks in a fixed order;
// - counts keep the integer path: the group leader adds the group's size.
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

// slot of an in-bracket v: count(e < v), known to lie in [1, nedges - 1]
__device__ __forceinline__ int search(float v, const float* e, int nedges) {
  int a = 1, b = nedges - 1;  // invariant: e[a-1] < v <= e[b]
  while (a < b) {
    const int m = (a + b) >> 1;
    if (e[m] < v) a = m + 1; else b = m;
  }
  return a;
}

// slot = count(edges < v); e[0] and e[nedges-1] are the bracket ends
__device__ __forceinline__ void bin_one(float v, const float* e, int nedges,
                                        int* hist, int& below, int& above) {
  if (v <= e[0]) {
    ++below;
  } else if (!(v <= e[nedges - 1])) {  // v > e_nbins, or NaN
    ++above;
  } else {
    atomicAdd(&hist[search(v, e, nedges)], 1);
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

// ---------------------------------------------------------------------------
// Weighted leg
// ---------------------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

// The warp's in-bracket step: each lane brings its slot s (-1 when its
// element is outside the bracket or absent) and weight wv; lanes with one
// slot form a group, whose lowest lane adds the group's weights, summed in
// lane order, to the warp's row and the group's size to the block's counts.
// Every lane of the warp must call it.
__device__ __forceinline__ void warp_slot_add(int s, float wv, float* row,
                                              float* stage, int* hist,
                                              int lane) {
  if (!__any_sync(kFull, s >= 0)) return;  // uniform over the warp
  stage[lane] = wv;
  const unsigned grp = __match_any_sync(kFull, s);
  __syncwarp();
  if (s >= 0 && lane == __ffs(grp) - 1) {
    float acc = 0.f;
    for (unsigned m = grp; m; m &= m - 1) acc += stage[__ffs(m) - 1];
    row[s] += acc;
    atomicAdd(&hist[s], __popc(grp));
  }
  __syncwarp();
}

struct EndSlots {  // this thread's out-of-bracket counts and masses
  int below = 0, above = 0;
  float mbelow = 0.f, mabove = 0.f;
};

__device__ __forceinline__ void wbin_one(float v, float wv, bool valid,
                                         const float* e, int nedges,
                                         float* row, float* stage, int* hist,
                                         int lane, EndSlots& t) {
  int s = -1;
  if (valid) {
    if (v <= e[0]) {
      ++t.below;
      t.mbelow += wv;
    } else if (!(v <= e[nedges - 1])) {  // v > e_nbins, or NaN
      ++t.above;
      t.mabove += wv;
    } else {
      s = search(v, e, nedges);
    }
  }
  warp_slot_add(s, wv, row, stage, hist, lane);
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
whist_batched_kernel(const T* __restrict__ x, const W* __restrict__ w,
                     const float* __restrict__ edges, int* __restrict__ cnt,
                     float* __restrict__ mass, long long n, int nedges) {
  extern __shared__ float smem[];
  const int nslots = nedges + 1;
  const int nwarps = blockDim.x >> 5;
  float* e = smem;                                  // nedges
  float* rows = e + nedges;                         // nwarps * nslots
  float* stage = rows + nwarps * nslots;            // nwarps * 32
  int* hist = reinterpret_cast<int*>(stage + nwarps * 32);  // nslots
  const long long row = blockIdx.y;
  for (int i = threadIdx.x; i < nedges; i += blockDim.x)
    e[i] = edges[row * nedges + i];
  for (int i = threadIdx.x; i < nwarps * nslots; i += blockDim.x)
    rows[i] = 0.f;
  for (int i = threadIdx.x; i < nslots; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* wrow = rows + warp * nslots;
  float* wstage = stage + warp * 32;
  const T* xr = x + row * n;
  const W* wr = w + row * n;
  EndSlots t;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; __all_sync(kFull, i + (kUnroll - 1) * stride < n);
       i += kUnroll * stride) {
    float v[kUnroll], wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = to_f32(xr[i + u * stride]);
      wv[u] = to_f32(wr[i + u * stride]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      wbin_one(v[u], wv[u], true, e, nedges, wrow, wstage, hist, lane, t);
  }
  for (; __any_sync(kFull, i < n); i += stride) {
    const bool valid = i < n;
    wbin_one(valid ? to_f32(xr[i]) : 0.f, valid ? to_f32(wr[i]) : 0.f,
             valid, e, nedges, wrow, wstage, hist, lane, t);
  }

  // the end slots, reduced in a fixed order; lane 0 is their only writer
  // in the warp's row (in-bracket slots lie in [1, nbins])
  const int below = warp_sum(t.below);
  const int above = warp_sum(t.above);
  const float mbelow = warp_sum(t.mbelow);
  const float mabove = warp_sum(t.mabove);
  if (lane == 0) {
    wrow[0] = mbelow;
    wrow[nslots - 1] = mabove;
    if (below) atomicAdd(&hist[0], below);
    if (above) atomicAdd(&hist[nslots - 1], above);
  }
  __syncthreads();
  float* out = mass + (row * gridDim.x + blockIdx.x) * nslots;
  int* c = cnt + row * nslots;
  for (int s = threadIdx.x; s < nslots; s += blockDim.x) {
    float m = 0.f;
    for (int wp = 0; wp < nwarps; ++wp) m += rows[wp * nslots + s];
    out[s] = m;
    if (hist[s]) atomicAdd(&c[s], hist[s]);
  }
}

template <typename T, typename W>
int wlaunch(const void* x, const void* w, const void* edges, void* cnt,
            void* mass, long long rows, long long n, int nedges, int nblk,
            int warps, void* stream) {
  const int nslots = nedges + 1;
  const size_t smem =
      (size_t)(nedges + warps * nslots + warps * 32 + nslots) * 4;
  const auto kernel = whist_batched_kernel<T, W>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)nblk, (unsigned)rows);
  kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const float*>(edges), static_cast<int*>(cnt),
      static_cast<float*>(mass), n, nedges);
  return (int)cudaGetLastError();
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

// Weighted leg, one entry per (x, w) type pair: `cnt` must be zeroed by the
// caller; `mass` (rows, nblk, nbins+2) is written whole; `warps` warps per
// block.  Returns the first non-zero CUDA error code of the set-up or the
// launch, else 0.
#define WHIST_BATCHED(XN, XT, WN, WT)                                        \
  extern "C" int whist_batched_##XN##_##WN(                                  \
      const void* x, const void* w, const void* edges, void* cnt,            \
      void* mass, long long rows, long long n, int nedges, int nblk,         \
      int warps, void* stream) {                                             \
    return wlaunch<XT, WT>(x, w, edges, cnt, mass, rows, n, nedges, nblk,    \
                           warps, stream);                                   \
  }
WHIST_BATCHED(f32, float, f32, float)
WHIST_BATCHED(f32, float, bf16, __nv_bfloat16)
WHIST_BATCHED(bf16, __nv_bfloat16, f32, float)
WHIST_BATCHED(bf16, __nv_bfloat16, bf16, __nv_bfloat16)

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
