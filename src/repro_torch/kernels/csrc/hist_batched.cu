// K1: row-batched slot histogram against realized bin edges.
//
// Replaces the TPU kernel src/repro/kernels/cp_objective.py
// `_hist_kernel_batched` (tile math `_bin_tile`) on all four of its legs:
// - counting leg (K1): x (B, n) f32 or bf16, edges (B, nbins+1) f32, out
//   int32 counts (B, nbins+2);
// - counting leg with per-slot sums (K1s, `want_sums`, the polish input):
//   the counts and per-block f32 slot sums of x (B, nblk, nbins+2), summed
//   over blocks by the wrapper;
// - weighted leg (K1w): x and w (B, n), each f32 or bf16 -> the int32
//   counts and per-block f32 slot masses (B, nblk, nbins+2);
// - weighted leg with per-slot sums (K1ws): the counts and per-block f32
//   slot masses and sums of w*x (B, nblk, 2, nbins+2).
// Slot layout: slot 0 is x <= e_0 (with -inf), slot j is e_{j-1} < x <= e_j,
// slot nbins+1 is x > e_nbins and NaN — exactly `searchsorted(edges, x,
// side='left')` with NaN pinned to the top slot, as the plain versions
// `kernels/ref.py:cp_histogram_batched_ref` / `wcp_histogram_batched_ref`
// compute it (so a NaN makes the top slot's sum NaN, a -inf slot 0's -inf).
//
// Bound on an H100 SXM: memory.  One sweep reads x once (4 bytes per f32
// element, 2 per bf16), and w once on the weighted legs: 512 MiB (1 GiB with
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
// Design, legs with f32 slot rows (K1w, K1s, K1ws; one kernel specialized on
// what an element adds: w, x, or the pair w and w*x).  The masses decide
// every narrowing step and the sums place the polish cut, so both are summed
// in an order fixed by n and the launch shape alone, never with float
// atomics:
// - out-of-bracket row values go to per-thread registers, beside the counts
//   (the top slot's sum is accumulated, not derived: a sum allows no
//   subtraction);
// - in-bracket elements go to per-warp f32 rows in shared memory: in each
//   step the lanes that share a slot are grouped with __match_any_sync, the
//   group's lowest lane sums their values in lane order, row by row, and
//   adds the sums to the warp's rows — one writer per row entry, no atomic.
//   The loops are warp-uniform (a lane past the end takes part with no
//   element), so the whole warp meets at every grouping;
// - K1ws keeps one (mass, sum) pair per slot, interleaved in one row of
//   shared memory rather than two rows: the group leader writes both at
//   the same moment, so one address serves both stores, and the block's
//   reduce reads them side by side;
// - w*x is formed with __fmul_rn, so that no product is contracted into a
//   sum;
// - after the loop the block sums its warps' rows in warp order and writes
//   one partial per row; the wrapper picks the block count from n alone and
//   reduces the partials over blocks in a fixed order;
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
// Legs with f32 slot rows: weighted (K1w), per-slot sums (K1s, K1ws)
// ---------------------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;

// What an element adds to its slot's f32 rows besides its count: its
// weight w (K1w), its value x (K1s, the counting leg's sums), or w and
// w*x (K1ws).  kRows[L] rows per slot, interleaved per slot in shared
// memory (one (mass, sum) pair per slot on K1ws).
enum Leg { kMass = 0, kSum = 1, kMassSum = 2 };
template <int L> struct LegRows { static constexpr int n = L == kMassSum ? 2 : 1; };

// The row values of one element; an absent element (a lane past the end)
// carries zeros.  The product is rounded on its own (__fmul_rn), so that no
// w*x is contracted into a sum.
template <int L>
__device__ __forceinline__ void payload(float v, float wv, bool valid,
                                        float (&p)[LegRows<L>::n]) {
  if (L == kMass) p[0] = valid ? wv : 0.f;
  if (L == kSum) p[0] = valid ? v : 0.f;
  if (L == kMassSum) {
    p[0] = valid ? wv : 0.f;
    p[LegRows<L>::n - 1] = valid ? __fmul_rn(wv, v) : 0.f;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

// The warp's in-bracket step: each lane brings its slot s (-1 when its
// element is outside the bracket or absent) and its row values p; lanes
// with one slot form a group, whose lowest lane adds the group's values,
// each row summed in lane order, to the warp's rows and the group's size to
// the block's counts.  Every lane of the warp must call it.
template <int R>
__device__ __forceinline__ void warp_slot_add(int s, const float (&p)[R],
                                              float* row, float* stage,
                                              int* hist, int lane) {
  if (!__any_sync(kFull, s >= 0)) return;  // uniform over the warp
#pragma unroll
  for (int c = 0; c < R; ++c) stage[c * 32 + lane] = p[c];
  const unsigned grp = __match_any_sync(kFull, s);
  __syncwarp();
  if (s >= 0 && lane == __ffs(grp) - 1) {
#pragma unroll
    for (int c = 0; c < R; ++c) {
      float acc = 0.f;
      for (unsigned m = grp; m; m &= m - 1) acc += stage[c * 32 + __ffs(m) - 1];
      row[s * R + c] += acc;
    }
    atomicAdd(&hist[s], __popc(grp));
  }
  __syncwarp();
}

template <int R>
struct EndSlots {  // this thread's out-of-bracket counts and row values
  int below = 0, above = 0;
  float pbelow[R] = {}, pabove[R] = {};
};

template <int L>
__device__ __forceinline__ void wbin_one(float v, float wv, bool valid,
                                         const float* e, int nedges,
                                         float* row, float* stage, int* hist,
                                         int lane,
                                         EndSlots<LegRows<L>::n>& t) {
  constexpr int R = LegRows<L>::n;
  float p[R];
  payload<L>(v, wv, valid, p);
  int s = -1;
  if (valid) {
    if (v <= e[0]) {
      ++t.below;
#pragma unroll
      for (int c = 0; c < R; ++c) t.pbelow[c] += p[c];
    } else if (!(v <= e[nedges - 1])) {  // v > e_nbins, or NaN
      ++t.above;
#pragma unroll
      for (int c = 0; c < R; ++c) t.pabove[c] += p[c];
    } else {
      s = search(v, e, nedges);
    }
  }
  warp_slot_add<R>(s, p, row, stage, hist, lane);
}

// K1w / K1s / K1ws.  `w` is not read on the K1s leg (it may be null).
template <typename T, typename W, int L>
__global__ void __launch_bounds__(kThreads)
whist_batched_kernel(const T* __restrict__ x, const W* __restrict__ w,
                     const float* __restrict__ edges, int* __restrict__ cnt,
                     float* __restrict__ part, long long n, int nedges) {
  constexpr int R = LegRows<L>::n;
  extern __shared__ float smem[];
  const int nslots = nedges + 1;
  const int nwarps = blockDim.x >> 5;
  float* e = smem;                                  // nedges
  float* rows = e + nedges;                         // nwarps * nslots * R
  float* stage = rows + nwarps * nslots * R;        // nwarps * 32 * R
  int* hist = reinterpret_cast<int*>(stage + nwarps * 32 * R);  // nslots
  const long long row = blockIdx.y;
  for (int i = threadIdx.x; i < nedges; i += blockDim.x)
    e[i] = edges[row * nedges + i];
  for (int i = threadIdx.x; i < nwarps * nslots * R; i += blockDim.x)
    rows[i] = 0.f;
  for (int i = threadIdx.x; i < nslots; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* wrow = rows + warp * nslots * R;
  float* wstage = stage + warp * 32 * R;
  const T* xr = x + row * n;
  const W* wr = L == kSum ? nullptr : w + row * n;
  EndSlots<R> t;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; __all_sync(kFull, i + (kUnroll - 1) * stride < n);
       i += kUnroll * stride) {
    float v[kUnroll], wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = to_f32(xr[i + u * stride]);
      wv[u] = L == kSum ? 0.f : to_f32(wr[i + u * stride]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      wbin_one<L>(v[u], wv[u], true, e, nedges, wrow, wstage, hist, lane, t);
  }
  for (; __any_sync(kFull, i < n); i += stride) {
    const bool valid = i < n;
    wbin_one<L>(valid ? to_f32(xr[i]) : 0.f,
                valid && L != kSum ? to_f32(wr[i]) : 0.f, valid, e, nedges,
                wrow, wstage, hist, lane, t);
  }

  // the end slots, reduced in a fixed order; lane 0 is their only writer
  // in the warp's rows (in-bracket slots lie in [1, nbins])
  const int below = warp_sum(t.below);
  const int above = warp_sum(t.above);
#pragma unroll
  for (int c = 0; c < R; ++c) {
    const float pb = warp_sum(t.pbelow[c]);
    const float pa = warp_sum(t.pabove[c]);
    if (lane == 0) {
      wrow[c] = pb;
      wrow[(nslots - 1) * R + c] = pa;
    }
  }
  if (lane == 0) {
    if (below) atomicAdd(&hist[0], below);
    if (above) atomicAdd(&hist[nslots - 1], above);
  }
  __syncthreads();
  // this block's partial: R rows of nslots, summed over warps in order
  float* out = part + (row * gridDim.x + blockIdx.x) * R * nslots;
  int* c_out = cnt + row * nslots;
  for (int s = threadIdx.x; s < nslots; s += blockDim.x) {
#pragma unroll
    for (int c = 0; c < R; ++c) {
      float m = 0.f;
      for (int wp = 0; wp < nwarps; ++wp) m += rows[(wp * nslots + s) * R + c];
      out[c * nslots + s] = m;
    }
    if (hist[s]) atomicAdd(&c_out[s], hist[s]);
  }
}

template <typename T, typename W, int L>
int wlaunch(const void* x, const void* w, const void* edges, void* cnt,
            void* part, long long rows, long long n, int nedges, int nblk,
            int warps, void* stream) {
  constexpr int R = LegRows<L>::n;
  const int nslots = nedges + 1;
  const size_t smem = (size_t)(nedges + warps * nslots * R +
                               warps * 32 * R + nslots) * 4;
  const auto kernel = whist_batched_kernel<T, W, L>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)nblk, (unsigned)rows);
  kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const float*>(edges), static_cast<int*>(cnt),
      static_cast<float*>(part), n, nedges);
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

// Weighted leg (K1w), one entry per (x, w) type pair: `cnt` must be zeroed
// by the caller; `mass` (rows, nblk, nbins+2) is written whole; `warps`
// warps per block.  Returns the first non-zero CUDA error code of the set-up
// or the launch, else 0.
#define WHIST_BATCHED(XN, XT, WN, WT)                                        \
  extern "C" int whist_batched_##XN##_##WN(                                  \
      const void* x, const void* w, const void* edges, void* cnt,            \
      void* mass, long long rows, long long n, int nedges, int nblk,         \
      int warps, void* stream) {                                             \
    return wlaunch<XT, WT, kMass>(x, w, edges, cnt, mass, rows, n, nedges,   \
                                  nblk, warps, stream);                      \
  }
WHIST_BATCHED(f32, float, f32, float)
WHIST_BATCHED(f32, float, bf16, __nv_bfloat16)
WHIST_BATCHED(bf16, __nv_bfloat16, f32, float)
WHIST_BATCHED(bf16, __nv_bfloat16, bf16, __nv_bfloat16)

// Counting leg with per-slot sums (K1s): `cnt` must be zeroed by the
// caller; `sums` (rows, nblk, nbins+2) f32 sums of x is written whole.
extern "C" int shist_batched_f32(const void* x, const void* edges, void* cnt,
                                 void* sums, long long rows, long long n,
                                 int nedges, int nblk, int warps,
                                 void* stream) {
  return wlaunch<float, float, kSum>(x, nullptr, edges, cnt, sums, rows, n,
                                     nedges, nblk, warps, stream);
}

extern "C" int shist_batched_bf16(const void* x, const void* edges, void* cnt,
                                  void* sums, long long rows, long long n,
                                  int nedges, int nblk, int warps,
                                  void* stream) {
  return wlaunch<__nv_bfloat16, float, kSum>(x, nullptr, edges, cnt, sums,
                                             rows, n, nedges, nblk, warps,
                                             stream);
}

// Weighted leg with per-slot sums (K1ws): `part` (rows, nblk, 2, nbins+2)
// holds each block's f32 masses (row 0) and sums of w*x (row 1).
#define WSHIST_BATCHED(XN, XT, WN, WT)                                       \
  extern "C" int wshist_batched_##XN##_##WN(                                 \
      const void* x, const void* w, const void* edges, void* cnt,            \
      void* part, long long rows, long long n, int nedges, int nblk,         \
      int warps, void* stream) {                                             \
    return wlaunch<XT, WT, kMassSum>(x, w, edges, cnt, part, rows, n,        \
                                     nedges, nblk, warps, stream);           \
  }
WSHIST_BATCHED(f32, float, f32, float)
WSHIST_BATCHED(f32, float, bf16, __nv_bfloat16)
WSHIST_BATCHED(bf16, __nv_bfloat16, f32, float)
WSHIST_BATCHED(bf16, __nv_bfloat16, bf16, __nv_bfloat16)

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
