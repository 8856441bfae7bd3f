// K3: one shared array binned against K realized edge ladders in one read.
//
// Replaces the TPU kernel src/repro/kernels/cp_objective.py
// `_hist_kernel_multi` (tile math `_bin_tile`) on all four of its legs:
// - counting leg (K3): x (n,) f32 or bf16, edges (K, nbins+1) f32, out int32
//   counts (K, nbins+2);
// - counting leg with per-slot sums (K3s, `want_sums`, the polish input):
//   the counts and per-block f32 slot sums of x (nblk, K, nbins+2), summed
//   over blocks by the wrapper;
// - weighted leg (K3w): x and w (n,), each f32 or bf16 -> the int32 counts
//   and per-block f32 slot masses (nblk, K, nbins+2);
// - weighted leg with per-slot sums (K3ws): the counts and per-block f32
//   slot masses and sums of w*x (nblk, K, 2, nbins+2).
// Slot layout per ladder as K1 (`hist_batched.cu`): slot 0 is x <= e_0
// (with -inf), slot j is e_{j-1} < x <= e_j, slot nbins+1 is x > e_nbins
// and NaN, exactly what the plain versions
// `kernels/ref.py:cp_histogram_multi_ref` / `wcp_histogram_multi_ref`
// compute ladder by ladder.
//
// Bound on an H100 SXM: one read of x (4 bytes per f32 element, 2 per
// bf16), and of w on the weighted leg: 512 MiB (1 GiB with f32 weights) at
// n = 2^27 against 3.35 TB/s is 0.16 ms (0.32 ms).  Per element and
// distinct ladder the work is two compares (and two selected adds of the
// weight), plus a binary search over the shared-memory edges (8 steps at
// nbins = 128) for in-bracket elements.
//
// Design, counting leg:
// - a block holds G ladders (G in {1, 2, 4, 8, 16}, a template parameter:
//   the smallest that covers K up to 16, halved while G ladders' edges and
//   (nbins+2)-slot histograms overflow the 48 KB of shared memory a block
//   gets without opting in; one ladder past that opts in).  K > G splits
//   into groups along grid.y, and each group reads x again (x is read
//   ceil(K / G) times: once for K <= 16 at nbins = 128);
// - the meeting of an element and a ladder is branch-free: one compare
//   adds to the ladder's slot-0 count in a register (compile-time index,
//   G unrolled), a second sets the ladder's bit in the element's in-bracket
//   mask.  Only the set bits take a binary search and a shared-memory
//   atomic, after all ladders are compared.  The top slot (x > e_nbins and
//   NaN) needs no count: it is what the block read less the other slots;
// - a ladder that equals an earlier ladder of its group edge for edge (the
//   first sweep gives every target the same bracket [min, max]) is binned
//   once: its counts are copied from the first such ladder at the flush;
// - each block strides over x with 64-bit offsets, four independent loads
//   in flight per thread;
// - the kernel only COMPARES against the realized edges; integer atomics
//   flush each block's histograms into the zeroed output, so the counts do
//   not depend on the order of blocks.
// Design, legs with f32 slot rows (K3w, K3s, K3ws; one kernel specialized on
// what an element adds: w, x, or the pair w and w*x, as in K1).  The masses
// decide every narrowing step and the sums place the polish cut, so both
// are summed in an order fixed by n and the launch shape alone, never with
// float atomics:
// - each ladder's slot-0 and top-slot row values go to per-thread registers
//   beside the slot-0 count (the top slot's mass and sum are accumulated,
//   not subtracted: a difference of f32 sums is not the sum; the counts
//   keep the subtraction).  That is two registers per ladder and row, so
//   K3ws holds 2 * 2 * G more than K3's compare loop;
// - w*x is formed with __fmul_rn, so that no product is contracted into a
//   sum;
// - in-bracket elements go to per-warp f32 rows (one per ladder) in shared
//   memory, grouped by (ladder, slot) with __match_any_sync as in K1's
//   weighted leg: each lane takes the lowest ladder it is still inside per
//   round, and the group's lowest lane sums the weights in lane order and
//   is the row entry's only writer.  The loops are warp-uniform;
// - the block sums its warps' rows in warp order and writes one partial per
//   ladder; a repeated ladder copies its first twin's partial (the same
//   elements and weights);
// - the per-warp rows take G * (nbins+2) * 4 bytes per warp and row (66 KB
//   for 8 warps at G = 16, 128 bins, one row; K3ws interleaves its (mass,
//   sum) pair per (ladder, slot), twice that): the block opts in past
//   48 KB, up to 227 KB, and the wrapper halves first the group, then the
//   warps per block, until the block fits (8192 bins: one ladder, four
//   warps with one row, two with two);
// - the wrapper picks the block count from n alone and reduces the partials
//   over blocks in a fixed order.
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

// Compares the U values v with every binned ladder of the block (bit j of
// `binned`; bracket (lo[j], hi[j])): slot-0 hits add to below[j], in-bracket
// hits set bit j of inside[u].
template <int G, int U>
__device__ __forceinline__ void compare(const float (&v)[U], unsigned binned,
                                        const float (&lo)[G],
                                        const float (&hi)[G],
                                        int (&below)[G],
                                        unsigned (&inside)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) inside[u] = 0;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (!((binned >> j) & 1u)) continue;  // uniform over the block
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool le_lo = v[u] <= lo[j];
      below[j] += le_lo;
      inside[u] |= (unsigned)(!le_lo && v[u] <= hi[j]) << j;
    }
  }
}

// slot of an in-bracket v in one ladder: count(e < v), known to lie in
// [1, nedges - 1]
__device__ __forceinline__ int search(float v, const float* e, int nedges) {
  int s = 1, t = nedges - 1;  // invariant: e[s-1] < v <= e[t]
  while (s < t) {
    const int m = (s + t) >> 1;
    if (e[m] < v) s = m + 1; else t = m;
  }
  return s;
}

// Slots v into each ladder whose bit is set in `mask` (ladder j at
// e + j * nedges).
__device__ __forceinline__ void slot_inside(float v, unsigned mask,
                                            const float* e, int* hist,
                                            int nedges) {
  while (mask) {
    const int j = __ffs(mask) - 1;
    mask &= mask - 1;
    atomicAdd(&hist[j * (nedges + 1) + search(v, e + j * nedges, nedges)],
              1);
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
hist_multi_kernel(const T* __restrict__ x, const float* __restrict__ edges,
                  int* __restrict__ cnt, long long n, int nladders,
                  int nedges) {
  extern __shared__ float smem[];
  __shared__ int rep[G];  // ladder j is binned as ladder rep[j]
  __shared__ int total;   // elements this block read
  const int nslots = nedges + 1;
  const int first = blockIdx.y * G;
  const int nl = min(G, nladders - first);
  float* e = smem;                                          // G * nedges
  int* hist = reinterpret_cast<int*>(smem + G * nedges);    // G * nslots
  for (int i = threadIdx.x; i < nl * nedges; i += blockDim.x)
    e[i] = edges[(long long)first * nedges + i];
  for (int i = threadIdx.x; i < nl * nslots; i += blockDim.x) hist[i] = 0;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  if (threadIdx.x < nl) {
    const int j = threadIdx.x;
    int r = j;
    for (int p = 0; p < j && r == j; ++p) {
      bool same = true;
      for (int s = 0; s < nedges && same; ++s)
        same = e[p * nedges + s] == e[j * nedges + s];
      if (same) r = p;
    }
    rep[j] = r;
  }
  __syncthreads();
  unsigned binned = 0;  // bit j: ladder j exists and is the first of its kind
  float lo[G], hi[G];
  int below[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const bool b = j < nl && rep[j] == j;
    binned |= (unsigned)b << j;
    lo[j] = b ? e[j * nedges] : 0.f;
    hi[j] = b ? e[j * nedges + nedges - 1] : 0.f;
    below[j] = 0;
  }

  int seen = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    float v[kUnroll];
    unsigned inside[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = to_f32(x[i + u * stride]);
    compare<G, kUnroll>(v, binned, lo, hi, below, inside);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      slot_inside(v[u], inside[u], e, hist, nedges);
    seen += kUnroll;
  }
  for (; i < n; i += stride) {
    const float v[1] = {to_f32(x[i])};
    unsigned inside[1];
    compare<G, 1>(v, binned, lo, hi, below, inside);
    slot_inside(v[0], inside[0], e, hist, nedges);
    ++seen;
  }

  const int lane = threadIdx.x & 31;
  seen = warp_sum(seen);
  if (lane == 0) atomicAdd(&total, seen);
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (!((binned >> j) & 1u)) continue;
    const int b = warp_sum(below[j]);
    if (lane == 0 && b) atomicAdd(&hist[j * nslots], b);
  }
  __syncthreads();
  if (threadIdx.x < nl && rep[threadIdx.x] == threadIdx.x) {
    int* hj = hist + threadIdx.x * nslots;
    int counted = 0;
    for (int s = 0; s < nslots - 1; ++s) counted += hj[s];
    hj[nslots - 1] = total - counted;  // x > e_nbins, or NaN
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nl * nslots; k += blockDim.x) {
    const int j = k / nslots;
    const int s = k - j * nslots;
    const int c = hist[rep[j] * nslots + s];
    if (c) atomicAdd(&cnt[(long long)(first + j) * nslots + s], c);
  }
}

template <typename T, int G>
int launch_group(const void* x, const void* edges, void* cnt, long long n,
                 int nladders, int nedges, void* stream) {
  const size_t smem = (size_t)G * (2 * nedges + 1) * sizeof(float);
  const auto kernel = hist_multi_kernel<T, G>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  // one resident wave over all groups; integer atomics make the counts
  // independent of the block count, so it may follow the card
  const int groups = (nladders + G - 1) / G;
  const long long per_block = (long long)kThreads * kUnroll;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1) / groups;
  if (blocks > (n + per_block - 1) / per_block)
    blocks = (n + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned)blocks, (unsigned)groups);
  hist_multi_kernel<T, G><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(edges),
      static_cast<int*>(cnt), n, nladders, nedges);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* edges, void* cnt, long long n,
           int nladders, int nedges, int group, void* stream) {
  switch (group) {
    case 1: return launch_group<T, 1>(x, edges, cnt, n, nladders, nedges,
                                      stream);
    case 2: return launch_group<T, 2>(x, edges, cnt, n, nladders, nedges,
                                      stream);
    case 4: return launch_group<T, 4>(x, edges, cnt, n, nladders, nedges,
                                      stream);
    case 8: return launch_group<T, 8>(x, edges, cnt, n, nladders, nedges,
                                      stream);
    case 16: return launch_group<T, 16>(x, edges, cnt, n, nladders, nedges,
                                        stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Legs with f32 slot rows: weighted (K3w), per-slot sums (K3s, K3ws)
// ---------------------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;

// What an element adds to its slot's f32 rows besides its count, as in K1
// (`hist_batched.cu`): its weight w (K3w), its value x (K3s), or w and w*x
// (K3ws); kRows[L] rows per slot, interleaved per (ladder, slot).
enum Leg { kMass = 0, kSum = 1, kMassSum = 2 };
template <int L> struct LegRows { static constexpr int n = L == kMassSum ? 2 : 1; };

// The row values of one element; an absent element carries zeros.  The
// product is rounded on its own (__fmul_rn): no w*x is contracted into a
// sum.
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

// As `compare`, and each binned ladder's slot-0 and top-slot row values in
// registers (accumulated, never a difference: a difference of f32 sums is
// not the sum).  A lane with no element brings v = NaN and zero row
// values: it adds 0 to a top slot and nothing elsewhere, and the block's
// element count (which gives the top counts) does not include it.
template <int G, int U, int R>
__device__ __forceinline__ void wcompare(const float (&v)[U],
                                         const float (&p)[U][R],
                                         unsigned binned,
                                         const float (&lo)[G],
                                         const float (&hi)[G],
                                         int (&below)[G],
                                         float (&pbelow)[G][R],
                                         float (&pabove)[G][R],
                                         unsigned (&inside)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) inside[u] = 0;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (!((binned >> j) & 1u)) continue;  // uniform over the block
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool le_lo = v[u] <= lo[j];
      const bool le_hi = v[u] <= hi[j];
      below[j] += le_lo;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        pbelow[j][c] += le_lo ? p[u][c] : 0.f;
        pabove[j][c] += le_hi ? 0.f : p[u][c];
      }
      inside[u] |= (unsigned)(!le_lo && le_hi) << j;
    }
  }
}

// The warp's in-bracket step for one element per lane.  Round by round,
// each lane takes the lowest ladder it is still inside and finds its slot
// there; lanes with the same (ladder, slot) key form a group, whose lowest
// lane adds the group's row values, each row summed in lane order, to that
// entry of the warp's rows and the group's size to the block's counts.
// The rounds are as many as the most ladders one element of the warp is
// inside (one in a narrow sweep), not as many as the ladders the warp
// meets.  Every lane of the warp must call it.
template <int R>
__device__ __forceinline__ void warp_inside(float v, const float (&p)[R],
                                            unsigned inside, const float* e,
                                            int nedges, float* rows,
                                            float* stage, int* hist,
                                            int lane) {
  const int nslots = nedges + 1;
  if (!__any_sync(kFull, inside != 0)) return;  // uniform over the warp
#pragma unroll
  for (int c = 0; c < R; ++c) stage[c * 32 + lane] = p[c];
  __syncwarp();
  do {
    int key = -1;
    if (inside) {
      const int j = __ffs(inside) - 1;
      inside &= inside - 1;
      key = j * nslots + search(v, e + j * nedges, nedges);
    }
    const unsigned grp = __match_any_sync(kFull, key);
    if (key >= 0 && lane == __ffs(grp) - 1) {
#pragma unroll
      for (int c = 0; c < R; ++c) {
        float acc = 0.f;
        for (unsigned m = grp; m; m &= m - 1)
          acc += stage[c * 32 + __ffs(m) - 1];
        rows[key * R + c] += acc;
      }
      atomicAdd(&hist[key], __popc(grp));
    }
  } while (__any_sync(kFull, inside != 0));
  __syncwarp();
}

// K3w / K3s / K3ws.  `w` is not read on the K3s leg (it may be null).
template <typename T, typename W, int G, int L>
__global__ void __launch_bounds__(kThreads)
whist_multi_kernel(const T* __restrict__ x, const W* __restrict__ w,
                   const float* __restrict__ edges, int* __restrict__ cnt,
                   float* __restrict__ part, long long n, int nladders,
                   int nedges) {
  constexpr int R = LegRows<L>::n;
  extern __shared__ float smem[];
  __shared__ int rep[G];  // ladder j is binned as ladder rep[j]
  __shared__ int total;   // elements this block read
  const int nslots = nedges + 1;
  const int nwarps = blockDim.x >> 5;
  const int first = blockIdx.y * G;
  const int nl = min(G, nladders - first);
  float* e = smem;                                  // G * nedges
  float* rows = e + G * nedges;                     // nwarps * G * nslots * R
  float* stage = rows + nwarps * G * nslots * R;    // nwarps * 32 * R
  int* hist = reinterpret_cast<int*>(stage + nwarps * 32 * R);  // G * nslots
  for (int i = threadIdx.x; i < nl * nedges; i += blockDim.x)
    e[i] = edges[(long long)first * nedges + i];
  for (int i = threadIdx.x; i < nwarps * G * nslots * R; i += blockDim.x)
    rows[i] = 0.f;
  for (int i = threadIdx.x; i < nl * nslots; i += blockDim.x) hist[i] = 0;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  if (threadIdx.x < nl) {
    const int j = threadIdx.x;
    int r = j;
    for (int p = 0; p < j && r == j; ++p) {
      bool same = true;
      for (int s = 0; s < nedges && same; ++s)
        same = e[p * nedges + s] == e[j * nedges + s];
      if (same) r = p;
    }
    rep[j] = r;
  }
  __syncthreads();
  unsigned binned = 0;  // bit j: ladder j exists and is the first of its kind
  float lo[G], hi[G], pbelow[G][R], pabove[G][R];
  int below[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const bool b = j < nl && rep[j] == j;
    binned |= (unsigned)b << j;
    lo[j] = b ? e[j * nedges] : 0.f;
    hi[j] = b ? e[j * nedges + nedges - 1] : 0.f;
    below[j] = 0;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      pbelow[j][c] = 0.f;
      pabove[j][c] = 0.f;
    }
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* wrows = rows + warp * G * nslots * R;
  float* wstage = stage + warp * 32 * R;
  int seen = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; __all_sync(kFull, i + (kUnroll - 1) * stride < n);
       i += kUnroll * stride) {
    float v[kUnroll], p[kUnroll][R];
    unsigned inside[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = to_f32(x[i + u * stride]);
      payload<L>(v[u], L == kSum ? 0.f : to_f32(w[i + u * stride]), true,
                 p[u]);
    }
    wcompare<G, kUnroll, R>(v, p, binned, lo, hi, below, pbelow, pabove,
                            inside);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      warp_inside<R>(v[u], p[u], inside[u], e, nedges, wrows, wstage, hist,
                     lane);
    seen += kUnroll;
  }
  for (; __any_sync(kFull, i < n); i += stride) {
    const bool valid = i < n;
    const float v[1] = {valid ? to_f32(x[i]) : __int_as_float(0x7fc00000)};
    float p[1][R];
    payload<L>(v[0], valid && L != kSum ? to_f32(w[i]) : 0.f, valid, p[0]);
    unsigned inside[1];
    wcompare<G, 1, R>(v, p, binned, lo, hi, below, pbelow, pabove, inside);
    warp_inside<R>(v[0], p[0], inside[0], e, nedges, wrows, wstage, hist,
                   lane);
    seen += valid;
  }

  // the end slots, reduced in a fixed order; lane 0 is their only writer in
  // the warp's rows (in-bracket slots lie in [1, nbins])
  seen = warp_sum(seen);
  if (lane == 0) atomicAdd(&total, seen);
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (!((binned >> j) & 1u)) continue;
    const int b = warp_sum(below[j]);
    if (lane == 0 && b) atomicAdd(&hist[j * nslots], b);
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const float pb = warp_sum(pbelow[j][c]);
      const float pa = warp_sum(pabove[j][c]);
      if (lane == 0) {
        wrows[j * nslots * R + c] = pb;
        wrows[(j * nslots + nslots - 1) * R + c] = pa;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < nl && rep[threadIdx.x] == threadIdx.x) {
    int* hj = hist + threadIdx.x * nslots;
    int counted = 0;
    for (int s = 0; s < nslots - 1; ++s) counted += hj[s];
    hj[nslots - 1] = total - counted;  // x > e_nbins, or NaN
  }
  __syncthreads();
  // this block's partials: per ladder R rows of nslots, summed over warps
  // in order; a repeated ladder copies its first twin's
  for (int k = threadIdx.x; k < nl * nslots; k += blockDim.x) {
    const int j = k / nslots;
    const int s = k - j * nslots;
    const int r = rep[j] * nslots + s;
    if (hist[r]) atomicAdd(&cnt[(long long)(first + j) * nslots + s], hist[r]);
    float* out = part + ((long long)blockIdx.x * nladders + first + j) * R *
                            nslots + s;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      float m = 0.f;
      for (int wp = 0; wp < nwarps; ++wp)
        m += rows[(wp * G * nslots + r) * R + c];
      out[c * nslots] = m;
    }
  }
}

template <typename T, typename W, int G, int L>
int wlaunch_group(const void* x, const void* w, const void* edges, void* cnt,
                  void* part, long long n, int nladders, int nedges, int nblk,
                  int warps, void* stream) {
  constexpr int R = LegRows<L>::n;
  const int nslots = nedges + 1;
  const size_t smem = (size_t)(G * nedges + warps * G * nslots * R +
                               warps * 32 * R + G * nslots) * 4;
  const auto kernel = whist_multi_kernel<T, W, G, L>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)nblk, (unsigned)((nladders + G - 1) / G));
  kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const float*>(edges), static_cast<int*>(cnt),
      static_cast<float*>(part), n, nladders, nedges);
  return (int)cudaGetLastError();
}

template <typename T, typename W, int L>
int wlaunch(const void* x, const void* w, const void* edges, void* cnt,
            void* part, long long n, int nladders, int nedges, int group,
            int nblk, int warps, void* stream) {
  switch (group) {
    case 1: return wlaunch_group<T, W, 1, L>(x, w, edges, cnt, part, n,
                                             nladders, nedges, nblk, warps,
                                             stream);
    case 2: return wlaunch_group<T, W, 2, L>(x, w, edges, cnt, part, n,
                                             nladders, nedges, nblk, warps,
                                             stream);
    case 4: return wlaunch_group<T, W, 4, L>(x, w, edges, cnt, part, n,
                                             nladders, nedges, nblk, warps,
                                             stream);
    case 8: return wlaunch_group<T, W, 8, L>(x, w, edges, cnt, part, n,
                                             nladders, nedges, nblk, warps,
                                             stream);
    case 16: return wlaunch_group<T, W, 16, L>(x, w, edges, cnt, part, n,
                                               nladders, nedges, nblk, warps,
                                               stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace


// `cnt` must be zeroed by the caller (the blocks add into it).  `group`
// (1, 2, 4, 8 or 16) ladders share a block.  Returns the first non-zero
// CUDA error code of the set-up or the launch, else 0.
extern "C" int hist_multi_f32(const void* x, const void* edges, void* cnt,
                              long long n, int nladders, int nedges,
                              int group, void* stream) {
  return launch<float>(x, edges, cnt, n, nladders, nedges, group, stream);
}

extern "C" int hist_multi_bf16(const void* x, const void* edges, void* cnt,
                               long long n, int nladders, int nedges,
                               int group, void* stream) {
  return launch<__nv_bfloat16>(x, edges, cnt, n, nladders, nedges, group,
                               stream);
}

// Weighted leg (K3w), one entry per (x, w) type pair: `cnt` must be zeroed
// by the caller; `mass` (nblk, K, nbins+2) is written whole; `group` (1, 2,
// 4, 8 or 16) ladders and `warps` warps share a block.  Returns the first
// non-zero CUDA error code of the set-up or the launch, else 0.
#define WHIST_MULTI(XN, XT, WN, WT)                                          \
  extern "C" int whist_multi_##XN##_##WN(                                    \
      const void* x, const void* w, const void* edges, void* cnt,            \
      void* mass, long long n, int nladders, int nedges, int group,          \
      int nblk, int warps, void* stream) {                                   \
    return wlaunch<XT, WT, kMass>(x, w, edges, cnt, mass, n, nladders,       \
                                  nedges, group, nblk, warps, stream);       \
  }
WHIST_MULTI(f32, float, f32, float)
WHIST_MULTI(f32, float, bf16, __nv_bfloat16)
WHIST_MULTI(bf16, __nv_bfloat16, f32, float)
WHIST_MULTI(bf16, __nv_bfloat16, bf16, __nv_bfloat16)

// Counting leg with per-slot sums (K3s): `cnt` must be zeroed by the
// caller; `sums` (nblk, K, nbins+2) f32 sums of x is written whole.
extern "C" int shist_multi_f32(const void* x, const void* edges, void* cnt,
                               void* sums, long long n, int nladders,
                               int nedges, int group, int nblk, int warps,
                               void* stream) {
  return wlaunch<float, float, kSum>(x, nullptr, edges, cnt, sums, n,
                                     nladders, nedges, group, nblk, warps,
                                     stream);
}

extern "C" int shist_multi_bf16(const void* x, const void* edges, void* cnt,
                                void* sums, long long n, int nladders,
                                int nedges, int group, int nblk, int warps,
                                void* stream) {
  return wlaunch<__nv_bfloat16, float, kSum>(x, nullptr, edges, cnt, sums, n,
                                             nladders, nedges, group, nblk,
                                             warps, stream);
}

// Weighted leg with per-slot sums (K3ws): `part` (nblk, K, 2, nbins+2)
// holds each block's f32 masses (row 0) and sums of w*x (row 1).
#define WSHIST_MULTI(XN, XT, WN, WT)                                         \
  extern "C" int wshist_multi_##XN##_##WN(                                   \
      const void* x, const void* w, const void* edges, void* cnt,            \
      void* part, long long n, int nladders, int nedges, int group,          \
      int nblk, int warps, void* stream) {                                   \
    return wlaunch<XT, WT, kMassSum>(x, w, edges, cnt, part, n, nladders,    \
                                     nedges, group, nblk, warps, stream);    \
  }
WSHIST_MULTI(f32, float, f32, float)
WSHIST_MULTI(f32, float, bf16, __nv_bfloat16)
WSHIST_MULTI(bf16, __nv_bfloat16, f32, float)
WSHIST_MULTI(bf16, __nv_bfloat16, bf16, __nv_bfloat16)

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
