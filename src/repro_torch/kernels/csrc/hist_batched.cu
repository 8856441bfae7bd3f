// K1: row-batched slot histogram against realized bin edges.
//
// Replaces the TPU kernel src/repro/kernels/cp_objective.py
// `_hist_kernel_batched` (tile math `_bin_tile`) on all four of its legs:
// - counting leg (K1): x (B, n) f32 or bf16, edges (B, nbins+1) f32, out
//   int32 counts (B, nbins+2);
// - counting leg with per-slot sums (K1s, `want_sums`, the polish input):
//   the counts and per-block f32 slot sums of x (B, nblk, nbins+2), summed
//   over blocks by the wrapper (`sum_blocks.cu`);
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
// element the work is one or two compares, and for in-bracket elements a
// slot lookup and an add to the slot's count (and row).
//
// Every design only COMPARES against the row's realized edges, staged in
// shared memory: no lo + w*j ever decides a slot, so the counts agree with
// the engine's later `x <= e_j` narrowing and finalize comparisons.
// Elements outside the bracket (after the first sweep nearly all of them)
// are counted, and their row values summed, in per-thread registers.
//
// Two designs per leg, chosen by the wrapper (`cp_objective.
// hist_rows_layout`, a rule on the call): the lane-private one where the
// ladder's bracket holds every element (`full_bracket`, the engine's first
// sweep) and its tables fit a block, for K1w/K1s only on rows of at least
// 2^23 elements; the earlier one elsewhere.  On a narrow sweep nearly every
// element lies outside the bracket and costs two compares in any design;
// there the earlier designs, whose small blocks fill an SM, read faster,
// and on short rows their blocks start and finish faster.
//
// Lane-private (K1, K1w and K1s on first sweeps, at 128 bins, the
// engine's width on the card).  On the first sweep every element is in
// the bracket, and the earlier design's per-element binary search and
// shared atomics (K1) or warp-wide grouping by slot (K1w) set its pace:
// - each lane owns one column of its warp's [slot][32] tables: packed
//   16-bit counts, and on K1w/K1s an f32 row.  Lane = bank, so the adds
//   have no conflicts, no atomics and no warp collectives; a lane zeroes
//   its columns before its first in-bracket element, and the block reads
//   only the columns of lanes that had one;
// - a slot is guessed from the ladder's end points and then decided by the
//   realized edges, e_{g-1} < v <= e_g; on a miss (non-uniform, duplicated
//   or denormal ladders) a branch-free search over the edges, padded with
//   +inf to a power of two, finds it.  A batch is binned in phases: end
//   slots by selects, then every guess and its two edges, then the rare
//   searches, then the adds, so that the edge loads of a batch overlap;
// - K1 reads x in 16-byte packs (the elements before a row's first
//   16-byte boundary and after its last whole pack one each); K1w and K1s
//   read one element of x (and w) per load, element i of a row to thread
//   i mod (nblk * 256), so that the order of the f32 adds is a function of
//   n alone; each thread bins a batch while the next one loads;
// - 16-bit counts cannot carry: the grid gives no thread more than 65535
//   elements of a row (K1: a persistent grid of the blocks that fit on the
//   card; K1w/K1s: fg_blocks(n) blocks of 256 threads, at most 8192);
// - f32 rows in a fixed order: a lane adds its elements in its own order;
//   at the end, for each slot, one lane sums the warp's touched columns
//   starting at its own (an order set by the slot), the block sums its
//   warps in warp order and writes one partial per row; the end slots'
//   registers meet in a shuffle tree and then warps in order.  The
//   longest chain: a thread's elements, 32 columns, 8 warps, then the
//   wrapper's `sum_blocks` over fg_blocks(n) partials;
// - counts leave through integer atomics, exact in any order.
// At 128 bins K1 has no rows (67,080 bytes of shared memory a block of 8
// warps, three blocks an SM), K1w and K1s one f32 row (202,312 bytes, one
// block an SM).
//
// Shared histogram (K1 on other sweeps, and past the lane tables' width,
// e.g. 8192 bins): the earlier design — a binary search per in-bracket
// element and a shared int atomic into the block's histogram, opting in
// past 48 KB.
//
// Grouped rows (K1w/K1s on other sweeps and shorter rows, K1ws, whose two
// f32 rows per slot do not fit lane tables, and past the lane tables'
// width): the earlier design, one kernel specialized on what
// an element adds: w, x, or the pair w and w*x.  The masses decide every
// narrowing step and the sums place the polish cut, so both are summed in
// an order fixed by n and the launch shape alone, never with float atomics:
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
//   reduces the partials over blocks with `sum_blocks`, in an order set by
//   the block count alone;
// - counts keep the integer path: the group leader adds the group's size.
// Built without fast-math, so denormals are compared exactly (no flush).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;

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
// Grouped rows: K1ws, and K1w / K1s where the lane tables do not run
// ---------------------------------------------------------------------------

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
  const auto kernel = hist_batched_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)blocks_per_row, (unsigned)rows);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(edges),
      static_cast<int*>(cnt), n, nedges);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Lane-private design: K1, and K1w / K1s at ladders whose tables fit
// ---------------------------------------------------------------------------

// What a thread bins per batch while the next batch loads: K1 reads x in
// 16-byte packs, 8 elements (two packs of f32, one of bf16); K1w and K1s
// read x (and w) one element per load, 16 of each.
constexpr int kBatchCount = 8;
constexpr int kBatchRows = 16;

// What an in-bracket element adds besides its count: nothing (K1), its
// weight (K1w) or its value (K1s), to the f32 row of its slot.
enum LaneLeg { kLaneCount = 0, kLaneMass = 1, kLaneSum = 2 };

// A lane-private block's shared memory, in 4-byte words: the edges padded
// with +inf to a power of two (`pad`); per warp an f32 table of nbins rows
// of 32 columns (K1w, K1s); per warp a table of ceil(nbins / 2) rows of 32
// columns of packed 16-bit counts; per warp an f32 reduction row of
// nbins + 2 slots (K1w, K1s); the block's int counts, nbins + 2 slots.
// `cp_objective.lane_hist_smem` computes the same size.
struct LaneLayout {
  int pad, nb, nwords, nslots, warps, rows;
  __host__ __device__ LaneLayout(int nedges, int warps_, bool with_rows)
      : pad(1), nb(nedges - 1), nwords(nedges / 2), nslots(nedges + 1),
        warps(warps_), rows(with_rows ? 1 : 0) {
    while (pad < nedges) pad <<= 1;
  }
  __host__ __device__ size_t words() const {
    return (size_t)pad + (size_t)warps * 32 * (nb * rows + nwords) +
           (size_t)warps * nslots * rows + nslots;
  }
};

// A lane-private block: its shared areas, and this lane's columns.
struct LaneBlock {
  const float* e;  // edges, padded with +inf
  float* mtab;     // [warp][nb][32] f32 rows (K1w, K1s)
  unsigned* ctab;  // [warp][nwords][32] packed 16-bit counts
  float* wred;     // [warp][nslots] the warps' f32 sums (K1w, K1s)
  int* bh;         // [nslots] the block's counts
  float* mcol;     // this lane's column of its warp's f32 table
  unsigned* ccol;  // this lane's column of its warp's count table
  float e0, en;    // the bracket's ends, e[0] and e[nb]
  float h0, sc;    // the guess: g = ceil((v / 2 - h0) * sc)
  int nb, nwords, nslots, half, warps, warp, lane;
};

// Carves a lane-private block's shared memory and stages row `row`'s
// edges; the caller synchronizes before reading them.
template <bool kRows>
__device__ __forceinline__ LaneBlock lane_block(float* smem,
                                                const float* edges,
                                                long long row, int nedges) {
  const LaneLayout lay(nedges, blockDim.x >> 5, kRows);
  LaneBlock b;
  b.nb = lay.nb;
  b.nwords = lay.nwords;
  b.nslots = lay.nslots;
  b.half = lay.pad >> 1;
  b.warps = lay.warps;
  b.warp = threadIdx.x >> 5;
  b.lane = threadIdx.x & 31;
  float* e = smem;
  b.e = e;
  b.mtab = e + lay.pad;
  b.ctab = reinterpret_cast<unsigned*>(b.mtab + lay.warps * 32 * b.nb *
                                       lay.rows);
  b.wred = reinterpret_cast<float*>(b.ctab + lay.warps * 32 * b.nwords);
  b.bh = reinterpret_cast<int*>(b.wred + lay.warps * b.nslots * lay.rows);
  b.mcol = b.mtab + b.warp * 32 * b.nb + b.lane;
  b.ccol = b.ctab + b.warp * 32 * b.nwords + b.lane;
  for (int i = threadIdx.x; i < lay.pad; i += blockDim.x)
    e[i] = i < nedges ? edges[row * nedges + i] : __int_as_float(0x7f800000);
  for (int i = threadIdx.x; i < b.nslots; i += blockDim.x) b.bh[i] = 0;
  return b;
}

// After the caller's __syncthreads: the bracket's ends and the guess.
__device__ __forceinline__ void lane_ends(LaneBlock& b) {
  b.e0 = b.e[0];
  b.en = b.e[b.nb];
  b.h0 = 0.5f * b.e0;
  b.sc = (float)b.nb / (0.5f * b.en - b.h0);
}

// The largest j with e_j < v (e_0 < v <= e_nb), by a branch-free search
// over the padded edges: slot j + 1.
__device__ __forceinline__ int lane_search(float v, const float* e,
                                           int half) {
  int j = 0;
  for (int step = half; step > 0; step >>= 1)
    j = e[j + step] < v ? j + step : j;
  return j + 1;
}

struct LaneAcc {  // this thread's end slots, and whether it owns a column
  int below = 0, above = 0;
  float pbelow = 0.f, pabove = 0.f;
  bool mine = false;
};

// B elements v with row values p (unused on K1).  The end slots take
// selects, not branches (adding +0 leaves a sum that started at +0 as it
// was).  Only a batch with an in-bracket element goes on: the lane zeroes
// its columns before its first one; each such element's slot is guessed
// from the ladder's ends and taken only if the realized edges agree,
// e_{g-1} < v <= e_g (the B pairs of edges load together), else searched;
// then the elements add to the lane's columns in order.
template <int L, int B>
__device__ __forceinline__ void lane_batch(const float* v, const float* p,
                                           const LaneBlock& b, LaneAcc& a) {
  bool in[B];
  bool any = false;
#pragma unroll
  for (int u = 0; u < B; ++u) {
    const bool lo = v[u] <= b.e0;
    const bool hi = !(v[u] <= b.en);  // v > e_nbins, or NaN
    a.below += lo;
    a.above += hi;
    if (L != kLaneCount) {
      a.pbelow += lo ? p[u] : 0.f;
      a.pabove += hi ? p[u] : 0.f;
    }
    in[u] = !(lo || hi);
    any |= in[u];
  }
  if (!any) return;
  if (!a.mine) {
    a.mine = true;
    if (L != kLaneCount)
      for (int r = 0; r < b.nb; ++r) b.mcol[r * 32] = 0.f;
    for (int r = 0; r < b.nwords; ++r) b.ccol[r * 32] = 0u;
  }
  int g[B];
  float elo[B], ehi[B];
#pragma unroll
  for (int u = 0; u < B; ++u) {
    g[u] = min(max(__float2int_ru((0.5f * v[u] - b.h0) * b.sc), 1), b.nb);
    elo[u] = b.e[g[u] - 1];
    ehi[u] = b.e[g[u]];
  }
#pragma unroll
  for (int u = 0; u < B; ++u)
    if (in[u] && !((elo[u] < v[u]) & (v[u] <= ehi[u])))
      g[u] = lane_search(v[u], b.e, b.half);
#pragma unroll
  for (int u = 0; u < B; ++u) {
    if (in[u]) {
      const int r = g[u] - 1;
      if (L != kLaneCount) b.mcol[r * 32] += p[u];
      b.ccol[(r >> 1) * 32] += 1u << ((r & 1) << 4);
    }
  }
}

// The block's end: counts into `c_out` (atomics), and on K1w/K1s one f32
// partial into `out`.  The end slots' registers meet in a shuffle tree
// and then warps in order; for the in-bracket slots, lane l sums table
// rows l, l + 32, ... over the warp's touched columns from column l on
// (bit j of `rot` is column (l + j) mod 32), so each slot's order is set
// by the slot alone, then the block sums its warps in order.  Every
// thread of the block calls it.
template <bool kRows>
__device__ __forceinline__ void lane_flush(const LaneBlock& b,
                                           const LaneAcc& a, int* c_out,
                                           float* out) {
  const unsigned touched = __ballot_sync(kFull, a.mine);
  __syncwarp();
  const int below = warp_sum(a.below), above = warp_sum(a.above);
  const int last = b.nslots - 1;
  if (b.lane == 0) {
    if (below) atomicAdd(&b.bh[0], below);
    if (above) atomicAdd(&b.bh[last], above);
  }
  if (kRows) {
    const float pb = warp_sum(a.pbelow), pa = warp_sum(a.pabove);
    if (b.lane == 0) {
      b.wred[b.warp * b.nslots] = pb;
      b.wred[b.warp * b.nslots + last] = pa;
    }
  }
  const unsigned rot = __funnelshift_r(touched, touched, b.lane);
  for (int r = b.lane; r < b.nb; r += 32) {
    const float* mrow = b.mtab + (b.warp * b.nb + r) * 32;
    const unsigned* crow = b.ctab + (b.warp * b.nwords + (r >> 1)) * 32;
    const int shift = (r & 1) << 4;
    float m = 0.f;
    int c = 0;
    if (touched == kFull) {  // every column, unrolled (the first sweep)
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = (b.lane + j) & 31;
        if (kRows) m += mrow[col];
        c += (crow[col] >> shift) & 0xffffu;
      }
    } else {
      for (unsigned bits = rot; bits; bits &= bits - 1) {
        const int col = (b.lane + __ffs(bits) - 1) & 31;
        if (kRows) m += mrow[col];
        c += (crow[col] >> shift) & 0xffffu;
      }
    }
    if (kRows) b.wred[b.warp * b.nslots + r + 1] = m;
    if (c) atomicAdd(&b.bh[r + 1], c);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < b.nslots; s += blockDim.x) {
    if (kRows) {
      float m = 0.f;
      for (int wp = 0; wp < b.warps; ++wp) m += b.wred[wp * b.nslots + s];
      out[s] = m;
    }
    if (b.bh[s]) atomicAdd(&c_out[s], b.bh[s]);
  }
}

// 16 bytes of x as floats: 4 f32 or 8 bf16 (element 0 in the low bits).
__device__ __forceinline__ void unpack(const uint4& q, float (&f)[4]) {
  f[0] = __uint_as_float(q.x);
  f[1] = __uint_as_float(q.y);
  f[2] = __uint_as_float(q.z);
  f[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack(const uint4& q, float (&f)[8]) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// K1.  Each row is read as 16-byte packs from its first 16-byte boundary;
// the elements before it (the head) and after the last whole pack (the
// tail) are binned one each by the row's first threads.  A thread bins
// two packs of f32 or one of bf16 while its next ones load.
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
lane_count_kernel(const T* __restrict__ x, const float* __restrict__ edges,
                  int* __restrict__ cnt, long long n, int nedges) {
  constexpr int kPack = 16 / sizeof(T);
  constexpr int kPacks = kBatchCount / kPack;
  extern __shared__ float smem[];
  const long long row = blockIdx.y;
  const T* xr = x + row * n;
  const long long head = min(
      (long long)(((16 - ((size_t)xr & 15)) & 15) / sizeof(T)), n);
  const long long npack = (n - head) / kPack;
  const long long tail = head + npack * kPack;
  const uint4* body = reinterpret_cast<const uint4*>(xr + head);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long q = first;
  uint4 cur[kPacks];
  bool full = q + (kPacks - 1) * stride < npack;
  if (full) {  // the first loads fly while the edges are staged
#pragma unroll
    for (int k = 0; k < kPacks; ++k) cur[k] = __ldg(body + q + k * stride);
  }
  LaneBlock b = lane_block<false>(smem, edges, row, nedges);
  __syncthreads();
  lane_ends(b);
  LaneAcc a;
  while (full) {
    const long long next = q + kPacks * stride;
    const bool more = next + (kPacks - 1) * stride < npack;
    uint4 nxt[kPacks];
    if (more) {
#pragma unroll
      for (int k = 0; k < kPacks; ++k) nxt[k] = __ldg(body + next + k * stride);
    }
    float v[kBatchCount];
#pragma unroll
    for (int k = 0; k < kPacks; ++k) {
      float f[kPack];
      unpack(cur[k], f);
#pragma unroll
      for (int j = 0; j < kPack; ++j) v[k * kPack + j] = f[j];
    }
    lane_batch<kLaneCount, kBatchCount>(v, v, b, a);
#pragma unroll
    for (int k = 0; k < kPacks; ++k) cur[k] = nxt[k];
    q = next;
    full = more;
  }
  for (; q < npack; q += stride) {
    float f[kPack];
    unpack(__ldg(body + q), f);
    lane_batch<kLaneCount, kPack>(f, f, b, a);
  }
  if (first < head + (n - tail)) {
    const float v1[1] = {to_f32(xr[first < head ? first
                                                : tail + (first - head)])};
    lane_batch<kLaneCount, 1>(v1, v1, b, a);
  }
  lane_flush<false>(b, a, cnt + row * b.nslots, nullptr);
}

// K1w (kLaneMass) and K1s (kLaneSum): element i of a row belongs to thread
// i mod (nblk * 256) of the row's blocks, which bins its elements in
// order, 16 (and their weights) while the next 16 load.  `w` is read on
// K1w only.
template <typename T, typename W, int L>
__global__ void __launch_bounds__(kThreads, 1)
lane_rows_kernel(const T* __restrict__ x, const W* __restrict__ w,
                 const float* __restrict__ edges, int* __restrict__ cnt,
                 float* __restrict__ part, long long n, int nedges) {
  constexpr int B = kBatchRows;
  extern __shared__ float smem[];
  const long long row = blockIdx.y;
  const T* xr = x + row * n;
  const W* wr = L == kLaneMass ? w + row * n : nullptr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long span = (B - 1) * stride;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float v[B], p[B];
  bool full = i + span < n;
  if (full) {  // the first loads fly while the edges are staged
#pragma unroll
    for (int u = 0; u < B; ++u) {
      v[u] = to_f32(__ldg(xr + i + u * stride));
      p[u] = L == kLaneMass ? to_f32(__ldg(wr + i + u * stride)) : v[u];
    }
  }
  LaneBlock b = lane_block<true>(smem, edges, row, nedges);
  __syncthreads();
  lane_ends(b);
  LaneAcc a;
  while (full) {
    const long long next = i + B * stride;
    const bool more = next + span < n;
    float nv[B], np[B];
    if (more) {
#pragma unroll
      for (int u = 0; u < B; ++u) {
        nv[u] = to_f32(__ldg(xr + next + u * stride));
        np[u] = L == kLaneMass ? to_f32(__ldg(wr + next + u * stride))
                               : nv[u];
      }
    }
    lane_batch<L, B>(v, p, b, a);
#pragma unroll
    for (int u = 0; u < B; ++u) {
      v[u] = nv[u];
      p[u] = np[u];
    }
    i = next;
    full = more;
  }
  for (; i < n; i += stride) {
    const float v1[1] = {to_f32(__ldg(xr + i))};
    const float p1[1] = {L == kLaneMass ? to_f32(__ldg(wr + i)) : v1[0]};
    lane_batch<L, 1>(v1, p1, b, a);
  }
  lane_flush<true>(b, a, cnt + row * b.nslots,
                   part + (row * gridDim.x + blockIdx.x) * b.nslots);
}

template <typename T>
int lane_count_launch(const void* x, const void* edges, void* cnt,
                      long long rows, long long n, int nedges,
                      int blocks_per_row, void* stream) {
  const size_t smem = LaneLayout(nedges, kThreads / 32, false).words() * 4;
  const auto kernel = lane_count_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)blocks_per_row, (unsigned)rows);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(edges),
      static_cast<int*>(cnt), n, nedges);
  return (int)cudaGetLastError();
}

template <typename T, typename W, int L>
int lane_rows_launch(const void* x, const void* w, const void* edges,
                     void* cnt, void* part, long long rows, long long n,
                     int nedges, int nblk, int warps, void* stream) {
  const size_t smem = LaneLayout(nedges, warps, true).words() * 4;
  const auto kernel = lane_rows_kernel<T, W, L>;
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

}  // namespace

// Shared-histogram design (K1 where the lane tables do not run).  `cnt`
// must be zeroed by the caller (the blocks add into it).  Returns the first
// non-zero CUDA error code of the set-up or the launch, else 0.
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

// Lane-private design.  K1: as hist_batched_*, 8 warps a block; the
// 16-bit counts need ceil(n / (blocks_per_row * 256)) <= 65535 - 16 (a
// thread's whole packs round up by less than a pack, 8 elements, and it
// may bin one head or tail element besides).
extern "C" int lane_hist_batched_f32(const void* x, const void* edges,
                                     void* cnt, long long rows, long long n,
                                     int nedges, int blocks_per_row,
                                     void* stream) {
  return lane_count_launch<float>(x, edges, cnt, rows, n, nedges,
                                  blocks_per_row, stream);
}

extern "C" int lane_hist_batched_bf16(const void* x, const void* edges,
                                      void* cnt, long long rows, long long n,
                                      int nedges, int blocks_per_row,
                                      void* stream) {
  return lane_count_launch<__nv_bfloat16>(x, edges, cnt, rows, n, nedges,
                                          blocks_per_row, stream);
}

// K1w and K1s: as whist_batched_* and shist_batched_*.
#define LANE_WHIST_BATCHED(XN, XT, WN, WT)                                   \
  extern "C" int lane_whist_batched_##XN##_##WN(                             \
      const void* x, const void* w, const void* edges, void* cnt,            \
      void* mass, long long rows, long long n, int nedges, int nblk,         \
      int warps, void* stream) {                                             \
    return lane_rows_launch<XT, WT, kLaneMass>(x, w, edges, cnt, mass, rows, \
                                               n, nedges, nblk, warps,       \
                                               stream);                      \
  }
LANE_WHIST_BATCHED(f32, float, f32, float)
LANE_WHIST_BATCHED(f32, float, bf16, __nv_bfloat16)
LANE_WHIST_BATCHED(bf16, __nv_bfloat16, f32, float)
LANE_WHIST_BATCHED(bf16, __nv_bfloat16, bf16, __nv_bfloat16)

extern "C" int lane_shist_batched_f32(const void* x, const void* edges,
                                      void* cnt, void* sums, long long rows,
                                      long long n, int nedges, int nblk,
                                      int warps, void* stream) {
  return lane_rows_launch<float, float, kLaneSum>(x, nullptr, edges, cnt,
                                                  sums, rows, n, nedges, nblk,
                                                  warps, stream);
}

extern "C" int lane_shist_batched_bf16(const void* x, const void* edges,
                                       void* cnt, void* sums, long long rows,
                                       long long n, int nedges, int nblk,
                                       int warps, void* stream) {
  return lane_rows_launch<__nv_bfloat16, float, kLaneSum>(
      x, nullptr, edges, cnt, sums, rows, n, nedges, nblk, warps, stream);
}

// Blocks of `warps` warps per SM of the f32 lane-private kernel of `leg`
// (0 K1, 1 K1w, 2 K1s) at `nedges` edges, with its shared memory, into
// *out.  Returns the first non-zero CUDA error code, else 0.
template <typename K>
int blocks_per_sm(K kernel, size_t smem, int warps, int* out) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kernel, warps * 32, smem);
}

extern "C" int lane_hist_blocks_per_sm(int leg, int nedges, int warps,
                                       int* out) {
  const size_t smem = LaneLayout(nedges, warps, leg != kLaneCount).words() * 4;
  if (leg == kLaneCount)
    return blocks_per_sm(lane_count_kernel<float>, smem, warps, out);
  return blocks_per_sm(leg == kLaneMass
                           ? lane_rows_kernel<float, float, kLaneMass>
                           : lane_rows_kernel<float, float, kLaneSum>,
                       smem, warps, out);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
