// K3: one shared array binned against K realized edge ladders in one read.
//
// Replaces the TPU kernel src/repro/kernels/cp_objective.py
// `_hist_kernel_multi` (tile math `_bin_tile`) on all four of its legs:
// - counting leg (K3): x (n,) f32 or bf16, edges (K, nbins+1) f32, out int32
//   counts (K, nbins+2);
// - counting leg with per-slot sums (K3s, `want_sums`, the polish input):
//   the counts and per-block f32 slot sums of x (nblk, K, nbins+2), summed
//   over blocks by the wrapper; here only for ladders too wide for
//   `hist_multi_sums.cu`'s sorted tile;
// - weighted leg (K3w): x and w (n,), each f32 or bf16 -> the int32 counts
//   and per-block f32 slot masses (nblk, K, nbins+2);
// - weighted leg with per-slot sums (K3ws): the counts and per-block f32
//   slot masses and sums of w*x (nblk, K, 2, nbins+2); here only for
//   ladders too wide for the sorted tile.
// Slot layout per ladder as K1 (`hist_batched.cu`): slot 0 is x <= e_0
// (with -inf), slot j is e_{j-1} < x <= e_j, slot nbins+1 is x > e_nbins
// and NaN, exactly what the plain versions
// `kernels/ref.py:cp_histogram_multi_ref` / `wcp_histogram_multi_ref`
// compute ladder by ladder.
//
// Bound on an H100 SXM: one read of x (4 bytes per f32 element, 2 per
// bf16), and of w on the weighted legs: 512 MiB (1 GiB with f32 weights)
// at n = 2^27 against 3.35 TB/s is 0.16 ms (0.32 ms).  Per element and
// distinct ladder the function needs which of the three parts of the
// ladder the element lies in (and on the legs with rows, the add of its
// value to that part's row), and for an in-bracket element its slot.
//
// Both kernels share a block's view of its G ladders (G in {1, 2, 4, 8,
// 16}, a template parameter; K > G splits along grid.y, and each group
// reads x again):
// - a ladder equal edge for edge to an earlier one of its group (the first
//   sweep gives every target the bracket [min, max]) is binned once, and
//   its outputs copied from its twin;
// - the bracket ends of the distinct ladders, at most 2G values, are
//   sorted once per block; an element's bucket is the number of ends below
//   it (a branch-free search of log2(ends) + 1 steps; NaN has a bucket of
//   its own above all).  Each bucket carries the mask of the ladders whose
//   bracket holds its elements, so only those take a slot search; per
//   bucket each lane counts its elements in a private 16-bit column (no
//   atomics, no conflicts).  A ladder's slot-0 count is the sum of the
//   buckets at or below its lower end's, its top count the sum of those
//   above its upper end's and NaN's: exact integers, so the grouping by
//   the other ladders' ends cannot change them;
// - an in-bracket element's slot is guessed from its ladder's ends and
//   decided by the realized edges, e_{g-1} < v <= e_g (a batch's guesses
//   and edge pairs load together), with a binary search over the edges on
//   a miss (non-uniform, duplicated or denormal ladders).  The kernel only
//   COMPARES against the realized edges.
//
// Counting leg (K3): in-bracket elements add to the block's shared counts
// with integer atomics, and blocks flush into the zeroed output with
// integer atomics, so the counts do not depend on the order of blocks;
// one resident wave of blocks, each striding over x with 64-bit offsets,
// four elements in flight per thread, the next four loading.  A first
// sweep whose ladders are all one (`full_bracket` and every ladder equal)
// runs K1's lane-private kernel (`hist_batched.cu`) on that ladder
// instead, the wrapper's choice: counts are exact in any design, so the
// design may follow the call.
//
// Legs with f32 slot rows (K3w, and K3s/K3ws past the sorted tile's
// widths; one kernel specialized on what an element adds: w, x, or the
// pair w and w*x).  The masses decide every narrowing step and the sums
// place the polish cut, so a ladder's rows are summed in an order set by
// n, the block's warps (a function of the width and the leg, never of K)
// and that ladder's own elements, never by the other ladders of its
// launch, and never with float atomics:
// - each ladder's slot-0 and top-slot row values accumulate in per-thread
//   registers in the thread's data order: two tests of the element's
//   bucket masks and two predicated adds per element and distinct ladder
//   (the top slot's values are accumulated, not subtracted: a difference
//   of f32 sums is not the sum);
// - w*x is formed with __fmul_rn, so that no product is contracted into a
//   sum;
// - in-bracket elements go to per-warp f32 rows in shared memory, one step
//   (one element per lane) at a time, in rounds: each lane offers its
//   lowest remaining ladder, and a ladder that every lane inside it offers
//   is taken whole; its lanes group by slot (one ballot per bit in which
//   the step's (ladder, slot) keys differ), and the group's lowest lane
//   sums the group's values in lane order and adds them to the warp's row
//   entry, its only writer (where no element is inside two ladders, a
//   batch's four steps are grouped together and added step by step).  So
//   a ladder's groups are all of its lanes of the step, whatever other
//   ladders those lanes are inside (disjoint or identical ladders take one
//   round, as in the earlier design, whose rounds took "the lowest ladder
//   each lane is still inside" and so grouped a ladder's lanes by the
//   ladders below them);
// - the block sums its warps' rows in warp order and writes one partial
//   per ladder; the wrapper picks the block count from n alone and reduces
//   the partials over blocks with `sum_blocks`, in an order set by the
//   block count alone;
// - the per-warp rows take G * (nbins+2) * 4 bytes per warp and row (66 KB
//   for 8 warps at G = 16, 128 bins, one row): the block opts in past
//   48 KB, up to 227 KB; the wrapper fixes the warps from the width and
//   the leg (8, halved while one ladder's block does not fit) and halves
//   the group until the block fits.  Since a ladder's rows are the same
//   bits alone as in any company, the wrapper bins a first sweep of
//   identical ladders as the one ladder (a block of G = 1: fewer registers
//   and shared bytes, more blocks an SM) and copies its outputs.
// Built without fast-math, so denormals are compared exactly (no flush).
//
// With -DHIST_MULTI_PROBE each thread times its phases with clock64 (0 the
// loads, 1 buckets and their counters, 2 end-slot adds, 3 slot guesses, 4
// in-bracket adds, 5 the flush) into `g_probe`, read by
// `hist_multi_probe_read` (`chip_smoke.py --probe`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#ifdef HIST_MULTI_PROBE
__device__ unsigned long long g_probe[8];
#define PROBE_START long long probe_acc[8] = {}; long long probe_t = clock64();
#define PROBE(i) { const long long t_ = clock64(); \
                   probe_acc[i] += t_ - probe_t; probe_t = t_; }
#define PROBE_END for (int q_ = 0; q_ < 8; ++q_) \
    atomicAdd(&g_probe[q_], (unsigned long long)probe_acc[q_]);
#define PROBE_PARAMS , long long (&probe_acc)[8], long long& probe_t
#define PROBE_ARGS , probe_acc, probe_t
#else
#define PROBE_START
#define PROBE(i)
#define PROBE_END
#define PROBE_PARAMS
#define PROBE_ARGS
#endif

namespace {

constexpr int kThreads = 256;  // K3's block
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

// A block's shared memory, in 4-byte words: per ladder its edges and its
// int counts; the sorted bracket ends (2G, padded with +inf), per bucket
// (2G + 1 of ends, one of NaN) three ladder masks (the ladders whose
// bracket holds its elements, whose slot 0 does, whose top slot does) and
// its block total; per ladder its guess (origin and scale) and the ranks
// of its two ends among the sorted ends; per warp the lanes' 16-bit bucket
// counters (G + 1 words of 32 lanes); with R f32 rows per slot, per warp R
// rows per ladder and a stage of 32 x R values for each step of a batch.
// `cp_objective.hist_multi_smem` computes the same size.
struct Layout {
  int e, hist, ends, bmask, lmask, tmask, btot, h0, sc, mlo, mhi, ccnt,
      rows, stage;
  size_t words;
  __host__ __device__ Layout(int G, int nedges, int warps, int R) {
    const int nslots = nedges + 1, nb = 2 * G + 2;
    e = 0;
    hist = e + G * nedges;
    ends = hist + G * nslots;
    bmask = ends + 2 * G;
    lmask = bmask + nb;
    tmask = lmask + nb;
    btot = tmask + nb;
    h0 = btot + nb;
    sc = h0 + G;
    mlo = sc + G;
    mhi = mlo + G;
    ccnt = mhi + G;
    rows = ccnt + warps * (G + 1) * 32;
    stage = rows + warps * G * nslots * R;
    words = (size_t)stage + warps * 32 * R * kUnroll;
  }
};

// The block's ladders, as the element loops read them.
struct Ladders {
  const float* e;         // [G][nedges] edges
  const float* ends;      // sorted distinct bracket ends, +inf padded
  const unsigned* bmask;  // per bucket: the ladders holding its elements
  const unsigned* lmask;  // ... whose slot 0 holds them (v <= lo)
  const unsigned* tmask;  // ... whose top slot holds them (v > hi, NaN)
  const float* h0;        // per ladder: the guess g = ceil((v/2 - h0) * sc)
  const float* sc;
  int nedges, nslots, pow2, nanq;  // pow2: searched ends; nanq: NaN's bucket
};

// Stages the block's ladders (`first` .. `first + nl - 1` of `edges`),
// zeroes its counts, finds each ladder's first twin (rep[j] == j: binned;
// bit j of the returned mask), sorts the distinct bracket ends and builds
// the bucket masks and the guesses; rep[G] carries the number of ends the
// bucket search covers.  NaN ends take no rank (-1): nothing lies at or
// below them.  Every thread of the block calls it; it ends with a
// __syncthreads.
template <int G>
__device__ unsigned stage_ladders(float* smem, const Layout& lay,
                                  const float* __restrict__ edges,
                                  long long first, int nl, int nedges,
                                  int* rep, Ladders& L) {
  const int nslots = nedges + 1, nb = 2 * G + 2;
  float* e = smem + lay.e;
  int* hist = reinterpret_cast<int*>(smem + lay.hist);
  for (int i = threadIdx.x; i < nl * nedges; i += blockDim.x)
    e[i] = edges[first * nedges + i];
  for (int i = threadIdx.x; i < nl * nslots; i += blockDim.x) hist[i] = 0;
  for (int i = lay.ccnt + threadIdx.x; i < lay.rows; i += blockDim.x)
    reinterpret_cast<unsigned*>(smem)[i] = 0u;
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
  float* ends = smem + lay.ends;
  if (threadIdx.x == 0) {
    int d = 0;  // insertion sort of the distinct ends
    for (int j = 0; j < nl; ++j) {
      if (rep[j] != j) continue;
      for (int t = 0; t < 2; ++t) {
        const float v = e[j * nedges + (t ? nedges - 1 : 0)];
        bool dup = v != v;
        for (int k = 0; k < d && !dup; ++k) dup = ends[k] == v;
        if (dup) continue;
        int k = d++;
        for (; k > 0 && ends[k - 1] > v; --k) ends[k] = ends[k - 1];
        ends[k] = v;
      }
    }
    int pow2 = 1;
    while (pow2 < d) pow2 <<= 1;
    for (int k = d; k < 2 * G; ++k) ends[k] = __int_as_float(0x7f800000);
    int* mlo = reinterpret_cast<int*>(smem + lay.mlo);
    int* mhi = reinterpret_cast<int*>(smem + lay.mhi);
    unsigned* bmask = reinterpret_cast<unsigned*>(smem + lay.bmask);
    unsigned* lmask = reinterpret_cast<unsigned*>(smem + lay.lmask);
    unsigned* tmask = reinterpret_cast<unsigned*>(smem + lay.tmask);
    for (int q = 0; q < nb; ++q) bmask[q] = lmask[q] = tmask[q] = 0u;
    for (int j = 0; j < nl; ++j) {
      if (rep[j] != j) continue;
      const float lo = e[j * nedges], hi = e[j * nedges + nedges - 1];
      int rlo = -1, rhi = -1;
      for (int k = 0; k < d; ++k) {
        if (ends[k] == lo) rlo = k;
        if (ends[k] == hi) rhi = k;
      }
      mlo[j] = rlo;
      mhi[j] = rhi;
      for (int q = 0; q < nb; ++q) {
        lmask[q] |= (unsigned)(q <= rlo) << j;
        bmask[q] |= (unsigned)(rlo < q && q <= rhi) << j;
        tmask[q] |= (unsigned)(q > max(rlo, rhi)) << j;
      }
      smem[lay.h0 + j] = 0.5f * lo;
      smem[lay.sc + j] = (float)(nedges - 1) / (0.5f * hi - 0.5f * lo);
    }
    rep[G] = pow2;
  }
  __syncthreads();
  L.e = e;
  L.ends = ends;
  L.bmask = reinterpret_cast<const unsigned*>(smem + lay.bmask);
  L.lmask = reinterpret_cast<const unsigned*>(smem + lay.lmask);
  L.tmask = reinterpret_cast<const unsigned*>(smem + lay.tmask);
  L.h0 = smem + lay.h0;
  L.sc = smem + lay.sc;
  L.nedges = nedges;
  L.nslots = nslots;
  L.pow2 = rep[G];
  L.nanq = nb - 1;
  unsigned binned = 0;
  for (int j = 0; j < nl; ++j) binned |= (unsigned)(rep[j] == j) << j;
  return binned;
}

// The buckets of U values, searched together: the number of sorted ends
// below each, NaN's own bucket for NaN.
template <int U>
__device__ __forceinline__ void buckets(const float (&v)[U],
                                        const Ladders& L, int (&q)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) q[u] = 0;
  for (int step = L.pow2 >> 1; step > 0; step >>= 1) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      q[u] = L.ends[q[u] + step - 1] < v[u] ? q[u] + step : q[u];
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    q[u] += L.ends[q[u]] < v[u];
    if (v[u] != v[u]) q[u] = L.nanq;
  }
}

// U elements (bucket q[u]; none where `ok[u]` is false) into this lane's
// 16-bit bucket counters: increments to one word merged first, then all
// loads before all stores, so the U read-modify-writes overlap.
template <int U>
__device__ __forceinline__ void count_buckets(unsigned* col,
                                              const int (&q)[U],
                                              const bool (&ok)[U]) {
  int wd[U];
  unsigned inc[U], old[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    wd[u] = q[u] >> 1;
    inc[u] = ok[u] ? 1u << ((q[u] & 1) << 4) : 0u;
  }
#pragma unroll
  for (int u = 1; u < U; ++u) {
    bool merged = false;
#pragma unroll
    for (int t = 0; t < u; ++t) {
      if (!merged && wd[t] == wd[u]) {
        inc[t] += inc[u];
        merged = true;
      }
    }
    if (merged) inc[u] = 0u;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) old[u] = inc[u] ? col[wd[u] * 32] : 0u;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (inc[u]) col[wd[u] * 32] = old[u] + inc[u];
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

__device__ __forceinline__ int guess(float v, const Ladders& L, int j) {
  return min(max(__float2int_ru((0.5f * v - L.h0[j]) * L.sc[j]), 1),
             L.nedges - 1);
}

// The slot of an in-bracket v in ladder j.
__device__ __forceinline__ int ladder_slot(float v, const Ladders& L, int j) {
  const float* e = L.e + j * L.nedges;
  const int g = guess(v, L, j);
  return e[g - 1] < v && v <= e[g] ? g : search(v, e, L.nedges);
}

// Each element's slot in the lowest ladder whose bracket holds it (bit set
// in `in`): the U guesses and their edge pairs load together, then the rare
// misses search.
template <int U>
__device__ __forceinline__ void first_slots(const float (&v)[U],
                                            const unsigned (&in)[U],
                                            const Ladders& L, int (&s)[U]) {
  float elo[U], ehi[U];
  const float* e[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    s[u] = 0;
    e[u] = L.e;
    elo[u] = ehi[u] = 0.f;
    if (in[u]) {
      const int j = __ffs(in[u]) - 1;
      e[u] = L.e + j * L.nedges;
      s[u] = guess(v[u], L, j);
      elo[u] = e[u][s[u] - 1];
      ehi[u] = e[u][s[u]];
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (in[u] && !(elo[u] < v[u] && v[u] <= ehi[u]))
      s[u] = search(v[u], e[u], L.nedges);
}

// The block's end: per bucket its total over lanes and warps, then per
// binned ladder its slot-0 count (buckets up to its lower end's rank) and
// top count (buckets above both ranks, NaN's included) into `hist`.  Every
// thread of the block calls it after a __syncthreads; it ends with one.
template <int G>
__device__ __forceinline__ void end_counts(float* smem, const Layout& lay,
                                           unsigned binned, int nslots) {
  const int nb = 2 * G + 2, warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned* ccnt = reinterpret_cast<const unsigned*>(smem + lay.ccnt);
  int* btot = reinterpret_cast<int*>(smem + lay.btot);
  for (int q = warp; q < nb; q += warps) {
    int c = 0;
    for (int w = 0; w < warps; ++w)
      c += (ccnt[(w * (G + 1) + (q >> 1)) * 32 + lane] >> ((q & 1) << 4)) &
           0xffffu;
    c = warp_sum(c);
    if (lane == 0) btot[q] = c;
  }
  __syncthreads();
  const int j = threadIdx.x;
  if (j < G && ((binned >> j) & 1u)) {
    const int* mlo = reinterpret_cast<const int*>(smem + lay.mlo);
    const int* mhi = reinterpret_cast<const int*>(smem + lay.mhi);
    const int top = max(mlo[j], mhi[j]);
    int below = 0, above = 0;
    for (int q = 0; q < nb; ++q) {
      below += q <= mlo[j] ? btot[q] : 0;
      above += q > top ? btot[q] : 0;
    }
    int* hist = reinterpret_cast<int*>(smem + lay.hist) + j * nslots;
    hist[0] = below;
    hist[nslots - 1] = above;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Counting leg (K3)
// ---------------------------------------------------------------------------

// An in-bracket element's counts: slot `s` of its lowest ladder, then each
// further ladder of `in` (overlapping brackets) searched in turn.
__device__ __forceinline__ void count_inside(float v, unsigned in, int s,
                                             const Ladders& L, int* hist) {
  while (in) {
    const int j = __ffs(in) - 1;
    atomicAdd(&hist[j * L.nslots + s], 1);
    in &= in - 1;
    if (in) s = ladder_slot(v, L, __ffs(in) - 1);
  }
}

// K3's batch of U elements (none where `ok[u]` is false).
template <int U>
__device__ __forceinline__ void count_batch(const float (&v)[U],
                                            const bool (&ok)[U],
                                            const Ladders& L, unsigned* col,
                                            int* hist PROBE_PARAMS) {
  int q[U], s[U];
  unsigned in[U];
  buckets<U>(v, L, q);
#pragma unroll
  for (int u = 0; u < U; ++u) in[u] = ok[u] ? L.bmask[q[u]] : 0u;
  count_buckets<U>(col, q, ok);
  PROBE(1)
  first_slots<U>(v, in, L, s);
  PROBE(3)
#pragma unroll
  for (int u = 0; u < U; ++u) count_inside(v[u], in[u], s[u], L, hist);
  PROBE(4)
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
hist_multi_kernel(const T* __restrict__ x, const float* __restrict__ edges,
                  int* __restrict__ cnt, long long n, int nladders,
                  int nedges) {
  extern __shared__ float smem[];
  __shared__ int rep[G + 1];  // ladder j is binned as ladder rep[j]
  PROBE_START
  const Layout lay(G, nedges, blockDim.x >> 5, 0);
  const int nslots = nedges + 1;
  const int first = blockIdx.y * G;
  const int nl = min(G, nladders - first);
  Ladders L;
  const unsigned binned = stage_ladders<G>(smem, lay, edges, first, nl,
                                           nedges, rep, L);
  int* hist = reinterpret_cast<int*>(smem + lay.hist);
  unsigned* col = reinterpret_cast<unsigned*>(smem + lay.ccnt) +
                  (threadIdx.x >> 5) * (G + 1) * 32 + (threadIdx.x & 31);

  // a batch is binned while the next one loads
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool all[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) all[u] = true;
  float cur[kUnroll];
  bool full = i + (kUnroll - 1) * stride < n;
  if (full) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = to_f32(x[i + u * stride]);
  }
  while (full) {
    const long long next = i + kUnroll * stride;
    const bool more = next + (kUnroll - 1) * stride < n;
    float nxt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      nxt[u] = more ? to_f32(x[next + u * stride]) : 0.f;
    PROBE(0)
    count_batch<kUnroll>(cur, all, L, col, hist PROBE_ARGS);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
    i = next;
    full = more;
  }
  for (; i < n; i += stride) {
    const float v[1] = {to_f32(x[i])};
    const bool one[1] = {true};
    count_batch<1>(v, one, L, col, hist PROBE_ARGS);
  }
  __syncthreads();
  end_counts<G>(smem, lay, binned, nslots);
  for (int k = threadIdx.x; k < nl * nslots; k += blockDim.x) {
    const int j = k / nslots;
    const int s = k - j * nslots;
    const int c = hist[rep[j] * nslots + s];
    if (c) atomicAdd(&cnt[(long long)(first + j) * nslots + s], c);
  }
  PROBE(5)
  PROBE_END
}

template <typename T, int G>
int launch_group(const void* x, const void* edges, void* cnt, long long n,
                 int nladders, int nedges, void* stream) {
  const size_t smem = Layout(G, nedges, kThreads / 32, 0).words * 4;
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
  // one resident wave over all groups (integer atomics make the counts
  // independent of the block count, so it may follow the card), but no
  // thread with more than 65535 elements: its bucket counters are 16-bit
  const int groups = (nladders + G - 1) / G;
  const long long per_block = (long long)kThreads * kUnroll;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1) / groups;
  if (blocks > (n + per_block - 1) / per_block)
    blocks = (n + per_block - 1) / per_block;
  const long long most = 65535LL * kThreads;
  if (blocks < (n + most - 1) / most) blocks = (n + most - 1) / most;
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned)blocks, (unsigned)groups);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
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

// One element's row values added to ladder `bit`'s slot-0 accumulators
// where its bucket's slot-0 mask `lm` holds the ladder (v <= lo), to its
// top-slot ones where the top mask `tm` does (v > hi, or NaN): two mask
// tests and R predicated adds each.
__device__ __forceinline__ void end_adds(const float (&p)[1], unsigned lm,
                                         unsigned tm, unsigned bit,
                                         float (&a0)[1], float (&a1)[1]) {
  asm("{\n\t.reg .pred plo, phi;\n\t.reg .b32 t;\n\t"
      "and.b32 t, %2, %4;\n\t"
      "setp.ne.b32 plo, t, 0;\n\t"
      "and.b32 t, %3, %4;\n\t"
      "setp.ne.b32 phi, t, 0;\n\t"
      "@plo add.rn.f32 %0, %0, %5;\n\t"
      "@phi add.rn.f32 %1, %1, %5;\n\t"
      "}"
      : "+f"(a0[0]), "+f"(a1[0])
      : "r"(lm), "r"(tm), "r"(bit), "f"(p[0]));
}

__device__ __forceinline__ void end_adds(const float (&p)[2], unsigned lm,
                                         unsigned tm, unsigned bit,
                                         float (&a0)[2], float (&a1)[2]) {
  asm("{\n\t.reg .pred plo, phi;\n\t.reg .b32 t;\n\t"
      "and.b32 t, %4, %6;\n\t"
      "setp.ne.b32 plo, t, 0;\n\t"
      "and.b32 t, %5, %6;\n\t"
      "setp.ne.b32 phi, t, 0;\n\t"
      "@plo add.rn.f32 %0, %0, %7;\n\t"
      "@plo add.rn.f32 %1, %1, %8;\n\t"
      "@phi add.rn.f32 %2, %2, %7;\n\t"
      "@phi add.rn.f32 %3, %3, %8;\n\t"
      "}"
      : "+f"(a0[0]), "+f"(a0[1]), "+f"(a1[0]), "+f"(a1[1])
      : "r"(lm), "r"(tm), "r"(bit), "f"(p[0]), "f"(p[1]));
}

// For each of U steps, the lanes of the warp whose key (>= 0) equals this
// lane's: from one ballot per key bit that differs among the step's keys
// (the bits' OR and AND over the warp tell which), the U steps' ballots
// side by side.  __match_any_sync gives the same masks, but took most of
// the in-bracket time on the first sweep (a key per lane, mostly
// distinct).  Every lane of the warp must call it.
template <int U>
__device__ __forceinline__ void same_keys(const int (&key)[U],
                                          unsigned (&grp)[U]) {
  unsigned vary = 0u;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool has = key[u] >= 0;
    grp[u] = __ballot_sync(kFull, has);
    vary |= __reduce_or_sync(kFull, has ? (unsigned)key[u] : 0u) &
            ~__reduce_and_sync(kFull, has ? (unsigned)key[u] : ~0u);
  }
  for (; vary; vary &= vary - 1) {  // uniform over the warp
    const unsigned bit = vary & (0u - vary);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool one = ((unsigned)key[u] & bit) != 0u;
      const unsigned set = __ballot_sync(kFull, one);
      grp[u] &= one ? set : ~set;
    }
  }
}

// The group's row values, each row summed in lane order from 0 (a group of
// one: its own value), added to the warp's row entry `key`, and the group's
// size to the block's counts; by the group's lowest lane, the entry's only
// writer.
template <int R>
__device__ __forceinline__ void group_add(int key, unsigned grp,
                                          const float (&p)[R],
                                          const float* stage, float* rows,
                                          int* hist, int lane) {
#pragma unroll
  for (int c = 0; c < R; ++c) {
    float acc = p[c];
    if (grp != 1u << lane) {
      acc = 0.f;
      for (unsigned m = grp; m; m &= m - 1)
        acc += stage[c * 32 + __ffs(m) - 1];
    }
    rows[key * R + c] += acc;
  }
  atomicAdd(&hist[key], __popc(grp));
}

// The warp's in-bracket step, one element per lane: `inside` holds the
// ladders whose bracket holds the lane's element and `s` its slot in the
// lowest of them.  Round by round each lane offers its lowest remaining
// ladder; a ladder that no lane holds back (every lane inside it offers it
// in this round) is taken whole: its lanes group by (ladder, slot), and
// the group's lowest lane adds the group's row values, each row summed in
// lane order, to that entry of the warp's rows and the group's size to the
// block's counts.  So each of a ladder's groups is all of its lanes of the
// step with that slot, whatever other ladders they are inside.  The lowest
// ladder left in the warp is always taken (every lane inside it offers it),
// so the rounds end; where no lane is inside two ladders (disjoint or
// identical ladders) there is one round and nothing is held back.  Every
// lane of the warp must call it.
template <int R>
__device__ __forceinline__ void warp_inside(float v, const float (&p)[R],
                                            unsigned inside, int s,
                                            const Ladders& L, float* rows,
                                            float* stage, int* hist,
                                            int lane) {
  if (!__any_sync(kFull, inside != 0)) return;  // uniform over the warp
#pragma unroll
  for (int c = 0; c < R; ++c) stage[c * 32 + lane] = p[c];
  __syncwarp();
  const bool several = __any_sync(kFull, (inside & (inside - 1)) != 0);
  do {
    const unsigned mine = inside & (0u - inside);  // lowest ladder left
    const unsigned held =
        several ? __reduce_or_sync(kFull, inside & ~mine) : 0u;
    const bool go = (mine & ~held) != 0u;
    const int key[1] = {go ? (__ffs(mine) - 1) * L.nslots + s : -1};
    unsigned grp[1];
    same_keys<1>(key, grp);
    if (go && lane == __ffs(grp[0]) - 1)
      group_add<R>(key[0], grp[0], p, stage, rows, hist, lane);
    if (go) {
      inside &= ~mine;
      if (inside) s = ladder_slot(v, L, __ffs(inside) - 1);
    }
  } while (__any_sync(kFull, inside != 0));
  __syncwarp();
}

// K3w's (K3s's, K3ws's) batch of U elements with row values p (a lane
// past the end brings NaN with zero row values, `ok` false: it adds 0 to a
// top-slot accumulator and nothing elsewhere, and counts nowhere).  Every
// lane of the warp must call it.
template <int G, int U, int R>
__device__ __forceinline__ void rows_batch(
    const float (&v)[U], const float (&p)[U][R], const bool (&ok)[U],
    unsigned binned, const Ladders& L, unsigned* col, float (&pbelow)[G][R],
    float (&pabove)[G][R], float* wrows, float* wstage, int* hist,
    int lane PROBE_PARAMS) {
  int q[U], s[U];
  unsigned in[U], lm[U], tm[U];
  buckets<U>(v, L, q);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    in[u] = L.bmask[q[u]];
    lm[u] = L.lmask[q[u]];
    tm[u] = L.tmask[q[u]];
  }
  count_buckets<U>(col, q, ok);
  PROBE(1)
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (!((binned >> j) & 1u)) continue;  // uniform over the block
#pragma unroll
    for (int u = 0; u < U; ++u)
      end_adds(p[u], lm[u], tm[u], 1u << j, pbelow[j], pabove[j]);
  }
  PROBE(2)
  first_slots<U>(v, in, L, s);
  PROBE(3)
  unsigned any = 0u, several = 0u;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    any |= in[u];
    several |= in[u] & (in[u] - 1);
  }
  if (__any_sync(kFull, several != 0u)) {
    // an element inside two ladders: the steps one by one, in rounds
#pragma unroll
    for (int u = 0; u < U; ++u)
      warp_inside<R>(v[u], p[u], in[u], s[u], L, wrows, wstage, hist, lane);
  } else if (__any_sync(kFull, any != 0u)) {
    // each element inside one ladder at most: every step is one round,
    // and the steps' groups are found together, then added step by step
    int key[U];
    unsigned grp[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      key[u] = in[u] ? (__ffs(in[u]) - 1) * L.nslots + s[u] : -1;
#pragma unroll
      for (int c = 0; c < R; ++c) wstage[(u * R + c) * 32 + lane] = p[u][c];
    }
    same_keys<U>(key, grp);
    __syncwarp();
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (key[u] >= 0 && lane == __ffs(grp[u]) - 1)
        group_add<R>(key[u], grp[u], p[u], wstage + u * R * 32, wrows, hist,
                     lane);
    __syncwarp();
  }
  PROBE(4)
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
  __shared__ int rep[G + 1];  // ladder j is binned as ladder rep[j]
  PROBE_START
  const int nwarps = blockDim.x >> 5;
  const Layout lay(G, nedges, nwarps, R);
  const int nslots = nedges + 1;
  const int first = blockIdx.y * G;
  const int nl = min(G, nladders - first);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* rows = smem + lay.rows;  // [warp][G][nslots][R]
  for (int i = threadIdx.x; i < nwarps * G * nslots * R; i += blockDim.x)
    rows[i] = 0.f;
  Ladders Ld;
  const unsigned binned = stage_ladders<G>(smem, lay, edges, first, nl,
                                           nedges, rep, Ld);
  int* hist = reinterpret_cast<int*>(smem + lay.hist);
  unsigned* col = reinterpret_cast<unsigned*>(smem + lay.ccnt) +
                  warp * (G + 1) * 32 + lane;
  float* wrows = rows + warp * G * nslots * R;
  float* wstage = smem + lay.stage + warp * 32 * R * kUnroll;
  float pbelow[G][R], pabove[G][R];
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int c = 0; c < R; ++c) {
      pbelow[j][c] = 0.f;
      pabove[j][c] = 0.f;
    }
  }

  // a batch is binned while the next one loads; the loops are uniform over
  // the warp (its lanes meet at every in-bracket step)
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool all[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) all[u] = true;
  float cv[kUnroll], cw[kUnroll];
  bool full = __all_sync(kFull, i + (kUnroll - 1) * stride < n);
  if (full) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      cv[u] = to_f32(x[i + u * stride]);
      cw[u] = L == kSum ? 0.f : to_f32(w[i + u * stride]);
    }
  }
  while (full) {
    const long long next = i + kUnroll * stride;
    const bool more = __all_sync(kFull, next + (kUnroll - 1) * stride < n);
    float nv[kUnroll], nw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      nv[u] = more ? to_f32(x[next + u * stride]) : 0.f;
      nw[u] = more && L != kSum ? to_f32(w[next + u * stride]) : 0.f;
    }
    float p[kUnroll][R];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) payload<L>(cv[u], cw[u], true, p[u]);
    PROBE(0)
    rows_batch<G, kUnroll, R>(cv, p, all, binned, Ld, col, pbelow, pabove,
                              wrows, wstage, hist, lane PROBE_ARGS);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      cv[u] = nv[u];
      cw[u] = nw[u];
    }
    i = next;
    full = more;
  }
  for (; __any_sync(kFull, i < n); i += stride) {
    const bool ok[1] = {i < n};
    const float v[1] = {ok[0] ? to_f32(x[i]) : __int_as_float(0x7fc00000)};
    float p[1][R];
    payload<L>(v[0], ok[0] && L != kSum ? to_f32(w[i]) : 0.f, ok[0], p[0]);
    rows_batch<G, 1, R>(v, p, ok, binned, Ld, col, pbelow, pabove, wrows,
                        wstage, hist, lane PROBE_ARGS);
  }

  // the end slots' row values, reduced in a fixed order; lane 0 is their
  // only writer in the warp's rows (in-bracket slots lie in [1, nbins])
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (!((binned >> j) & 1u)) continue;
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
  end_counts<G>(smem, lay, binned, nslots);
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
  PROBE(5)
  PROBE_END
}

template <typename T, typename W, int G, int L>
int wlaunch_group(const void* x, const void* w, const void* edges, void* cnt,
                  void* part, long long n, int nladders, int nedges, int nblk,
                  int warps, void* stream) {
  constexpr int R = LegRows<L>::n;
  const size_t smem = Layout(G, nedges, warps, R).words * 4;
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

// The dynamic shared bytes of a block of `group` ladders of `nedges` edges
// with `warps` warps and `nrows` f32 rows per slot (0: K3).
extern "C" long long hist_multi_smem(int group, int nedges, int warps,
                                     int nrows) {
  return (long long)Layout(group, nedges, warps, nrows).words * 4;
}

// Blocks an SM holds of the f32 instance of K3 (`nrows` 0, 256 threads)
// or K3w (`nrows` 1, `warps` warps) at `group` 16 ladders of `nedges`
// edges, into *out.  Returns a CUDA error code, else 0.
extern "C" int hist_multi_blocks_per_sm(int nrows, int nedges, int warps,
                                        int* out) {
  cudaError_t err;
  if (nrows == 0) {
    const size_t smem = Layout(16, nedges, kThreads / 32, 0).words * 4;
    const auto k = hist_multi_kernel<float, 16>;
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(
             k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
            cudaSuccess)
      return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k,
                                                              kThreads, smem);
  }
  const size_t smem = Layout(16, nedges, warps, 1).words * 4;
  const auto k = whist_multi_kernel<float, float, 16, kMass>;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(
           k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
          cudaSuccess)
    return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k,
                                                            warps * 32, smem);
}

#ifdef HIST_MULTI_PROBE
// The probe's phase cycles, summed over threads since the last reset
// (after a device synchronize); `reset` zeroes them.
extern "C" int hist_multi_probe_read(unsigned long long* out, int reset) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyFromSymbol(out, g_probe, sizeof(unsigned long long) * 8);
  if (err != cudaSuccess || !reset) return (int)err;
  const unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
}
#endif

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
