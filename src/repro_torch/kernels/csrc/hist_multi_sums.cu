// K3s and K3ws: one shared array binned against K realized edge ladders,
// with per-slot sums, around a sorted tile.
//
// Replaces the sums legs of the TPU kernel
// src/repro/kernels/cp_objective.py `_hist_kernel_multi` (tile math
// `_bin_tile` with `want_sums`), the input of the binned polish:
// - K3s: x (n,) f32 or bf16, edges (K, nbins+1) f32 -> int32 counts
//   (K, nbins+2) and per-block f32 slot sums of x (nblk, K, 1, nbins+2);
// - K3ws: x and w (n,), each f32 or bf16 -> the int32 counts and per-block
//   f32 slot masses and sums of w*x (nblk, K, 2, nbins+2), w*x formed with
//   __fmul_rn (no product is contracted into a sum).
// The wrapper sums the block partials with `sum_blocks.cu`.  Slot layout
// per ladder as `hist_multi.cu`: slot 0 is x <= e_0 (with -inf), slot j is
// e_{j-1} < x <= e_j, slot nbins+1 is x > e_nbins and NaN, what the plain
// versions `kernels/ref.py:cp_histogram_multi_ref` /
// `wcp_histogram_multi_ref` compute ladder by ladder.  Ladders too wide
// for one a block (past 12255 edges for K3s, 9650 for K3ws) stay on
// `hist_multi.cu`'s grouped kernel (`cp_objective.hist_multi_sums_layout`).
//
// Bound on an H100 SXM: one read of x (and w), 0.16 ms (0.32 ms) at
// n = 2^27 f32; per element and distinct ladder the adds of its count and
// its sums, fewer lane operations than the read takes.  The earlier kernel
// (`hist_multi.cu`, kSum / kMassSum, which still serves wider ladders)
// searched and grouped each element once per ladder it lay inside: 28 ms on
// the polished first sweep, where every element lies inside 16 distinct
// ladders.  Here the sort of a chunk (CUB's block radix sort) sets the pace
// and is shared by all ladders of the block; per ladder and chunk the work
// is one search per edge and one sum per slot.
//
// Design:
// - each block takes fixed chunks of 4096 consecutive elements, chunk
//   c = blockIdx.x + i * gridDim.x, with gridDim.x = fg_blocks(n): which
//   elements share a chunk, and the order of a block's chunks, depend on n
//   alone;
// - the chunk is sorted once by value, for all ladders of the block: the
//   keys are the order-preserving map of the f32 bits (NaN of either sign
//   to 0xFFFFFFFE, above +inf; the padding past n to 0xFFFFFFFF, after
//   every element), sorted by CUB's block radix sort, which is stable;
//   thread t loads chunk positions t + 256 u (u < 16) as its items
//   16 t + u, so equal keys keep that order.  ±0 and denormals keep their
//   bits;
// - per ladder, slot s holds the sorted positions [p_{s-1}, p_s), p_s the
//   number of elements <= e_s (an upper bound of the edge's key over the
//   sorted keys; an edge of ±0 takes the key of +0, so that -0 and +0 are
//   both <= it); counts are differences of these integers;
// - the sorted tile holds the whole chunk, so a position in it depends on
//   the chunk alone, never on the other ladders, and a slot's sum is a
//   direct sum over its positions [a, b) in an order set by those
//   positions.  Thread t's strip is the positions 16 t .. 16 t + 15; each
//   strip's sum (its values in order, from +0), and the sums of the strips
//   before and after it (a warp's Kogge-Stone scan, then the warps in
//   order) are taken once a chunk.  A slot in one strip sums its values in
//   order from +0; one that starts at position 0 adds the strips before
//   b-1's, then b-1's strip up to b-1; one that ends at the last element
//   adds a's strip from a, then the strips after it; any other adds a's
//   strip from a, each strip between in order, then b-1's strip up to b-1.
//   No slot sum is a difference of sums, so an inf or NaN reaches only its
//   own slot;
// - a block adds each chunk's (ladder, slot) sums to its own rows in chunk
//   order, one writer per entry; the block rows are its partials (a
//   repeated ladder, equal edge keys to an earlier one of the block, is
//   binned once and copies its first twin's).  So a ladder's sums are the
//   same bits alone, among 16 or in any order;
// - no float atomics; integer atomics flush the block's counts.
// Built without fast-math, so denormals are compared exactly (no flush).

#include <cub/block/block_radix_sort.cuh>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;  // ladders a block
constexpr int kItems = 16;     // sorted positions a thread (its strip)
constexpr int kTile = kThreads * kItems;  // elements a chunk
constexpr int kIlp = 4;        // boundary searches a thread runs at once
constexpr unsigned kNanKey = 0xFFFFFFFEu;
constexpr unsigned kPadKey = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The order-preserving map of the f32 bits (NaN above +inf).
__device__ __forceinline__ unsigned order_key(unsigned bits) {
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ unsigned value_key(float v) {
  return v != v ? kNanKey : order_key(__float_as_uint(v));
}

// The key of edge e: the largest key k such that every value of key <= k
// is <= e (±0: the key of +0).
__device__ __forceinline__ unsigned edge_key(float e) {
  return e == 0.f ? 0x80000000u : order_key(__float_as_uint(e));
}

// The value of a key (a NaN for the NaN key).
__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// What an element adds to its slot's rows besides its count: its value x
// (K3s), or w and w*x (K3ws).  The tile keeps one row of values per sorted
// position: x, or w (w*x is formed from w and the key where it is read).
enum Leg { kSum = 1, kMassSum = 2 };
// The radix sort takes digits of 5 bits for K3s and 4 for K3ws (whose w
// rides along), and the register bound lets an SM hold three K3s blocks,
// two K3ws blocks: the fastest of 4 and 5 bits, 2 and 3 blocks, and 8 and
// 16 items a thread on the card.
template <int L> struct Leg_ {
  static constexpr int rows = L == kMassSum ? 2 : 1;
  static constexpr int bits = L == kMassSum ? 4 : 5;
  static constexpr int blocks = L == kMassSum ? 2 : 3;
  using Value = typename std::conditional<L == kMassSum, float,
                                          cub::NullType>::type;
  using Sort = cub::BlockRadixSort<unsigned, kThreads, kItems, Value, bits>;
};

// A block's dynamic shared memory, in 4-byte words: the sorted tile (keys,
// then one row of values; the sort's storage reuses it), per row the sums
// of each thread's strip of sorted positions and the exclusive sums of the
// strips before and after it (kThreads each), per ladder its edge keys and
// boundaries, its rows (`rows` of nslots) and its counts.
struct Layout {
  int group, nedges, nslots, rows;
  __host__ __device__ Layout(int g, int ne, int r)
      : group(g), nedges(ne), nslots(ne + 1), rows(r) {}
  __host__ __device__ size_t gs() const { return (size_t)2 * kTile; }
  __host__ __device__ size_t ekey() const {
    return gs() + (size_t)3 * rows * kThreads;
  }
  __host__ __device__ size_t bnd() const {
    return ekey() + (size_t)group * nedges;
  }
  __host__ __device__ size_t acc() const {
    return bnd() + (size_t)group * nedges;
  }
  __host__ __device__ size_t cnt() const {
    return acc() + (size_t)group * rows * nslots;
  }
  __host__ __device__ size_t words() const {
    return cnt() + (size_t)group * nslots;
  }
};

// The elements of the sorted tile with key <= k, for kIlp keys at once
// (TILE a power of two; the padding's key is above every edge key).
template <int TILE>
__device__ __forceinline__ void count_le(const unsigned* skey,
                                         const unsigned (&k)[kIlp],
                                         int (&pos)[kIlp]) {
#pragma unroll
  for (int i = 0; i < kIlp; ++i) pos[i] = 0;
#pragma unroll
  for (int step = TILE / 2; step > 0; step >>= 1) {
#pragma unroll
    for (int i = 0; i < kIlp; ++i)
      pos[i] += skey[pos[i] + step - 1] <= k[i] ? step : 0;
  }
#pragma unroll
  for (int i = 0; i < kIlp; ++i) pos[i] += skey[pos[i]] <= k[i];
}

// The sorted tile of a chunk as the slot sums read it.
template <int L>
struct Tile {
  static constexpr int R = Leg_<L>::rows;
  static constexpr int G = kItems;  // positions a strip
  const unsigned* key;
  const float* row;   // x (K3s) or w (K3ws) per sorted position
  const float* gs;    // [R][kThreads] strip sums
  const float* pre;   // [R][kThreads] sums of the strips before
  const float* suf;   // [R][kThreads] sums of the strips after
  int valid;

  __device__ __forceinline__ void value(int p, float (&v)[R]) const {
    v[0] = row[p];
    if constexpr (R == 2) v[1] = __fmul_rn(row[p], key_value(key[p]));
  }
  // values p in [p0, p1) in order, from +0
  __device__ __forceinline__ void run(int p0, int p1, float (&s)[R]) const {
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    for (int p = p0; p < p1; ++p) {
      float v[R];
      value(p, v);
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] += v[r];
    }
  }
  // The sum of each row over the sorted positions [a, b), a < b: in one
  // strip, its values in order; from position 0, the strips before b-1's
  // (pre) and then b-1's strip up to b-1; up to the last element, a's
  // strip from a and then the strips after (suf); else a's strip from a,
  // each strip between in order, then b-1's strip up to b-1.
  __device__ __forceinline__ void sum(int a, int b, float (&s)[R]) const {
    const int ga = a / G, gb = (b - 1) / G;
    if (ga == gb) {
      run(a, b, s);
      return;
    }
    if (a == 0) {
      run(gb * G, b, s);
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = pre[r * kThreads + gb] + s[r];
      return;
    }
    run(a, (ga + 1) * G, s);
    if (b == valid) {
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] += suf[r * kThreads + ga];
      return;
    }
    for (int g = ga + 1; g < gb; ++g) {
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] += gs[r * kThreads + g];
    }
    float t[R];
    run(gb * G, b, t);
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] += t[r];
  }
};

template <typename T, typename W, int L>
__global__ void __launch_bounds__(kThreads, Leg_<L>::blocks)
sorted_sums_kernel(const T* __restrict__ x, const W* __restrict__ w,
                   const float* __restrict__ edges, int* __restrict__ cnt,
                   float* __restrict__ part, long long n, int nladders,
                   int nedges, int group) {
  constexpr int R = Leg_<L>::rows;
  constexpr int I = kItems;
  constexpr int TILE = kTile;
  using Sort = typename Leg_<L>::Sort;
  static_assert((TILE & (TILE - 1)) == 0, "the searches halve the tile");
  static_assert(I % 4 == 0, "vector stores of a thread's items");
  static_assert(sizeof(typename Sort::TempStorage) <=
                    sizeof(unsigned) * 2 * TILE,
                "the sort's storage must fit the tile it reuses");
  __shared__ int rep[kMaxGroup];  // ladder j is binned as ladder rep[j]
  __shared__ int dl[kMaxGroup];   // the ladders binned, nd of them
  __shared__ int nd;
  __shared__ float wtot[R][2][kWarps];
  extern __shared__ __align__(16) unsigned smem[];
  const Layout lay(group, nedges, R);
  const int nslots = nedges + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned* skey = smem;                                      // TILE
  float* srow = reinterpret_cast<float*>(smem + TILE);        // TILE
  float* gs = reinterpret_cast<float*>(smem + lay.gs());      // R*kThreads
  float* pre = gs + R * kThreads;                             // R*kThreads
  float* suf = pre + R * kThreads;                            // R*kThreads
  unsigned* ekey = smem + lay.ekey();                         // G * nedges
  int* bnd = reinterpret_cast<int*>(smem + lay.bnd());        // G * nedges
  float* acc = reinterpret_cast<float*>(smem + lay.acc());    // G*R*nslots
  int* hcnt = reinterpret_cast<int*>(smem + lay.cnt());       // G * nslots
  auto& sort_tmp = *reinterpret_cast<typename Sort::TempStorage*>(smem);

  const int first = blockIdx.y * group;
  const int nl = min(group, nladders - first);
  for (int i = tid; i < nl * nedges; i += kThreads)
    ekey[i] = edge_key(edges[(long long)first * nedges + i]);
  for (int i = tid; i < nl * R * nslots; i += kThreads) acc[i] = 0.f;
  for (int i = tid; i < nl * nslots; i += kThreads) hcnt[i] = 0;
  __syncthreads();
  if (tid < nl) {  // equal edge keys give equal slots and sums
    int r = tid;
    for (int p = 0; p < tid && r == tid; ++p) {
      bool same = true;
      for (int s = 0; s < nedges && same; ++s)
        same = ekey[p * nedges + s] == ekey[tid * nedges + s];
      if (same) r = p;
    }
    rep[tid] = r;
  }
  __syncthreads();
  if (tid == 0) {
    int m = 0;
    for (int j = 0; j < nl; ++j)
      if (rep[j] == j) dl[m++] = j;
    nd = m;
  }

  const Tile<L> tile{skey, srow, gs, pre, suf, 0};
  const long long nchunks = (n + TILE - 1) / TILE;
  for (long long c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const long long i0 = c * TILE;
    const int valid = (int)min((long long)TILE, n - i0);
    unsigned key[I];
    float wv[I];
#pragma unroll
    for (int u = 0; u < I; ++u) {
      const int p = tid + u * kThreads;
      const bool ok = p < valid;
      key[u] = ok ? value_key(to_f32(x[i0 + p])) : kPadKey;
      wv[u] = 0.f;
      if constexpr (L == kMassSum) {
        if (ok) wv[u] = to_f32(w[i0 + p]);
      }
    }
    if constexpr (L == kMassSum) {
      Sort(sort_tmp).Sort(key, wv);
    } else {
      Sort(sort_tmp).Sort(key);
    }
    __syncthreads();  // the tile reuses the sort's storage

    // this thread's strip: sorted positions tid * I + u
    float g[R];
#pragma unroll
    for (int r = 0; r < R; ++r) g[r] = 0.f;
#pragma unroll
    for (int u = 0; u < I; ++u) {
      const bool ok = tid * I + u < valid;
      const float xv = ok ? key_value(key[u]) : 0.f;
      if constexpr (L == kSum) {
        wv[u] = xv;  // the stored row
        g[0] += xv;
      } else {
        wv[u] = ok ? wv[u] : 0.f;
        g[0] += wv[u];
        g[1] += ok ? __fmul_rn(wv[u], xv) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < I; u += 4) {
      *reinterpret_cast<uint4*>(skey + tid * I + u) =
          make_uint4(key[u], key[u + 1], key[u + 2], key[u + 3]);
      *reinterpret_cast<float4*>(srow + tid * I + u) =
          make_float4(wv[u], wv[u + 1], wv[u + 2], wv[u + 3]);
    }
    // the sums of the strips before and after this one: a warp's
    // Kogge-Stone scans, then the warps in order
    float ex[R], sx[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      gs[r * kThreads + tid] = g[r];
      float inc = g[r], sinc = g[r];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(kFull, inc, o);
        const float z = __shfl_down_sync(kFull, sinc, o);
        if (lane >= o) inc = y + inc;
        if (lane + o < 32) sinc = sinc + z;
      }
      ex[r] = __shfl_up_sync(kFull, inc, 1);
      sx[r] = __shfl_down_sync(kFull, sinc, 1);
      if (lane == 0) ex[r] = 0.f;
      if (lane == 31) sx[r] = 0.f;
      if (lane == 31) wtot[r][0][warp] = inc;
      if (lane == 0) wtot[r][1][warp] = sinc;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float off = 0.f, soff = 0.f;
      for (int v = 0; v < warp; ++v) off += wtot[r][0][v];
      for (int v = kWarps - 1; v > warp; --v) soff += wtot[r][1][v];
      pre[r * kThreads + tid] = off + ex[r];
      suf[r * kThreads + tid] = soff + sx[r];
    }

    // the boundaries p_s of every binned ladder
    for (int q0 = tid; q0 < nd * nedges; q0 += kThreads * kIlp) {
      unsigned k[kIlp];
      int pos[kIlp], at[kIlp];
#pragma unroll
      for (int i = 0; i < kIlp; ++i) {
        const int q = q0 + i * kThreads;
        const int d = q / nedges;
        at[i] = q < nd * nedges ? dl[d] * nedges + q - d * nedges : -1;
        k[i] = at[i] >= 0 ? ekey[at[i]] : 0u;
      }
      count_le<TILE>(skey, k, pos);
#pragma unroll
      for (int i = 0; i < kIlp; ++i)
        if (at[i] >= 0) bnd[at[i]] = pos[i];
    }
    __syncthreads();

    // slot 0 and the top slot of each binned ladder, one thread each
    Tile<L> t = tile;
    t.valid = valid;
    for (int q = tid; q < 2 * nd; q += kThreads) {
      const int j = dl[q >> 1];
      const bool top = q & 1;
      const int a = top ? bnd[j * nedges + nedges - 1] : 0;
      const int b = top ? valid : bnd[j * nedges];
      const int s = top ? nedges : 0;
      if (b > a) {
        hcnt[j * nslots + s] += b - a;
        float v[R];
        t.sum(a, b, v);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[(j * R + r) * nslots + s] += v[r];
      }
    }
    // the slots between, added in chunk order
    {
      const int ni = nedges - 1;  // interior slots a ladder
      int d = tid / ni, s = tid - d * ni + 1;
      for (int q = tid; q < nd * ni; q += kThreads) {
        const int j = dl[d];
        const int a = bnd[j * nedges + s - 1], b = bnd[j * nedges + s];
        if (b > a) {
          hcnt[j * nslots + s] += b - a;
          float v[R];
          t.sum(a, b, v);
#pragma unroll
          for (int r = 0; r < R; ++r) acc[(j * R + r) * nslots + s] += v[r];
        }
        s += kThreads;
        while (s > ni) { s -= ni; ++d; }
      }
    }
    __syncthreads();  // before the next chunk's sort reuses the tile
  }

  // this block's partials (a repeated ladder copies its first twin's) and
  // its counts
  {
    int j = tid / nslots, s = tid - j * nslots;
    for (int q = tid; q < nl * nslots; q += kThreads) {
      const int rj = rep[j];
      const int h = hcnt[rj * nslots + s];
      if (h) atomicAdd(&cnt[(long long)(first + j) * nslots + s], h);
      float* out = part + ((long long)blockIdx.x * nladders + first + j) *
                              R * nslots + s;
#pragma unroll
      for (int r = 0; r < R; ++r)
        out[r * nslots] = acc[(rj * R + r) * nslots + s];
      s += kThreads;
      while (s >= nslots) { s -= nslots; ++j; }
    }
  }
}

template <typename T, typename W, int L>
int launch(const void* x, const void* w, const void* edges, void* cnt,
           void* part, long long n, int nladders, int nedges, int group,
           int nblk, void* stream) {
  if (group < 1 || group > kMaxGroup || nedges < 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = Layout(group, nedges, Leg_<L>::rows).words() * 4;
  const auto kernel = sorted_sums_kernel<T, W, L>;
  // the sort's static storage and the dynamic layout pass 48 KB together
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)nblk, (unsigned)((nladders + group - 1) / group));
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const float*>(edges), static_cast<int*>(cnt),
      static_cast<float*>(part), n, nladders, nedges, group);
  return (int)cudaGetLastError();
}

template <int L>
int static_smem(long long* out) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, sorted_sums_kernel<float, float, L>);
  if (err != cudaSuccess) return (int)err;
  *out = (long long)attr.sharedSizeBytes;
  return 0;
}

template <int L>
int blocks_per_sm(int nedges, int group, int* out) {
  const size_t smem = Layout(group, nedges, Leg_<L>::rows).words() * 4;
  const auto kernel = sorted_sums_kernel<float, float, L>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                            kThreads, smem);
}

}  // namespace

// K3s: `cnt` (K, nbins+2) must be zeroed by the caller; `sums` (nblk, K,
// 1, nbins+2) is written whole; `group` (1..16) ladders share a block, and
// `nblk` blocks (fg_blocks(n)) read x.  Returns the first non-zero CUDA
// error code of the set-up or the launch, else 0.
extern "C" int shist_multi_sums_f32(const void* x, const void* edges,
                                    void* cnt, void* sums, long long n,
                                    int nladders, int nedges, int group,
                                    int nblk, void* stream) {
  return launch<float, float, kSum>(x, nullptr, edges, cnt, sums, n,
                                    nladders, nedges, group, nblk, stream);
}

extern "C" int shist_multi_sums_bf16(const void* x, const void* edges,
                                     void* cnt, void* sums, long long n,
                                     int nladders, int nedges, int group,
                                     int nblk, void* stream) {
  return launch<__nv_bfloat16, float, kSum>(x, nullptr, edges, cnt, sums, n,
                                            nladders, nedges, group, nblk,
                                            stream);
}

// K3ws, one entry per (x, w) type pair: `part` (nblk, K, 2, nbins+2) holds
// each block's f32 masses (row 0) and sums of w*x (row 1).
#define WSHIST_MULTI_SUMS(XN, XT, WN, WT)                                    \
  extern "C" int wshist_multi_sums_##XN##_##WN(                              \
      const void* x, const void* w, const void* edges, void* cnt,            \
      void* part, long long n, int nladders, int nedges, int group,          \
      int nblk, void* stream) {                                              \
    return launch<XT, WT, kMassSum>(x, w, edges, cnt, part, n, nladders,     \
                                    nedges, group, nblk, stream);            \
  }
WSHIST_MULTI_SUMS(f32, float, f32, float)
WSHIST_MULTI_SUMS(f32, float, bf16, __nv_bfloat16)
WSHIST_MULTI_SUMS(bf16, __nv_bfloat16, f32, float)
WSHIST_MULTI_SUMS(bf16, __nv_bfloat16, bf16, __nv_bfloat16)

// The dynamic shared bytes of a K3s (`rows` 1) or K3ws (2) block of `group`
// ladders of `nedges` edges, as the launch asks for them.
extern "C" long long sorted_sums_smem(int rows, int group, int nedges) {
  return (long long)Layout(group, nedges, rows).words() * 4;
}

// The blocks of the f32 instance of K3s (`rows` 1) or K3ws (2) that an SM
// holds at `group` ladders of `nedges` edges, into *out.  Returns the first
// non-zero CUDA error code, else 0.
extern "C" int sorted_sums_blocks_per_sm(int rows, int nedges, int group,
                                         int* out) {
  return rows == 1 ? blocks_per_sm<kSum>(nedges, group, out)
                   : blocks_per_sm<kMassSum>(nedges, group, out);
}

// The static shared bytes of the f32 instance of K3s (`rows` 1) or K3ws
// (2), which `cp_objective.SORTED_STATIC_SMEM` must cover, into *out.
// Returns the first non-zero CUDA error code, else 0.
extern "C" int sorted_sums_static_smem(int rows, long long* out) {
  return rows == 1 ? static_smem<kSum>(out) : static_smem<kMassSum>(out);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
