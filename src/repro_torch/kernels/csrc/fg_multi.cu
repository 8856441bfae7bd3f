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
// Bound on an H100 SXM: instruction issue, not bytes.  One read of x (and
// of w) is 0.16 ms (0.32 ms with f32 weights) at n = 2^27 against
// 3.35 TB/s; the work per element and pivot is at least 7 f32 lane
// operations on the counting leg (a subtract, two compares, two sum adds,
// two count adds) and 10 on the weighted leg (a multiply, two more sum
// adds), none of them an FMA.  An SM issues 4 warp instructions (128 lane
// operations) per clock, so at K = 16, n = 2^27 and 1.98 GHz that is
// 0.45 ms (0.64 ms).
//
// Design:
// - a block holds G pivots (G in {1, 2, 4, 8, 16}, a template parameter, the
//   smallest that covers K up to 16) with its accumulators in registers;
//   K > 16 splits into groups of 16 along grid.y, and each group reads x
//   (and w) again (ceil(K / 16) times);
// - grid (nblk, groups); each block strides over its share of x with 64-bit
//   offsets as K2 does (`fg_batched.cu`), and loads the next kUnroll
//   elements (and weights) while it sums the current ones;
// - per (element, pivot) every sum and count is ONE predicated add (inline
//   PTX, `add.rn`, so never contracted), behind compares that each give a
//   predicate and its complement.  Where every pivot of the block is
//   finite, d is NaN exactly where x is, so one compare fewer serves (see
//   `step`; the general path runs for a block with an inf or NaN pivot).
//   At G = 16 the main loop runs 7.4 SASS instructions per (element,
//   pivot) on the counting leg (8.3 on the general path) and 10.7 (11.5)
//   on the weighted leg, loads and loop included (`cuobjdump -sass`, as
//   `chip_smoke.py`'s `sass_g16` counts them);
// - a skipped add stands for the select chains' `+ 0`: an accumulator
//   that starts at +0 never becomes -0, so adding +0 leaves it unchanged
//   and the sums are K2's bit for bit.  Counts ride in f32 on the counting
//   leg (exact: a thread counts at most 8192 elements, n < 2^31) and
//   packed in one int (#(d < 0) low, #(d <= 0) high half) on the weighted
//   leg: 126 and 128 registers at G = 16, no spills, two 8-warp blocks per
//   SM;
// - per-thread sums and counts, then the fixed-order warp-shuffle and
//   shared-memory block reduce of K2, pivot by pivot: one partial per
//   block and pivot, no float atomics; the wrapper sums the block partials
//   with `sum_blocks.cu` as it does K2's.  Every pivot sees the elements in
//   K2's order, so its partials do not depend on K or on its group, and at
//   K = 1 they equal K2's bit for bit.  The wrapper picks nblk from n
//   alone, so the sums repeat bit for bit from run to run;
// - NaN as K2: on the counting leg a NaN d adds into both sums (as
//   max(d, 0) does), on the weighted leg it adds nothing, and it never
//   counts; the weighted products are __fmul_rn, and -w*d is formed as
//   -(w*d), equal bit for bit in round-to-nearest.
// Built without fast-math, so denormal differences are kept (no flush).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // elements per thread and batch, either leg
constexpr int kMaxGroup = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the weight type of the counting leg: no weights are read
struct NoWeights {};

// NF f32 sums (2 counting, 4 weighted) and the two counts, as reduced
template <int NF>
struct Partials {
  float s[NF];
  int lt, le;
};

template <typename W>
constexpr int kSums = std::is_same<W, NoWeights>::value ? 2 : 4;

// A thread's running partials of one pivot.  Counting leg: the two sums
// and the counts in f32.
struct CountAcc {
  float pos, neg, lt, le;
  __device__ __forceinline__ Partials<2> partials() const {
    return {{pos, neg}, (int)lt, (int)le};
  }
};

// Weighted leg: four sums, and the two counts packed in one int.
struct WeightAcc {
  float pos, neg, wlt, wle;
  unsigned cnt;  // #(d < 0) in the low half, #(d <= 0) in the high half
  __device__ __forceinline__ Partials<4> partials() const {
    return {{pos, neg, wlt, wle}, (int)(cnt & 0xffffu), (int)(cnt >> 16)};
  }
};

template <typename W>
using Acc = typename std::conditional<std::is_same<W, NoWeights>::value,
                                      CountAcc, WeightAcc>::type;

// One element as every pivot reads it: x, its weight, and on the finite
// path the weight and count increment that a NaN x zeroes (with a finite
// pivot d is NaN exactly where x is).
struct Elem {
  float x, w, wq, one;
};

// One (element, pivot) term with d = x - y.  Counting leg: `gtu|le` gives
// d > 0 or NaN (pos += d: max(d, 0) with its NaN) and its complement
// d <= 0 (le += 1); `ltu` gives d < 0 or NaN (neg -= d).  #(d < 0) needs
// the ordered compare, unless every pivot is finite (Finite), where
// d < 0 or NaN, counted by `one` (0 for a NaN x), is the same count.
template <bool Finite>
__device__ __forceinline__ void step(CountAcc& a, float d, const Elem& e) {
  if (Finite) {
    asm("{\n\t.reg .pred pup, ple, plu;\n\t"
        "setp.gtu.f32 pup|ple, %4, 0f00000000;\n\t"
        "@pup add.rn.f32 %0, %0, %4;\n\t"
        "@ple add.rn.f32 %3, %3, 0f3F800000;\n\t"
        "setp.ltu.f32 plu, %4, 0f00000000;\n\t"
        "@plu sub.rn.f32 %1, %1, %4;\n\t"
        "@plu add.rn.f32 %2, %2, %5;\n\t"
        "}"
        : "+f"(a.pos), "+f"(a.neg), "+f"(a.lt), "+f"(a.le)
        : "f"(d), "f"(e.one));
  } else {
    asm("{\n\t.reg .pred pup, ple, plu, plt;\n\t"
        "setp.gtu.f32 pup|ple, %4, 0f00000000;\n\t"
        "@pup add.rn.f32 %0, %0, %4;\n\t"
        "@ple add.rn.f32 %3, %3, 0f3F800000;\n\t"
        "setp.ltu.f32 plu, %4, 0f00000000;\n\t"
        "@plu sub.rn.f32 %1, %1, %4;\n\t"
        "setp.lt.f32 plt, %4, 0f00000000;\n\t"
        "@plt add.rn.f32 %2, %2, 0f3F800000;\n\t"
        "}"
        : "+f"(a.pos), "+f"(a.neg), "+f"(a.lt), "+f"(a.le)
        : "f"(d));
  }
}

// Weighted leg: p = w*d; `gt` adds p to pos, `lt` subtracts it from neg
// (-(w*d) == (-w)*d) and adds w to the mass below; d <= 0 adds w to the
// mass at or below.  With every pivot finite the complement of `gt`
// (d <= 0 or NaN) serves for d <= 0, with the NaN x's weight and count
// increment zeroed (wq, one).
template <bool Finite>
__device__ __forceinline__ void step(WeightAcc& a, float d, const Elem& e) {
  const float p = __fmul_rn(e.w, d);
  if (Finite) {
    asm("{\n\t.reg .pred pgt, ple, plt;\n\t"
        "setp.gt.f32 pgt|ple, %5, 0f00000000;\n\t"
        "@pgt add.rn.f32 %0, %0, %6;\n\t"
        "@ple add.rn.f32 %3, %3, %8;\n\t"
        "@ple add.u32 %4, %4, %9;\n\t"
        "setp.lt.f32 plt, %5, 0f00000000;\n\t"
        "@plt sub.rn.f32 %1, %1, %6;\n\t"
        "@plt add.rn.f32 %2, %2, %7;\n\t"
        "@plt add.u32 %4, %4, 1;\n\t"
        "}"
        : "+f"(a.pos), "+f"(a.neg), "+f"(a.wlt), "+f"(a.wle), "+r"(a.cnt)
        : "f"(d), "f"(p), "f"(e.w), "f"(e.wq),
          "r"(e.one != 0.f ? 0x10000u : 0u));
  } else {
    asm("{\n\t.reg .pred pgt, ple, plt;\n\t"
        "setp.gt.f32 pgt, %5, 0f00000000;\n\t"
        "@pgt add.rn.f32 %0, %0, %6;\n\t"
        "setp.le.f32 ple, %5, 0f00000000;\n\t"
        "@ple add.rn.f32 %3, %3, %7;\n\t"
        "@ple add.u32 %4, %4, 65536;\n\t"
        "setp.lt.f32 plt, %5, 0f00000000;\n\t"
        "@plt sub.rn.f32 %1, %1, %6;\n\t"
        "@plt add.rn.f32 %2, %2, %7;\n\t"
        "@plt add.u32 %4, %4, 1;\n\t"
        "}"
        : "+f"(a.pos), "+f"(a.neg), "+f"(a.wlt), "+f"(a.wle), "+r"(a.cnt)
        : "f"(d), "f"(p), "f"(e.w));
  }
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

template <typename T, typename W>
__device__ __forceinline__ Elem load(const T* x, const W* w, long long i) {
  Elem e;
  e.x = to_f32(x[i]);
  if constexpr (std::is_same<W, NoWeights>::value) {
    e.w = 0.f;
  } else {
    e.w = to_f32(w[i]);
  }
  return e;
}

// What the finite path reads besides x and w: a NaN x adds no weight and
// no count through the complement predicates.
template <bool Finite>
__device__ __forceinline__ void prepare(Elem& e) {
  if (Finite) {
    const bool nan = e.x != e.x;
    e.wq = nan ? 0.f : e.w;
    e.one = nan ? 0.f : 1.f;
  }
}

// The thread's share of x, in K2's order (i, i + stride, ...): whole
// batches of kUnroll elements, the next batch loaded while the current one
// is summed, then the tail one element at a time.
template <bool Finite, typename T, typename W, int G>
__device__ __forceinline__ void sweep(const T* __restrict__ x,
                                      const W* __restrict__ w,
                                      const float (&yv)[G], Acc<W> (&a)[G],
                                      long long i, long long n,
                                      long long stride) {
  const long long batch = kUnroll * stride;
  bool full = i + (kUnroll - 1) * stride < n;
  Elem cur[kUnroll];
  if (full) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = load(x, w, i + u * stride);
  }
  while (full) {
    const bool more = i + batch + (kUnroll - 1) * stride < n;
    // the last batch reloads itself (valid addresses, values unused)
    const long long src = more ? i + batch : i;
    Elem next[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) next[u] = load(x, w, src + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      prepare<Finite>(cur[u]);
#pragma unroll
      for (int g = 0; g < G; ++g)
        step<Finite>(a[g], __fsub_rn(cur[u].x, yv[g]), cur[u]);
    }
    i += batch;
    full = more;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = next[u];
  }
  for (; i < n; i += stride) {
    Elem e = load(x, w, i);
    prepare<Finite>(e);
#pragma unroll
    for (int g = 0; g < G; ++g) step<Finite>(a[g], __fsub_rn(e.x, yv[g]), e);
  }
}

// two blocks per SM: at most 128 registers a thread (G = 16 takes 126 on
// the counting leg, 128 on the weighted leg, and spills nothing)
template <typename T, typename W, int G>
__global__ void __launch_bounds__(kThreads, 2)
fg_multi_kernel(const T* __restrict__ x, const W* __restrict__ w,
                const float* __restrict__ y, float* __restrict__ fsum,
                int* __restrict__ cnt, long long n, int npiv) {
  constexpr int NF = kSums<W>;
  __shared__ Partials<NF> warp_parts[kThreads / 32][G];
  const int first = blockIdx.y * G;
  const int np = min(G, npiv - first);
  float yv[G];
  Acc<W> a[G];
  bool finite = true;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    // a group's unused slots repeat its first pivot and are never written
    yv[g] = y[first + (g < np ? g : 0)];
    finite = finite && fabsf(yv[g]) <= 3.40282347e+38f;  // not inf, NaN
    a[g] = Acc<W>{};
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // the same pivots for the whole block: a uniform branch
  if (finite)
    sweep<true>(x, w, yv, a, i, n, stride);
  else
    sweep<false>(x, w, yv, a, i, n, stride);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    Partials<NF> p = a[g].partials();
    warp_reduce(p);
    if (lane == 0) warp_parts[warp][g] = p;
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
