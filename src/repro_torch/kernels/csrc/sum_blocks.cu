// The cross-block sums of every leg with f32 block partials: the partials
// kernels K2 (`fg_batched.cu`) and K4 (`fg_multi.cu`), and the histogram
// legs with rows, K1w/K1s/K1ws (`hist_batched.cu`) and K3w/K3s/K3ws
// (`hist_multi.cu`): f32 per-block partials part (outer, nblk, inner) ->
// out (outer, inner), summed over the block axis.
//
// Replaces the `jnp.sum(..., axis=0 or 1)` after the TPU kernels' grids in
// src/repro/kernels/cp_objective.py (`_fg_call_multi`, `_fg_call_batched`,
// `_hist_call_multi`, `_hist_call_batched`).  torch.sum would do it in one
// call, but its order of additions may depend on the shape of the whole
// tensor, so a pivot's sums would change with K and differ between K4 at
// K = 1 and K2's row, and a histogram row's or ladder's masses would follow
// the other rows or ladders of its launch.  Here the order depends on nblk
// alone: for each output, "lane" l adds blocks l, l + 32, l + 64, ... in
// that order, then the 32 lane sums meet in a fixed shuffle tree.  No float
// atomics: two launches give the same bits.
//
// A block sums 32 consecutive outputs: thread (warp l, lane c) runs lane
// l's serial sum for output c, so that a warp reads 32 neighbouring
// partials of one block at a time (coalesced); the 32 x 32 lane sums pass
// through shared memory to warp c, whose lane l holds lane l's sum, and
// meet there in the shuffle tree.
//
// Bound: bytes; the partials are at most a few MB (1024 blocks x K x 4
// floats, or x 130 slots x a row or two per ladder), read once.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;  // lane sums per output, and outputs per block

__global__ void __launch_bounds__(kLanes * 32)
sum_blocks_kernel(const float* __restrict__ part, float* __restrict__ out,
                  int nblk, long long inner) {
  __shared__ float tile[kLanes][kLanes + 1];  // [lane l][output c]
  const int l = threadIdx.x >> 5;   // which lane sum
  const int c = threadIdx.x & 31;   // which output of the block's 32
  const long long o = blockIdx.y;
  const long long i = (long long)blockIdx.x * kLanes + c;
  float s = 0.f;
  if (i < inner) {
    const float* p = part + o * nblk * inner + i;
    for (int b = l; b < nblk; b += kLanes) s += p[(long long)b * inner];
  }
  tile[l][c] = s;
  __syncthreads();
  s = tile[c][l];  // warp l now holds output l's 32 lane sums, lane c's
  for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(0xffffffffu, s, d);
  const long long j = (long long)blockIdx.x * kLanes + l;
  if (c == 0 && j < inner) out[o * inner + j] = s;
}

}  // namespace

// Returns the launch's cudaGetLastError() code.
extern "C" int sum_blocks_f32(const void* part, void* out, long long outer,
                              int nblk, long long inner, void* stream) {
  const dim3 grid((unsigned)((inner + kLanes - 1) / kLanes),
                  (unsigned)outer);
  sum_blocks_kernel<<<grid, kLanes * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(part), static_cast<float*>(out), nblk,
      inner);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
