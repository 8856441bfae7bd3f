// The cross-block sums of the partials kernels K2 (`fg_batched.cu`) and K4
// (`fg_multi.cu`): f32 per-block partials part (outer, nblk, inner) ->
// out (outer, inner), summed over the block axis.
//
// Replaces the `jnp.sum(fsum, axis=0)` after the TPU kernels' grids in
// src/repro/kernels/cp_objective.py (`_fg_call_multi`, `_fg_call_batched`).
// torch.sum would do it in one call, but its order of additions may depend
// on the shape of the whole tensor, so a pivot's sums would change with K
// and differ between K4 at K = 1 and K2's row.  Here the order depends on
// nblk alone: one warp per output, lane l adds blocks l, l + 32, l + 64,
// ... in that order, then the 32 lane sums meet in a fixed shuffle tree.
// No float atomics: two launches give the same bits.
//
// Bound: bytes; the partials are at most a few hundred KB (1024 blocks x
// K x 4 floats), read once.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
sum_blocks_kernel(const float* __restrict__ part, float* __restrict__ out,
                  long long outer, int nblk, long long inner) {
  const long long j = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= outer * inner) return;  // the whole warp leaves together
  const long long o = j / inner, i = j % inner;
  const float* p = part + o * nblk * inner + i;
  float s = 0.f;
  for (int b = lane; b < nblk; b += 32) s += p[(long long)b * inner];
  for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(0xffffffffu, s, d);
  if (lane == 0) out[j] = s;
}

}  // namespace

// Returns the launch's cudaGetLastError() code.
extern "C" int sum_blocks_f32(const void* part, void* out, long long outer,
                              int nblk, long long inner, void* stream) {
  const long long nout = outer * inner;
  const unsigned grid = (unsigned)((nout + kWarps - 1) / kWarps);
  sum_blocks_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(part), static_cast<float*>(out), outer, nblk,
      inner);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
