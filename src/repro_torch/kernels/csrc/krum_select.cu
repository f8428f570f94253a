// K3 krum_select: (n, n) Gram -> (n,) one-hot fp32 at the Krum minimizer.
//
// Replaces repro/kernels/select.py:krum_select (the Pallas TPU kernel: one
// grid step; squared distances off the Gram with NaN -> +inf and a +inf
// diagonal, the per-row sort network, the k = max(n - f - 2, 1) smallest
// summed, and an exact comparison rank with first-index ties, NaN last).
//
// Bound on this card: launch latency.  The input is n^2 fp32 (16 KB at
// n = 64) and the work O(n^2) per row; nothing here is worth more than
// the few microseconds a launch costs.
//
// Design: one block, one thread per candidate row; the Gram diagonal and
// the distance rows live in shared memory; each thread sorts its own row,
// sums the k smallest in ascending order, and ranks its score against
// every other score (select.cuh, shared with K8-K10).
#include "select.cuh"

__global__ void krum_select_kernel(const float* __restrict__ gram,
                                   float* __restrict__ out, int n, int k) {
  __shared__ float sq[kSelectMaxN];
  __shared__ float rows[kSelectMaxN][kSelectMaxN + 1];
  __shared__ float scores[kSelectMaxN];
  krum_scores_block(gram, sq, rows, scores, n, k);
  const int i = threadIdx.x;
  if (i < n) out[i] = rank_of(scores, n, i) == 0 ? 1.f : 0.f;
}

RT_EXPORT int rt_krum_select(const float* gram, float* out, int n, int f,
                             void* stream) {
  if (n < 1 || n > kSelectMaxN || f < 0) return (int)cudaErrorInvalidValue;
  const int k = (n - f - 2) > 1 ? (n - f - 2) : 1;
  krum_select_kernel<<<1, kSelectMaxN, 0, (cudaStream_t)stream>>>(gram, out,
                                                                  n, k);
  return rt_status();
}
