// K8 cge_select: (n, n) Gram -> (n,) {0,1} fp32 keep-mask of the n_keep
// smallest row norms (comparative gradient elimination).
//
// Replaces repro/kernels/select.py:cge_select (the Pallas TPU kernel: one
// grid step; norms sqrt(max(G_ii, 0)) off the Gram diagonal, an exact
// comparison rank with first-index ties and NaN last, rank < n_keep).
//
// Bound on this card: launch latency (n reads of the diagonal).
//
// Design: one block, one thread per row.  The max propagates NaN
// (nan_max): CUDA's fmaxf(NaN, 0) is 0, which would rank a NaN-norm row
// FIRST and keep the hostile row; with the NaN kept, rank_of orders it
// last.  sqrtf is correctly rounded (no fast-math), as torch.sqrt is, so
// equal and distinct norms tie exactly as in the plain version.
#include "select.cuh"

__global__ void cge_select_kernel(const float* __restrict__ gram,
                                  float* __restrict__ out, int n,
                                  int n_keep) {
  __shared__ float norms[kSelectMaxN];
  const int i = threadIdx.x;
  if (i < n) norms[i] = sqrtf(nan_max(gram[i * n + i], 0.f));
  __syncthreads();
  if (i < n) out[i] = rank_of(norms, n, i) < n_keep ? 1.f : 0.f;
}

RT_EXPORT int rt_cge_select(const float* gram, float* out, int n,
                            int n_keep, void* stream) {
  if (n < 1 || n > kSelectMaxN || n_keep < 0)
    return (int)cudaErrorInvalidValue;
  cge_select_kernel<<<1, kSelectMaxN, 0, (cudaStream_t)stream>>>(gram, out,
                                                                 n, n_keep);
  return rt_status();
}
