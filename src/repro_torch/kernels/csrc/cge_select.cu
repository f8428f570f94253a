// K8 cge_select: (n, n) Gram -> (n,) {0,1} fp32 keep-mask of the n_keep
// smallest row norms (comparative gradient elimination).
//
// Replaces repro/kernels/select.py:cge_select (the Pallas TPU kernel: one
// grid step; norms sqrt(max(G_ii, 0)) off the Gram diagonal, an exact
// comparison rank with first-index ties and NaN last, rank < n_keep).
//
// Bound on this card: launch latency (n reads of the diagonal).
//
// Design: one block, one thread per row, through select.cuh:cge_keep (the
// norms with NaN kept, then their exact rank), the function the CGE apply
// (wsum.cu, masked_wsum.cu) runs as its prologue: the main path's CGE
// launches that apply and not this kernel, which stays the counterpart of
// the TPU kernel for its callers.
#include "select.cuh"

__global__ void cge_select_kernel(const float* __restrict__ gram,
                                  float* __restrict__ out, int n,
                                  int n_keep) {
  __shared__ float norms[kSelectMaxN];
  const float keep = cge_keep(gram, norms, n, n_keep);
  if (threadIdx.x < n) out[threadIdx.x] = keep;
}

RT_EXPORT int rt_cge_select(const float* gram, float* out, int n,
                            int n_keep, void* stream) {
  if (n < 1 || n > kSelectMaxN || n_keep < 0)
    return (int)cudaErrorInvalidValue;
  cge_select_kernel<<<1, kSelectMaxN, 0, (cudaStream_t)stream>>>(gram, out,
                                                                 n, n_keep);
  return rt_status();
}
