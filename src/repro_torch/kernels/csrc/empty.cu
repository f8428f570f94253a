// An empty kernel: one launch of one warp that does nothing.  What it
// takes under the smoke test's timer (CUDA events around many launches)
// is the floor of every launch, the bound that the launch-bound kernels
// (K3, K8-K10 on an (n, n) Gram) are held to in PERF.md.
#include "common.cuh"

__global__ void empty_kernel() {}

RT_EXPORT int rt_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return rt_status();
}
