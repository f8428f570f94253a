// K4 weighted_sum: w^T G over the agent axis, (d,) fp32 out.
//
// Replaces repro/kernels/wsum.py:weighted_sum (the Pallas TPU kernel: one
// (1, n) x (n, TILE_D) dot per VMEM tile), with the caller's
// _drop_unselected (repro/kernels/ops.py:53-59) fused in.
//
// Bound on this card: bytes.  Rows with w_i <= 0 are skipped and never
// read, so Krum's one-hot w reads ONE row and writes (d,) fp32; the JAX
// path's (n, d) where-copy that zeroes the other rows does not exist.
//
// Design: each block first lists the selected rows (w_i > 0) in shared
// memory, so the per-coordinate loop touches only those and carries no
// weight loads or branches; then a grid-stride loop over coordinates (a
// few blocks per SM) sums the selected rows in row order, in fp32, as a
// chain of fused multiply-adds starting from the first selected product
// (the arithmetic the jitted JAX step compiles sum(w * x) to), so a
// one-hot w returns exactly the selected row's bits and 0 * inf from a
// rejected row cannot reach the sum.
#include "common.cuh"

namespace {
constexpr int kMaxN = 64;
}

template <typename T>
__global__ void __launch_bounds__(256)
wsum_kernel(const float* __restrict__ w, const T* __restrict__ x,
            float* __restrict__ out, int n, long long d, long long ld) {
  // the selected rows (w_i > 0), in row order, listed once per block
  __shared__ int sel[kMaxN];
  __shared__ float wsel[kMaxN];
  __shared__ int nsel;
  if (threadIdx.x == 0) {
    int m = 0;
    for (int i = 0; i < n; ++i) {
      const float wi = w[i];
      if (wi > 0.f) {
        sel[m] = i;
        wsel[m] = wi;
        ++m;
      }
    }
    nsel = m;
  }
  __syncthreads();
  const int m = nsel;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float acc = 0.f;
    for (int k = 0; k < m; ++k) {
      const float v = to_f32(x[(long long)sel[k] * ld + j]);
      acc = k ? __fmaf_rn(wsel[k], v, acc) : wsel[k] * v;
    }
    out[j] = acc;
  }
}

RT_EXPORT int rt_weighted_sum(const float* w, const void* x, int dtype,
                              float* out, int n, long long d, long long ld,
                              void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  if (d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  const unsigned blocks = grid_blocks(d, threads);
  if (dtype == RT_F32)
    wsum_kernel<float><<<blocks, threads, 0, s>>>(w, (const float*)x, out, n,
                                                  d, ld);
  else if (dtype == RT_BF16)
    wsum_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        w, (const __nv_bfloat16*)x, out, n, d, ld);
  else
    return (int)cudaErrorInvalidValue;
  return rt_status();
}
