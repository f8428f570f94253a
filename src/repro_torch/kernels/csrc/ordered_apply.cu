// K11 ordered_apply: the k rows picked by a selection ORDER, summed in
// pick order in fp32, divided by div: (n,) int32 order, (n, d) stack ->
// (d,) fp32.  multi-Krum (K9's order, /m), m-Krum (K10's order, /m) and
// MDA (the subset order, /(n - f)) apply their selection through it.
//
// Replaces repro/kernels/wsum.py:ordered_apply (the Pallas TPU kernel: per
// (n, TILE_D) VMEM tile, one masked extraction per rank, the k extracted
// rows summed as a stack or as a chain, then divided).  The reference's
// two summation shapes and its constant-division device (true_div) only
// pin XLA's reduce order and division strength reduction; here both
// shapes are the one sum in pick order, and the division is IEEE (the
// plain version divides by a device tensor, so it does too).
//
// Bound on this card: bytes.  It reads the k picked rows once (2 or 4
// bytes each) and writes (d,) fp32; the unpicked rows are never read.
//
// Design: as K4 (wsum.cu).  Each block reads the (n,) order once and
// lists, in shared memory, the row picked at each position r < k (the
// first row carrying r; none when no row does, which adds nothing); then
// a grid-stride loop over coordinates adds the listed rows in pick order
// from 0 and divides.  An +-inf in an unpicked row is never read, so it
// cannot leak through 0 * inf (the hazard the reference's where-copy
// guards, repro/kernels/ops.py:53-59).
#include "common.cuh"

namespace {
constexpr int kMaxN = 64;
}

template <typename T>
__global__ void __launch_bounds__(256)
ordered_apply_kernel(const int* __restrict__ order, const T* __restrict__ x,
                     float* __restrict__ out, int n, long long d,
                     long long ld, int k, float div) {
  __shared__ int pick[kMaxN];
  __shared__ int npick;
  if (threadIdx.x == 0) {
    for (int r = 0; r < k; ++r) pick[r] = -1;
    for (int i = 0; i < n; ++i) {
      const int o = order[i];
      if (o >= 0 && o < k && pick[o] < 0) pick[o] = i;
    }
    int m = 0;                        // compact, keeping the pick order
    for (int r = 0; r < k; ++r)
      if (pick[r] >= 0) pick[m++] = pick[r];
    npick = m;
  }
  __syncthreads();
  const int m = npick;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float acc = 0.f;
    for (int r = 0; r < m; ++r) acc += to_f32(x[(long long)pick[r] * ld + j]);
    out[j] = div > 0.f ? acc / div : acc;
  }
}

// div <= 0: no division.
RT_EXPORT int rt_ordered_apply(const int* order, const void* x, int dtype,
                               float* out, int n, long long d, long long ld,
                               int k, float div, void* stream) {
  if (n < 1 || n > kMaxN || k < 0 || k > n) return (int)cudaErrorInvalidValue;
  if (d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  const unsigned blocks = grid_blocks(d, threads);
  if (dtype == RT_F32)
    ordered_apply_kernel<float><<<blocks, threads, 0, s>>>(
        order, (const float*)x, out, n, d, ld, k, div);
  else if (dtype == RT_BF16)
    ordered_apply_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        order, (const __nv_bfloat16*)x, out, n, d, ld, k, div);
  else
    return (int)cudaErrorInvalidValue;
  return rt_status();
}
