// K11 ordered_apply: the k rows picked by a selection ORDER, summed in
// pick order in fp32, divided by div: (n,) int32 order, (n, d) stack ->
// (d,) fp32.  multi-Krum (K9's order, /m), m-Krum (K10's order, /m) and
// MDA (the subset order, /(n - f)) apply their selection through it.
// K12 masked_ordered_apply: the same over the MEAN-IMPUTED stack, without
// building it (the async path's masked multi-Krum, m-Krum and MDA).
//
// Replaces repro/kernels/wsum.py:ordered_apply and masked_ordered_apply
// (the Pallas TPU kernels: per (n, TILE_D) VMEM tile, one masked
// extraction per rank, the k extracted rows summed as a stack or as a
// chain, then divided; the masked one adds the tile's slice of the
// precomputed (d,) mean to a rank whose pick is a ghost, i.e. absent,
// row).  The reference's two summation shapes and its constant-division
// device (true_div) only pin XLA's reduce order and division strength
// reduction; here both shapes are the one sum in pick order, and the
// division is IEEE (the plain versions divide by a device tensor, so they
// do too).
//
// Bound on this card: bytes.  It reads the k picked rows once (2 or 4
// bytes each) and writes (d,) fp32; the unpicked rows are never read.
// Under IMPUTE a ghost pick reads the (d,) mean in place of its row (the
// absent row itself is never read), so several ghost picks read one mean.
//
// Design: as K4 (wsum.cu).  Each block reads the (n,) order once and
// lists, in shared memory, the row picked at each position r < k (the
// first row carrying r; none when no row does, which adds nothing) and,
// under IMPUTE, whether that row arrived (mask > 0.5); then a grid-stride
// loop over coordinates adds the listed rows in pick order from 0 (a
// ghost pick adds mean[j] upcast: exactly the mean's bits, as the
// reference's row + where(ghost, mean, 0) gives) and divides.  An +-inf in
// an unpicked row, or a NaN in an absent one, is never read, so it cannot
// leak through 0 * inf (the hazard the reference's where-copy guards,
// repro/kernels/ops.py:53-59).
#include "common.cuh"

namespace {
constexpr int kMaxN = 64;
}

// IMPUTE = false is K11 (mask and mean unused); IMPUTE = true is K12.
template <typename T, bool IMPUTE>
__global__ void __launch_bounds__(256)
ordered_apply_kernel(const int* __restrict__ order, const T* __restrict__ x,
                     const float* __restrict__ mask,
                     const T* __restrict__ mean, float* __restrict__ out,
                     int n, long long d, long long ld, int k, float div) {
  __shared__ int pick[kMaxN];
  __shared__ int live[kMaxN];
  __shared__ int npick;
  if (threadIdx.x == 0) {
    for (int r = 0; r < k; ++r) pick[r] = -1;
    for (int i = 0; i < n; ++i) {
      const int o = order[i];
      if (o >= 0 && o < k && pick[o] < 0) pick[o] = i;
    }
    int m = 0;                        // compact, keeping the pick order
    for (int r = 0; r < k; ++r)
      if (pick[r] >= 0) {
        live[m] = !IMPUTE || mask[pick[r]] > 0.5f;
        pick[m++] = pick[r];
      }
    npick = m;
  }
  __syncthreads();
  const int m = npick;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float acc = 0.f;
    for (int r = 0; r < m; ++r)
      acc += (!IMPUTE || live[r]) ? to_f32(x[(long long)pick[r] * ld + j])
                                  : to_f32(mean[j]);
    out[j] = div > 0.f ? acc / div : acc;
  }
}

template <bool IMPUTE>
int ordered_apply_launch(const int* order, const void* x, int dtype,
                         const float* mask, const void* mean, float* out,
                         int n, long long d, long long ld, int k, float div,
                         cudaStream_t s) {
  if (n < 1 || n > kMaxN || k < 0 || k > n) return (int)cudaErrorInvalidValue;
  if (d <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = grid_blocks(d, threads);
  if (dtype == RT_F32)
    ordered_apply_kernel<float, IMPUTE><<<blocks, threads, 0, s>>>(
        order, (const float*)x, mask, (const float*)mean, out, n, d, ld, k,
        div);
  else if (dtype == RT_BF16)
    ordered_apply_kernel<__nv_bfloat16, IMPUTE><<<blocks, threads, 0, s>>>(
        order, (const __nv_bfloat16*)x, mask, (const __nv_bfloat16*)mean,
        out, n, d, ld, k, div);
  else
    return (int)cudaErrorInvalidValue;
  return rt_status();
}

// div <= 0: no division.
RT_EXPORT int rt_ordered_apply(const int* order, const void* x, int dtype,
                               float* out, int n, long long d, long long ld,
                               int k, float div, void* stream) {
  return ordered_apply_launch<false>(order, x, dtype, nullptr, nullptr, out,
                                     n, d, ld, k, div, (cudaStream_t)stream);
}

// mask: (n,) fp32, > 0.5 = arrived; mean: (d,) in the arena dtype.
RT_EXPORT int rt_masked_ordered_apply(const int* order, const void* x,
                                      int dtype, const float* mask,
                                      const void* mean, float* out, int n,
                                      long long d, long long ld, int k,
                                      float div, void* stream) {
  return ordered_apply_launch<true>(order, x, dtype, mask, mean, out, n, d,
                                    ld, k, div, (cudaStream_t)stream);
}
