// K17 sparse_masked_weighted_mean: the sparse / dropout-aware weighted
// mean of sparse_mean.  A zero coordinate means "not sent", so each
// coordinate is averaged over the live rows that sent it,
//
//   cw_i = (x_i != 0) * w_i * live_i,
//   out  = sum_i cw_i x_i / sum_i cw_i,  or exactly 0 where the sum is 0
//
// ((n, d) fp32 / bf16 stack, (n,) mask and raw row weights -> (d,) fp32).
// K21 scaled_sparse_masked_weighted_mean: the same law on a QUANTIZED
// stack, int8 / fp8 e4m3 codes dequantized with their row's fp32 scale.
//
// Replaces repro/kernels/wsum.py:sparse_masked_weighted_mean and
// scaled_sparse_masked_weighted_mean (the Pallas TPU kernels: per (n,
// TILE_D) VMEM tile, the fp32 upcast (times the scale), cw = (x != 0) *
// where(live, w, 0), then sum(where(cw > 0, x, 0) * cw) / sum(cw) with the
// zero-denominator guard, _sparse_mean_body).
//
// Bound on this card: bytes.  It reads the live rows once (4, 2 or 1
// bytes a value; an absent row is never read) and writes (d,) fp32; the
// work is a compare, a select, a multiply and two adds per value.
//
// Design: sign_vote.cu's layout.  Each block lists the live rows (mask >
// 0.5) in shared memory with their weights (and, SCALED, their scales),
// then a grid-stride loop over coordinates, one coordinate per thread and
// coalesced row loads.  Per value, in row order: the fp32 upcast (SCALED:
// times the scale with one rounded multiply, __fmul_rn, exactly
// core.flat.dequantize_rows); "sent" tests that decoded fp32 value, not
// the code, so -0.0 is not sent, a NaN is sent and poisons its column,
// and an inf row's 0 codes decode to 0 * inf = NaN and poison every
// column where the row is live, as in the reference; cw = sent ? w : 0;
// num += (cw > 0 ? x : 0) * cw and den += cw.  The where-gate, not a
// multiply by 0, keeps an unsent value out of the sums.  The products and
// sums are __fmul_rn / __fadd_rn, never contracted into a fused
// multiply-add (the plain version, wsum.sparse_masked_weighted_mean_plain,
// rounds each product and each sum the same way, in the same row order),
// and the quotient is __fdiv_rn.
#include "common.cuh"

namespace {
constexpr int kMaxN = 64;
}

template <typename T, bool SCALED>
__global__ void __launch_bounds__(256)
sparse_wmean_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ mask,
                    const float* __restrict__ w, float* __restrict__ out,
                    int n, long long d, long long ld) {
  __shared__ int rows[kMaxN];
  __shared__ float wr[kMaxN];
  __shared__ float sc[kMaxN];
  __shared__ int nrows;
  if (threadIdx.x == 0) {
    int m = 0;
    for (int i = 0; i < n; ++i)
      if (mask[i] > 0.5f) {
        wr[m] = w[i];
        if (SCALED) sc[m] = scale[i];
        rows[m++] = i;
      }
    nrows = m;
  }
  __syncthreads();
  const int m = nrows;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float num = 0.f, den = 0.f;
    for (int r = 0; r < m; ++r) {
      float v = to_f32(x[(long long)rows[r] * ld + j]);
      if (SCALED) v = __fmul_rn(v, sc[r]);
      const float cw = v != 0.f ? wr[r] : 0.f;
      num = __fadd_rn(num, __fmul_rn(cw > 0.f ? v : 0.f, cw));
      den = __fadd_rn(den, cw);
    }
    out[j] = den > 0.f ? __fdiv_rn(num, den) : 0.f;
  }
}

template <typename T, bool SCALED>
int sparse_wmean_run(const void* x, const float* scale, const float* mask,
                     const float* w, float* out, int n, long long d,
                     long long ld, cudaStream_t s) {
  const int threads = 256;
  const unsigned blocks = grid_blocks(d, threads);
  sparse_wmean_kernel<T, SCALED><<<blocks, threads, 0, s>>>(
      (const T*)x, scale, mask, w, out, n, d, ld);
  return rt_status();
}

// K17: dtype RT_F32 or RT_BF16; mask: (n,) fp32, > 0.5 = live; w: (n,)
// fp32 raw row weights.
RT_EXPORT int rt_sparse_masked_weighted_mean(const void* x, int dtype,
                                             const float* mask,
                                             const float* w, float* out,
                                             int n, long long d,
                                             long long ld, void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  if (d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == RT_F32)
    return sparse_wmean_run<float, false>(x, nullptr, mask, w, out, n, d, ld,
                                          s);
  if (dtype == RT_BF16)
    return sparse_wmean_run<__nv_bfloat16, false>(x, nullptr, mask, w, out,
                                                  n, d, ld, s);
  return (int)cudaErrorInvalidValue;
}

// K21: dtype RT_I8 or RT_F8; scale: (n,) fp32; mask and w as K17's.
RT_EXPORT int rt_scaled_sparse_masked_weighted_mean(
    const void* x, int dtype, const float* scale, const float* mask,
    const float* w, float* out, int n, long long d, long long ld,
    void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  if (d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == RT_I8)
    return sparse_wmean_run<int8_t, true>(x, scale, mask, w, out, n, d, ld,
                                          s);
  if (dtype == RT_F8)
    return sparse_wmean_run<__nv_fp8_e4m3, true>(x, scale, mask, w, out, n,
                                                 d, ld, s);
  return (int)cudaErrorInvalidValue;
}
