// K15 sign_vote: the majority vote of signSGD, sign(sum_i sign(x_i)) per
// coordinate; (n, d) stack -> (d,) fp32 in {-1, 0, +1} (NaN where a
// voting value is NaN).  K16 masked_sign_vote: the vote of the ARRIVED
// rows only (the async path's masked sign_sgd); absent rows cast no vote.
// K20 scaled_masked_sign_vote: K16 over a QUANTIZED stack, int8 / fp8
// e4m3 codes dequantized with their row's fp32 scale.
//
// Replaces repro/kernels/masked.py:sign_vote, masked_sign_vote and
// scaled_masked_sign_vote (the Pallas TPU kernels: per (n, TILE_D) VMEM
// tile, jnp.sign of the fp32 upcast, summed over the agent axis, then
// jnp.sign; the masked ones multiply each row's signs by its mask first;
// the scaled one votes on codes.astype(f32) * scale[:, None]).  The
// synchronous compressed sign_sgd runs K15 on the codes themselves
// (repro/kernels/dispatch.py:_scaled_sign_sgd: a scale > 0 never changes
// a sign), so K15 also takes int8 and fp8 codes.
//
// Bound on this card: bytes.  It reads the voting rows once (4, 2 or 1
// bytes each; K16 and K20 never read an absent row) and writes (d,) fp32;
// the work is one compare pair and one add per value (and K20's multiply).
//
// Design: one template, MASKED and SCALED the switches, as K4's layout
// (wsum.cu): each block lists the voting rows in shared memory (all n, or
// the rows with mask > 0.5, with their scales), then a grid-stride loop
// over coordinates, one coordinate per thread and coalesced row loads,
// upcasts in registers and adds each sign into an int (the reference's
// fp32 sum of +-1 / 0 is exact for n < 2^24, so any order agrees).  NaN is
// carried apart: jnp.sign(NaN) is NaN and poisons the column's vote, which
// a compare-only sign would turn into 0.  Where the reference multiplies
// an absent row's signs by 0 (so a NaN there still leaks, NaN * 0 = NaN),
// K16 and K20 do not read the row at all: the law's own "absent rows cast
// no vote" (ROADMAP.md P10).  SCALED keeps the reference's dequantizing
// multiply (__fmul_rn, the product of core.flat.dequantize_rows) before
// the sign: sign-neutral for a finite scale, but an inf scale (an inf
// row) times a 0 code is NaN and poisons the column, as in the reference;
// K15 on the raw codes casts a 0 vote there instead, as the JAX sync path
// does.  An e4m3 NaN code (0x7F / 0xFF) poisons its column in either;
// int8 has no NaN.
#include "common.cuh"

namespace {
constexpr int kMaxN = 64;
}

template <typename T, bool MASKED, bool SCALED>
__global__ void __launch_bounds__(256)
sign_vote_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                 const float* __restrict__ scale, float* __restrict__ out,
                 int n, long long d, long long ld) {
  __shared__ int rows[kMaxN];
  __shared__ float sc[kMaxN];
  __shared__ int nrows;
  if (threadIdx.x == 0) {
    int m = 0;
    for (int i = 0; i < n; ++i)
      if (!MASKED || mask[i] > 0.5f) {
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
    int votes = 0;
    bool nan = false;
    for (int r = 0; r < m; ++r) {
      float v = to_f32(x[(long long)rows[r] * ld + j]);
      if (SCALED) v = __fmul_rn(v, sc[r]);
      nan |= v != v;
      votes += (v > 0.f) - (v < 0.f);
    }
    out[j] = nan ? __int_as_float(0x7fc00000)
                 : (float)((votes > 0) - (votes < 0));
  }
}

template <typename T, bool MASKED, bool SCALED>
void sign_vote_run(const void* x, const float* mask, const float* scale,
                   float* out, int n, long long d, long long ld,
                   cudaStream_t s) {
  const int threads = 256;
  const unsigned blocks = grid_blocks(d, threads);
  sign_vote_kernel<T, MASKED, SCALED><<<blocks, threads, 0, s>>>(
      (const T*)x, mask, scale, out, n, d, ld);
}

// K15 and K16 take fp32, bf16 and (K15, on the sync path's codes) int8 /
// e4m3 codes; K20 (SCALED) takes codes only.
template <bool MASKED, bool SCALED>
int sign_vote_launch(const void* x, int dtype, const float* mask,
                     const float* scale, float* out, int n, long long d,
                     long long ld, cudaStream_t s) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  if (d <= 0) return 0;
  if constexpr (!SCALED) {
    if (dtype == RT_F32) {
      sign_vote_run<float, MASKED, false>(x, mask, scale, out, n, d, ld, s);
      return rt_status();
    }
    if (dtype == RT_BF16) {
      sign_vote_run<__nv_bfloat16, MASKED, false>(x, mask, scale, out, n, d,
                                                  ld, s);
      return rt_status();
    }
  }
  if (dtype == RT_I8)
    sign_vote_run<int8_t, MASKED, SCALED>(x, mask, scale, out, n, d, ld, s);
  else if (dtype == RT_F8)
    sign_vote_run<__nv_fp8_e4m3, MASKED, SCALED>(x, mask, scale, out, n, d,
                                                 ld, s);
  else
    return (int)cudaErrorInvalidValue;
  return rt_status();
}

RT_EXPORT int rt_sign_vote(const void* x, int dtype, float* out, int n,
                           long long d, long long ld, void* stream) {
  return sign_vote_launch<false, false>(x, dtype, nullptr, nullptr, out, n,
                                        d, ld, (cudaStream_t)stream);
}

// mask: (n,) fp32, > 0.5 = arrived.
RT_EXPORT int rt_masked_sign_vote(const void* x, int dtype, const float* mask,
                                  float* out, int n, long long d,
                                  long long ld, void* stream) {
  return sign_vote_launch<true, false>(x, dtype, mask, nullptr, out, n, d,
                                       ld, (cudaStream_t)stream);
}

// dtype RT_I8 or RT_F8; scale: (n,) fp32; mask: (n,) fp32, > 0.5 =
// arrived.
RT_EXPORT int rt_scaled_masked_sign_vote(const void* x, int dtype,
                                         const float* scale,
                                         const float* mask, float* out,
                                         int n, long long d, long long ld,
                                         void* stream) {
  return sign_vote_launch<true, true>(x, dtype, mask, scale, out, n, d, ld,
                                      (cudaStream_t)stream);
}
