// K15 sign_vote: the majority vote of signSGD, sign(sum_i sign(x_i)) per
// coordinate; (n, d) stack -> (d,) fp32 in {-1, 0, +1} (NaN where a
// voting value is NaN).  K16 masked_sign_vote: the vote of the ARRIVED
// rows only (the async path's masked sign_sgd); absent rows cast no vote.
//
// Replaces repro/kernels/masked.py:sign_vote and masked_sign_vote (the
// Pallas TPU kernels: per (n, TILE_D) VMEM tile, jnp.sign of the fp32
// upcast, summed over the agent axis, then jnp.sign; the masked one
// multiplies each row's signs by its mask first).
//
// Bound on this card: bytes.  It reads the voting rows once (2 or 4 bytes
// each; K16 never reads an absent row) and writes (d,) fp32; the work is
// one compare pair and one add per value.
//
// Design: one template, MASKED the switch, as K4's layout (wsum.cu): each
// block lists the voting rows in shared memory (all n, or the rows with
// mask > 0.5), then a grid-stride loop over coordinates, one coordinate
// per thread and coalesced row loads, upcasts in registers and adds each
// sign into an int (the reference's fp32 sum of +-1 / 0 is exact for n <
// 2^24, so any order agrees).  NaN is carried apart: jnp.sign(NaN) is
// NaN and poisons the column's vote, which a compare-only sign would
// turn into 0.  Where the reference multiplies an absent row's signs by
// 0 (so a NaN there still leaks, NaN * 0 = NaN), K16 does not read the
// row at all: the law's own "absent rows cast no vote" (ROADMAP.md P10).
#include "common.cuh"

namespace {
constexpr int kMaxN = 64;
}

template <typename T, bool MASKED>
__global__ void __launch_bounds__(256)
sign_vote_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                 float* __restrict__ out, int n, long long d, long long ld) {
  __shared__ int rows[kMaxN];
  __shared__ int nrows;
  if (threadIdx.x == 0) {
    int m = 0;
    for (int i = 0; i < n; ++i)
      if (!MASKED || mask[i] > 0.5f) rows[m++] = i;
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
      const float v = to_f32(x[(long long)rows[r] * ld + j]);
      nan |= v != v;
      votes += (v > 0.f) - (v < 0.f);
    }
    out[j] = nan ? __int_as_float(0x7fc00000)
                 : (float)((votes > 0) - (votes < 0));
  }
}

template <bool MASKED>
int sign_vote_launch(const void* x, int dtype, const float* mask, float* out,
                     int n, long long d, long long ld, cudaStream_t s) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  if (d <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = grid_blocks(d, threads);
  if (dtype == RT_F32)
    sign_vote_kernel<float, MASKED><<<blocks, threads, 0, s>>>(
        (const float*)x, mask, out, n, d, ld);
  else if (dtype == RT_BF16)
    sign_vote_kernel<__nv_bfloat16, MASKED><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)x, mask, out, n, d, ld);
  else
    return (int)cudaErrorInvalidValue;
  return rt_status();
}

RT_EXPORT int rt_sign_vote(const void* x, int dtype, float* out, int n,
                           long long d, long long ld, void* stream) {
  return sign_vote_launch<false>(x, dtype, nullptr, out, n, d, ld,
                                 (cudaStream_t)stream);
}

// mask: (n,) fp32, > 0.5 = arrived.
RT_EXPORT int rt_masked_sign_vote(const void* x, int dtype, const float* mask,
                                  float* out, int n, long long d,
                                  long long ld, void* stream) {
  return sign_vote_launch<true>(x, dtype, mask, out, n, d, ld,
                                (cudaStream_t)stream);
}
