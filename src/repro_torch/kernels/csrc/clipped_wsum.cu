// K22 clipped_weighted_sum: one centered-clipping step,
//   out = (1 - sum_i lam_i) v + sum_{lam_i > 0} lam_i g_i,  (d,) fp32 out.
//
// Replaces repro/kernels/wsum.py:clipped_weighted_sum (the Pallas TPU
// kernel: per (n, TILE_D) VMEM tile, the rows where-gated on lam > 0,
// one (1, n) x (n, TILE_D) dot and (1 - sum lam) v added).  The caller
// computes lam_i = w_i / tot * min(1, tau / ||g_i - v||) outside: the
// clip radius needs whole-row norms, a reduction across every block.
//
// Bound on this card: bytes.  The rows with lam_i > 0 are read once, v is
// read once and (d,) fp32 is written; a row with lam_i = 0 (absent, or
// given no weight) is never read, so its inf or NaN cannot leak.
//
// Design: K7's.  Each block lists the rows with lam_i > 0 in shared
// memory and sums sum_i lam_i once, over every row in row order, each
// sum rounded on its own (a NaN lam poisons the sum, as in JAX, and
// gates its row out); then a grid-stride loop over coordinates sums the
// listed rows in row order as a chain of fused multiply-adds from the
// first rounded product (K4's arithmetic) and adds the center in one more
// fused step, __fmaf_rn(1 - sum lam, v_j, acc).  The plain version
// (kernels/wsum.py:clipped_weighted_sum_plain) does the same operations
// in the same order, so the two agree bit for bit.  Any n up to 64, any d.
#include "common.cuh"

namespace {
constexpr int kMaxN = 64;
}

template <typename T>
__global__ void __launch_bounds__(256)
clipped_wsum_kernel(const float* __restrict__ lam, const T* __restrict__ x,
                    const float* __restrict__ v, float* __restrict__ out,
                    int n, long long d, long long ld) {
  __shared__ int sel[kMaxN];
  __shared__ float lsel[kMaxN];
  __shared__ int nsel;
  __shared__ float keep_s;
  if (threadIdx.x == 0) {
    int m = 0;
    float s = 0.f;
    for (int i = 0; i < n; ++i) {
      const float li = lam[i];
      s = __fadd_rn(s, li);
      if (li > 0.f) {
        sel[m] = i;
        lsel[m] = li;
        ++m;
      }
    }
    nsel = m;
    keep_s = __fsub_rn(1.f, s);
  }
  __syncthreads();
  const int m = nsel;
  const float keep = keep_s;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float acc = 0.f;
    for (int k = 0; k < m; ++k) {
      const float g = to_f32(x[(long long)sel[k] * ld + j]);
      acc = k ? __fmaf_rn(lsel[k], g, acc) : __fmul_rn(lsel[k], g);
    }
    out[j] = __fmaf_rn(keep, v[j], acc);
  }
}

// lam: (n,) fp32 >= 0; x: (n, d) rows of the arena dtype, row stride ld;
// v: (d,) fp32.
RT_EXPORT int rt_clipped_weighted_sum(const float* lam, const void* x,
                                      int dtype, const float* v, float* out,
                                      int n, long long d, long long ld,
                                      void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  if (d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  const unsigned blocks = grid_blocks(d, threads);
  if (dtype == RT_F32)
    clipped_wsum_kernel<float><<<blocks, threads, 0, s>>>(
        lam, (const float*)x, v, out, n, d, ld);
  else if (dtype == RT_BF16)
    clipped_wsum_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        lam, (const __nv_bfloat16*)x, v, out, n, d, ld);
  else
    return (int)cudaErrorInvalidValue;
  return rt_status();
}
