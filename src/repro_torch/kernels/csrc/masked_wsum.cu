// K7 masked_weighted_sum: w^T over the MEAN-IMPUTED agent stack, (d,)
// fp32 out, without building the imputed stack.
//
// Replaces repro/kernels/wsum.py:masked_weighted_sum (the Pallas TPU
// kernel: per (n, TILE_D) VMEM tile, live selected rows dotted raw and
// the ghost weight times the tile's slice of the precomputed mean).
//
// Bound on this card: bytes.  Live rows with w_i > 0 are read once and no
// other row is read at all (the caller's _drop_unselected is fused, as in
// K4), plus the (d,) mean when a ghost (absent row) carries weight; it
// writes (d,) fp32.  Krum's one-hot w reads one row.
//
// Design: K4's kernel plus one mean term.  Each block lists the live
// selected rows (mask > 0.5, w > 0) in shared memory and sums the ghost
// weight sum_{absent} w_i in row order; the grid-stride loop over
// coordinates sums the listed rows in row order as K4 does (a chain of
// fused multiply-adds from the first product), then adds ghost * mean in
// one more fused step only when ghost > 0 (so 0 * inf cannot leak from
// the mean, and a one-hot w returns exactly the selected live row or the
// mean upcast for a ghost).  The weights must be >= 0 (the caller's
// precondition: a negative one would be dropped, not subtracted).
#include "common.cuh"

namespace {
constexpr int kMaxN = 64;
}

template <typename T>
__global__ void __launch_bounds__(256)
masked_wsum_kernel(const float* __restrict__ w, const T* __restrict__ x,
                   const float* __restrict__ mask, const T* __restrict__ mean,
                   float* __restrict__ out, int n, long long d,
                   long long ld) {
  __shared__ int sel[kMaxN];
  __shared__ float wsel[kMaxN];
  __shared__ int nsel;
  __shared__ float ghost_s;
  if (threadIdx.x == 0) {
    int m = 0;
    float ghost = 0.f;
    for (int i = 0; i < n; ++i) {
      const float wi = w[i];
      if (mask[i] > 0.5f) {
        if (wi > 0.f) {
          sel[m] = i;
          wsel[m] = wi;
          ++m;
        }
      } else {
        ghost += wi;
      }
    }
    nsel = m;
    ghost_s = ghost;
  }
  __syncthreads();
  const int m = nsel;
  const float ghost = ghost_s;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float acc = 0.f;
    for (int k = 0; k < m; ++k) {
      const float v = to_f32(x[(long long)sel[k] * ld + j]);
      acc = k ? __fmaf_rn(wsel[k], v, acc) : wsel[k] * v;
    }
    if (ghost > 0.f) {
      const float v = to_f32(mean[j]);
      acc = m ? __fmaf_rn(ghost, v, acc) : ghost * v;
    }
    out[j] = acc;
  }
}

// w: (n,) fp32 >= 0; mask: (n,) fp32, > 0.5 = arrived; mean: (d,) in the
// arena dtype.
RT_EXPORT int rt_masked_weighted_sum(const float* w, const void* x,
                                     int dtype, const float* mask,
                                     const void* mean, float* out, int n,
                                     long long d, long long ld,
                                     void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  if (d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  const unsigned blocks = grid_blocks(d, threads);
  if (dtype == RT_F32)
    masked_wsum_kernel<float><<<blocks, threads, 0, s>>>(
        w, (const float*)x, mask, (const float*)mean, out, n, d, ld);
  else if (dtype == RT_BF16)
    masked_wsum_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        w, (const __nv_bfloat16*)x, mask, (const __nv_bfloat16*)mean, out,
        n, d, ld);
  else
    return (int)cudaErrorInvalidValue;
  return rt_status();
}
