// K6 masked_gram: the (n, n) Gram of the MEAN-IMPUTED agent stack, fp32
// out, imputation fused into the load.
//
// Replaces repro/kernels/pairwise.py:masked_gram (the Pallas TPU kernel:
// absent rows of each (n, TILE_D) VMEM tile replaced by the tile's slice
// of the precomputed (d,) imputed mean, then one MXU dot per tile summed
// across the sequential grid).
//
// Bound on this card: bytes, as K2.  It reads the live rows and, when a
// row is absent, the (d,) mean once (an absent row is never read), and
// writes (n, n) fp32.
//
// Design: K2's kernels (gram.cuh) with the imputing load, IMPUTE = true:
// where(mask, x, mean) in the arena dtype, then the exact upcast, so the
// (n, d) imputed stack is never built.  K2's exactness rule holds: fp64
// multiply-adds (fp32 products are exact in fp64), per-block partials
// summed in block order, no atomics — a run repeats bit for bit.
#include "gram.cuh"

// mask: (n,) fp32, > 0.5 = arrived; mean: (d,) in the arena dtype.
RT_EXPORT int rt_masked_gram(const void* x, int dtype, const float* mask,
                             const void* mean, double* partial, float* out,
                             int n, long long d, long long ld, int blocks,
                             void* stream) {
  return gram_launch<true>(x, dtype, mask, mean, partial, out, n, d, ld,
                           blocks, stream);
}
