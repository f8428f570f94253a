// K23 coord_sort: the full per-coordinate sorted stack, (n, d) fp32 / bf16
// -> (n, d) fp32, every rank of K1's network.
//
// Replaces repro/kernels/coord_stats.py:coord_sort (the Pallas TPU
// kernel: the odd-even transposition network over (n, TILE_D) VMEM tiles,
// writing the whole sorted tile).  Its callers are the legacy ``ops``
// statistics (ops.kernel_coordinate_median / kernel_trimmed_mean), which
// read the median or the trimmed window off the stack.
//
// Bound on this card: bytes.  It reads the stack once and writes n * d
// fp32, so at n = 8 the write is twice a bf16 read; the network is
// n^2/2 compare-exchanges per coordinate, in registers.
//
// Design: K1's kernel with every rank written (coord_stat.cuh,
// coord_sort_kernel): a grid-stride loop over coordinates, one column per
// thread, coalesced row loads, the fp32 upcast in registers, the SAME
// NaN-propagating network (nan_min / nan_max: a NaN spreads as
// jnp.minimum / jnp.maximum spread it, not to the end as jnp.sort puts
// it), and n coalesced row stores.  Register capacities 4, 8 and 16 are
// instantiated here, 32 and 64 in coord_sort_{32,64}_{f32,bf16}.cu.
#include "coord_stat.cuh"

// out: (n, d) fp32, row stride d.
RT_EXPORT int rt_coord_sort(const void* x, int dtype, float* out, int n,
                            long long d, long long ld, void* stream) {
  if (n < 1 || n > kCoordStatMaxN) return (int)cudaErrorInvalidValue;
  if (d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == RT_F32)
    return coord_sort_dispatch<float>(x, out, n, d, ld, s);
  if (dtype == RT_BF16)
    return coord_sort_dispatch<__nv_bfloat16>(x, out, n, d, ld, s);
  return (int)cudaErrorInvalidValue;
}
