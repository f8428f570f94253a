// K18 scaled_coord_stat: K1's per-coordinate order statistic over a
// QUANTIZED agent stack, (n, d) int8 / fp8 e4m3 codes and an (n,) fp32
// per-row scale -> (d,) fp32.
//
// Replaces repro/kernels/masked.py:scaled_coord_stat (the Pallas TPU
// kernel: per (n, TILE_D) VMEM tile, codes.astype(f32) * scale[:, None],
// then K1's odd-even network and the median / trimmed-mean window fused
// in the tile, so the dequantized stack never exists outside VMEM).
//
// Bound on this card: instructions issued.  It reads the codes once (1
// byte each) and writes (d,) fp32, 12 bytes a coordinate at n = 8, fewer
// than the dequantization and the sort cost to issue.
//
// Design: order_stat.cuh with MASKED = false (every row listed, in
// row order): 16-byte loads of each row up to n = 8, an exact dequantizing
// byte permute (int8) or the e4m3x2 -> f16x2 conversion (fp8) and one
// __fmul_rn by the row's scale, Batcher's network of fminf / fmaxf over the register
// capacity with +-inf pads that keep the median's ranks and the trimmed
// window at fixed registers, and K1's odd-even network with the
// NaN-propagating min / max (the reference's law) for the coordinates with
// a NaN code and the blocks with a non-finite scale.  The median is 0.5 *
// (s[(n-1)//2] + s[n//2]); the trimmed mean sums ranks [b, n - b) in
// ascending order from +0 and divides by n - 2b.
#include "order_stat.cuh"

// stat: 0 = median, 1 = trimmed mean with b per side; dtype RT_I8 or
// RT_F8; scale: (n,) fp32.
RT_EXPORT int rt_scaled_coord_stat(const void* x, int dtype,
                                   const float* scale, float* out, int n,
                                   long long d, long long ld, int stat,
                                   int b, void* stream) {
  if (n < 1 || n > kOrderMaxN || b < 0) return (int)cudaErrorInvalidValue;
  if (d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == RT_I8)
    return order_stat_dispatch<int8_t, false>(x, nullptr, scale, out, n, d,
                                               ld, stat, b, s);
  if (dtype == RT_F8)
    return order_stat_dispatch<__nv_fp8_e4m3, false>(x, nullptr, scale, out,
                                                      n, d, ld, stat, b, s);
  return (int)cudaErrorInvalidValue;
}
