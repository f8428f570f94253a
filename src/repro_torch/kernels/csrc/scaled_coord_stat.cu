// K18 scaled_coord_stat: K1's per-coordinate order statistic over a
// QUANTIZED agent stack, (n, d) int8 / fp8 e4m3 codes and an (n,) fp32
// per-row scale -> (d,) fp32.
//
// Replaces repro/kernels/masked.py:scaled_coord_stat (the Pallas TPU
// kernel: per (n, TILE_D) VMEM tile, codes.astype(f32) * scale[:, None],
// then K1's odd-even network and the median / trimmed-mean window fused
// in the tile, so the dequantized stack never exists outside VMEM).
//
// Bound on this card: bytes.  It reads the codes once (1 byte each, a
// quarter of K5's fp32 read) and writes (d,) fp32; the network is in
// registers.  K1 at 2 bytes a value ran at 2.2x its bound, held back by
// one narrow load per row per thread, so this kernel is expected near
// K1's time, not at a quarter of it.
//
// Design: K1's kernel (coord_stat.cuh with SCALED = true).  Each block
// reads the n scales once into shared memory; per coordinate, one thread
// loads its column row by row (coalesced 1-byte loads), dequantizes each
// value with one rounded fp32 multiply (__fmul_rn: never fused into an
// add, so it is core.flat.dequantize_rows' product bit for bit), and runs
// K1's NaN-propagating network and window unchanged.  An inf scale times
// a 0 code is NaN and spreads through the network, as in the reference.
#include "coord_stat.cuh"

// stat: 0 = median, 1 = trimmed mean with b per side; dtype RT_I8 or
// RT_F8; scale: (n,) fp32.
RT_EXPORT int rt_scaled_coord_stat(const void* x, int dtype,
                                   const float* scale, float* out, int n,
                                   long long d, long long ld, int stat,
                                   int b, void* stream) {
  if (n < 1 || n > kCoordStatMaxN || b < 0)
    return (int)cudaErrorInvalidValue;
  if (d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == RT_I8)
    return coord_stat_dispatch<int8_t, false, true>(x, nullptr, scale, out,
                                                    n, d, ld, stat, b, s);
  if (dtype == RT_F8)
    return coord_stat_dispatch<__nv_fp8_e4m3, false, true>(
        x, nullptr, scale, out, n, d, ld, stat, b, s);
  return (int)cudaErrorInvalidValue;
}
