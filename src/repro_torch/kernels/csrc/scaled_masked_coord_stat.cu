// K19 scaled_masked_coord_stat: K5's per-coordinate order statistic over
// the ARRIVED rows of a QUANTIZED agent stack, (n, d) int8 / fp8 e4m3
// codes, an (n,) fp32 per-row scale and the (n,) arrival mask -> (d,)
// fp32.
//
// Replaces repro/kernels/masked.py:scaled_masked_coord_stat (the Pallas
// TPU kernel: in-tile dequantization codes.astype(f32) * scale[:, None],
// absent rows pushed to +inf sentinels, one odd-even sort and the
// arrived-count window, ref.arrived_stat_from_sorted).
//
// Bound on this card: bytes.  It reads the arrived rows' codes once (1
// byte each; an absent row is never read, its sentinel is a constant) and
// writes (d,) fp32.
//
// Design: K5's kernel (coord_stat.cuh with MASKED = true and SCALED =
// true).  Each block reads the (n,) mask and the (n,) scales once into
// shared memory, derives the live flags and the arrived count cnt there
// (the rank window is computed on the card, with no host sync), and per
// coordinate one thread loads the live rows' codes (coalesced 1-byte
// loads), dequantizes each with one rounded fp32 multiply (__fmul_rn:
// core.flat.dequantize_rows' product bit for bit), puts +inf in the
// absent rows, runs K1's NaN-propagating network and sums the kept
// window's ranks in ascending order.  cnt == 0 writes exactly 0.
#include "coord_stat.cuh"

// stat: 0 = median, 1 = trimmed mean with b per side (clamped to the
// arrived count inside the kernel); dtype RT_I8 or RT_F8; scale: (n,)
// fp32; mask: (n,) fp32, > 0.5 = arrived.
RT_EXPORT int rt_scaled_masked_coord_stat(const void* x, int dtype,
                                          const float* scale,
                                          const float* mask, float* out,
                                          int n, long long d, long long ld,
                                          int stat, int b, void* stream) {
  if (n < 1 || n > kCoordStatMaxN || b < 0)
    return (int)cudaErrorInvalidValue;
  if (d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == RT_I8)
    return coord_stat_dispatch<int8_t, true, true>(x, mask, scale, out, n,
                                                   d, ld, stat, b, s);
  if (dtype == RT_F8)
    return coord_stat_dispatch<__nv_fp8_e4m3, true, true>(
        x, mask, scale, out, n, d, ld, stat, b, s);
  return (int)cudaErrorInvalidValue;
}
