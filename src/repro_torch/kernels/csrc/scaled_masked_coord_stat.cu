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
// Bound on this card: instructions issued.  It reads the arrived rows'
// codes once (1 byte each; an absent row is never read) and writes (d,)
// fp32, fewer bytes than the dequantization and the sort cost to issue.
//
// Design: order_stat.cuh with MASKED = true.  Each block reads the
// (n,) mask and scales once, lists the arrived rows (the rank window
// follows their count cnt, computed on the card with no host sync: median
// lo = (cnt-1)//2, trimmed lo = min(b, (cnt-1)//2), hi = cnt - lo) and
// pads the register capacity with +-inf so that the window's ranks sit at
// registers known once per block; Batcher's network of fminf / fmaxf
// sorts each coordinate on the fast path, and the reference's law (K5's
// odd-even network over the n positions, an absent row +inf, with the
// NaN-propagating min / max) serves the coordinates with a NaN code and
// the blocks with a non-finite live scale.  The window sums in ascending
// rank order from +0 and divides by max(hi - lo, 1); cnt == 0 writes
// exactly 0.
#include "order_stat.cuh"

// stat: 0 = median, 1 = trimmed mean with b per side (clamped to the
// arrived count inside the kernel); dtype RT_I8 or RT_F8; scale: (n,)
// fp32; mask: (n,) fp32, > 0.5 = arrived.
RT_EXPORT int rt_scaled_masked_coord_stat(const void* x, int dtype,
                                          const float* scale,
                                          const float* mask, float* out,
                                          int n, long long d, long long ld,
                                          int stat, int b, void* stream) {
  if (n < 1 || n > kOrderMaxN || b < 0) return (int)cudaErrorInvalidValue;
  if (d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == RT_I8)
    return order_stat_dispatch<int8_t, true>(x, mask, scale, out, n, d, ld,
                                              stat, b, s);
  if (dtype == RT_F8)
    return order_stat_dispatch<__nv_fp8_e4m3, true>(x, mask, scale, out, n,
                                                     d, ld, stat, b, s);
  return (int)cudaErrorInvalidValue;
}
