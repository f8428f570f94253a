// K5 masked_coord_stat: per-coordinate order statistic over the ARRIVED
// rows of the agent stack, (d,) fp32 out.
//
// Replaces repro/kernels/masked.py:masked_coord_stat (the Pallas TPU
// kernel: absent rows become +inf sentinels in the (n, TILE_D) VMEM tile,
// the odd-even network sorts it, and the kept rank window follows the
// arrived count, ref.arrived_stat_from_sorted).
//
// Bound on this card: bytes.  It reads the arrived rows once (absent rows
// are never read: their sentinel is a constant) and writes (d,) fp32; the
// network and the window sum stay in registers.
//
// Design: K1's kernel (coord_stat.cuh with MASKED = true) with two
// changes.  Each block reads the (n,) mask once into shared memory and
// derives the live flags and the arrived count cnt there, so the rank window [lo, hi) is computed on the card
// (no host sync): median lo = (cnt-1)//2, trimmed lo = min(b, (cnt-1)//2),
// hi = cnt - lo.  Per coordinate, one thread loads the live rows (fp32 in
// registers, absent rows +inf), runs K1's NaN-propagating network, and
// sums the ranks in [lo, hi) in ascending order, selected by predicate
// (never multiplied by 0, so a sentinel or a NaN outside the window
// cannot leak), divided by max(hi - lo, 1).  cnt == 0 writes exactly 0.
#include "coord_stat.cuh"

// stat: 0 = median, 1 = trimmed mean with b per side (clamped to the
// arrived count inside the kernel).  mask: (n,) fp32, > 0.5 = arrived.
RT_EXPORT int rt_masked_coord_stat(const void* x, int dtype,
                                   const float* mask, float* out, int n,
                                   long long d, long long ld, int stat,
                                   int b, void* stream) {
  if (n < 1 || n > kCoordStatMaxN || b < 0)
    return (int)cudaErrorInvalidValue;
  if (d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == RT_F32)
    return coord_stat_dispatch<float, true, false>(x, mask, nullptr, out, n,
                                                   d, ld, stat, b, s);
  if (dtype == RT_BF16)
    return coord_stat_dispatch<__nv_bfloat16, true, false>(
        x, mask, nullptr, out, n, d, ld, stat, b, s);
  return (int)cudaErrorInvalidValue;
}
