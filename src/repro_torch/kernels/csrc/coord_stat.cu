// K1 coord_stat: per-coordinate order statistic over the agent axis.
//
// Replaces repro/kernels/coord_stats.py:coord_stat (the Pallas TPU kernel:
// odd-even transposition network over (n, TILE_D) VMEM tiles, median or
// b-per-side trimmed mean fused in the tile).
//
// Bound on this card: bytes.  It reads the (n, d) stack once (bf16 or
// fp32, never an fp32 copy of it) and writes (d,) fp32: 20 bytes a
// coordinate for bf16 at n = 8.  The first kernel (coord_stat.cuh's
// odd-even network, one scalar load a row per thread) was bound by the
// instructions it issued instead, some 350 a coordinate at n = 8: a
// 2-byte load with its own address arithmetic a row and 28
// compare-exchanges of about ten instructions each (the NaN-propagating
// min / max), 1.65 ms at n = 8, P = 1.25e8 against the bytes' 0.744
// (PERF.md §6, NVIDIA H100 80GB HBM3, 700 W).
//
// Design: order_stat.cuh with MASKED = false on bf16 / fp32 rows (every
// row listed, in row order): 16-byte loads of each row up to n = 8 (8
// bf16 or 4 fp32 coordinates a thread), the exact widening of bf16 (one
// shift or and a value), Batcher's network of fminf / fmaxf over the
// register capacity with +-inf pads that keep the median's ranks and the
// trimmed window at fixed registers, and the odd-even network with the
// NaN-propagating min / max (the reference's law) only for the
// coordinates with a NaN, found on whole words.  +-inf stays on the fast
// path (fminf / fmaxf order it as the reference does).  The median is 0.5
// * (s[(n-1)//2] + s[n//2]); the trimmed mean sums ranks [b, n - b) in
// ascending order from +0 and divides by n - 2b.
#include "order_stat.cuh"

// stat: 0 = median, 1 = trimmed mean with b per side.
RT_EXPORT int rt_coord_stat(const void* x, int dtype, float* out, int n,
                            long long d, long long ld, int stat, int b,
                            void* stream) {
  if (n < 1 || n > kOrderMaxN || b < 0) return (int)cudaErrorInvalidValue;
  if (d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == RT_F32)
    return order_stat_dispatch<float, false>(x, nullptr, nullptr, out, n, d,
                                             ld, stat, b, s);
  if (dtype == RT_BF16)
    return order_stat_dispatch<__nv_bfloat16, false>(x, nullptr, nullptr,
                                                     out, n, d, ld, stat, b,
                                                     s);
  return (int)cudaErrorInvalidValue;
}
