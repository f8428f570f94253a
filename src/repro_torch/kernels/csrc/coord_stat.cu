// K1 coord_stat: per-coordinate order statistic over the agent axis.
//
// Replaces repro/kernels/coord_stats.py:coord_stat (the Pallas TPU kernel:
// odd-even transposition network over (n, TILE_D) VMEM tiles, median or
// b-per-side trimmed mean fused in the tile).
//
// Bound on this card: bytes.  It reads the (n, d) stack once (bf16 or
// fp32, never an fp32 copy of it) and writes (d,) fp32; the network is
// n^2/2 compare-exchanges per coordinate, all in registers.  Measured
// (PERF.md): about 1.6 ms for bf16 and fp32 alike at n = 8, P = 1.25e8,
// so it is held back by the bytes each thread keeps in flight (8 loads
// of 2 or 4 bytes), not by the network: a variant that ran a cheaper
// network on NaN-free columns was no faster.
//
// Design: a grid-stride loop over coordinates (a few blocks per SM), one
// coordinate per thread at a time; thread j loads column j row by row
// (neighbouring threads read neighbouring addresses, so every row load is
// coalesced), upcasts to fp32 in registers, runs the SAME odd-even
// transposition network as the TPU kernel (so a NaN spreads through it
// exactly as jnp.minimum / jnp.maximum spread it), and writes only the
// statistic.  MAXN is a compile-time register capacity; the network runs
// on the first n entries under compile-time indices and runtime
// predicates, so it is the n-row network whatever MAXN is.
#include "coord_stat.cuh"

// stat: 0 = median, 1 = trimmed mean with b per side.
RT_EXPORT int rt_coord_stat(const void* x, int dtype, float* out, int n,
                            long long d, long long ld, int stat, int b,
                            void* stream) {
  if (d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == RT_F32)
    return coord_stat_dispatch<float, false>(x, nullptr, out, n, d, ld, stat,
                                             b, s);
  if (dtype == RT_BF16)
    return coord_stat_dispatch<__nv_bfloat16, false>(
        x, nullptr, out, n, d, ld, stat, b, s);
  return (int)cudaErrorInvalidValue;
}
