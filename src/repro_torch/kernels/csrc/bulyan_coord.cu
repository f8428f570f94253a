// K13 bulyan_coord: Bulyan's coordinate stage.  Per coordinate: the median
// of the theta selected rows, then the mean of the beta = max(theta - 2f,
// 1) selected values closest to it; (n, d) stack, (n,) {0,1} selection ->
// (d,) fp32.
//
// Replaces repro/kernels/select.py:bulyan_coord (the Pallas TPU kernel:
// per (n, TILE_D) VMEM tile, the unselected rows padded to +inf, the
// odd-even network, the median of the selected set, then beta rounds of
// first-index min-extraction of |x - med| over the still-available
// rows, summed in extraction order and divided by beta).
//
// Bound on this card: bytes.  It reads the theta selected rows once (2 or
// 4 bytes each) and writes (d,) fp32; the network (n^2/2
// compare-exchanges) and the beta rounds of n comparisons stay in
// registers.
//
// Design: K1's layout (coord_stat.cuh): a grid-stride loop over
// coordinates, one coordinate per thread, coalesced row loads.  Each block
// reads the (n,) selection once into shared memory; a thread loads only
// the selected rows (the others are +inf constants in their own
// positions), so the network that K1 shares with the reference spreads a
// NaN exactly as jnp.minimum / jnp.maximum do.  The rounds scan the rows
// in ORIGINAL row order with a NaN-propagating minimum: a NaN in a
// selected coordinate makes the reference's jnp.min NaN, so no row is
// "first" and the round adds 0; the kernel does the same.  The extracted
// values are summed in extraction order from 0 and divided by beta (IEEE
// division; the plain version divides by a device tensor, so it does
// too).
#include "bulyan_coord.cuh"

RT_EXPORT int rt_bulyan_coord(const void* x, int dtype, const float* sel,
                              float* out, int n, long long d, long long ld,
                              int theta, int beta, void* stream) {
  return bulyan_coord_entry<false>(x, dtype, sel, nullptr, nullptr, out, n,
                                   d, ld, theta, beta, stream);
}
