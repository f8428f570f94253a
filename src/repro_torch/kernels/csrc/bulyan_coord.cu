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

// Runs the instance whose register capacity holds n rows.
template <typename T>
int bulyan_coord_dispatch(const void* x, const float* sel, float* out,
                          int n, long long d, long long ld, int theta,
                          int beta, cudaStream_t s) {
  if (n <= 8)
    bulyan_coord_launch<8, T>(x, sel, out, n, d, ld, theta, beta, s);
  else if (n <= 16)
    bulyan_coord_launch<16, T>(x, sel, out, n, d, ld, theta, beta, s);
  else if (n <= 32)
    bulyan_coord_launch<32, T>(x, sel, out, n, d, ld, theta, beta, s);
  else if (n <= 64)
    bulyan_coord_launch<64, T>(x, sel, out, n, d, ld, theta, beta, s);
  else
    return (int)cudaErrorInvalidValue;
  return rt_status();
}

RT_EXPORT int rt_bulyan_coord(const void* x, int dtype, const float* sel,
                              float* out, int n, long long d, long long ld,
                              int theta, int beta, void* stream) {
  if (n < 1 || n > kCoordStatMaxN || theta < 1 || theta > n || beta < 1 ||
      beta > theta)
    return (int)cudaErrorInvalidValue;
  if (d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == RT_F32)
    return bulyan_coord_dispatch<float>(x, sel, out, n, d, ld, theta, beta,
                                        s);
  if (dtype == RT_BF16)
    return bulyan_coord_dispatch<__nv_bfloat16>(x, sel, out, n, d, ld, theta,
                                                beta, s);
  return (int)cudaErrorInvalidValue;
}
