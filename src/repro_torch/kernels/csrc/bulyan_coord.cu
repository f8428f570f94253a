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
// 4 bytes each) and writes (d,) fp32.  The work a coordinate (a network
// over theta values, beta rounds over theta distances) is some two hundred
// instructions, of the same order as the bytes' time, so the design
// spends as few instructions a coordinate as it can.
//
// Design (bulyan_coord.cuh, shared with K14):
//
// * The row list.  Each block reads the (n,) selection once and builds in
//   shared memory the list of the selected rows in ascending row order,
//   each entry the pointer its values are read from.  The inner loop has
//   no per-row branch, and the reference's first-index tie rule becomes
//   "first in the list".
// * The register capacity CAP (8, 16, 32 or 64) is chosen on the host
//   from theta, with no device sync: theta = 7 (n = 11, f = 2) takes the
//   8-value instance.  Past the k listed rows come (CAP - theta) / 2 rows
//   of -inf and then +inf, which put the law's median ranks (theta - 1) /
//   2 and theta / 2 (among the listed values and +inf) at the fixed
//   positions CAP / 2 - 1 and CAP / 2, whatever theta.  Nothing checks
//   that the selection holds theta rows (only a sync could), so a block
//   whose list does not fit beside its -inf rows, or holds fewer rows
//   than beta, takes the exact path below everywhere (block-uniform).
// * The fast path: the median from Batcher's network of fminf / fmaxf
//   over the CAP registers, halved with __fmul_rn (never contracted into
//   x - med: the plain version rounds the median first); each |x - med|
//   once into registers; then beta rounds, each the least distance as a
//   tree and one pass that takes the first listed row at it.  It is exact
//   when no distance is NaN (no NaN listed value, a median off +-inf) and
//   every round finds a finite minimum (the minima never fall, so the last
//   one tells): on NaN-free data the two middle ranks hold the same values
//   under any correct network (the reference's odd-even transposition
//   network over n positions with the unselected ones +inf included), the
//   sign of a zero aside; a +-0 median changes no |x - med|; the output
//   sums x values, not network outputs; and the rounds then pick the
//   reference's rows (an infinite value or an overflowing |x - med| is a
//   +inf distance that a round may never reach).  Any other coordinate
//   takes the exact path.
// * The exact path is the reference's per-coordinate law: K1's
//   odd-even transposition network over the n positions with the
//   NaN-propagating min / max, then the rounds with a NaN-propagating
//   minimum, reading the listed rows again from memory (a NaN minimum
//   adds 0, and so does every later round; an all-inf minimum takes row
//   0, selected or not, and adds its value).  It runs only for the
//   coordinates that need it, after the thread's fast-path results are
//   stored, so a warp diverges only where such values are.
// * Loads: a thread takes V consecutive coordinates, one 16-byte load of
//   each listed row up to CAP = 8 (8 bf16 or 4 fp32 values), 8 bytes at
//   16 and one value above, so that the CAP row loads stay in registers;
//   its V results go out in 16-byte stores where V allows.  A row stride or
//   base not aligned for the loads (rows of 4099, a view offset by one
//   value) and the last partial chunk take scalar loads of the same words
//   inside the same kernel.
//
// The extracted values are summed in extraction order from 0 and divided
// by beta (IEEE division; the plain version divides by a device tensor,
// so it does too).
#include "bulyan_coord.cuh"

namespace {

template <typename T>
void bulyan_coord_dispatch(const void* x, const float* sel,
                           const float* mask, const void* mean, float* out,
                           int n, long long d, long long ld, int theta,
                           int beta, cudaStream_t s) {
  if (theta <= 8)
    bulyan_coord_launch<8, T>(x, sel, mask, mean, out, n, d, ld, theta, beta,
                              s);
  else if (theta <= 16)
    bulyan_coord_launch<16, T>(x, sel, mask, mean, out, n, d, ld, theta,
                               beta, s);
  else if (theta <= 32)
    bulyan_coord_launch<32, T>(x, sel, mask, mean, out, n, d, ld, theta,
                               beta, s);
  else
    bulyan_coord_launch<64, T>(x, sel, mask, mean, out, n, d, ld, theta,
                               beta, s);
}

}  // namespace

int bulyan_coord_entry(const void* x, int dtype, const float* sel,
                       const float* mask, const void* mean, float* out, int n,
                       long long d, long long ld, int theta, int beta,
                       void* stream) {
  if (n < 1 || n > kBulyanMaxN || theta < 1 || theta > n || beta < 1 ||
      beta > theta)
    return (int)cudaErrorInvalidValue;
  if (d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == RT_F32)
    bulyan_coord_dispatch<float>(x, sel, mask, mean, out, n, d, ld, theta,
                                 beta, s);
  else if (dtype == RT_BF16)
    bulyan_coord_dispatch<__nv_bfloat16>(x, sel, mask, mean, out, n, d, ld,
                                         theta, beta, s);
  else
    return (int)cudaErrorInvalidValue;
  return rt_status();
}

RT_EXPORT int rt_bulyan_coord(const void* x, int dtype, const float* sel,
                              float* out, int n, long long d, long long ld,
                              int theta, int beta, void* stream) {
  return bulyan_coord_entry(x, dtype, sel, nullptr, nullptr, out, n, d, ld,
                            theta, beta, stream);
}
