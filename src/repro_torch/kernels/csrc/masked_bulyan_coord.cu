// K14 masked_bulyan_coord: Bulyan's coordinate stage over the
// MEAN-IMPUTED agent stack, without building it (the async path's masked
// Bulyan).  Per coordinate: the median of the theta selected rows of the
// imputed stack, then the mean of the beta = max(theta - 2f, 1) selected
// values closest to it; (n, d) stack, (n,) {0,1} mask, (d,) mean, (n,)
// {0,1} selection -> (d,) fp32.
//
// Replaces repro/kernels/select.py:masked_bulyan_coord (the Pallas TPU
// kernel: absent rows of each (n, TILE_D) VMEM tile replaced by the
// tile's slice of the precomputed (d,) imputed mean, _impute_tile, then
// K13's stage on the imputed tile).
//
// Bound on this card: bytes.  It reads the selected arrived rows and, if
// an absent row is selected, the (d,) mean once, and writes (d,) fp32;
// an absent row is never read.
//
// Design: K13's kernel (bulyan_coord.cuh; its notes are in
// bulyan_coord.cu), with the mask and the mean.  Each block reads the
// (n,) mask beside the selection once, and lists a selected absent row as
// a pointer to the mean, so the imputation costs nothing in the inner
// loop (several selected ghosts read one mean, from the cache after the
// first).  Row 0 as the reference's all-inf round reads it is the mean
// too when row 0 is absent: the JAX kernel imputes the whole tile before
// the stage, so that round adds row 0's imputed value, selected or not.
// The fast path, the exact path, the register capacity from theta and
// the vector loads are K13's.
#include "bulyan_coord.cuh"

// mask: (n,) fp32, > 0.5 = arrived; mean: (d,) in the arena dtype.
RT_EXPORT int rt_masked_bulyan_coord(const void* x, int dtype,
                                     const float* mask, const void* mean,
                                     const float* sel, float* out, int n,
                                     long long d, long long ld, int theta,
                                     int beta, void* stream) {
  return bulyan_coord_entry(x, dtype, sel, mask, mean, out, n, d, ld, theta,
                            beta, stream);
}
