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
// Bound on this card: bytes.  It reads the theta selected rows once, a
// selected absent row as the (d,) mean in its place (the absent row is
// never read, and several selected ghosts read one mean), and writes (d,)
// fp32; the network and the beta rounds stay in registers.
//
// Design: K13's kernel (bulyan_coord.cuh) with IMPUTE = true, as K6 is
// K2's with an imputing load: each block reads the (n,) mask beside the
// selection, and every read of a row goes through the imputing load
// where(mask > 0.5, x, mean) in the arena dtype, then the exact upcast.
// That includes the reference's all-inf round, which takes the first row
// at +inf even if it is unselected and adds its (imputed) value: the JAX
// kernel imputes the whole tile before the stage.  The 32- and 64-row
// register capacities are instantiated in masked_bulyan_coord_{32,64}_
// {f32,bf16}.cu, apart from K13's, so that nvcc compiles them in parallel.
#include "bulyan_coord.cuh"

// mask: (n,) fp32, > 0.5 = arrived; mean: (d,) in the arena dtype.
RT_EXPORT int rt_masked_bulyan_coord(const void* x, int dtype,
                                     const float* mask, const void* mean,
                                     const float* sel, float* out, int n,
                                     long long d, long long ld, int theta,
                                     int beta, void* stream) {
  return bulyan_coord_entry<true>(x, dtype, sel, mask, mean, out, n, d, ld,
                                  theta, beta, stream);
}
