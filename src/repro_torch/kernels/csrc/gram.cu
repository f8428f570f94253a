// K2 gram: the (n, n) Gram X X^T of the agent stack, fp32 out.
//
// Replaces repro/kernels/pairwise.py:gram (the Pallas TPU kernel: one MXU
// dot per (n, TILE_D) VMEM tile, the (n, n) block revisited and summed
// across the sequential grid).
//
// Bound on this card: bytes at the n = 8 of the main path.  The (n, d)
// stack is read once; the n(n+1)/2 * d multiply-adds run in fp64 (half
// the fp32 rate), which stays under the memory time up to n ~ 16 and
// sets the time above that.
//
// Design (the templates are in gram.cuh, shared with K6): n <= 8 (the
// main path) runs gram_reg_kernel: all pair sums in registers, each value
// read once.  Larger n: the grid splits d into one contiguous chunk per
// block (blocks run in no order, so nothing is carried between them).  A
// block walks its chunk in (n, TD) tiles staged in shared memory as fp32
// (exact for bf16 and fp32 input); each (pair, lane) work item
// multiply-adds its lane of the tile's columns into an fp64 running sum.
// fp32 sums over the ~1e8 columns of a model drift past the 3e-6 bar on
// entries that cancel; in fp64 the only rounding that shows is the final
// one to fp32.  The block writes its (n, n) fp64 partial; a second
// one-block kernel sums the partials in block order.  No atomics: a run
// repeats bit for bit.
#include "gram.cuh"

RT_EXPORT int rt_gram(const void* x, int dtype, double* partial, float* out,
                      int n, long long d, long long ld, int blocks,
                      void* stream) {
  return gram_launch<false>(x, dtype, nullptr, nullptr, partial, out, n, d,
                            ld, blocks, stream);
}
