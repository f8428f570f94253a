// K2 gram: the (n, n) Gram X X^T of the agent stack, fp32 out.
//
// Replaces repro/kernels/pairwise.py:gram (the Pallas TPU kernel: one MXU
// dot per (n, TILE_D) VMEM tile, the (n, n) block revisited and summed
// across the sequential grid).
//
// Bound on this card: bytes up to n ~ 40 in bf16 and up to n = 64 in
// fp32: the (n, d) stack is read once (2 or 4 bytes a value) against the
// n(n+1)/2 * d multiply-adds at the 67 TFLOP/s of the fp64 tensor cores
// (H100 SXM).  The kernel multiplies whole 16 x 8 blocks, so its own
// tensor time passes the bytes' earlier: at n = 11 it runs 2 products of
// 512 multiply-adds per 4 columns where 66 would do.
//
// Design (gram.cuh, shared with K6): mma.sync m16n8k4 f64 over n padded
// to 8-row blocks, row pairs against the blocks at or right of them; each
// lane streams 16-byte vectors of its row into the fragments directly (no
// shared memory), one iteration ahead; a persistent grid, one contiguous
// column range per block; the warps folded in order into per-block fp64
// partials, summed in a fixed order by a second kernel, each (i <= j)
// entry written to both halves.  No atomics: a run repeats bit for bit,
// and the Gram is bitwise symmetric.
#include "gram.cuh"

RT_EXPORT int rt_gram(const void* x, int dtype, double* partial, float* out,
                      int n, long long d, long long ld, int blocks,
                      void* stream) {
  return gram_launch<false>(x, dtype, nullptr, nullptr, partial, out, n, d,
                            ld, blocks, stream);
}

// Blocks of the (blocks, n, n) fp64 scratch that rt_gram and
// rt_masked_gram take for an (n, d) stack on a card of `sms` SMs; 0 for
// an n or dtype they do not take.
RT_EXPORT int rt_gram_scratch_blocks(int n, int dtype, long long d,
                                     int sms) {
  return gram_blocks(n, dtype, d, sms);
}
