// K3 krum_select: (n, n) Gram -> (n,) one-hot fp32 at the Krum minimizer.
//
// Replaces repro/kernels/select.py:krum_select (the Pallas TPU kernel: one
// grid step; squared distances off the Gram with NaN -> +inf and a +inf
// diagonal, the per-row sort network, the k = max(n - f - 2, 1) smallest
// summed, and an exact comparison rank with first-index ties, NaN last).
//
// Bound on this card: launch latency.  The input is n^2 fp32 (16 KB at
// n = 64); the work, n^3 comparisons at most, is a few microseconds.
//
// Design: one block of tile_threads(n) threads (select.cuh: a warp a
// column) computes every row's Krum score through krum_score_tile, the
// score pass K9 shares: the distance tile, every pair ranked in its row,
// each row's k smallest summed from 0.f in ascending order by one thread a
// row.  A score is +0 ... +inf (never NaN, never -0), so its bits order as
// unsigned and the least score's first index is a warp min and a ballot,
// then (n > 32) a combine of the two warps.
#include "select.cuh"

__global__ void __launch_bounds__(kTileThreads)
    krum_select_kernel(const float* __restrict__ gram,
                       float* __restrict__ out, int n, int k) {
  __shared__ float d2[kSelectMaxN][kSelectMaxN + 1];
  __shared__ float low[kSelectMaxN][kSelectMaxN + 1];
  __shared__ unsigned warp_min[2];
  __shared__ int warp_first[2];
  const int t = threadIdx.x;
  if (n == 1) {                 // one candidate: Krum picks it, whatever
    if (t == 0) out[0] = 1.f;   // its (+inf) score
    return;
  }
  const float score = krum_score_tile(gram, d2, low, n, k);
  const int warps = (n + 31) >> 5;
  if (t < 32 * warps) {
    // above +inf: never the least
    const unsigned bits = t < n ? __float_as_uint(score) : 0xffffffffu;
    const unsigned m = __reduce_min_sync(0xffffffffu, bits);
    const int first = (t & ~31) + __ffs(__ballot_sync(0xffffffffu,
                                                      bits == m)) - 1;
    if (warps == 1) {
      if (t < n) out[t] = t == first ? 1.f : 0.f;
    } else if ((t & 31) == 0) {
      warp_min[t >> 5] = m;
      warp_first[t >> 5] = first;
    }
  }
  if (warps == 2) {                     // the same branch in every thread
    __syncthreads();
    if (t < n) {
      const int pick = warp_min[1] < warp_min[0] ? warp_first[1]
                                                 : warp_first[0];
      out[t] = t == pick ? 1.f : 0.f;
    }
  }
}

RT_EXPORT int rt_krum_select(const float* gram, float* out, int n, int f,
                             void* stream) {
  if (n < 1 || n > kSelectMaxN || f < 0) return (int)cudaErrorInvalidValue;
  const int k = (n - f - 2) > 1 ? (n - f - 2) : 1;
  krum_select_kernel<<<1, tile_threads(n), 0, (cudaStream_t)stream>>>(
      gram, out, n, k);
  return rt_status();
}
