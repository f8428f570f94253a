// K9 multi_krum_order and K10 iterative_order: (n, n) Gram -> (n,) int32
// selection ORDER (order[i] = the position row i was picked at, the
// sentinel n if it was not picked).  The ordered application (K11,
// ordered_apply.cu) and Bulyan's coordinate stage (K13) consume it.
//
// Replaces repro/kernels/select.py:multi_krum_order and iterative_order
// (the two Pallas TPU kernels of one call site: one grid step each).
//
// Bound on this card: launch latency.  The input is the (n, n) Gram; the
// work is at most n^3 comparisons once and k_total * n steps a thread.
//
// Design (select.cuh):
//  * K9 (multi-Krum): ONE score pass with the classic k = n - f - 2
//    (clamped to [1, n - 1]) on K3's tile (select.cuh:krum_score_tile,
//    tile_threads(n) threads), then each row's exact score rank (first
//    index wins ties; the scores' bits order as unsigned) by one thread a
//    row: the m smallest get their rank, the rest n.
//  * K10 (m-Krum's m picks, Bulyan's theta picks): per round, each
//    candidate's key is the sum of its k = remaining - f - 2 (clamped)
//    smallest distances to the other REMAINING candidates, in ascending
//    order from 0.f; a tie on the least key is broken by the secondary
//    (the raw distances to the other remaining candidates, summed in
//    index order), then by the first index, every comparison restricted
//    to the candidates, so a round in which every key is +inf (a
//    NaN-poisoned adversary) still picks a genuine candidate.  With one
//    neighbour left the closest pair shares one distance: both keys are
//    bitwise equal (a bitwise-symmetric Gram, select.cuh:pair_d2) and the
//    secondary decides.
//    Every row is sorted ONCE: tile_threads(n) threads rank each pair in
//    its row (select.cuh:rank_tile) and scatter the value to that rank,
//    keeping each column's rank.  Self and, round by round, each removed row are struck from the
//    sorted row (-1: no distance is negative) at that rank.  A round then
//    costs a walk of the candidate's sorted row until k distances are
//    summed (+inf if fewer than k others remain, as a +inf-padded sort
//    gives), and a warp min of the keys' bits (+0 ... +inf, so they order
//    as unsigned) with a ballot; only when more than one candidate ties
//    do the tied threads sum their secondary and reduce on it.  Rows
//    32-63 are the second warp: the two warps combine through shared
//    memory and a named barrier of 64 threads, double-buffered by round
//    parity.
#include "select.cuh"

// sorted rows: 16-byte aligned, room for the walk's prefetch of the four
// positions past the last, and a stride of 12 banks (mod 32), so the
// float4 reads of 8 consecutive rows fill the 32 banks once
constexpr int kRow4 = kSelectMaxN + 12;

// Both warps of K10's rounds (rows 0-63) meet here; the other warps have
// left the kernel.
__device__ __forceinline__ void pair_barrier() {
  asm volatile("bar.sync 1, 64;" ::: "memory");
}

// K9: the scores through K3's pass, then each row's rank among them.
// Threads past the score rows leave; the one or two warps of rows meet at
// a warp or a 64-thread barrier before reading each other's scores.
__global__ void __launch_bounds__(kTileThreads)
    multi_krum_order_kernel(const float* __restrict__ gram,
                            int* __restrict__ out, int n, int k, int m) {
  __shared__ float d2[kSelectMaxN][kSelectMaxN + 1];
  __shared__ float low[kSelectMaxN][kSelectMaxN + 1];
  __shared__ unsigned scores[kSelectMaxN];
  const int t = threadIdx.x;
  const unsigned s = __float_as_uint(krum_score_tile(gram, d2, low, n, k));
  const int warps = (n + 31) >> 5;
  if (t >= 32 * warps) return;
  if (t < n) scores[t] = s;
  if (warps == 2)
    pair_barrier();
  else
    __syncwarp();
  if (t < n) {
    int r = 0;
    for (int j = 0; j < t; ++j) r += scores[j] <= s;
    for (int j = t + 1; j < n; ++j) r += scores[j] < s;
    out[t] = r < m ? r : n;
  }
}

__global__ void __launch_bounds__(kTileThreads)
    iterative_order_kernel(const float* __restrict__ gram,
                           int* __restrict__ out, int n, int f,
                           int k_total) {
  __shared__ float d2[kSelectMaxN][kSelectMaxN + 1];      // index order
  // row i ascending; -1 where the column is i itself or a removed row
  __shared__ __align__(16) float sval[kSelectMaxN][kRow4];
  __shared__ unsigned char pos[kSelectMaxN][kRow4];       // column -> rank
  __shared__ unsigned red_min[2][2][2];   // [round parity][stage][warp]
  __shared__ int red_first[2][2][2];
  __shared__ int red_count[2][2];
  const int t = threadIdx.x;
  if (n == 1) {                 // one candidate: picked in round 0, if any
    if (t == 0) out[0] = k_total > 0 ? 0 : 1;
    return;
  }
  distance_tile(gram, d2, n);
  rank_tile(d2, n, [&](int i, int j, int r, float v) {
    sval[i][r] = v;
    pos[i][j] = (unsigned char)r;
  });
  const int warps = (n + 31) >> 5;
  if (t >= 32 * warps) return;
  const int n4 = (n + 3) & ~3;
  if (t < n) {                    // each thread alone reads its row now
    sval[t][pos[t][t]] = -1.f;
    for (int r = n; r < n4; ++r) sval[t][r] = -1.f;
  }
  const int lane = t & 31, w = t >> 5;
  unsigned long long cand = n == 64 ? ~0ull : (1ull << n) - 1;
  int order = n;
  for (int it = 0; it < k_total; ++it) {
    int k = n - it - f - 2;
    k = k < 1 ? 1 : k;
    k = k > n - 1 ? n - 1 : k;
    k = k < 1 ? 1 : k;
    const int par = it & 1;
    unsigned key = 0xffffffffu;     // not a candidate: above +inf
    if (t < n && ((cand >> t) & 1ull)) {
      float acc = 0.f;
      int need = k;
      float4 v4 = *reinterpret_cast<const float4*>(&sval[t][0]);
      for (int r = 0; r < n4 && need > 0; r += 4) {
        // the next four positions load while these four are summed (a
        // read past n4 lands in the row's slack and is never used)
        const float4 vn = *reinterpret_cast<const float4*>(&sval[t][r + 4]);
        // position q is taken if it is a distance and fewer than need
        // distances precede it in these four: the counts of the four are
        // independent, so only the adds form a chain.  acc + 0.f == acc:
        // a sum from +0.f of values >= +0 is never -0.
        const int a0 = v4.x >= 0.f, a1 = v4.y >= 0.f, a2 = v4.z >= 0.f,
                  a3 = v4.w >= 0.f;
        const int c2 = a0 + a1, c3 = c2 + a2;
        acc += (a0 && 0 < need) ? v4.x : 0.f;
        acc += (a1 && a0 < need) ? v4.y : 0.f;
        acc += (a2 && c2 < need) ? v4.z : 0.f;
        acc += (a3 && c3 < need) ? v4.w : 0.f;
        need -= c3 + a3;
        need = need < 0 ? 0 : need;
        v4 = vn;
      }
      key = __float_as_uint(need > 0 ? INFINITY : acc);
    }
    unsigned m = __reduce_min_sync(0xffffffffu, key);
    const unsigned tied = __ballot_sync(0xffffffffu, key == m);
    int first = (w << 5) + __ffs(tied) - 1;
    int count = __popc(tied);
    if (warps == 2) {
      if (lane == 0) {
        red_min[par][0][w] = m;
        red_first[par][0][w] = first;
        red_count[par][w] = count;
      }
      pair_barrier();
      const unsigned m0 = red_min[par][0][0], m1 = red_min[par][0][1];
      m = m1 < m0 ? m1 : m0;
      count = (m0 == m ? red_count[par][0] : 0)
              + (m1 == m ? red_count[par][1] : 0);
      first = m0 == m ? red_first[par][0][0] : red_first[par][0][1];
    }
    int pick = first;
    if (count > 1) {                // the same branch in both warps
      unsigned sec = 0xffffffffu;
      if (key == m) {
        const unsigned long long others = cand & ~(1ull << t);
        float acc = 0.f;
        for (int j = 0; j < n; ++j)
          if ((others >> j) & 1ull) acc += d2[t][j];
        sec = __float_as_uint(acc);
      }
      const unsigned sm = __reduce_min_sync(0xffffffffu, sec);
      pick = (w << 5) + __ffs(__ballot_sync(0xffffffffu, sec == sm)) - 1;
      if (warps == 2) {
        if (lane == 0) {
          red_min[par][1][w] = sm;
          red_first[par][1][w] = pick;
        }
        pair_barrier();
        pick = red_min[par][1][1] < red_min[par][1][0]
                   ? red_first[par][1][1]
                   : red_first[par][1][0];
      }
    }
    if (t == pick) order = it;
    if (t < n) sval[t][pos[t][pick]] = -1.f;
    cand &= ~(1ull << pick);
  }
  if (t < n) out[t] = order;
}

RT_EXPORT int rt_multi_krum_order(const float* gram, int* out, int n, int f,
                                  int m, void* stream) {
  if (n < 1 || n > kSelectMaxN || f < 0 || m < 0 || m > n)
    return (int)cudaErrorInvalidValue;
  int k = n - f - 2;
  k = k > n - 1 ? n - 1 : k;
  k = k < 1 ? 1 : k;
  multi_krum_order_kernel<<<1, tile_threads(n), 0, (cudaStream_t)stream>>>(
      gram, out, n, k, m);
  return rt_status();
}

RT_EXPORT int rt_iterative_order(const float* gram, int* out, int n, int f,
                                 int k_total, void* stream) {
  if (n < 1 || n > kSelectMaxN || f < 0 || k_total < 0 || k_total > n)
    return (int)cudaErrorInvalidValue;
  iterative_order_kernel<<<1, tile_threads(n), 0, (cudaStream_t)stream>>>(
      gram, out, n, f, k_total);
  return rt_status();
}
