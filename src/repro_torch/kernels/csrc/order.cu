// K9 multi_krum_order and K10 iterative_order: (n, n) Gram -> (n,) int32
// selection ORDER (order[i] = the position row i was picked at, the
// sentinel n if it was not picked).  The ordered application (K11,
// ordered_apply.cu) and Bulyan's coordinate stage (K13) consume it.
//
// Replaces repro/kernels/select.py:multi_krum_order and iterative_order
// (the two Pallas TPU kernels of one call site: one grid step each).
//
// Bound on this card: launch latency.  The input is the (n, n) Gram; K10
// does k_total rounds of n row sorts of n entries, a few microseconds.
//
// Design: one block, one thread per row, the distances in shared memory
// (select.cuh, shared with K3 and K8).
//  * K9 (multi-Krum): ONE score pass with the classic k = n - f - 2
//    (clamped to [1, n - 1]); the m smallest scores get their rank, the
//    rest n.
//  * K10 (m-Krum's m picks, Bulyan's theta picks): per round, each
//    candidate's score is the sum of its k = remaining - f - 2 (clamped)
//    smallest distances to the other REMAINING candidates, in ascending
//    order; its secondary is the sum of its raw distances to all other
//    remaining candidates, in index order.  Thread 0 then picks: the
//    least score among the candidates, exact ties by the least
//    secondary, then the first index — every comparison restricted to
//    the candidates, so a round in which every score is +inf (a
//    NaN-poisoned adversary) still picks a genuine candidate, never a
//    removed row.  With one neighbour left the closest pair shares one
//    distance: both primaries are bitwise equal (a bitwise-symmetric
//    Gram, select.cuh:gram_d2) and the secondary decides.
#include "select.cuh"

__global__ void multi_krum_order_kernel(const float* __restrict__ gram,
                                        int* __restrict__ out, int n, int k,
                                        int m) {
  __shared__ float sq[kSelectMaxN];
  __shared__ float rows[kSelectMaxN][kSelectMaxN + 1];
  __shared__ float scores[kSelectMaxN];
  krum_scores_block(gram, sq, rows, scores, n, k);
  const int i = threadIdx.x;
  if (i < n) {
    const int r = rank_of(scores, n, i);
    out[i] = r < m ? r : n;
  }
}

__global__ void iterative_order_kernel(const float* __restrict__ gram,
                                       int* __restrict__ out, int n, int f,
                                       int k_total) {
  __shared__ float sq[kSelectMaxN];
  __shared__ float d2[kSelectMaxN][kSelectMaxN + 1];    // raw, diagonal 0
  __shared__ float rows[kSelectMaxN][kSelectMaxN + 1];  // sort scratch
  __shared__ float key[kSelectMaxN];
  __shared__ float sec[kSelectMaxN];
  __shared__ int cand[kSelectMaxN];
  __shared__ int pick_s;
  const int i = threadIdx.x;
  if (i < n) {
    sq[i] = gram[i * n + i];
    cand[i] = 1;
  }
  __syncthreads();
  if (i < n)
    for (int j = 0; j < n; ++j)
      d2[i][j] = (j == i) ? 0.f : gram_d2(gram, sq, n, i, j);
  int order = n;
  __syncthreads();
  for (int it = 0; it < k_total; ++it) {
    int k = n - it - f - 2;
    k = k < 1 ? 1 : k;
    k = k > n - 1 ? n - 1 : k;
    k = k < 1 ? 1 : k;
    if (i < n) {
      float* row = rows[i];
      float acc = 0.f;
      for (int j = 0; j < n; ++j) {
        const bool other = cand[j] && j != i;
        row[j] = other ? d2[i][j] : INFINITY;
        if (other) acc += d2[i][j];
      }
      const float s = sum_smallest(row, n, k);
      key[i] = cand[i] ? s : INFINITY;
      sec[i] = (acc != acc) ? INFINITY : acc;
    }
    __syncthreads();
    if (i == 0) {
      float kmin = key[0];
      for (int j = 1; j < n; ++j) kmin = fminf(kmin, key[j]);
      float smin = INFINITY;
      for (int j = 0; j < n; ++j)
        if (cand[j] && key[j] == kmin) smin = fminf(smin, sec[j]);
      int p = -1;
      for (int j = 0; j < n && p < 0; ++j)
        if (cand[j] && key[j] == kmin && sec[j] == smin) p = j;
      pick_s = p;
      if (p >= 0) cand[p] = 0;
    }
    __syncthreads();
    if (i == pick_s) order = it;
  }
  if (i < n) out[i] = order;
}

RT_EXPORT int rt_multi_krum_order(const float* gram, int* out, int n, int f,
                                  int m, void* stream) {
  if (n < 1 || n > kSelectMaxN || f < 0 || m < 0 || m > n)
    return (int)cudaErrorInvalidValue;
  int k = n - f - 2;
  k = k > n - 1 ? n - 1 : k;
  k = k < 1 ? 1 : k;
  multi_krum_order_kernel<<<1, kSelectMaxN, 0, (cudaStream_t)stream>>>(
      gram, out, n, k, m);
  return rt_status();
}

RT_EXPORT int rt_iterative_order(const float* gram, int* out, int n, int f,
                                 int k_total, void* stream) {
  if (n < 1 || n > kSelectMaxN || f < 0 || k_total < 0 || k_total > n)
    return (int)cudaErrorInvalidValue;
  iterative_order_kernel<<<1, kSelectMaxN, 0, (cudaStream_t)stream>>>(
      gram, out, n, f, k_total);
  return rt_status();
}
