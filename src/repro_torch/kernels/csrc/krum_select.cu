// K3 krum_select: (n, n) Gram -> (n,) one-hot fp32 at the Krum minimizer.
//
// Replaces repro/kernels/select.py:krum_select (the Pallas TPU kernel: one
// grid step; squared distances off the Gram with NaN -> +inf and a +inf
// diagonal, the per-row sort network, the k = max(n - f - 2, 1) smallest
// summed, and an exact comparison rank with first-index ties, NaN last).
//
// Bound on this card: launch latency.  The input is n^2 fp32 (16 KB at
// n = 64) and the work O(n^2) per row; nothing here is worth more than
// the few microseconds a launch costs.
//
// Design: one block, one thread per candidate row; the Gram diagonal and
// the distance rows live in shared memory; each thread sorts its own row
// (insertion sort: no NaN remains after the rewrite, so any correct sort
// gives the network's order), sums the k smallest in ascending order,
// and ranks its score against every other score.
#include <math.h>

#include "common.cuh"

namespace {
constexpr int kMaxN = 64;
}

__global__ void krum_select_kernel(const float* __restrict__ gram,
                                   float* __restrict__ out, int n, int k) {
  __shared__ float sq[kMaxN];
  __shared__ float rows[kMaxN][kMaxN + 1];
  __shared__ float scores[kMaxN];
  const int i = threadIdx.x;
  if (i < n) sq[i] = gram[i * n + i];
  __syncthreads();
  if (i < n) {
    float* row = rows[i];
    for (int j = 0; j < n; ++j) {
      float v = INFINITY;
      if (j != i) {
        v = nan_max((sq[i] + sq[j]) - 2.0f * gram[i * n + j], 0.f);
        if (v != v) v = INFINITY;          // NaN distances order last
      }
      row[j] = v;
    }
    for (int a = 1; a < n; ++a) {          // ascending insertion sort
      const float key = row[a];
      int b = a - 1;
      while (b >= 0 && row[b] > key) {
        row[b + 1] = row[b];
        --b;
      }
      row[b + 1] = key;
    }
    float acc = 0.f;
    for (int m = 0; m < k; ++m) acc += row[m];
    scores[i] = (acc != acc) ? INFINITY : acc;
  }
  __syncthreads();
  if (i < n) {
    const float si = scores[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const float sj = scores[j];
      rank += (sj < si) || (sj == si && j < i);
    }
    out[i] = rank == 0 ? 1.f : 0.f;
  }
}

RT_EXPORT int rt_krum_select(const float* gram, float* out, int n, int f,
                             void* stream) {
  if (n < 1 || n > kMaxN || f < 0) return (int)cudaErrorInvalidValue;
  const int k = (n - f - 2) > 1 ? (n - f - 2) : 1;
  krum_select_kernel<<<1, kMaxN, 0, (cudaStream_t)stream>>>(gram, out, n, k);
  return rt_status();
}
