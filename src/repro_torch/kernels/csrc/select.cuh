// The selection kernels' shared code (K3 krum_select.cu, K8 cge_select.cu,
// K9 and K10 order.cu, and the CGE apply of wsum.cu / masked_wsum.cu):
// squared distances off the (n, n) Gram, the Krum scores, CGE's keep-mask
// and the exact comparison rank.  One copy, so the kernels order and sum
// alike, and so do their plain versions (repro_torch/kernels/select.py).
//
// K3, K9 and K10 run one block of tile_threads(n) threads over the tile:
// distance_tile fills it from coalesced reads of the Gram, and rank_tile
// sorts every row at once (the thread of pair (i, j) computes the rank of
// d2[i][j] in its row, row_rank, and its kernel scatters it there).  K3
// and K9 share the score pass on top of it (krum_score_tile) and differ
// only in their epilogue; K10 walks the sorted rows round by round.  K8's
// law (cge_keep: the norms off the Gram diagonal and their rank) is one
// function, which K8 and the CGE apply's prologue call.
#pragma once

#include <math.h>

#include "common.cuh"

constexpr int kSelectMaxN = 64;
constexpr int kTileThreads = 1024;  // K3, K9, K10 at n >= 32: 32 warps

// Squared distance between rows i and j off the Gram, as the TPU kernels
// compute it: max((sq_i + sq_j) - 2 G_ij, 0) with NaN propagating through
// the max, then NaN -> +inf (orders last).  The parenthesised sum and a
// bitwise-symmetric Gram make d2(i, j) and d2(j, i) bitwise equal, which
// the iterative selection's tie-break relies on.
__device__ __forceinline__ float pair_d2(float sq_i, float sq_j, float g) {
  const float v = nan_max((sq_i + sq_j) - 2.0f * g, 0.f);
  return (v != v) ? INFINITY : v;
}

// Threads of K3's, K9's and K10's block at n: a warp for each column j of
// the tile (at most 32 warps, two columns a warp above n = 32), so the
// rank pass has many warps to hide its shared-memory latency.  K3's and
// K9's sums and K10's rounds then take one thread a row, threads [0, n).
static inline int tile_threads(int n) { return 32 * (n < 32 ? n : 32); }

// d2[i][j] for every pair of the (n, n) Gram with self excluded (+inf on
// the diagonal), by a block of tile_threads(n) threads: warp w takes rows
// w and w + 32, its lanes the columns (coalesced), and each thread reads
// the diagonal entries of its rows and columns itself - one round of
// independent reads of device memory and one barrier, in compact code:
// at a small n the kernel's time is its code's first fetch and its
// latencies.
__device__ __forceinline__ void distance_tile(
    const float* __restrict__ gram, float (*d2)[kSelectMaxN + 1], int n) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float sq_i[2], sq_j[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int i = w + 32 * a, j = lane + 32 * a;
    sq_i[a] = i < n ? gram[i * n + i] : 0.f;
    sq_j[a] = j < n ? gram[j * n + j] : 0.f;
  }
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int i = w + 32 * a, j = lane + 32 * b;
      if (i < n && j < n)
        d2[i][j] = (i == j) ? INFINITY
                            : pair_d2(sq_i[a], sq_j[b], gram[i * n + j]);
    }
  __syncthreads();
}

// The rank of v = d2[i][j] in row i: #{l : d2[i][l] < v, or equal and l <
// j}.  The tile holds no NaN, so a row's ranks are a permutation of [0,
// n), and the row scattered by them is ascending (equal values in index
// order).  The callers give the lanes of a warp one j and consecutive i:
// the bounds are uniform and the reads (row stride 65) free of bank
// conflicts.  Two counts halve the chain of dependent adds.
__device__ __forceinline__ int row_rank(float (*d2)[kSelectMaxN + 1],
                                        int n, int i, int j, float v) {
  const float* row = d2[i];
  int r0 = 0, r1 = 0, l = 0;
  for (; l + 1 < j; l += 2) {
    r0 += row[l] <= v;
    r1 += row[l + 1] <= v;
  }
  if (l < j) r0 += row[l] <= v;
  for (l = j + 1; l + 1 < n; l += 2) {
    r0 += row[l] < v;
    r1 += row[l + 1] < v;
  }
  if (l < n) r0 += row[l] < v;
  return r0 + r1;
}

// The sorting pass of K3, K9 and K10: every pair (i, j) of the tile ranked in
// its row (row_rank; a warp a column j, its lanes the rows i) and handed
// to store(i, j, rank, d2[i][j]), which scatters what its kernel keeps.
// Ends with a barrier.
template <class Store>
__device__ __forceinline__ void rank_tile(float (*d2)[kSelectMaxN + 1],
                                          int n, Store store) {
  for (int j = threadIdx.x >> 5; j < n; j += blockDim.x >> 5)
    for (int i = threadIdx.x & 31; i < n; i += 32) {
      const float v = d2[i][j];
      store(i, j, row_rank(d2, n, i, j, v), v);
    }
  __syncthreads();
}

// rank[i] = #{j : v_j < v_i or (v_j == v_i and j < i)} with NaN ordered
// last: argmin / top_k order, first index wins ties.
__device__ __forceinline__ int rank_of(const float* v, int n, int i) {
  const float vi = (v[i] != v[i]) ? INFINITY : v[i];
  int rank = 0;
  for (int j = 0; j < n; ++j) {
    const float vj = (v[j] != v[j]) ? INFINITY : v[j];
    rank += (vj < vi) || (vj == vi && j < i);
  }
  return rank;
}

// The Krum scores of K3 and K9: the block (tile_threads(n) threads) fills
// the distance tile, ranks every pair in its row, and scatters each pair
// of rank < k into low[i][rank], so row i's k smallest lie there in
// ascending order; thread i < n then sums them from 0.f in that order (the
// plain version's sort-then-sum, bitwise: equal values form the same
// sequence whatever their order) and returns the score, the others 0.f.
// A score is +0 ... +inf, never NaN and never -0 (a sum from +0 of values
// >= +0), so its bits order as unsigned.  1 <= k < n, or k = 1 at n = 1.
__device__ __forceinline__ float krum_score_tile(
    const float* __restrict__ gram, float (*d2)[kSelectMaxN + 1],
    float (*low)[kSelectMaxN + 1], int n, int k) {
  distance_tile(gram, d2, n);
  rank_tile(d2, n, [&](int i, int, int r, float v) {
    if (r < k) low[i][r] = v;
  });
  const int t = threadIdx.x;
  float acc = 0.f;
  if (t < n)
    for (int r = 0; r < k; ++r) acc += low[t][r];
  return acc;
}

// K8's law, by every thread of a block of at least n threads: thread i < n
// gets 1.f if row i is among the n_keep smallest norms sqrt(max(G_ii, 0))
// of the Gram's diagonal, else 0.f (so do threads i >= n).  The max
// propagates NaN (nan_max): CUDA's fmaxf(NaN, 0) is 0, which would rank a
// NaN-norm row FIRST and keep the hostile row; with the NaN kept, rank_of
// orders it last.  sqrtf is correctly rounded (no fast-math), as
// torch.sqrt is, so equal and distinct norms tie exactly as in the plain
// version.  norms: n floats of shared scratch.  Holds a barrier.
__device__ __forceinline__ float cge_keep(const float* __restrict__ gram,
                                          float* norms, int n, int n_keep) {
  const int i = threadIdx.x;
  if (i < n) norms[i] = sqrtf(nan_max(gram[i * n + i], 0.f));
  __syncthreads();
  return (i < n && rank_of(norms, n, i) < n_keep) ? 1.f : 0.f;
}
