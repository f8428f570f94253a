// The selection kernels' shared code (K3 krum_select.cu, K8 cge_select.cu,
// K9 and K10 order.cu): squared distances off the (n, n) Gram, the sum of
// the k smallest of a row and the exact comparison rank.  One copy, so the
// four kernels order and sum alike, and so do their plain versions
// (repro_torch/kernels/select.py).
//
// K3 and K10 run one block of tile_threads(n) threads over the tile:
// distance_tile fills it from coalesced reads of the Gram, and rank_tile
// sorts every row at once (the thread of pair (i, j) computes the rank of
// d2[i][j] in its row, row_rank, and its kernel scatters it there).  K8
// and K9 keep one thread a row (krum_scores_block, sum_smallest,
// rank_of).
#pragma once

#include <math.h>

#include "common.cuh"

constexpr int kSelectMaxN = 64;
constexpr int kTileThreads = 1024;  // K3 and K10 at n >= 32: 32 warps

// Squared distance between rows i and j off the Gram, as the TPU kernels
// compute it: max((sq_i + sq_j) - 2 G_ij, 0) with NaN propagating through
// the max, then NaN -> +inf (orders last).  The parenthesised sum and a
// bitwise-symmetric Gram make d2(i, j) and d2(j, i) bitwise equal, which
// the iterative selection's tie-break relies on.
__device__ __forceinline__ float pair_d2(float sq_i, float sq_j, float g) {
  const float v = nan_max((sq_i + sq_j) - 2.0f * g, 0.f);
  return (v != v) ? INFINITY : v;
}

__device__ __forceinline__ float gram_d2(const float* __restrict__ gram,
                                         const float* sq, int n, int i,
                                         int j) {
  return pair_d2(sq[i], sq[j], gram[i * n + j]);
}

// Threads of K3's and K10's block at n: a warp for each column j of the
// tile (at most 32 warps, two columns a warp above n = 32), so the rank
// pass has many warps to hide its shared-memory latency.  K3's sums and
// K10's rounds then take one thread a row, threads [0, n).
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

// The sorting pass of K3 and K10: every pair (i, j) of the tile ranked in
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

// Sum of the k smallest of row[0, m), taken in ascending order from 0
// (the row is sorted in place; insertion sort: the row holds no NaN, so
// any correct sort gives the network's order).  A NaN sum orders last.
// K9's score pass.
__device__ __forceinline__ float sum_smallest(float* row, int m, int k) {
  for (int a = 1; a < m; ++a) {
    const float key = row[a];
    int b = a - 1;
    while (b >= 0 && row[b] > key) {
      row[b + 1] = row[b];
      --b;
    }
    row[b + 1] = key;
  }
  float acc = 0.f;
  for (int r = 0; r < k; ++r) acc += row[r];
  return (acc != acc) ? INFINITY : acc;
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

// Each thread i < n writes the Krum score of row i (the k smallest
// distances to the others) into scores[i]; rows is per-thread scratch.
// Reads the diagonal into sq first.  Ends with a barrier.
__device__ __forceinline__ void krum_scores_block(
    const float* __restrict__ gram, float* sq,
    float (*rows)[kSelectMaxN + 1], float* scores, int n, int k) {
  const int i = threadIdx.x;
  if (i < n) sq[i] = gram[i * n + i];
  __syncthreads();
  if (i < n) {
    float* row = rows[i];
    for (int j = 0; j < n; ++j)
      row[j] = (j == i) ? INFINITY : gram_d2(gram, sq, n, i, j);
    scores[i] = sum_smallest(row, n, k);
  }
  __syncthreads();
}
