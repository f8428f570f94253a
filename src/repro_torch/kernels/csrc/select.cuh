// The selection kernels' shared code (K3 krum_select.cu, K8 cge_select.cu,
// K9 and K10 order.cu): squared distances off the (n, n) Gram, the
// per-row ascending sort and sum of the k smallest, and the exact
// comparison rank.  One copy, so the four kernels order and sum alike,
// and so do their plain versions (repro_torch/kernels/select.py).
#pragma once

#include <math.h>

#include "common.cuh"

constexpr int kSelectMaxN = 64;

// Squared distance between rows i and j off the Gram, as the TPU kernels
// compute it: max((sq_i + sq_j) - 2 G_ij, 0) with NaN propagating through
// the max, then NaN -> +inf (orders last).  The parenthesised sum and a
// bitwise-symmetric Gram make d2(i, j) and d2(j, i) bitwise equal, which
// the iterative selection's tie-break relies on.
__device__ __forceinline__ float gram_d2(const float* __restrict__ gram,
                                         const float* sq, int n, int i,
                                         int j) {
  const float v = nan_max((sq[i] + sq[j]) - 2.0f * gram[i * n + j], 0.f);
  return (v != v) ? INFINITY : v;
}

// Sum of the k smallest of row[0, m), taken in ascending order from 0
// (the row is sorted in place; insertion sort: the row holds no NaN, so
// any correct sort gives the network's order).  A NaN sum orders last.
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
