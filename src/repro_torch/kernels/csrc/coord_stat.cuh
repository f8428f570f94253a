// The odd-even network kernel template and its launcher, shared by K5
// (masked_coord_stat.cu, MASKED = true) and K23's coord_sort kernel
// (coord_sort.cu: the same network, writing every rank); see those files
// for the design notes.  K1, K18 and K19 run order_stat.cuh, which beat
// this kernel at every register capacity on the card (PERF.md §6); the
// MASKED = false form (every one of the n rows read, the window fixed by
// n) is no longer instantiated.  MASKED = true: each block reads the (n,)
// mask once, an absent row becomes a +inf sentinel (and is never read),
// and the kept rank window follows the arrived count.  Each register
// capacity MAXN above 16 is instantiated in its own translation unit
// (coord_stat_{32,64}_*.cu, coord_sort_{32,64}_*.cu), so nvcc compiles
// them in parallel.
#pragma once

#include <math.h>

#include "common.cuh"

constexpr int kCoordStatMaxN = 64;

// Odd-even transposition network over the first n of v, with the
// NaN-propagating min/max (the TPU kernel's jnp.minimum/maximum law).
template <int MAXN>
__device__ __forceinline__ void sort_network(float (&v)[MAXN], int n) {
#pragma unroll
  for (int p = 0; p < MAXN; ++p) {
    if (p < n) {
#pragma unroll
      for (int i = (p & 1); i < MAXN - 1; i += 2) {
        if (i + 1 < n) {
          const float lo = nan_min(v[i], v[i + 1]);
          const float hi = nan_max(v[i], v[i + 1]);
          v[i] = lo;
          v[i + 1] = hi;
        }
      }
    }
  }
}

template <int MAXN, typename T, bool MASKED>
__global__ void __launch_bounds__(256)
coord_stat_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                  float* __restrict__ out, int n, long long d, long long ld,
                  int stat, int b) {
  // live flags and the arrived count: all n rows for K1; for K5 the (n,)
  // mask, read once per block
  __shared__ int live_s[kCoordStatMaxN];
  __shared__ int cnt_s;
  if (MASKED) {
    if (threadIdx.x < n) live_s[threadIdx.x] = mask[threadIdx.x] > 0.5f;
    __syncthreads();
    if (threadIdx.x == 0) {
      int c = 0;
      for (int i = 0; i < n; ++i) c += live_s[i];
      cnt_s = c;
    }
    __syncthreads();
  }
  bool live[MAXN];
#pragma unroll
  for (int i = 0; i < MAXN; ++i) live[i] = (i < n) && (!MASKED || live_s[i]);
  // the kept rank window [lo, hi).  K5's arrived values sit in ranks
  // [0, cnt) of the sentinel sort (ref.arrived_stat_from_sorted): median
  // lo = (cnt-1)//2, trimmed lo = min(b, (cnt-1)//2), hi = cnt - lo.
  const int cnt = MASKED ? cnt_s : n;
  int lo = b;
  if (MASKED) {
    lo = (cnt - 1) / 2;
    if (stat != 0 && b < lo) lo = b;
    if (lo < 0) lo = 0;
  }
  const int hi = cnt - lo;
  const float width = (float)(hi - lo > 1 ? hi - lo : 1);

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float v[MAXN];
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      v[i] = live[i] ? to_f32(x[(long long)i * ld + j])
                     : (MASKED ? INFINITY : 0.f);
    }
    sort_network<MAXN>(v, n);
    float r;
    if (!MASKED && stat == 0) {  // median: 0.5 * (s[(n-1)//2] + s[n//2])
      const int m0 = (n - 1) / 2, m1 = n / 2;
      float a = 0.f, c = 0.f;
#pragma unroll
      for (int i = 0; i < MAXN; ++i) {
        if (i == m0) a = v[i];
        if (i == m1) c = v[i];
      }
      r = 0.5f * (a + c);
    } else {  // the window's ranks, ascending, selected by predicate (never
              // multiplied by 0: a sentinel or NaN outside cannot leak)
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < MAXN; ++i)
        if (i >= lo && i < hi) acc += v[i];
      r = (!MASKED || cnt > 0) ? acc / width : 0.f;
    }
    out[j] = r;
  }
}

template <int MAXN, typename T, bool MASKED>
void coord_stat_launch(const void* x, const float* mask, float* out, int n,
                       long long d, long long ld, int stat, int b,
                       cudaStream_t s) {
  const int threads = 256;
  const unsigned blocks = grid_blocks(d, threads);
  coord_stat_kernel<MAXN, T, MASKED><<<blocks, threads, 0, s>>>(
      (const T*)x, mask, out, n, d, ld, stat, b);
}

// Runs the instance whose register capacity holds n rows.
template <typename T, bool MASKED>
int coord_stat_dispatch(const void* x, const float* mask, float* out, int n,
                        long long d, long long ld, int stat, int b,
                        cudaStream_t s) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  if (n <= 4)
    coord_stat_launch<4, T, MASKED>(x, mask, out, n, d, ld, stat, b, s);
  else if (n <= 8)
    coord_stat_launch<8, T, MASKED>(x, mask, out, n, d, ld, stat, b, s);
  else if (n <= 16)
    coord_stat_launch<16, T, MASKED>(x, mask, out, n, d, ld, stat, b, s);
  else if (n <= 32)
    coord_stat_launch<32, T, MASKED>(x, mask, out, n, d, ld, stat, b, s);
  else if (n <= 64)
    coord_stat_launch<64, T, MASKED>(x, mask, out, n, d, ld, stat, b, s);
  else
    return (int)cudaErrorInvalidValue;
  return rt_status();
}

// K23 coord_sort (coord_sort.cu): every rank of the same network, the
// (n, d) fp32 sorted stack, row-major with row stride d.  A thread holds
// its column in registers, runs sort_network and writes each of the n
// ranks (coalesced across the warp, one row at a time).
template <int MAXN, typename T>
__global__ void __launch_bounds__(256)
coord_sort_kernel(const T* __restrict__ x, float* __restrict__ out, int n,
                  long long d, long long ld) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float v[MAXN];
#pragma unroll
    for (int i = 0; i < MAXN; ++i)
      v[i] = i < n ? to_f32(x[(long long)i * ld + j]) : 0.f;
    sort_network<MAXN>(v, n);
#pragma unroll
    for (int i = 0; i < MAXN; ++i)
      if (i < n) out[(long long)i * d + j] = v[i];
  }
}

template <int MAXN, typename T>
void coord_sort_launch(const void* x, float* out, int n, long long d,
                       long long ld, cudaStream_t s) {
  const int threads = 256;
  const unsigned blocks = grid_blocks(d, threads);
  coord_sort_kernel<MAXN, T><<<blocks, threads, 0, s>>>((const T*)x, out, n,
                                                        d, ld);
}

// Runs the instance whose register capacity holds n rows.
template <typename T>
int coord_sort_dispatch(const void* x, float* out, int n, long long d,
                        long long ld, cudaStream_t s) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  if (n <= 4)
    coord_sort_launch<4, T>(x, out, n, d, ld, s);
  else if (n <= 8)
    coord_sort_launch<8, T>(x, out, n, d, ld, s);
  else if (n <= 16)
    coord_sort_launch<16, T>(x, out, n, d, ld, s);
  else if (n <= 32)
    coord_sort_launch<32, T>(x, out, n, d, ld, s);
  else if (n <= 64)
    coord_sort_launch<64, T>(x, out, n, d, ld, s);
  else
    return (int)cudaErrorInvalidValue;
  return rt_status();
}

// The signature of one instance, for the explicit instantiations in
// coord_stat_{32,64}_{f32,bf16}.cu and the extern declarations here.
#define RT_CS_LAUNCH(N, T, M)                                              \
  void coord_stat_launch<N, T, M>(const void*, const float*, float*, int,  \
                                  long long, long long, int, int,          \
                                  cudaStream_t)
extern template RT_CS_LAUNCH(32, float, true);
extern template RT_CS_LAUNCH(32, __nv_bfloat16, true);
extern template RT_CS_LAUNCH(64, float, true);
extern template RT_CS_LAUNCH(64, __nv_bfloat16, true);

// K23's 32- and 64-row instances (coord_sort_{32,64}_{f32,bf16}.cu).
#define RT_SORT_LAUNCH(N, T)                                               \
  void coord_sort_launch<N, T>(const void*, float*, int, long long,        \
                               long long, cudaStream_t)
extern template RT_SORT_LAUNCH(32, float);
extern template RT_SORT_LAUNCH(32, __nv_bfloat16);
extern template RT_SORT_LAUNCH(64, float);
extern template RT_SORT_LAUNCH(64, __nv_bfloat16);
