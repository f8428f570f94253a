// The coord_stat kernel template and its launcher, shared by K1
// (coord_stat.cu), K5 (masked_coord_stat.cu), K18 (scaled_coord_stat.cu)
// and K19 (scaled_masked_coord_stat.cu); see those files for the design
// notes.  MASKED = false: every one of the n rows is read and the window
// is fixed by n.  MASKED = true: each block reads the (n,) mask once, an
// absent row becomes a +inf sentinel (and is never read), and the kept
// rank window follows the arrived count.  SCALED = true: the stack holds
// int8 / fp8 codes, each block reads the (n,) fp32 row scales once into
// shared memory, and the load dequantizes, to_f32(code) * scale[row] with
// one rounded multiply (never contracted into an add), exactly
// core.flat.dequantize_rows.  The load, the network and the window sum are
// shared.  Each register capacity MAXN above 16 is instantiated in its own
// translation unit (coord_stat_{32,64}_*.cu), so nvcc compiles them in
// parallel.
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

template <int MAXN, typename T, bool MASKED, bool SCALED>
__global__ void __launch_bounds__(256)
coord_stat_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                  const float* __restrict__ scale, float* __restrict__ out,
                  int n, long long d, long long ld, int stat, int b) {
  // the per-row dequantization scales, read once per block
  __shared__ float scale_s[kCoordStatMaxN];
  if (SCALED) {
    if (threadIdx.x < n) scale_s[threadIdx.x] = scale[threadIdx.x];
    __syncthreads();
  }
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
      if (live[i]) {
        v[i] = to_f32(x[(long long)i * ld + j]);
        if (SCALED) v[i] = __fmul_rn(v[i], scale_s[i]);
      } else {
        v[i] = MASKED ? INFINITY : 0.f;
      }
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

template <int MAXN, typename T, bool MASKED, bool SCALED>
void coord_stat_launch(const void* x, const float* mask, const float* scale,
                       float* out, int n, long long d, long long ld, int stat,
                       int b, cudaStream_t s) {
  const int threads = 256;
  const unsigned blocks = grid_blocks(d, threads);
  coord_stat_kernel<MAXN, T, MASKED, SCALED><<<blocks, threads, 0, s>>>(
      (const T*)x, mask, scale, out, n, d, ld, stat, b);
}

// Runs the instance whose register capacity holds n rows.
template <typename T, bool MASKED, bool SCALED>
int coord_stat_dispatch(const void* x, const float* mask, const float* scale,
                        float* out, int n, long long d, long long ld,
                        int stat, int b, cudaStream_t s) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  if (n <= 4)
    coord_stat_launch<4, T, MASKED, SCALED>(x, mask, scale, out, n, d, ld,
                                            stat, b, s);
  else if (n <= 8)
    coord_stat_launch<8, T, MASKED, SCALED>(x, mask, scale, out, n, d, ld,
                                            stat, b, s);
  else if (n <= 16)
    coord_stat_launch<16, T, MASKED, SCALED>(x, mask, scale, out, n, d, ld,
                                             stat, b, s);
  else if (n <= 32)
    coord_stat_launch<32, T, MASKED, SCALED>(x, mask, scale, out, n, d, ld,
                                             stat, b, s);
  else if (n <= 64)
    coord_stat_launch<64, T, MASKED, SCALED>(x, mask, scale, out, n, d, ld,
                                             stat, b, s);
  else
    return (int)cudaErrorInvalidValue;
  return rt_status();
}

// The signature of one instance, for the explicit instantiations in
// coord_stat_{32,64}_{f32,bf16,i8,f8}.cu and the extern declarations here.
#define RT_CS_LAUNCH(N, T, M, S)                                           \
  void coord_stat_launch<N, T, M, S>(                                      \
      const void*, const float*, const float*, float*, int, long long,     \
      long long, int, int, cudaStream_t)
extern template RT_CS_LAUNCH(32, float, false, false);
extern template RT_CS_LAUNCH(32, float, true, false);
extern template RT_CS_LAUNCH(32, __nv_bfloat16, false, false);
extern template RT_CS_LAUNCH(32, __nv_bfloat16, true, false);
extern template RT_CS_LAUNCH(64, float, false, false);
extern template RT_CS_LAUNCH(64, float, true, false);
extern template RT_CS_LAUNCH(64, __nv_bfloat16, false, false);
extern template RT_CS_LAUNCH(64, __nv_bfloat16, true, false);
extern template RT_CS_LAUNCH(32, int8_t, false, true);
extern template RT_CS_LAUNCH(32, int8_t, true, true);
extern template RT_CS_LAUNCH(32, __nv_fp8_e4m3, false, true);
extern template RT_CS_LAUNCH(32, __nv_fp8_e4m3, true, true);
extern template RT_CS_LAUNCH(64, int8_t, false, true);
extern template RT_CS_LAUNCH(64, int8_t, true, true);
extern template RT_CS_LAUNCH(64, __nv_fp8_e4m3, false, true);
extern template RT_CS_LAUNCH(64, __nv_fp8_e4m3, true, true);
