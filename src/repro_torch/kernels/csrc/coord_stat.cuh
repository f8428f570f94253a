// The coord_stat kernel template and its launcher; see coord_stat.cu for
// the design note.  Each register capacity MAXN is instantiated in its own
// translation unit (coord_stat*.cu), so nvcc compiles them in parallel.
#pragma once

#include "common.cuh"

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

template <int MAXN, typename T>
__global__ void __launch_bounds__(256)
coord_stat_kernel(const T* __restrict__ x, float* __restrict__ out, int n,
                  long long d, long long ld, int stat, int b) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float v[MAXN];
#pragma unroll
    for (int i = 0; i < MAXN; ++i)
      v[i] = (i < n) ? to_f32(x[(long long)i * ld + j]) : 0.f;
    sort_network<MAXN>(v, n);
    float r;
    if (stat == 0) {  // median: 0.5 * (s[(n-1)//2] + s[n//2])
      const int lo = (n - 1) / 2, hi = n / 2;
      float a = 0.f, c = 0.f;
#pragma unroll
      for (int i = 0; i < MAXN; ++i) {
        if (i == lo) a = v[i];
        if (i == hi) c = v[i];
      }
      r = 0.5f * (a + c);
    } else {          // trimmed mean over ranks [b, n - b), ascending order
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < MAXN; ++i)
        if (i >= b && i < n - b) acc += v[i];
      r = acc / (float)(n - 2 * b);
    }
    out[j] = r;
  }
}

template <int MAXN, typename T>
void coord_stat_launch(const void* x, float* out, int n, long long d,
                       long long ld, int stat, int b, cudaStream_t s) {
  const int threads = 256;
  const unsigned blocks = grid_blocks(d, threads);
  coord_stat_kernel<MAXN, T><<<blocks, threads, 0, s>>>(
      (const T*)x, out, n, d, ld, stat, b);
}

// instantiated in coord_stat_{32,64}_{f32,bf16}.cu
extern template void coord_stat_launch<32, float>(
    const void*, float*, int, long long, long long, int, int, cudaStream_t);
extern template void coord_stat_launch<32, __nv_bfloat16>(
    const void*, float*, int, long long, long long, int, int, cudaStream_t);
extern template void coord_stat_launch<64, float>(
    const void*, float*, int, long long, long long, int, int, cudaStream_t);
extern template void coord_stat_launch<64, __nv_bfloat16>(
    const void*, float*, int, long long, long long, int, int, cudaStream_t);
