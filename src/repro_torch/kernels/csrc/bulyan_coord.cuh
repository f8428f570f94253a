// K13's kernel template and launcher (bulyan_coord.cu holds the design
// note and the entry point).  Each register capacity MAXN of 32 and 64
// rows is instantiated in its own translation unit
// (bulyan_coord_{32,64}_{f32,bf16}.cu), so nvcc compiles them in
// parallel; 8 and 16 are instantiated in bulyan_coord.cu.
#pragma once

#include "coord_stat.cuh"

template <int MAXN, typename T>
__global__ void __launch_bounds__(256)
bulyan_coord_kernel(const T* __restrict__ x, const float* __restrict__ sel,
                    float* __restrict__ out, int n, long long d,
                    long long ld, int theta, int beta) {
  // the selected rows, read once per block
  __shared__ int sel_s[kCoordStatMaxN];
  if (threadIdx.x < n) sel_s[threadIdx.x] = sel[threadIdx.x] > 0.5f;
  __syncthreads();
  unsigned long long sel_bits = 0ull;
  for (int i = 0; i < n; ++i)
    if (sel_s[i]) sel_bits |= 1ull << i;
  const int m0 = (theta - 1) / 2, m1 = theta / 2;

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    // the selected values; the others are +inf and never read
    float xv[MAXN], v[MAXN];
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      xv[i] = ((sel_bits >> i) & 1ull) ? to_f32(x[(long long)i * ld + j])
                                       : INFINITY;
      v[i] = xv[i];
    }
    // median of the selected set: K1's NaN-propagating network over the n
    // positions, the unselected rows sorting last as +inf
    sort_network<MAXN>(v, n);
    float a = 0.f, c = 0.f;
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      if (i == m0) a = v[i];
      if (i == m1) c = v[i];
    }
    const float med = 0.5f * (a + c);
    // beta rounds of first-index minimum of |x - med| over ALL n rows, a
    // row no longer available counting +inf (the reference's law, edge
    // cases included: a NaN minimum extracts nothing and adds 0; an
    // all-inf round takes the first row at +inf, which may be one that is
    // unselected or already taken, and adds its value)
    unsigned long long avail = sel_bits;
    float acc = 0.f;
    for (int r = 0; r < beta; ++r) {
      float mn = INFINITY;
#pragma unroll
      for (int i = 0; i < MAXN; ++i)
        if (i < n) {
          const float cur = ((avail >> i) & 1ull) ? fabsf(xv[i] - med)
                                                  : INFINITY;
          mn = nan_min(mn, cur);
        }
      if (mn != mn) continue;
      int pick = -1;
      float val = 0.f;
#pragma unroll
      for (int i = 0; i < MAXN; ++i)
        if (i < n && pick < 0) {
          const float cur = ((avail >> i) & 1ull) ? fabsf(xv[i] - med)
                                                  : INFINITY;
          if (cur == mn) {
            pick = i;
            val = ((sel_bits >> i) & 1ull)
                      ? xv[i]
                      : to_f32(x[(long long)i * ld + j]);
          }
        }
      acc += val;
      avail &= ~(1ull << pick);
    }
    out[j] = acc / (float)beta;
  }
}

template <int MAXN, typename T>
void bulyan_coord_launch(const void* x, const float* sel, float* out, int n,
                         long long d, long long ld, int theta, int beta,
                         cudaStream_t s) {
  const int threads = 256;
  const unsigned blocks = grid_blocks(d, threads);
  bulyan_coord_kernel<MAXN, T><<<blocks, threads, 0, s>>>(
      (const T*)x, sel, out, n, d, ld, theta, beta);
}

// instantiated in bulyan_coord_{32,64}_{f32,bf16}.cu
#define RT_BC_EXTERN(N, T)                                                 \
  extern template void bulyan_coord_launch<N, T>(                          \
      const void*, const float*, float*, int, long long, long long, int,   \
      int, cudaStream_t);
RT_BC_EXTERN(32, float)
RT_BC_EXTERN(32, __nv_bfloat16)
RT_BC_EXTERN(64, float)
RT_BC_EXTERN(64, __nv_bfloat16)
#undef RT_BC_EXTERN
