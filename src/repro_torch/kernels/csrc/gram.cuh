// The Gram kernels' templates and launcher, shared by K2 (gram.cu) and K6
// (masked_gram.cu); see gram.cu for the design note.  IMPUTE = false is
// K2's plain load; IMPUTE = true is K6's imputing load: an absent row
// (mask <= 0.5) is replaced by the (d,) mean, in the arena dtype, before
// the upcast, and is never read itself.  Everything else — fp64 running
// sums, per-block partials summed in block order, no atomics — is shared.
// All of it is file-local to each including translation unit.
#pragma once

#include "common.cuh"

namespace {
constexpr int kThreads = 256;
constexpr int kTD = 128;      // columns per shared-memory tile
constexpr int kMaxItems = 9;  // ceil(64 * 65 / 2 / kThreads)
constexpr int kGramMaxN = 64;

__device__ __forceinline__ void pair_of(int p, int n, int* i, int* j) {
  int r = 0, off = 0;
  while (off + (n - r) <= p) {
    off += n - r;
    ++r;
  }
  *i = r;
  *j = r + (p - off);
}

template <typename T, bool IMPUTE>
__global__ void __launch_bounds__(kThreads)
gram_partial_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                    const T* __restrict__ mean, double* __restrict__ partial,
                    int n, long long d, long long ld, long long chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int live_s[kGramMaxN];
  float* tile = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x;
  if (IMPUTE && tid < n) live_s[tid] = mask[tid] > 0.5f;
  const int npairs = n * (n + 1) / 2;
  const int lanes = npairs >= kThreads ? 1 : kThreads / npairs;
  const int items = npairs * lanes;

  int pi[kMaxItems], pj[kMaxItems], lane[kMaxItems];
  double acc[kMaxItems];
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k) {
    const int item = tid + k * kThreads;
    pi[k] = pj[k] = lane[k] = 0;
    acc[k] = 0.0;
    if (item < items) {
      pair_of(item / lanes, n, &pi[k], &pj[k]);
      lane[k] = item % lanes;
    }
  }

  const long long start = (long long)blockIdx.x * chunk;
  const long long end = start + chunk < d ? start + chunk : d;
  for (long long c0 = start; c0 < end; c0 += kTD) {
    __syncthreads();
    for (int e = tid; e < n * kTD; e += kThreads) {
      const int r = e / kTD, c = e % kTD;
      const long long col = c0 + c;
      float v = 0.f;
      if (col < end)
        v = (!IMPUTE || live_s[r]) ? to_f32(x[(long long)r * ld + col])
                                   : to_f32(mean[col]);
      tile[e] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxItems; ++k) {
      if (tid + k * kThreads < items) {
        const float* a = tile + pi[k] * kTD;
        const float* b = tile + pj[k] * kTD;
        double s = acc[k];
        for (int c = lane[k]; c < kTD; c += lanes)
          s = fma((double)a[c], (double)b[c], s);
        acc[k] = s;
      }
    }
  }

  // fold the lanes of each pair in lane order (shared memory reused)
  __syncthreads();
  double* red = reinterpret_cast<double*>(smem);
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k)
    if (tid + k * kThreads < items) red[tid + k * kThreads] = acc[k];
  __syncthreads();
  double* out = partial + (long long)blockIdx.x * n * n;
  for (int p = tid; p < npairs; p += kThreads) {
    double s = 0.0;
    for (int l = 0; l < lanes; ++l) s += red[p * lanes + l];
    int i, j;
    pair_of(p, n, &i, &j);
    out[i * n + j] = s;
    out[j * n + i] = s;
  }
}

// n <= 8 (the main path's n): every thread keeps all n(n+1)/2 pair sums in
// fp64 registers and walks its columns grid-stride, reading each value
// once from device memory — no shared-memory traffic in the main loop.
// The block then folds the pair sums across threads in a fixed order
// (shuffle tree per warp, warps in order).
template <int NR, typename T, bool IMPUTE>
__global__ void __launch_bounds__(kThreads)
gram_reg_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                const T* __restrict__ mean, double* __restrict__ partial,
                long long d, long long ld) {
  constexpr int NP = NR * (NR + 1) / 2;
  bool live[NR];
  bool any_absent = false;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    live[i] = !IMPUTE || mask[i] > 0.5f;
    any_absent |= !live[i];
  }
  double acc[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) acc[p] = 0.0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    const double m = any_absent ? (double)to_f32(mean[j]) : 0.0;
    double v[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i)
      v[i] = live[i] ? (double)to_f32(x[(long long)i * ld + j]) : m;
    int p = 0;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
#pragma unroll
      for (int k = i; k < NR; ++k) {
        acc[p] = fma(v[i], v[k], acc[p]);
        ++p;
      }
    }
  }
  __shared__ double warp_sum[kThreads / 32][NP];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    double s = acc[p];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) warp_sum[warp][p] = s;
  }
  __syncthreads();
  double* out = partial + (long long)blockIdx.x * NR * NR;
  for (int p = threadIdx.x; p < NP; p += blockDim.x) {
    double s = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sum[w][p];
    int i, k;
    pair_of(p, NR, &i, &k);
    out[i * NR + k] = s;
    out[k * NR + i] = s;
  }
}

template <typename T, bool IMPUTE>
bool launch_reg(const T* x, const float* mask, const T* mean,
                double* partial, int n, long long d, long long ld,
                int blocks, cudaStream_t s) {
  switch (n) {
#define RT_GRAM_REG(N)                                                 \
  case N:                                                              \
    gram_reg_kernel<N, T, IMPUTE><<<blocks, kThreads, 0, s>>>(         \
        x, mask, mean, partial, d, ld);                                \
    return true;
    RT_GRAM_REG(1) RT_GRAM_REG(2) RT_GRAM_REG(3) RT_GRAM_REG(4)
    RT_GRAM_REG(5) RT_GRAM_REG(6) RT_GRAM_REG(7) RT_GRAM_REG(8)
#undef RT_GRAM_REG
    default:
      return false;
  }
}

__global__ void gram_finish_kernel(const double* __restrict__ partial,
                                   float* __restrict__ out, int n,
                                   int blocks) {
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    double s = 0.0;
    for (int blk = 0; blk < blocks; ++blk)
      s += partial[(long long)blk * n * n + e];
    out[e] = (float)s;
  }
}

// Shared memory one partial block needs (the tile, then the lane buffer).
long long gram_smem_bytes(int n) {
  const int npairs = n * (n + 1) / 2;
  const int lanes = npairs >= kThreads ? 1 : kThreads / npairs;
  const long long tile = (long long)n * kTD * sizeof(float);
  const long long red = (long long)npairs * lanes * sizeof(double);
  return tile > red ? tile : red;
}

// Columns per block for a d split over `blocks` blocks (a tile multiple).
long long gram_chunk(long long d, int blocks) {
  long long c = (d + blocks - 1) / blocks;
  return (c + kTD - 1) / kTD * kTD;
}

template <typename T, bool IMPUTE>
int gram_launch_t(const void* x, const float* mask, const void* mean,
                  double* partial, float* out, int n, long long d,
                  long long ld, int blocks, cudaStream_t s) {
  const T* xt = (const T*)x;
  const T* mt = (const T*)mean;
  if (!launch_reg<T, IMPUTE>(xt, mask, mt, partial, n, d, ld, blocks, s)) {
    const size_t smem = (size_t)gram_smem_bytes(n);
    cudaFuncSetAttribute(gram_partial_kernel<T, IMPUTE>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    gram_partial_kernel<T, IMPUTE><<<blocks, kThreads, smem, s>>>(
        xt, mask, mt, partial, n, d, ld, gram_chunk(d, blocks));
  }
  int rc = rt_status();
  if (rc) return rc;
  gram_finish_kernel<<<1, 256, 0, s>>>(partial, out, n, blocks);
  return rt_status();
}

// partial: (blocks, n, n) fp64 scratch the caller allocated; out: (n, n).
template <bool IMPUTE>
int gram_launch(const void* x, int dtype, const float* mask,
                const void* mean, double* partial, float* out, int n,
                long long d, long long ld, int blocks, void* stream) {
  if (n < 1 || n > kGramMaxN || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == RT_F32)
    return gram_launch_t<float, IMPUTE>(x, mask, mean, partial, out, n, d,
                                        ld, blocks, s);
  if (dtype == RT_BF16)
    return gram_launch_t<__nv_bfloat16, IMPUTE>(x, mask, mean, partial, out,
                                                n, d, ld, blocks, s);
  return (int)cudaErrorInvalidValue;
}
}  // namespace
