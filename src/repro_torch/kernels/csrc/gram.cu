// K2 gram: the (n, n) Gram X X^T of the agent stack, fp32 out.
//
// Replaces repro/kernels/pairwise.py:gram (the Pallas TPU kernel: one MXU
// dot per (n, TILE_D) VMEM tile, the (n, n) block revisited and summed
// across the sequential grid).
//
// Bound on this card: bytes at the n = 8 of the main path.  The (n, d)
// stack is read once; the n(n+1)/2 * d multiply-adds run in fp64 (half
// the fp32 rate), which stays under the memory time up to n ~ 16 and
// sets the time above that.
//
// Design: n <= 8 (the main path) runs gram_reg_kernel below: all pair
// sums in registers, each value read once.  Larger n: the grid splits d
// into one contiguous chunk per block (blocks run in no order, so nothing
// is carried between them).  A block walks its chunk in (n, TD) tiles
// staged in shared memory as fp32 (exact for bf16 and fp32 input); each (pair, lane) work item multiply-adds its lane of
// the tile's columns into an fp64 running sum.  fp32 sums over the ~1e8
// columns of a model drift past the 3e-6 bar on entries that cancel; in
// fp64 the only rounding that shows is the final one to fp32.  The block
// writes its (n, n) fp64 partial; a second one-block kernel sums the
// partials in block order.  No atomics: a run repeats bit for bit.
#include "common.cuh"

namespace {
constexpr int kThreads = 256;
constexpr int kTD = 128;      // columns per shared-memory tile
constexpr int kMaxItems = 9;  // ceil(64 * 65 / 2 / kThreads)

__device__ __forceinline__ void pair_of(int p, int n, int* i, int* j) {
  int r = 0, off = 0;
  while (off + (n - r) <= p) {
    off += n - r;
    ++r;
  }
  *i = r;
  *j = r + (p - off);
}
}  // namespace

template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_partial_kernel(const T* __restrict__ x, double* __restrict__ partial,
                    int n, long long d, long long ld, long long chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x;
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
      tile[e] = col < end ? to_f32(x[(long long)r * ld + col]) : 0.f;
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
template <int NR, typename T>
__global__ void __launch_bounds__(kThreads)
gram_reg_kernel(const T* __restrict__ x, double* __restrict__ partial,
                long long d, long long ld) {
  constexpr int NP = NR * (NR + 1) / 2;
  double acc[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) acc[p] = 0.0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    double v[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i)
      v[i] = (double)to_f32(x[(long long)i * ld + j]);
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

template <typename T>
static bool launch_reg(const T* x, double* partial, int n, long long d,
                       long long ld, int blocks, cudaStream_t s) {
  switch (n) {
#define RT_GRAM_REG(N)                                                   \
  case N:                                                                \
    gram_reg_kernel<N, T><<<blocks, kThreads, 0, s>>>(x, partial, d, ld); \
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
static long long gram_smem_bytes(int n) {
  const int npairs = n * (n + 1) / 2;
  const int lanes = npairs >= kThreads ? 1 : kThreads / npairs;
  const long long tile = (long long)n * kTD * sizeof(float);
  const long long red = (long long)npairs * lanes * sizeof(double);
  return tile > red ? tile : red;
}

// Columns per block for a d split over `blocks` blocks (a tile multiple).
static long long gram_chunk(long long d, int blocks) {
  long long c = (d + blocks - 1) / blocks;
  return (c + kTD - 1) / kTD * kTD;
}

// partial: (blocks, n, n) fp64 scratch the caller allocated; out: (n, n).
RT_EXPORT int rt_gram(const void* x, int dtype, double* partial, float* out,
                      int n, long long d, long long ld, int blocks,
                      void* stream) {
  if (n < 1 || n > 64 || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long chunk = gram_chunk(d, blocks);
  const size_t smem = (size_t)gram_smem_bytes(n);
  if (dtype == RT_F32) {
    if (!launch_reg((const float*)x, partial, n, d, ld, blocks, s)) {
      cudaFuncSetAttribute(gram_partial_kernel<float>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
      gram_partial_kernel<float><<<blocks, kThreads, smem, s>>>(
          (const float*)x, partial, n, d, ld, chunk);
    }
  } else if (dtype == RT_BF16) {
    const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
    if (!launch_reg(xb, partial, n, d, ld, blocks, s)) {
      cudaFuncSetAttribute(gram_partial_kernel<__nv_bfloat16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
      gram_partial_kernel<__nv_bfloat16><<<blocks, kThreads, smem, s>>>(
          xb, partial, n, d, ld, chunk);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  int rc = rt_status();
  if (rc) return rc;
  gram_finish_kernel<<<1, 256, 0, s>>>(partial, out, n, blocks);
  return rt_status();
}
