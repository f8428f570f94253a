// The Bulyan coordinate-stage template and its launcher, shared by K13
// (bulyan_coord.cu) and K14 (masked_bulyan_coord.cu); those files hold the
// design notes and the entry points.  IMPUTE = false is K13's load: row i
// is x[i].  IMPUTE = true is K14's imputing load: an absent row (mask <=
// 0.5) is read as the (d,) imputed mean in the arena dtype, so the
// mean-imputed stack is never built; every read of a row goes through
// that load, the all-inf round's read of an unselected row included.
// Each register capacity MAXN of 32 and 64 rows is instantiated in its
// own translation unit (bulyan_coord_{32,64}_{f32,bf16}.cu for K13,
// masked_bulyan_coord_{32,64}_{f32,bf16}.cu for K14), so nvcc compiles
// them in parallel; 8 and 16 are instantiated in bulyan_coord.cu and
// masked_bulyan_coord.cu.
#pragma once

#include "coord_stat.cuh"

template <int MAXN, typename T, bool IMPUTE>
__global__ void __launch_bounds__(256)
bulyan_coord_kernel(const T* __restrict__ x, const float* __restrict__ sel,
                    const float* __restrict__ mask,
                    const T* __restrict__ mean, float* __restrict__ out,
                    int n, long long d, long long ld, int theta, int beta) {
  // the selected rows and (IMPUTE) the arrived rows, read once per block
  __shared__ int sel_s[kCoordStatMaxN];
  __shared__ int live_s[kCoordStatMaxN];
  if (threadIdx.x < n) {
    sel_s[threadIdx.x] = sel[threadIdx.x] > 0.5f;
    live_s[threadIdx.x] = !IMPUTE || mask[threadIdx.x] > 0.5f;
  }
  __syncthreads();
  unsigned long long sel_bits = 0ull, live_bits = 0ull;
  for (int i = 0; i < n; ++i) {
    if (sel_s[i]) sel_bits |= 1ull << i;
    if (live_s[i]) live_bits |= 1ull << i;
  }
  // row i's value at coordinate j: raw, or the mean for an absent row
  auto load = [&](int i, long long j) -> float {
    return (!IMPUTE || ((live_bits >> i) & 1ull))
               ? to_f32(x[(long long)i * ld + j])
               : to_f32(mean[j]);
  };
  const int m0 = (theta - 1) / 2, m1 = theta / 2;

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    // the selected values; the others are +inf and never read
    float xv[MAXN], v[MAXN];
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      xv[i] = ((sel_bits >> i) & 1ull) ? load(i, j) : INFINITY;
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
            val = ((sel_bits >> i) & 1ull) ? xv[i] : load(i, j);
          }
        }
      acc += val;
      avail &= ~(1ull << pick);
    }
    out[j] = acc / (float)beta;
  }
}

template <int MAXN, typename T, bool IMPUTE>
void bulyan_coord_launch(const void* x, const float* sel, const float* mask,
                         const void* mean, float* out, int n, long long d,
                         long long ld, int theta, int beta, cudaStream_t s) {
  const int threads = 256;
  const unsigned blocks = grid_blocks(d, threads);
  bulyan_coord_kernel<MAXN, T, IMPUTE><<<blocks, threads, 0, s>>>(
      (const T*)x, sel, mask, (const T*)mean, out, n, d, ld, theta, beta);
}

// Runs the instance whose register capacity holds n rows.
template <typename T, bool IMPUTE>
int bulyan_coord_dispatch(const void* x, const float* sel, const float* mask,
                          const void* mean, float* out, int n, long long d,
                          long long ld, int theta, int beta,
                          cudaStream_t s) {
  if (n <= 8)
    bulyan_coord_launch<8, T, IMPUTE>(x, sel, mask, mean, out, n, d, ld,
                                      theta, beta, s);
  else if (n <= 16)
    bulyan_coord_launch<16, T, IMPUTE>(x, sel, mask, mean, out, n, d, ld,
                                       theta, beta, s);
  else if (n <= 32)
    bulyan_coord_launch<32, T, IMPUTE>(x, sel, mask, mean, out, n, d, ld,
                                       theta, beta, s);
  else if (n <= 64)
    bulyan_coord_launch<64, T, IMPUTE>(x, sel, mask, mean, out, n, d, ld,
                                       theta, beta, s);
  else
    return (int)cudaErrorInvalidValue;
  return rt_status();
}

template <bool IMPUTE>
int bulyan_coord_entry(const void* x, int dtype, const float* sel,
                       const float* mask, const void* mean, float* out, int n,
                       long long d, long long ld, int theta, int beta,
                       void* stream) {
  if (n < 1 || n > kCoordStatMaxN || theta < 1 || theta > n || beta < 1 ||
      beta > theta)
    return (int)cudaErrorInvalidValue;
  if (d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == RT_F32)
    return bulyan_coord_dispatch<float, IMPUTE>(x, sel, mask, mean, out, n, d,
                                                ld, theta, beta, s);
  if (dtype == RT_BF16)
    return bulyan_coord_dispatch<__nv_bfloat16, IMPUTE>(
        x, sel, mask, mean, out, n, d, ld, theta, beta, s);
  return (int)cudaErrorInvalidValue;
}

// instantiated in {,masked_}bulyan_coord_{32,64}_{f32,bf16}.cu
#define RT_BC_EXTERN(N, T, I)                                              \
  extern template void bulyan_coord_launch<N, T, I>(                       \
      const void*, const float*, const float*, const void*, float*, int,   \
      long long, long long, int, int, cudaStream_t);
RT_BC_EXTERN(32, float, false)
RT_BC_EXTERN(32, __nv_bfloat16, false)
RT_BC_EXTERN(64, float, false)
RT_BC_EXTERN(64, __nv_bfloat16, false)
RT_BC_EXTERN(32, float, true)
RT_BC_EXTERN(32, __nv_bfloat16, true)
RT_BC_EXTERN(64, float, true)
RT_BC_EXTERN(64, __nv_bfloat16, true)
#undef RT_BC_EXTERN
