// K17 sparse_masked_weighted_mean: the sparse / dropout-aware weighted
// mean of sparse_mean.  A zero coordinate means "not sent", so each
// coordinate is averaged over the live rows that sent it,
//
//   cw_i = (x_i != 0) * w_i * live_i,
//   out  = sum_i cw_i x_i / sum_i cw_i,  or exactly 0 where the sum is 0
//
// ((n, d) fp32 / bf16 stack, (n,) mask and raw row weights -> (d,) fp32).
// K21 scaled_sparse_masked_weighted_mean: the same law on a QUANTIZED
// stack, int8 / fp8 e4m3 codes dequantized with their row's fp32 scale.
//
// Replaces repro/kernels/wsum.py:sparse_masked_weighted_mean and
// scaled_sparse_masked_weighted_mean (the Pallas TPU kernels: per (n,
// TILE_D) VMEM tile, the fp32 upcast (times the scale), cw = (x != 0) *
// where(live, w, 0), then sum(where(cw > 0, x, 0) * cw) / sum(cw) with the
// zero-denominator guard, _sparse_mean_body).
//
// Bound on this card: bytes.  Each reads the live rows once (4, 2 or 1
// bytes a value; an absent row is never read) and writes (d,) fp32: 12
// bytes a coordinate for K21 at 8 live rows.
//
// The law, per value in row order: the fp32 value (K21: the code's exact
// value times the scale with one rounded multiply, __fmul_rn, exactly
// core.flat.dequantize_rows); "sent" tests that decoded value, not the
// code, so -0.0 is not sent, a NaN is sent and poisons its column, and an
// inf row's 0 codes decode to 0 * inf = NaN and poison every column where
// the row is live, as in the reference; cw = sent ? w : 0; num += (cw > 0
// ? x : 0) * cw and den += cw.  The where-gate, not a multiply by 0, keeps
// an unsent value out of the sums.  The products and sums are __fmul_rn /
// __fadd_rn, never contracted into a fused multiply-add (the plain
// version, wsum.sparse_masked_weighted_mean_plain, rounds each product and
// each sum the same way, in the same row order), and the quotient is
// __fdiv_rn.
//
// K17's design (sparse_wmean_kernel): sign_vote.cu's layout.  Each block
// lists the live rows (mask > 0.5) in shared memory with their weights,
// then a grid-stride loop over coordinates, one coordinate per thread and
// one scalar load a row, coalesced across the warp.
//
// K21's design (scaled_sparse_kernel).  K17's layout with 1-byte loads
// and an int8 / e4m3 conversion a value was bound by the instructions it
// issued, some 20 a value (1.0-1.16 ms at 8 live rows, P = 1.25e8, against
// the bytes' 0.447; PERF.md §6, NVIDIA H100 80GB HBM3, 700 W).  Here:
// * The list.  Each block lists, in row order, the live rows of non-zero
//   weight with their scales (a live row of weight +-0 adds exactly +0 to
//   both sums, so it is never read).  A block whose listed weights are
//   all positive and finite takes the short law: den += w where the value
//   is sent, num += v * w always (an unsent +-0 value adds +-0, and num
//   and den, started at +0, are never -0, so that add changes nothing:
//   the same bits as the gated law); any other block the gated law above.
// * Loads.  A thread takes kSparseB = 8 consecutive coordinates: one
//   8-byte load of each listed row, four rows loaded before their sums
//   (then two, then one), so that four loads are in flight, and 8 num and
//   8 den registers; its results leave in 16-byte stores.  At most 64
//   registers a thread keep four blocks of 256 on an SM: the warps that
//   keep the bytes in flight (16 coordinates a thread at 110-128
//   registers, two blocks an SM, ran slower on the card).  A row or
//   output not aligned for the loads (a view offset by one byte) and the
//   last partial chunk take byte loads of the same words.
// * Dequantization, exact for every code (codes.cuh, K18's): int8 by a
//   byte permute into 2^23 and one add, fp8 by the card's e4m3x2 -> f16x2
//   conversion, then the __fmul_rn by the row's scale.
#include <float.h>

#include "codes.cuh"

namespace {
constexpr int kMaxN = 64;
}

template <typename T>
__global__ void __launch_bounds__(256)
sparse_wmean_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                    const float* __restrict__ w, float* __restrict__ out,
                    int n, long long d, long long ld) {
  __shared__ int rows[kMaxN];
  __shared__ float wr[kMaxN];
  __shared__ int nrows;
  if (threadIdx.x == 0) {
    int m = 0;
    for (int i = 0; i < n; ++i)
      if (mask[i] > 0.5f) {
        wr[m] = w[i];
        rows[m++] = i;
      }
    nrows = m;
  }
  __syncthreads();
  const int m = nrows;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float num = 0.f, den = 0.f;
    for (int r = 0; r < m; ++r) {
      const float v = to_f32(x[(long long)rows[r] * ld + j]);
      const float cw = v != 0.f ? wr[r] : 0.f;
      num = __fadd_rn(num, __fmul_rn(cw > 0.f ? v : 0.f, cw));
      den = __fadd_rn(den, cw);
    }
    out[j] = den > 0.f ? __fdiv_rn(num, den) : 0.f;
  }
}

template <typename T>
int sparse_wmean_run(const void* x, const float* mask, const float* w,
                     float* out, int n, long long d, long long ld,
                     cudaStream_t s) {
  const int threads = 256;
  const unsigned blocks = grid_blocks(d, threads);
  sparse_wmean_kernel<T><<<blocks, threads, 0, s>>>((const T*)x, mask, w,
                                                    out, n, d, ld);
  return rt_status();
}

// K21's shape: the codes a thread takes at a time (one load of each listed
// row), and the blocks of 256 an SM holds (at most 64 registers a thread).
constexpr int kSparseB = 8;
constexpr int kSparseMinBlocks = 4;

// K21's law on the kSparseB codes of one listed row (its words w), scale
// sc and weight wt, into the coordinates' sums; GATED: the law as
// written, else the short law of a positive finite weight (the same bits).
template <typename T, bool GATED>
__device__ __forceinline__ void sparse_row(const unsigned (&w)[kSparseB / 4],
                                           float sc, float wt,
                                           float (&num)[kSparseB],
                                           float (&den)[kSparseB]) {
  using C = Codes<T>;
#pragma unroll
  for (int q = 0; q < kSparseB / 4; ++q) {
    const unsigned u = C::prep(w[q]);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = 4 * q + c;
      const float v = __fmul_rn(C::value(u, c), sc);
      if constexpr (GATED) {
        const float cw = v != 0.f ? wt : 0.f;
        num[i] = __fadd_rn(num[i], __fmul_rn(cw > 0.f ? v : 0.f, cw));
        den[i] = __fadd_rn(den[i], cw);
      } else {
        if (v != 0.f) den[i] = __fadd_rn(den[i], wt);
        num[i] = __fadd_rn(num[i], __fmul_rn(v, wt));
      }
    }
  }
}

// S listed rows from r of the chunk at j0: their S loads first, then
// their sums in row order; VEC: kSparseB-byte loads, else element loads.
template <typename T, bool GATED, bool VEC, int S>
__device__ __forceinline__ void sparse_rows(
    const unsigned char* const* rows, const float* wr, const float* sc,
    int r, long long j0, long long d, float (&num)[kSparseB],
    float (&den)[kSparseB]) {
  unsigned w[S][kSparseB / 4];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if constexpr (VEC)
      row_load_vec<kSparseB>(rows[r + s] + j0, w[s]);
    else
      row_load_elems<T, kSparseB>(rows[r + s], j0, d, w[s]);
  }
#pragma unroll
  for (int s = 0; s < S; ++s)
    sparse_row<T, GATED>(w[s], sc[r + s], wr[r + s], num, den);
}

// The kSparseB coordinates from j0 over the k listed rows, in row order:
// four rows at a time, then the rest in steps of 2 and 1; VEC: the whole
// chunk lies below d and every listed row is aligned for the loads (and
// the output for 16-byte stores).
template <typename T, bool GATED, bool VEC>
__device__ __forceinline__ void sparse_chunk(
    const unsigned char* const* rows, const float* wr, const float* sc,
    int k, long long j0, long long d, float* out) {
  constexpr int B = kSparseB;
  float num[B], den[B];
#pragma unroll
  for (int c = 0; c < B; ++c) num[c] = den[c] = 0.f;
  int r = 0;
  for (; r + 4 <= k; r += 4)
    sparse_rows<T, GATED, VEC, 4>(rows, wr, sc, r, j0, d, num, den);
  if (r + 2 <= k) {
    sparse_rows<T, GATED, VEC, 2>(rows, wr, sc, r, j0, d, num, den);
    r += 2;
  }
  if (r < k) sparse_rows<T, GATED, VEC, 1>(rows, wr, sc, r, j0, d, num, den);
  float res[B];
#pragma unroll
  for (int c = 0; c < B; ++c)
    res[c] = den[c] > 0.f ? __fdiv_rn(num[c], den[c]) : 0.f;
  if constexpr (VEC) {
#pragma unroll
    for (int c = 0; c < B; c += 4)
      *reinterpret_cast<float4*>(out + j0 + c) =
          make_float4(res[c], res[c + 1], res[c + 2], res[c + 3]);
  } else {
#pragma unroll
    for (int c = 0; c < B; ++c)
      if (j0 + c < d) out[j0 + c] = res[c];
  }
}

template <typename T, bool GATED>
__device__ __forceinline__ void sparse_chunks(
    const unsigned char* const* rows, const float* wr, const float* sc,
    int k, bool vec, long long d, float* out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long chunks = (d + kSparseB - 1) / kSparseB;
  const long long full = vec ? d / kSparseB : 0;
  long long ch = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; ch < full; ch += stride)
    sparse_chunk<T, GATED, true>(rows, wr, sc, k, ch * kSparseB, d, out);
  for (; ch < chunks; ch += stride)
    sparse_chunk<T, GATED, false>(rows, wr, sc, k, ch * kSparseB, d, out);
}

template <typename T>
__global__ void __launch_bounds__(256, kSparseMinBlocks)
scaled_sparse_kernel(const unsigned char* __restrict__ x,
                     const float* __restrict__ scale,
                     const float* __restrict__ mask,
                     const float* __restrict__ w, float* __restrict__ out,
                     int n, long long d, long long ld) {
  __shared__ const unsigned char* rows_s[kMaxN];
  __shared__ float wr_s[kMaxN];
  __shared__ float sc_s[kMaxN];
  __shared__ unsigned list_w[2];
  const int t = threadIdx.x;
  float wt = 0.f;
  bool listed = false;
  if (t < kMaxN) {
    if (t < n && mask[t] > 0.5f) {
      wt = w[t];
      listed = wt != 0.f;
    }
    const unsigned bits = __ballot_sync(0xffffffffu, listed);
    if ((t & 31) == 0) list_w[t >> 5] = bits;
  }
  __syncthreads();
  const unsigned w0 = list_w[0], w1 = list_w[1];
  const int k = __popc(w0) + __popc(w1);
  int gated = 0, misaligned = 0;
  if (listed) {
    const int pos = t < 32 ? __popc(w0 & ((1u << t) - 1u))
                           : __popc(w0) + __popc(w1 & ((1u << (t - 32)) - 1u));
    const unsigned char* p = x + (long long)t * ld;
    rows_s[pos] = p;
    wr_s[pos] = wt;
    sc_s[pos] = scale[t];
    gated = !(wt > 0.f && wt <= FLT_MAX);
    misaligned = reinterpret_cast<uintptr_t>(p) % kSparseB != 0;
  }
  if (t == 0) misaligned |= reinterpret_cast<uintptr_t>(out) % 16 != 0;
  // block-uniform: the law's form; vector loads and stores
  const bool any_gated = __syncthreads_or(gated);
  const bool vec = !__syncthreads_or(misaligned);
  if (any_gated)
    sparse_chunks<T, true>(rows_s, wr_s, sc_s, k, vec, d, out);
  else
    sparse_chunks<T, false>(rows_s, wr_s, sc_s, k, vec, d, out);
}

template <typename T>
int scaled_sparse_run(const void* x, const float* scale, const float* mask,
                      const float* w, float* out, int n, long long d,
                      long long ld, cudaStream_t s) {
  const int threads = 256;
  const unsigned blocks =
      grid_blocks((d + kSparseB - 1) / kSparseB, threads);
  scaled_sparse_kernel<T><<<blocks, threads, 0, s>>>(
      (const unsigned char*)x, scale, mask, w, out, n, d, ld);
  return rt_status();
}

// K17: dtype RT_F32 or RT_BF16; mask: (n,) fp32, > 0.5 = live; w: (n,)
// fp32 raw row weights.
RT_EXPORT int rt_sparse_masked_weighted_mean(const void* x, int dtype,
                                             const float* mask,
                                             const float* w, float* out,
                                             int n, long long d,
                                             long long ld, void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  if (d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == RT_F32)
    return sparse_wmean_run<float>(x, mask, w, out, n, d, ld, s);
  if (dtype == RT_BF16)
    return sparse_wmean_run<__nv_bfloat16>(x, mask, w, out, n, d, ld, s);
  return (int)cudaErrorInvalidValue;
}

// K21: dtype RT_I8 or RT_F8; scale: (n,) fp32; mask and w as K17's.
RT_EXPORT int rt_scaled_sparse_masked_weighted_mean(
    const void* x, int dtype, const float* scale, const float* mask,
    const float* w, float* out, int n, long long d, long long ld,
    void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  if (d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == RT_I8)
    return scaled_sparse_run<int8_t>(x, scale, mask, w, out, n, d, ld, s);
  if (dtype == RT_F8)
    return scaled_sparse_run<__nv_fp8_e4m3>(x, scale, mask, w, out, n, d,
                                            ld, s);
  return (int)cudaErrorInvalidValue;
}
