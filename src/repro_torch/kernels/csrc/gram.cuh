// The Gram kernel template and its launcher, shared by K2 (gram.cu) and K6
// (masked_gram.cu).  IMPUTE = false is K2's plain load; IMPUTE = true is
// K6's imputing load: the lanes of an absent row (mask <= 0.5) read the
// (d,) mean, in the arena dtype, in its place, so an absent row is never
// read.  Everything else is shared; all of it is file-local to each
// including translation unit.
//
// One kernel for every n from 1 to 64, on the fp64 tensor cores
// (mma.sync m16n8k4 f64; on the H100 m8n8k4 falls short of their rate).  n is
// padded to NB row blocks of 8.  Lane l's fragment value of a row block is
// its row 8 I + l/4 at the k-step's column of lane l % 4: that is the B
// fragment of m16n8k4 for block J, and two of them (blocks 2P, 2P + 1)
// are its A fragment.  So one fp64 value per lane and row block feeds
// every product (row pair P) x (block J >= 2P), which covers the upper
// triangle.  Which column a lane supplies at a k-step does not matter as
// long as every row uses the same mapping: each lane reads one 16-byte
// vector of its row (8 bf16 or 4 fp32 values; 4 lanes = one 64-byte chunk
// of the row) straight into registers and feeds its V values to V
// k-steps, so no shared memory sits between the load and the tensor
// cores.  Up to NB = 4 the next iteration's vectors are loaded before the
// current ones are consumed; from NB = 7 two warp groups split the
// products of the same chunks (the accumulators would not fit one warp).
//
// Exactness: every bf16 and fp32 value is an fp64 value and their
// products are exact in fp64; the sums run in fp64 (an fp32 sum over
// 1e8 columns drifts past the 3e-6 bar on entries that cancel).  A
// persistent grid (one block per SM) splits the column chunks into one
// contiguous range per block; a block's warps fold their accumulators in
// warp order into its fp64 partial (upper triangle only), and a second
// kernel sums the partials in a fixed order and writes each (i <= j)
// entry to (i, j) and (j, i): the Gram is bitwise symmetric and a run
// repeats bit for bit (fixed work assignment, no atomics).
//
// Alignment: the 16-byte vectors need a 16-byte aligned base, leading
// stride and mean.  A stack without that (ld * size % 16 != 0, d = 4099
// for example), and the last partial chunk of any stack, take a scalar
// load inside the same kernel (lane q's k-step s reads column c0 + 4 s +
// q, again one mapping for every row).
#pragma once

#include "common.cuh"

namespace {
constexpr int kGramMaxN = 64;
constexpr int kFinishThreads = 128;

// Per row-block count NB: warps per block, 64-byte chunks a warp takes
// per iteration, whether the next iteration's vectors are loaded before
// the current ones are consumed, the warp groups that split the products,
// and the m16n8k4 products per k-step (row pair P against blocks J >= 2P).
__host__ __device__ constexpr int gram_warps(int nb) {
  return nb <= 2 ? 16 : nb <= 4 ? 12 : 8;
}
__host__ __device__ constexpr int gram_unroll(int nb) {
  return nb == 1 ? 6 : nb == 2 ? 3 : 1;
}
__host__ __device__ constexpr bool gram_prefetch(int nb) { return nb <= 4; }
__host__ __device__ constexpr int gram_groups(int nb) {
  return nb >= 7 ? 2 : 1;
}
__host__ __device__ constexpr int gram_products(int nb) {
  int t = 0;
  for (int p = 0; 2 * p < nb; ++p) t += nb - 2 * p;
  return t;
}

template <typename T>
struct GramT;
template <>
struct GramT<float> {
  using bits = unsigned;
  static constexpr int V = 4;   // values per 16-byte vector
};
template <>
struct GramT<__nv_bfloat16> {
  using bits = unsigned short;
  static constexpr int V = 8;
};

// Pair p of the upper triangle (row-major) -> (i, j), i <= j.
__device__ __forceinline__ void pair_of(int p, int n, int* i, int* j) {
  int r = 0, off = 0;
  while (off + (n - r) <= p) {
    off += n - r;
    ++r;
  }
  *i = r;
  *j = r + (p - off);
}

// Product t of the k-step's list -> its row pair P and block J.
__device__ __forceinline__ void product_of(int t, int nb, int* P, int* J) {
  int p = 0;
  while (t >= nb - 2 * p) {
    t -= nb - 2 * p;
    ++p;
  }
  *P = p;
  *J = 2 * p + t;
}

__device__ __forceinline__ unsigned word_of(const uint4& r, int m) {
  return m == 0 ? r.x : m == 1 ? r.y : m == 2 ? r.z : r.w;
}

// Value s of a raw vector, exactly, in fp64.
template <typename T>
__device__ __forceinline__ double value_of(const uint4& r, int s);
template <>
__device__ __forceinline__ double value_of<float>(const uint4& r, int s) {
  return (double)__uint_as_float(word_of(r, s));
}
template <>
__device__ __forceinline__ double value_of<__nv_bfloat16>(const uint4& r,
                                                          int s) {
  const unsigned w = word_of(r, s >> 1);
  return (double)__uint_as_float((s & 1) ? (w & 0xffff0000u) : (w << 16));
}

// The scalar load: value s of lane q is column c0 + 4 s + q (0 past d).
template <typename T>
__device__ __forceinline__ uint4 load_scalar(const T* p, long long c0,
                                             long long d, int q) {
  using B = typename GramT<T>::bits;
  constexpr int V = GramT<T>::V;
  const B* b = reinterpret_cast<const B*>(p);
  unsigned e[V];
#pragma unroll
  for (int s = 0; s < V; ++s) {
    const long long col = c0 + 4 * s + q;
    e[s] = col < d ? (unsigned)b[col] : 0u;
  }
  uint4 r;
  if constexpr (V == 4) {
    r = make_uint4(e[0], e[1], e[2], e[3]);
  } else {
    r = make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16),
                   e[4] | (e[5] << 16), e[6] | (e[7] << 16));
  }
  return r;
}

// Chunks g .. g + U - 1 of this lane's rows (zeros past the block's range
// and for padding rows).  The vector / scalar choice is uniform per warp.
template <int NB, int U, typename T>
__device__ __forceinline__ void load_group(uint4 (&raw)[U][NB],
                                           const T* (&rows)[NB],
                                           long long g, long long c_end,
                                           long long d, bool vec, int q) {
  constexpr int V = GramT<T>::V, W = 4 * V;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long ch = g + u;
    const long long c0 = ch * W;
    const bool in_range = ch < c_end;
    const bool full = vec && c0 + W <= d;
#pragma unroll
    for (int I = 0; I < NB; ++I) {
      uint4 r = make_uint4(0u, 0u, 0u, 0u);
      if (in_range && rows[I] != nullptr)
        r = full ? __ldg(reinterpret_cast<const uint4*>(rows[I] + c0 +
                                                        q * V))
                 : load_scalar(rows[I], c0, d, q);
      raw[u][I] = r;
    }
  }
}

// D = A B + D: rows 16P .. 16P + 15 (a0: block 2P, a1: block 2P + 1)
// against the 8 rows of block J (b), over 4 columns.
__device__ __forceinline__ void dmma(double (&c)[4], double a0, double a1,
                                     double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// The products of group H (those with t % G == H) over U chunks.
template <int NB, int U, int G, int H, typename T>
__device__ __forceinline__ void mma_group(
    double (&acc)[(gram_products(NB) + G - 1) / G][4],
    const uint4 (&raw)[U][NB]) {
  constexpr int V = GramT<T>::V;
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int s = 0; s < V; ++s) {
      double f[NB + 1];
      f[NB] = 0.0;                 // the padding block of an odd NB
#pragma unroll
      for (int I = 0; I < NB; ++I) f[I] = value_of<T>(raw[u][I], s);
      int t = 0;
#pragma unroll
      for (int P = 0; 2 * P < NB; ++P) {
#pragma unroll
        for (int J = 2 * P; J < NB; ++J) {
          if (t % G == H) dmma(acc[t / G], f[2 * P], f[2 * P + 1], f[J]);
          ++t;
        }
      }
    }
  }
}

// One warp's stream over its chunks g, g + step, ... of [.., c_end).
template <int NB, int G, int H, typename T>
__device__ __forceinline__ void gram_stream(
    double (&acc)[(gram_products(NB) + G - 1) / G][4],
    const T* (&rows)[NB], long long g, long long step, long long c_end,
    long long d, bool vec, int q) {
  constexpr int U = gram_unroll(NB);
  uint4 cur[U][NB];
  load_group<NB, U, T>(cur, rows, g, c_end, d, vec, q);
  for (; g < c_end; g += step) {
    if constexpr (gram_prefetch(NB)) {
      uint4 nxt[U][NB];
      load_group<NB, U, T>(nxt, rows, g + step, c_end, d, vec, q);
      mma_group<NB, U, G, H, T>(acc, cur);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int I = 0; I < NB; ++I) cur[u][I] = nxt[u][I];
    } else {
      mma_group<NB, U, G, H, T>(acc, cur);
      load_group<NB, U, T>(cur, rows, g + step, c_end, d, vec, q);
    }
  }
}

template <int NB, typename T, bool IMPUTE>
__global__ void __launch_bounds__(32 * gram_warps(NB), 1)
gram_mma_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                const T* __restrict__ mean, double* __restrict__ partial,
                int n, long long d, long long ld, bool vec) {
  constexpr int WARPS = gram_warps(NB), U = gram_unroll(NB);
  constexpr int G = gram_groups(NB), NT = gram_products(NB);
  constexpr int TG = (NT + G - 1) / G;         // products per group
  constexpr int W = 4 * GramT<T>::V;           // columns per chunk
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane & 3, rr = lane >> 2;
  const int h = warp % G, slot = warp / G;     // group, chunk slot

  // this lane's row in each row block: the stack's row, the mean (an
  // absent row of K6) or none (padding)
  const T* rows[NB];
#pragma unroll
  for (int I = 0; I < NB; ++I) {
    const int r = 8 * I + rr;
    const T* p = nullptr;
    if (r < n)
      p = (!IMPUTE || mask[r] > 0.5f) ? x + (long long)r * ld : mean;
    rows[I] = p;
  }

  const long long nchunk = (d + W - 1) / W;
  const long long c_begin = nchunk * blockIdx.x / gridDim.x;
  const long long c_end = nchunk * (blockIdx.x + 1) / gridDim.x;
  const long long g = c_begin + (long long)slot * U;
  const long long step = (long long)(WARPS / G) * U;

  double acc[TG][4];
#pragma unroll
  for (int t = 0; t < TG; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.0;
  if (h == 0)
    gram_stream<NB, G, 0, T>(acc, rows, g, step, c_end, d, vec, q);
  else if constexpr (G > 1)
    gram_stream<NB, G, 1, T>(acc, rows, g, step, c_end, d, vec, q);

  // fold the warps in warp order; lane (rr, q) holds entries (rr, 2q),
  // (rr, 2q + 1), (rr + 8, 2q) and (rr + 8, 2q + 1) of each 16x8 product
  __shared__ double red[NT][128];
#pragma unroll 1
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int tt = 0; tt < TG; ++tt) {
        const int t = tt * G + h;
        if (t < NT) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int idx = (rr + 8 * (e >> 1)) * 8 + 2 * q + (e & 1);
            red[t][idx] = w < G ? acc[tt][e] : red[t][idx] + acc[tt][e];
          }
        }
      }
    }
    __syncthreads();
  }
  double* out = partial + (long long)blockIdx.x * n * n;
  for (int k = threadIdx.x; k < NT * 128; k += blockDim.x) {
    int P, J;
    product_of(k >> 7, NB, &P, &J);
    const int gi = 16 * P + ((k & 127) >> 3), gj = 8 * J + (k & 7);
    if (gj < n && gi <= gj) out[gi * n + gj] = red[k >> 7][k & 127];
  }
}

// One block per (i <= j) entry: the partials in a fixed order (thread t
// takes blocks t, t + 128, ... in turn; then a fixed shuffle tree and the
// warps in order), written to (i, j) and (j, i).
__global__ void __launch_bounds__(kFinishThreads)
gram_finish_kernel(const double* __restrict__ partial,
                   float* __restrict__ out, int n, int blocks) {
  int i, j;
  pair_of(blockIdx.x, n, &i, &j);
  const long long nn = (long long)n * n;
  const int e = i * n + j;
  double s = 0.0;
  for (int b = threadIdx.x; b < blocks; b += kFinishThreads)
    s += partial[b * nn + e];
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  __shared__ double ws[kFinishThreads / 32];
  if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int w = 0; w < kFinishThreads / 32; ++w) t += ws[w];
    const float v = (float)t;
    out[i * n + j] = v;
    out[j * n + i] = v;
  }
}

// Partial blocks of a launch: one per SM, fewer when d has fewer chunk
// groups than that.  The wrapper sizes its (blocks, n, n) fp64 scratch
// with this (rt_gram_scratch_blocks); 0 for an n or dtype not taken.
int gram_blocks(int n, int dtype, long long d, int sms) {
  if (n < 1 || n > kGramMaxN || d < 0 || sms < 1 ||
      (dtype != RT_F32 && dtype != RT_BF16))
    return 0;
  const int nb = (n + 7) / 8;
  const long long cols = dtype == RT_F32 ? 16 : 32;    // one chunk
  const long long nchunk = (d + cols - 1) / cols;
  const long long per_block =
      (long long)(gram_warps(nb) / gram_groups(nb)) * gram_unroll(nb);
  const long long b = (nchunk + per_block - 1) / per_block;
  return b < 1 ? 1 : b > sms ? sms : (int)b;
}

template <int NB, typename T, bool IMPUTE>
void launch_nb(const T* x, const float* mask, const T* mean,
               double* partial, int n, long long d, long long ld,
               int blocks, bool vec, cudaStream_t s) {
  gram_mma_kernel<NB, T, IMPUTE><<<blocks, 32 * gram_warps(NB), 0, s>>>(
      x, mask, mean, partial, n, d, ld, vec);
}

template <typename T, bool IMPUTE>
int gram_launch_t(const void* x, const float* mask, const void* mean,
                  double* partial, float* out, int n, long long d,
                  long long ld, int blocks, cudaStream_t s) {
  const T* xt = (const T*)x;
  const T* mt = (const T*)mean;
  const bool vec = (uintptr_t)x % 16 == 0 && (ld * sizeof(T)) % 16 == 0 &&
                   (!IMPUTE || (uintptr_t)mean % 16 == 0);
  switch ((n + 7) / 8) {
#define RT_GRAM_NB(NB)                                                   \
  case NB:                                                               \
    launch_nb<NB, T, IMPUTE>(xt, mask, mt, partial, n, d, ld, blocks, vec, \
                             s);                                         \
    break;
    RT_GRAM_NB(1) RT_GRAM_NB(2) RT_GRAM_NB(3) RT_GRAM_NB(4)
    RT_GRAM_NB(5) RT_GRAM_NB(6) RT_GRAM_NB(7) RT_GRAM_NB(8)
#undef RT_GRAM_NB
    default:
      return (int)cudaErrorInvalidValue;
  }
  int rc = rt_status();
  if (rc) return rc;
  gram_finish_kernel<<<n * (n + 1) / 2, kFinishThreads, 0, s>>>(
      partial, out, n, blocks);
  return rt_status();
}

// partial: (blocks, n, n) fp64 scratch the caller allocated, blocks from
// gram_blocks; out: (n, n).
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
