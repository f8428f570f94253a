// The Bulyan coordinate-stage template and its launcher, shared by K13
// (bulyan_coord.cu) and K14 (masked_bulyan_coord.cu); those files hold the
// design notes and the entry points.  The two differ only in the row list
// each block builds: K14 passes the (n,) mask and the (d,) imputed mean,
// and a selected absent row is listed as the mean; K13 passes no mask.
// The 32- and 64-value register capacities are instantiated in their own
// translation units (bulyan_coord_{32,64}_{f32,bf16}.cu), so nvcc compiles
// them in parallel; 8 and 16 are instantiated in bulyan_coord.cu.
#pragma once

#include <float.h>

#include <type_traits>

#include "common.cuh"

constexpr int kBulyanMaxN = 64;
constexpr int kBulyanThreads = 256;

// For a register capacity of CAP values: B bytes of one listed row a
// thread loads at a time (16 up to CAP = 8, 8 at 16, one value above: a
// thread holds CAP such loads, so they shrink as the capacity grows), V =
// B / sizeof(T) coordinates a thread, and the W 32-bit words that hold
// them.
template <int CAP, typename T>
struct BulyanShape {
  static constexpr int B = CAP <= 8 ? 16 : CAP <= 16 ? 8 : (int)sizeof(T);
  static constexpr int V = B / (int)sizeof(T);
  static constexpr int W = (B + 3) / 4;
};

// +inf (or -inf) in every value of a word.
template <typename T>
__device__ __forceinline__ unsigned bulyan_inf_word(bool neg = false) {
  if (sizeof(T) == 4) return neg ? 0xff800000u : 0x7f800000u;
  return neg ? 0xff80ff80u : 0x7f807f80u;
}

// Value c of a row's words, exactly, in fp32.
template <typename T, int W>
__device__ __forceinline__ float bulyan_value(const unsigned (&w)[W],
                                              int c) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[c]);
  } else {
    const unsigned u = w[c >> 1];
    return __uint_as_float((c & 1) ? (u & 0xffff0000u) : (u << 16));
  }
}

// One load of B bytes into W words (p aligned to B bytes).
template <int B, int W>
__device__ __forceinline__ void bulyan_load_vec(const void* p,
                                                unsigned (&w)[W]) {
  if constexpr (B == 16) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = r.x;
    w[1] = r.y;
    w[2] = r.z;
    w[3] = r.w;
  } else if constexpr (B == 8) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = r.x;
    w[1] = r.y;
  } else if constexpr (B == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
}

// The scalar load of the same words: columns j0 .. j0 + V - 1 of row p, a
// column past d read as 0.
template <typename T, int V, int W>
__device__ __forceinline__ void bulyan_load_scalar(const T* p, long long j0,
                                                   long long d,
                                                   unsigned (&w)[W]) {
  constexpr int EPW = 4 / (int)sizeof(T);
#pragma unroll
  for (int q = 0; q < W; ++q) w[q] = 0u;
#pragma unroll
  for (int c = 0; c < V; ++c) {
    if (j0 + c < d) {
      using B = typename std::conditional<sizeof(T) == 4, unsigned,
                                          unsigned short>::type;
      const unsigned b = *reinterpret_cast<const B*>(p + j0 + c);
      w[c / EPW] |= b << (32 / EPW * (c % EPW));
    }
  }
}

// The V results of a thread, with one store of up to 16 bytes at a time.
template <int V>
__device__ __forceinline__ void bulyan_store_vec(float* p,
                                                 const float (&r)[V]) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int c = 0; c < V; c += 4)
      *reinterpret_cast<float4*>(p + c) =
          make_float4(r[c], r[c + 1], r[c + 2], r[c + 3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  } else {
    p[0] = r[0];
  }
}

// A block's list of the selected rows, in ascending row order: each entry
// the pointer its values are read from (K14: the mean for an absent row)
// and its row; row 0 as the all-inf round reads it; the median's ranks.
template <typename T>
struct BulyanList {
  const T* const* rows;
  const int* row_of;
  const T* row0;
  int k, n, theta, m0, m1, beta;
};

// The exact law at coordinate j, the reference's own computation: K1's
// odd-even transposition network (the comparators of coord_stat.cuh's
// sort_network, as a loop: n is known only at run time, so the n
// positions sit in local memory) over the n positions, the unselected
// ones +inf, with the NaN-propagating min / max; then beta rounds of the
// first listed row with the least |x - med| under a NaN-propagating
// minimum, each value read again from memory.  A NaN minimum extracts
// nothing and adds 0, and so does every later round (nothing changed); an
// all-inf minimum takes row 0, selected or not (its imputed value for
// K14), and adds it.
template <typename T>
__device__ __forceinline__ float bulyan_exact(const BulyanList<T>& L,
                                              long long j) {
  const int n = L.n, k = L.k;
  float v[kBulyanMaxN];
#pragma unroll 1
  for (int i = 0; i < n; ++i) v[i] = INFINITY;
#pragma unroll 1
  for (int e = 0; e < k; ++e) v[L.row_of[e]] = to_f32(L.rows[e][j]);
#pragma unroll 1
  for (int p = 0; p < n; ++p) {
#pragma unroll 1
    for (int i = p & 1; i + 1 < n; i += 2) {
      const float lo = nan_min(v[i], v[i + 1]);
      v[i + 1] = nan_max(v[i], v[i + 1]);
      v[i] = lo;
    }
  }
  const float med = __fmul_rn(0.5f, v[L.m0] + v[L.m1]);
  unsigned long long avail = k == 64 ? ~0ull : (1ull << k) - 1ull;
  float acc = 0.f;
#pragma unroll 1
  for (int r = 0; r < L.beta; ++r) {
    float mn = INFINITY;
#pragma unroll 1
    for (int e = 0; e < k; ++e)
      if ((avail >> e) & 1ull)
        mn = nan_min(mn, fabsf(to_f32(L.rows[e][j]) - med));
    if (mn != mn) break;
    const T* pick = L.row0;
    if (mn != INFINITY) {
#pragma unroll 1
      for (int e = 0; e < k; ++e)
        if (((avail >> e) & 1ull) &&
            fabsf(to_f32(L.rows[e][j]) - med) == mn) {
          pick = L.rows[e];
          avail &= ~(1ull << e);
          break;
        }
    }
    acc += to_f32(pick[j]);
  }
  return acc / (float)L.beta;
}

// The least of CAP values, as a tree (depth log2 CAP).
template <int CAP>
__device__ __forceinline__ float bulyan_min(const float (&v)[CAP]) {
  float m[CAP];
#pragma unroll
  for (int e = 0; e < CAP; ++e) m[e] = v[e];
#pragma unroll
  for (int s = 1; s < CAP; s *= 2) {
#pragma unroll
    for (int e = 0; e + s < CAP; e += 2 * s) m[e] = fminf(m[e], m[e + s]);
  }
  return m[0];
}

// Whether a block's list takes the fast path in the CAP-value instance:
// at least beta rows, and room beside them for the (CAP - theta) / 2 -inf
// pads that put the median's ranks at CAP / 2 - 1 and CAP / 2.
template <int CAP, typename T>
__device__ __forceinline__ bool bulyan_fits(const BulyanList<T>& L) {
  return L.k >= L.beta && L.k + (CAP - L.theta) / 2 <= CAP;
}

// The V coordinates j0 .. j0 + V - 1 of a block whose list fits
// (bulyan_fits).
template <int CAP, typename T>
__device__ __forceinline__ void bulyan_chunk(const BulyanList<T>& L,
                                             long long j0, long long d,
                                             bool vec, float* out) {
  using S = BulyanShape<CAP, T>;
  constexpr int B = S::B, V = S::V, W = S::W;
  const bool full = j0 + V <= d;
  // past the k listed rows: (CAP - theta) / 2 rows of -inf, then +inf.
  // The law's median ranks (theta - 1) / 2 and theta / 2 among the listed
  // values and +inf then sit at CAP / 2 - 1 and CAP / 2 (the second only
  // for an even theta), whatever theta.
  const int lo_pads = (CAP - L.theta) / 2;
  unsigned w[CAP][W];
#pragma unroll
  for (int e = 0; e < CAP; ++e) {
    if (e < L.k) {
      if (vec && full)
        bulyan_load_vec<B>(L.rows[e] + j0, w[e]);
      else
        bulyan_load_scalar<T, V>(L.rows[e], j0, d, w[e]);
    } else {
      const unsigned pad = bulyan_inf_word<T>(e - L.k < lo_pads);
#pragma unroll
      for (int q = 0; q < W; ++q) w[e][q] = pad;
    }
  }
  float res[V];
  unsigned pend = 0u;
#pragma unroll
  for (int c = 0; c < V; ++c) {
    // the fast path: the listed values and the pads
    float xs[CAP], v[CAP];
#pragma unroll
    for (int e = 0; e < CAP; ++e) v[e] = xs[e] = bulyan_value<T>(w[e], c);
    batcher_sort<CAP, 0, CAP - 1>(v);
    const float a = v[CAP / 2 - 1];
    const float b = (L.theta & 1) ? a : v[CAP / 2];
    // never contracted into the subtractions below: the plain version
    // rounds the median first
    const float med = __fmul_rn(0.5f, a + b);
    // no NaN distance: no NaN listed value and a median off +-inf (the
    // pads are +-inf, never NaN)
    float dist[CAP];
    bool nan = false;
#pragma unroll
    for (int e = 0; e < CAP; ++e) {
      dist[e] = fabsf(xs[e] - med);
      nan = nan || dist[e] != dist[e];
    }
    // beta rounds, each the first listed row at the least distance (the
    // pads' distances are +inf); the minima never fall, so the last is
    // finite iff every round found a finite one, as the law's did
    float acc = 0.f, mn = 0.f;
    for (int r = 1; !nan; ++r) {
      mn = bulyan_min<CAP>(dist);
      float val = 0.f;
      if (r == L.beta) {
#pragma unroll
        for (int e = CAP - 1; e >= 0; --e)
          if (dist[e] == mn) val = xs[e];
        acc += val;
        break;
      }
      bool found = false;
#pragma unroll
      for (int e = 0; e < CAP; ++e) {
        const bool hit = !found && dist[e] == mn;
        found = found || dist[e] == mn;
        if (hit) {
          val = xs[e];
          dist[e] = INFINITY;
        }
      }
      acc += val;
    }
    if (nan || !(mn <= FLT_MAX)) {
      // a NaN listed value, a +-inf median, or a round that finds only
      // +inf (infinite values, |x - med| overflowing): the exact law,
      // after the store below (a column past d, padded with 0, has none
      // of these unless its median is a +inf pad)
      if (j0 + c < d) pend |= 1u << c;
      res[c] = 0.f;
      continue;
    }
    res[c] = acc / (float)L.beta;
  }
  if (vec && full) {
    bulyan_store_vec<V>(out + j0, res);
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c)
      if (j0 + c < d) out[j0 + c] = res[c];
  }
  while (pend != 0u) {
    const int c = __ffs(pend) - 1;
    pend &= pend - 1u;
    out[j0 + c] = bulyan_exact<T>(L, j0 + c);
  }
}

template <int CAP, typename T>
__global__ void __launch_bounds__(kBulyanThreads)
bulyan_coord_kernel(const T* __restrict__ x, const float* __restrict__ sel,
                    const float* __restrict__ mask,
                    const T* __restrict__ mean, float* __restrict__ out,
                    int n, long long d, long long ld, int theta, int beta) {
  using S = BulyanShape<CAP, T>;
  constexpr int B = S::B, V = S::V;
  // the block's list (BulyanList), built once per block
  __shared__ const T* rows_s[kBulyanMaxN];
  __shared__ int row_of_s[kBulyanMaxN];
  __shared__ const T* row0_s;
  __shared__ unsigned sel_w[2];
  const int t = threadIdx.x;
  if (t < kBulyanMaxN) {
    const unsigned b = __ballot_sync(0xffffffffu, t < n && sel[t] > 0.5f);
    if ((t & 31) == 0) sel_w[t >> 5] = b;
  }
  if (t == 0) row0_s = (mask == nullptr || mask[0] > 0.5f) ? x : mean;
  __syncthreads();
  const unsigned w0 = sel_w[0], w1 = sel_w[1];
  const int k = __popc(w0) + __popc(w1);
  int misaligned = 0;
  if (t < n && (((t < 32 ? w0 : w1) >> (t & 31)) & 1u)) {
    const int pos = t < 32 ? __popc(w0 & ((1u << t) - 1u))
                           : __popc(w0) + __popc(w1 & ((1u << (t - 32)) - 1u));
    const T* p = (mask == nullptr || mask[t] > 0.5f)
                     ? x + (long long)t * ld
                     : mean;
    rows_s[pos] = p;
    row_of_s[pos] = t;
    misaligned = reinterpret_cast<uintptr_t>(p) % B != 0;
  }
  if (t == 0)
    misaligned |= reinterpret_cast<uintptr_t>(out) % (V >= 4 ? 16 : 4 * V)
                  != 0;
  // vector loads and stores only if every listed row and the output are
  // aligned for them (block-uniform)
  const bool vec = !__syncthreads_or(misaligned);

  const BulyanList<T> L{rows_s, row_of_s, row0_s, k, n, theta,
                        (theta - 1) / 2, theta / 2, beta};
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + t;
  if (!bulyan_fits<CAP>(L)) {
    // more rows listed than the registers hold, or fewer than the rounds
    // (block-uniform): the exact law everywhere
    for (long long j = first; j < d; j += stride)
      out[j] = bulyan_exact<T>(L, j);
    return;
  }
  const long long chunks = (d + V - 1) / V;
  for (long long ch = first; ch < chunks; ch += stride)
    bulyan_chunk<CAP, T>(L, ch * V, d, vec, out);
}

template <int CAP, typename T>
void bulyan_coord_launch(const void* x, const float* sel, const float* mask,
                         const void* mean, float* out, int n, long long d,
                         long long ld, int theta, int beta, cudaStream_t s) {
  constexpr int V = BulyanShape<CAP, T>::V;
  const unsigned blocks = grid_blocks((d + V - 1) / V, kBulyanThreads);
  bulyan_coord_kernel<CAP, T><<<blocks, kBulyanThreads, 0, s>>>(
      (const T*)x, sel, mask, (const T*)mean, out, n, d, ld, theta, beta);
}

// K13 (mask = mean = nullptr) and K14: checks the sizes and runs the
// instance whose register capacity holds theta rows (bulyan_coord.cu).
int bulyan_coord_entry(const void* x, int dtype, const float* sel,
                       const float* mask, const void* mean, float* out, int n,
                       long long d, long long ld, int theta, int beta,
                       void* stream);

// instantiated in bulyan_coord_{32,64}_{f32,bf16}.cu
#define RT_BC_EXTERN(N, T)                                                 \
  extern template void bulyan_coord_launch<N, T>(                          \
      const void*, const float*, const float*, const void*, float*, int,   \
      long long, long long, int, int, cudaStream_t);
RT_BC_EXTERN(32, float)
RT_BC_EXTERN(32, __nv_bfloat16)
RT_BC_EXTERN(64, float)
RT_BC_EXTERN(64, __nv_bfloat16)
#undef RT_BC_EXTERN
