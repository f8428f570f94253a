// The order-statistic template and its launcher: a per-coordinate median
// or trimmed mean over the rows of an (n, d) stack -> (d,) fp32, shared
// by K1 (coord_stat.cu: bf16 / fp32 rows), K18 (scaled_coord_stat.cu)
// and K19 (scaled_masked_coord_stat.cu: int8 / fp8 e4m3 codes with an
// fp32 scale a row; the value of a code is to_f32(code) * scale[row], one
// rounded multiply, core.flat.dequantize_rows).  K1 and K18 read every
// row (MASKED = false) and keep the window of K1's law; K19 reads the
// arrived rows (MASKED = true) and its window follows their count, K5's
// law.  The entry points are in those files.
//
// Bound on this card: bytes, once the instructions are few enough.  A
// coordinate moves n elements and writes 4 bytes (20 bytes for bf16 at n
// = 8, 12 for codes), which the card's issue rate covers with some 170
// (bf16) or 100 (codes) instructions a coordinate.  The odd-even
// transposition network with one scalar load a row (coord_stat.cuh) spends
// about 350: a load with its own address arithmetic and conversion, and
// n(n - 1) / 2 compare-exchanges, each a NaN-propagating min and max of
// some ten instructions.  This template spends about 70 at n = 8:
//
// * The row list.  Each block reads the (n,) mask (K19) and scales once
//   and lists the live rows in row order in shared memory (and their
//   scales); the k listed rows fill the first k of the CAP register slots
//   (CAP = 4, 8, 16, 32 or 64, the least that holds n, chosen on the
//   host), and the other slots are pads: (CAP - k) / 2 below every value,
//   then above (Codes<T>::kPadLo / kPadHi: the +-inf words of a float
//   row; the largest codes of each sign times an inf scale).  The law's
//   median ranks then sit at the fixed registers CAP / 2 - 1 and CAP / 2
//   (the first alone for an odd count) and the trimmed window at
//   registers known once per block.  An absent row is never read.
// * Loads.  A thread takes the B consecutive coordinates of RB bytes of
//   each listed row, one RB-byte load a row (RB = 16 up to CAP = 8, 8 at
//   16, 4 above: CAP * RB / 4 words stay in registers; B = 16 codes, 8
//   bf16 or 4 fp32 at CAP 8), and widens and sorts them one word at a
//   time (Codes<T>: 4 codes, 2 bf16 or 1 fp32 a word); its B results
//   leave in 16-byte stores (8 or 4 bytes for fp32 above CAP 8).  A row
//   or output not aligned for them (rows of 4099, a view offset by one
//   element) and the last partial chunk take element loads of the same
//   words.
// * Widening, exact for every element (codes.cuh): a byte permute into
//   2^23 and one add for int8, the card's e4m3x2 -> f16x2 conversion for
//   fp8, one shift or and for bf16, nothing for fp32; then, for codes
//   only, one __fmul_rn by the row's scale: bit for bit to_f32(x) *
//   scale, or to_f32(x).  NaN elements are found on whole words, every
//   lane of a word at once.
// * The fast path.  A coordinate takes it when its live values hold no
//   NaN: int8 codes times the finite scales of a block give none (an
//   overflow to +-inf sorts as a value), and a float or fp8 coordinate
//   with no NaN element gives none either; a block with a non-finite live
//   scale takes the exact law throughout.  It runs Batcher's network of
//   fminf / fmaxf over the CAP registers (19 compare-exchanges of one
//   instruction each at CAP = 8, where the odd-even network takes 28 of
//   some ten; the compiler drops the comparators the median's registers
//   do not need), then the median, or the window summed in ascending
//   rank order from +0 and divided by max(hi - lo, 1) (a multiply by the
//   exact reciprocal when that is a power of two: the same rounding).  On
//   NaN-free values (+-inf among them) any sorting network gives every
//   rank the same value as the reference's odd-even network over the n
//   positions (absent rows +inf in theirs), except the sign of a zero
//   among tied zeros (counted on the card: chip_smoke.py).
// * The exact law.  Every coordinate of a block with a non-finite live
//   scale, and every coordinate with a NaN element, runs the reference's
//   own computation (coord_stat.cuh's): the n positions in row order, an
//   absent row +inf, the odd-even transposition network with the
//   NaN-propagating min / max, the same window.  A fast chunk stores its
//   results first and then overwrites those coordinates, so a warp
//   diverges only where NaN elements are.
//
// The 32- and 64-row instances are compiled in their own translation
// units (order_stat_{32,64}_{i8,f8,bf16,f32}.cu), so nvcc runs them in
// parallel; 4, 8 and 16 are instantiated with the entry points.
#pragma once

#include <float.h>

#include "codes.cuh"

constexpr int kOrderMaxN = 64;
constexpr int kOrderThreads = 256;

// For a register capacity of CAP rows of T: RB bytes of one listed row a
// thread loads at a time, in W words, holding B coordinates.
template <int CAP, typename T>
struct OrderShape {
  static constexpr int RB = CAP <= 8 ? 16 : CAP <= 16 ? 8 : 4;
  static constexpr int W = RB / 4;
  static constexpr int B = W * Codes<T>::kLanes;
};

// The reference's law at one coordinate (the exact path): the n positions
// in row order, their leading stride ld (elements), n, the live rows'
// bits, the scales by row (codes), the stat, the window [lo, hi) of
// coord_stat.cuh, its width and the arrived count.
struct OrderLaw {
  const unsigned char* x;
  long long ld;
  const float* scale;
  unsigned live0, live1;
  int n, stat, lo, hi, cnt;
  float width;
};

template <typename T, bool MASKED>
__device__ __noinline__ float order_exact(const OrderLaw& E, long long j) {
  const int n = E.n;
  float v[kOrderMaxN];
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const bool live = (((i < 32 ? E.live0 : E.live1) >> (i & 31)) & 1u) != 0;
    float x = INFINITY;
    if (live) {
      x = to_f32(reinterpret_cast<const T*>(
          E.x + (long long)i * E.ld * (long long)sizeof(T))[j]);
      if constexpr (Codes<T>::kScaled) x = __fmul_rn(x, E.scale[i]);
    }
    v[i] = x;
  }
#pragma unroll 1
  for (int p = 0; p < n; ++p) {
#pragma unroll 1
    for (int i = p & 1; i + 1 < n; i += 2) {
      const float lo = nan_min(v[i], v[i + 1]);
      v[i + 1] = nan_max(v[i], v[i + 1]);
      v[i] = lo;
    }
  }
  if (!MASKED && E.stat == 0)
    return __fmul_rn(0.5f, __fadd_rn(v[(n - 1) / 2], v[n / 2]));
  float acc = 0.f;
#pragma unroll 1
  for (int i = E.lo; i < E.hi; ++i) acc = __fadd_rn(acc, v[i]);
  return (!MASKED || E.cnt > 0) ? __fdiv_rn(acc, E.width) : 0.f;
}

// A block's list: the k listed rows' pointers (and scales), then the
// pads' words (and scales, +inf); the window as a bit mask of the
// registers, its width and, for a power of two, its exact reciprocal;
// whether the count (n for K1 / K18, the arrived count for K19) is even.
struct OrderList {
  const unsigned char* const* rows;
  const float* scale;
  const unsigned* pad;
  unsigned long long keep;
  int k;
  bool even, pow2;
  float rw, width;
};

// How a block reads the statistic off the sorted registers: K1's and
// K18's median, 0.5 * (s[(n-1)//2] + s[n//2]); a window of width 1 or 2
// (K19's median, a trimmed mean that keeps the middle ranks only), which
// sits at CAP / 2 - 1 (and CAP / 2), summed from +0 and halved for width
// 2; any wider window, summed from +0 in ascending rank order and divided
// by its width once a chunk (order_chunk).
enum OrderMode { kHalfSum, kNarrow, kWindow };

// The statistic of one coordinate from its CAP sorted registers (a wide
// window: its sum, not yet divided).
template <int CAP, int MODE>
__device__ __forceinline__ float order_window(const float (&v)[CAP],
                                              const OrderList& L) {
  const float a = v[CAP / 2 - 1];
  if constexpr (MODE == kHalfSum) {
    return __fmul_rn(0.5f, __fadd_rn(a, L.even ? v[CAP / 2] : a));
  } else if constexpr (MODE == kNarrow) {
    const float acc = __fadd_rn(0.f, a);
    return L.even ? __fmul_rn(__fadd_rn(acc, v[CAP / 2]), 0.5f) : acc;
  } else {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < CAP; ++i)
      if ((L.keep >> i) & 1ull) acc = __fadd_rn(acc, v[i]);
    return acc;
  }
}

// The B coordinates j0 .. j0 + B - 1 of a block on the fast path; VEC:
// the whole chunk lies below d and every listed row is aligned for the
// RB-byte loads (and the output for the stores).
template <int CAP, typename T, bool MASKED, int MODE, bool VEC>
__device__ __forceinline__ void order_chunk(const OrderList& L,
                                            const OrderLaw& E, long long j0,
                                            long long d, float* out) {
  using C = Codes<T>;
  using S = OrderShape<CAP, T>;
  constexpr int B = S::B, W = S::W, LN = C::kLanes, LB = 32 / LN;
  unsigned w[CAP][W];
  [[maybe_unused]] float sc[CAP];
#pragma unroll
  for (int e = 0; e < CAP; ++e) {
    if constexpr (C::kScaled) sc[e] = L.scale[e];
    if (e < L.k) {
      if constexpr (VEC)
        row_load_vec<S::RB>(L.rows[e] + j0 * (long long)sizeof(T), w[e]);
      else
        row_load_elems<T, B>(L.rows[e], j0, d, w[e]);
    } else {
      const unsigned pad = L.pad[e];
#pragma unroll
      for (int q = 0; q < W; ++q) w[e][q] = pad;
    }
  }
  float res[B];
  unsigned pend = 0u;
#pragma unroll
  for (int q = 0; q < W; ++q) {
    unsigned nan = 0u;
    unsigned u[CAP];
#pragma unroll
    for (int e = 0; e < CAP; ++e) {
      if (C::kHasNaN) nan |= C::nan_lanes(w[e][q]);
      u[e] = C::prep(w[e][q]);
    }
#pragma unroll
    for (int c = 0; c < LN; ++c) {
      float v[CAP];
#pragma unroll
      for (int e = 0; e < CAP; ++e) {
        if constexpr (C::kScaled)
          v[e] = __fmul_rn(C::value(u[e], c), sc[e]);
        else
          v[e] = C::value(u[e], c);
      }
      batcher_sort<CAP, 0, CAP - 1>(v);
      const int col = LN * q + c;
      res[col] = order_window<CAP, MODE>(v, L);
      // a NaN element: the exact law, after the stores (a column past d,
      // read as 0, has none)
      if (C::kHasNaN && ((nan >> (LB * c + LB - 1)) & 1u) &&
          (VEC || j0 + col < d))
        pend |= 1u << col;
    }
  }
  if constexpr (MODE == kWindow) {  // IEEE division, or the same rounding
    if (L.pow2) {
#pragma unroll
      for (int c = 0; c < B; ++c) res[c] = __fmul_rn(res[c], L.rw);
    } else {
#pragma unroll
      for (int c = 0; c < B; ++c) res[c] = __fdiv_rn(res[c], L.width);
    }
  }
  if constexpr (VEC && B % 4 == 0) {
#pragma unroll
    for (int c = 0; c < B; c += 4)
      *reinterpret_cast<float4*>(out + j0 + c) =
          make_float4(res[c], res[c + 1], res[c + 2], res[c + 3]);
  } else if constexpr (VEC && B == 2) {
    *reinterpret_cast<float2*>(out + j0) = make_float2(res[0], res[1]);
  } else {
#pragma unroll
    for (int c = 0; c < B; ++c)
      if (VEC || j0 + c < d) out[j0 + c] = res[c];
  }
  while (pend != 0u) {
    const int c = __ffs(pend) - 1;
    pend &= pend - 1u;
    out[j0 + c] = order_exact<T, MASKED>(E, j0 + c);
  }
}

// The fast path over a block's share of the chunks: the full chunks with
// vector loads when the rows allow them, any other with element loads.
template <int CAP, typename T, bool MASKED, int MODE>
__device__ __forceinline__ void order_chunks(const OrderList& L,
                                             const OrderLaw& E, bool vec,
                                             long long d, float* out) {
  constexpr int B = OrderShape<CAP, T>::B;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long chunks = (d + B - 1) / B;
  const long long full = vec ? d / B : 0;
  long long ch = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; ch < full; ch += stride)
    order_chunk<CAP, T, MASKED, MODE, true>(L, E, ch * B, d, out);
  for (; ch < chunks; ch += stride)
    order_chunk<CAP, T, MASKED, MODE, false>(L, E, ch * B, d, out);
}

// Up to capacity 16, at most 128 registers a thread: two blocks an SM, the
// warps that keep the loads in flight.
template <int CAP, typename T, bool MASKED>
__global__ void __launch_bounds__(kOrderThreads, CAP <= 16 ? 2 : 1)
order_stat_kernel(const unsigned char* __restrict__ x,
                  const float* __restrict__ mask,
                  const float* __restrict__ scale, float* __restrict__ out,
                  int n, long long d, long long ld, int stat, int b) {
  using C = Codes<T>;
  using S = OrderShape<CAP, T>;
  __shared__ const unsigned char* rows_s[kOrderMaxN];
  __shared__ float sc_s[kOrderMaxN];
  __shared__ unsigned pad_s[kOrderMaxN];
  __shared__ float scale_s[kOrderMaxN];
  __shared__ unsigned live_w[2];
  const int t = threadIdx.x;
  if (t < kOrderMaxN) {
    const bool live = t < n && (!MASKED || mask[t] > 0.5f);
    const unsigned bits = __ballot_sync(0xffffffffu, live);
    if ((t & 31) == 0) live_w[t >> 5] = bits;
    if (C::kScaled && t < n) scale_s[t] = scale[t];
  }
  __syncthreads();
  const unsigned w0 = live_w[0], w1 = live_w[1];
  const int k = __popc(w0) + __popc(w1);
  int bad = 0, misaligned = 0;
  if (t < n && (((t < 32 ? w0 : w1) >> (t & 31)) & 1u)) {
    const int pos = t < 32 ? __popc(w0 & ((1u << t) - 1u))
                           : __popc(w0) + __popc(w1 & ((1u << (t - 32)) - 1u));
    const unsigned char* p = x + (long long)t * ld * (long long)sizeof(T);
    rows_s[pos] = p;
    if constexpr (C::kScaled) {
      sc_s[pos] = scale_s[t];
      bad = !(fabsf(scale_s[t]) <= FLT_MAX);
    }
    misaligned = reinterpret_cast<uintptr_t>(p) % S::RB != 0;
  }
  const int lo_pads = (CAP - k) / 2;
  if (t >= k && t < CAP) {
    if constexpr (C::kScaled) sc_s[t] = INFINITY;
    pad_s[t] = t - k < lo_pads ? C::kPadLo : C::kPadHi;
  }
  if (t == 0)
    misaligned |= reinterpret_cast<uintptr_t>(out) %
                      (S::B >= 4 ? 16 : 4 * S::B) != 0;
  // block-uniform: every live scale finite; vector loads and stores
  const bool fast = !__syncthreads_or(bad);
  const bool vec = !__syncthreads_or(misaligned);

  // the law's window [lo, hi) over the sorted count (K19's arrived values
  // in ranks [0, cnt): median lo = (cnt-1)//2, trimmed lo = min(b,
  // (cnt-1)//2), hi = cnt - lo; K1's and K18's lo = b, hi = n - b)
  const int cnt = k;
  int lo = b;
  if (MASKED) {
    lo = (cnt - 1) / 2;
    if (stat != 0 && b < lo) lo = b;
    if (lo < 0) lo = 0;
  }
  const int hi = cnt - lo;
  const int width = hi - lo > 1 ? hi - lo : 1;
  const OrderLaw E{x, ld, scale_s, w0, w1, n, stat, lo, hi, cnt,
                   (float)width};
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + t;
  if (MASKED && cnt == 0) {
    for (long long j = first; j < d; j += stride) out[j] = 0.f;
    return;
  }
  if (!fast) {
    for (long long j = first; j < d; j += stride)
      out[j] = order_exact<T, MASKED>(E, j);
    return;
  }
  // the window in register positions, past the lo_pads low pads
  auto below = [](int m) { return m >= 64 ? ~0ull : (1ull << m) - 1ull; };
  const unsigned long long keep = below(lo_pads + hi) & ~below(lo_pads + lo);
  const bool pow2 = (width & (width - 1)) == 0;
  const OrderList L{rows_s, sc_s, pad_s, keep, k, (cnt & 1) == 0, pow2,
                    1.f / (float)width, (float)width};
  if (!MASKED && stat == 0)
    order_chunks<CAP, T, MASKED, kHalfSum>(L, E, vec, d, out);
  else if (width <= 2)
    order_chunks<CAP, T, MASKED, kNarrow>(L, E, vec, d, out);
  else
    order_chunks<CAP, T, MASKED, kWindow>(L, E, vec, d, out);
}

template <int CAP, typename T, bool MASKED>
void order_stat_launch(const void* x, const float* mask, const float* scale,
                       float* out, int n, long long d, long long ld, int stat,
                       int b, cudaStream_t s) {
  constexpr int B = OrderShape<CAP, T>::B;
  const unsigned blocks = grid_blocks((d + B - 1) / B, kOrderThreads);
  order_stat_kernel<CAP, T, MASKED><<<blocks, kOrderThreads, 0, s>>>(
      (const unsigned char*)x, mask, scale, out, n, d, ld, stat, b);
}

// Runs the instance whose register capacity holds n rows.
template <typename T, bool MASKED>
int order_stat_dispatch(const void* x, const float* mask, const float* scale,
                        float* out, int n, long long d, long long ld,
                        int stat, int b, cudaStream_t s) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  if (n <= 4)
    order_stat_launch<4, T, MASKED>(x, mask, scale, out, n, d, ld, stat, b,
                                    s);
  else if (n <= 8)
    order_stat_launch<8, T, MASKED>(x, mask, scale, out, n, d, ld, stat, b,
                                    s);
  else if (n <= 16)
    order_stat_launch<16, T, MASKED>(x, mask, scale, out, n, d, ld, stat, b,
                                     s);
  else if (n <= 32)
    order_stat_launch<32, T, MASKED>(x, mask, scale, out, n, d, ld, stat, b,
                                     s);
  else if (n <= 64)
    order_stat_launch<64, T, MASKED>(x, mask, scale, out, n, d, ld, stat, b,
                                     s);
  else
    return (int)cudaErrorInvalidValue;
  return rt_status();
}

// The signature of one instance, for the explicit instantiations in
// order_stat_{32,64}_{i8,f8,bf16,f32}.cu and the extern declarations here.
#define RT_OS_LAUNCH(N, T, M)                                              \
  void order_stat_launch<N, T, M>(const void*, const float*, const float*, \
                                  float*, int, long long, long long, int,  \
                                  int, cudaStream_t)
extern template RT_OS_LAUNCH(32, int8_t, false);
extern template RT_OS_LAUNCH(32, int8_t, true);
extern template RT_OS_LAUNCH(32, __nv_fp8_e4m3, false);
extern template RT_OS_LAUNCH(32, __nv_fp8_e4m3, true);
extern template RT_OS_LAUNCH(64, int8_t, false);
extern template RT_OS_LAUNCH(64, int8_t, true);
extern template RT_OS_LAUNCH(64, __nv_fp8_e4m3, false);
extern template RT_OS_LAUNCH(64, __nv_fp8_e4m3, true);
extern template RT_OS_LAUNCH(32, __nv_bfloat16, false);
extern template RT_OS_LAUNCH(32, float, false);
extern template RT_OS_LAUNCH(64, __nv_bfloat16, false);
extern template RT_OS_LAUNCH(64, float, false);
