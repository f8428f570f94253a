// The scaled coordinate-statistic template and its launcher, shared by
// K18 (scaled_coord_stat.cu, MASKED = false) and K19
// (scaled_masked_coord_stat.cu, MASKED = true), which hold the entry
// points.  The stack holds int8 or fp8 e4m3 codes with an fp32 scale per
// row; the value of a code is to_f32(code) * scale[row], one rounded
// multiply (core.flat.dequantize_rows), and the statistic is K1's (K18)
// or K5's (K19) over those values.
//
// Bound on this card: bytes, once the instructions are few enough.  A
// coordinate moves one byte a live row and writes 4 (12 bytes at n = 8),
// which the card's issue rate covers with some 100 instructions; the
// first version (K1's template with a scaled load) spent over 330: a
// 1-byte load with its own address arithmetic, a conversion, the
// multiply, and the odd-even transposition network's n(n - 1) / 2
// compare-exchanges, each a NaN-propagating min and max of some ten
// instructions.  This template spends about 70 at n = 8:
//
// * The row list.  Each block reads the (n,) mask (K19) and scales once
//   and lists the live rows in row order in shared memory, each with its
//   pointer and scale; the k listed rows fill the first k of the CAP
//   register slots (CAP = 4, 8, 16, 32 or 64, the least that holds n,
//   chosen on the host), and the other slots are pads: (CAP - k) / 2 of
//   -inf, then +inf.  The law's median ranks then sit at the fixed
//   registers CAP / 2 - 1 and CAP / 2 (the first alone for an odd count)
//   and the trimmed window at registers known once per block.  An absent
//   row is never read.
// * Loads.  A thread takes B consecutive coordinates, one B-byte load of
//   each listed row (B = 16 up to CAP = 8, 8 at 16, 4 above: CAP * B / 4
//   words stay in registers), and dequantizes and sorts them four at a
//   time (one word a row); its B results leave in 16-byte stores.  A row
//   or output not aligned for them (rows of 4099, a view offset by one
//   byte) and the last partial chunk take byte loads of the same words.
// * Dequantization, exact for every code.  int8: the byte, xor 0x80, is
//   placed in the mantissa of 2^23 (one byte permute) and 2^23 + 128
//   subtracted (one add).  fp8 e4m3: the card's conversion of two codes
//   to two fp16 values (exact: every e4m3 value is one), each widened to
//   fp32.  Then one __fmul_rn by the row's scale: bit for bit
//   to_f32(code) * scale.  The fp8 NaN codes (0x7f, 0xff) are found on
//   whole words, four coordinates at a time.
// * The fast path.  A block whose live scales are all finite takes it:
//   int8 codes times finite scales give no NaN (an overflow to +-inf sorts
//   as a value), and an fp8 coordinate with no NaN code gives none
//   either.  It runs Batcher's network of fminf / fmaxf over the CAP
//   registers (19 compare-exchanges of one instruction each at CAP = 8,
//   where the odd-even network takes 28 of some ten; the compiler drops
//   the comparators the median's registers do not need), then the
//   median, or the window summed in ascending rank order from +0 and
//   divided by max(hi - lo, 1) (a multiply by the exact reciprocal when
//   that is a power of two: the same rounding).  On NaN-free values any
//   sorting network gives every rank the same value as the reference's
//   odd-even network over the n positions (absent rows +inf in theirs),
//   except the sign of a zero among tied zeros.
// * The exact law.  Every coordinate of a block with a non-finite live
//   scale, and every fp8 coordinate with a NaN code, runs the reference's
//   own computation (the first version's): the n positions in row order,
//   an absent row +inf, the odd-even transposition network with the
//   NaN-propagating min / max, the same window.  A fast chunk stores its
//   results first and then overwrites those coordinates, so a warp
//   diverges only where NaN codes are.
//
// A later kernel on float rows (K1, K5) takes this template by a Codes<T>
// of its own: its load words, its value of a word's lanes, a scale of 1.
// The 32- and 64-row instances are compiled in their own translation
// units (scaled_coord_stat_{32,64}_{i8,f8}.cu), so nvcc runs them in
// parallel; 4, 8 and 16 are instantiated with the entry points.
#pragma once

#include <cuda_fp16.h>
#include <float.h>

#include "common.cuh"

constexpr int kScaledMaxN = 64;
constexpr int kScaledThreads = 256;

// For a register capacity of CAP rows: B bytes of one listed row (B
// coordinates: a code is one byte) a thread loads at a time, in W words.
template <int CAP>
struct ScaledShape {
  static constexpr int B = CAP <= 8 ? 16 : CAP <= 16 ? 8 : 4;
  static constexpr int W = B / 4;
};

// What the template needs of a code type: prep(w), once a loaded word;
// value(w, c), lane c of a prepped word as the exact fp32 value that the
// row's scale multiplies; the pad words, +inf and -inf once multiplied by
// +inf; and, where the type has NaN codes, nan_lanes(w), whose bit 8 c +
// 7 is set iff lane c holds one.
template <typename T>
struct Codes;

template <>
struct Codes<int8_t> {
  static constexpr bool kHasNaN = false;
  static constexpr unsigned kPadHi = 0x7f7f7f7fu;  // 127
  static constexpr unsigned kPadLo = 0x81818181u;  // -127
  static __device__ __forceinline__ unsigned prep(unsigned w) {
    return w ^ 0x80808080u;
  }
  static __device__ __forceinline__ float value(unsigned w, int c) {
    // 2^23 + (code + 128), exact, less 2^23 + 128
    const unsigned m = __byte_perm(w, 0x4b000000u, 0x7540u | c);
    return __fsub_rn(__uint_as_float(m), 8388736.f);
  }
  static __device__ __forceinline__ unsigned nan_lanes(unsigned) {
    return 0u;
  }
};

template <>
struct Codes<__nv_fp8_e4m3> {
  static constexpr bool kHasNaN = true;
  static constexpr unsigned kPadHi = 0x7e7e7e7eu;  // 448
  static constexpr unsigned kPadLo = 0xfefefefeu;  // -448
  static __device__ __forceinline__ unsigned prep(unsigned w) { return w; }
  static __device__ __forceinline__ float value(unsigned w, int c) {
    // two codes a conversion to fp16 (exact: e4m3 is a subset), widened
    const __half2_raw h2 = __nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)((c & 2) ? w >> 16 : w & 0xffffu), __NV_E4M3);
    __half_raw h;
    h.x = (c & 1) ? h2.y : h2.x;
    return __half2float(__half(h));
  }
  static __device__ __forceinline__ unsigned nan_lanes(unsigned w) {
    return (w & 0x7f7f7f7fu) + 0x01010101u;
  }
};

// One load of B bytes into W words (p aligned to B bytes).
template <int B, int W>
__device__ __forceinline__ void scaled_load_vec(const unsigned char* p,
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
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  }
}

// The byte loads of the same words: columns j0 .. j0 + B - 1 of row p, a
// column past d read as code 0.
template <int B, int W>
__device__ __forceinline__ void scaled_load_bytes(const unsigned char* p,
                                                  long long j0, long long d,
                                                  unsigned (&w)[W]) {
#pragma unroll
  for (int q = 0; q < W; ++q) w[q] = 0u;
#pragma unroll
  for (int c = 0; c < B; ++c)
    if (j0 + c < d)
      w[c >> 2] |= (unsigned)__ldg(p + j0 + c) << (8 * (c & 3));
}

// The reference's law at one coordinate (the exact path): the n positions
// in row order, n, the live rows' bits, the scales by row, the stat, the
// window [lo, hi) of the old kernel, its width and the arrived count.
struct ScaledLaw {
  const unsigned char* x;
  long long ld;
  const float* scale;
  unsigned live0, live1;
  int n, stat, lo, hi, cnt;
  float width;
};

template <typename T, bool MASKED>
__device__ __noinline__ float scaled_exact(const ScaledLaw& E, long long j) {
  const int n = E.n;
  float v[kScaledMaxN];
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const bool live = (((i < 32 ? E.live0 : E.live1) >> (i & 31)) & 1u) != 0;
    v[i] = live ? __fmul_rn(to_f32(reinterpret_cast<const T*>(
                                E.x + (long long)i * E.ld)[j]),
                            E.scale[i])
                : INFINITY;
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

// A block's list: the k listed rows' pointers and scales, then the pads'
// words and scales (+inf); the window as a bit mask of the registers, its
// width and, for a power of two, its exact reciprocal; whether the count
// (n for K18, the arrived count for K19) is even.
struct ScaledList {
  const unsigned char* const* rows;
  const float* scale;
  const unsigned* pad;
  unsigned long long keep;
  int k;
  bool even, pow2;
  float rw, width;
};

// How a block reads the statistic off the sorted registers: K18's median,
// 0.5 * (s[(n-1)//2] + s[n//2]); a window of width 1 or 2 (K19's median,
// a trimmed mean that keeps the middle ranks only), which sits at CAP / 2
// - 1 (and CAP / 2), summed from +0 and halved for width 2; any wider
// window, summed from +0 in ascending rank order and divided by its width
// once a chunk (scaled_chunk).
enum ScaledMode { kHalfSum, kNarrow, kWindow };

// The statistic of one coordinate from its CAP sorted registers (a wide
// window: its sum, not yet divided).
template <int CAP, int MODE>
__device__ __forceinline__ float scaled_window(const float (&v)[CAP],
                                               const ScaledList& L) {
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
// B-byte loads (and the output for 16-byte stores).
template <int CAP, typename T, bool MASKED, int MODE, bool VEC>
__device__ __forceinline__ void scaled_chunk(const ScaledList& L,
                                             const ScaledLaw& E, long long j0,
                                             long long d, float* out) {
  using C = Codes<T>;
  constexpr int B = ScaledShape<CAP>::B, W = ScaledShape<CAP>::W;
  unsigned w[CAP][W];
  float sc[CAP];
#pragma unroll
  for (int e = 0; e < CAP; ++e) {
    sc[e] = L.scale[e];
    if (e < L.k) {
      if constexpr (VEC)
        scaled_load_vec<B>(L.rows[e] + j0, w[e]);
      else
        scaled_load_bytes<B>(L.rows[e], j0, d, w[e]);
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
    for (int c = 0; c < 4; ++c) {
      float v[CAP];
#pragma unroll
      for (int e = 0; e < CAP; ++e)
        v[e] = __fmul_rn(C::value(u[e], c), sc[e]);
      batcher_sort<CAP, 0, CAP - 1>(v);
      res[4 * q + c] = scaled_window<CAP, MODE>(v, L);
      // a NaN code: the exact law, after the stores (a column past d,
      // read as code 0, has none)
      const int col = 4 * q + c;
      if (C::kHasNaN && ((nan >> (8 * c + 7)) & 1u) && (VEC || j0 + col < d))
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
  while (pend != 0u) {
    const int c = __ffs(pend) - 1;
    pend &= pend - 1u;
    out[j0 + c] = scaled_exact<T, MASKED>(E, j0 + c);
  }
}

// The fast path over a block's share of the chunks: the full chunks with
// vector loads when the rows allow them, any other with byte loads.
template <int CAP, typename T, bool MASKED, int MODE>
__device__ __forceinline__ void scaled_chunks(const ScaledList& L,
                                              const ScaledLaw& E, bool vec,
                                              long long d, float* out) {
  constexpr int B = ScaledShape<CAP>::B;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long chunks = (d + B - 1) / B;
  const long long full = vec ? d / B : 0;
  long long ch = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; ch < full; ch += stride)
    scaled_chunk<CAP, T, MASKED, MODE, true>(L, E, ch * B, d, out);
  for (; ch < chunks; ch += stride)
    scaled_chunk<CAP, T, MASKED, MODE, false>(L, E, ch * B, d, out);
}

// Up to capacity 16, at most 128 registers a thread: two blocks an SM, the
// warps that keep the loads in flight.
template <int CAP, typename T, bool MASKED>
__global__ void __launch_bounds__(kScaledThreads, CAP <= 16 ? 2 : 1)
scaled_stat_kernel(const unsigned char* __restrict__ x,
                   const float* __restrict__ mask,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int n, long long d, long long ld, int stat, int b) {
  using C = Codes<T>;
  constexpr int B = ScaledShape<CAP>::B;
  __shared__ const unsigned char* rows_s[kScaledMaxN];
  __shared__ float sc_s[kScaledMaxN];
  __shared__ unsigned pad_s[kScaledMaxN];
  __shared__ float scale_s[kScaledMaxN];
  __shared__ unsigned live_w[2];
  const int t = threadIdx.x;
  if (t < kScaledMaxN) {
    const bool live = t < n && (!MASKED || mask[t] > 0.5f);
    const unsigned bits = __ballot_sync(0xffffffffu, live);
    if ((t & 31) == 0) live_w[t >> 5] = bits;
    if (t < n) scale_s[t] = scale[t];
  }
  __syncthreads();
  const unsigned w0 = live_w[0], w1 = live_w[1];
  const int k = __popc(w0) + __popc(w1);
  int bad = 0, misaligned = 0;
  if (t < n && (((t < 32 ? w0 : w1) >> (t & 31)) & 1u)) {
    const int pos = t < 32 ? __popc(w0 & ((1u << t) - 1u))
                           : __popc(w0) + __popc(w1 & ((1u << (t - 32)) - 1u));
    const unsigned char* p = x + (long long)t * ld;
    rows_s[pos] = p;
    sc_s[pos] = scale_s[t];
    bad = !(fabsf(scale_s[t]) <= FLT_MAX);
    misaligned = reinterpret_cast<uintptr_t>(p) % B != 0;
  }
  const int lo_pads = (CAP - k) / 2;
  if (t >= k && t < CAP) {
    sc_s[t] = INFINITY;
    pad_s[t] = t - k < lo_pads ? C::kPadLo : C::kPadHi;
  }
  if (t == 0) misaligned |= reinterpret_cast<uintptr_t>(out) % 16 != 0;
  // block-uniform: every live scale finite; vector loads and stores
  const bool fast = !__syncthreads_or(bad);
  const bool vec = !__syncthreads_or(misaligned);

  // the law's window [lo, hi) over the sorted count (K19's arrived values
  // in ranks [0, cnt): median lo = (cnt-1)//2, trimmed lo = min(b,
  // (cnt-1)//2), hi = cnt - lo; K18's lo = b, hi = n - b)
  const int cnt = k;
  int lo = b;
  if (MASKED) {
    lo = (cnt - 1) / 2;
    if (stat != 0 && b < lo) lo = b;
    if (lo < 0) lo = 0;
  }
  const int hi = cnt - lo;
  const int width = hi - lo > 1 ? hi - lo : 1;
  const ScaledLaw E{x, ld, scale_s, w0, w1, n, stat, lo, hi, cnt,
                    (float)width};
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + t;
  if (MASKED && cnt == 0) {
    for (long long j = first; j < d; j += stride) out[j] = 0.f;
    return;
  }
  if (!fast) {
    for (long long j = first; j < d; j += stride)
      out[j] = scaled_exact<T, MASKED>(E, j);
    return;
  }
  // the window in register positions, past the lo_pads -inf pads
  auto below = [](int m) { return m >= 64 ? ~0ull : (1ull << m) - 1ull; };
  const unsigned long long keep = below(lo_pads + hi) & ~below(lo_pads + lo);
  const bool pow2 = (width & (width - 1)) == 0;
  const ScaledList L{rows_s, sc_s, pad_s, keep, k, (cnt & 1) == 0, pow2,
                     1.f / (float)width, (float)width};
  if (!MASKED && stat == 0)
    scaled_chunks<CAP, T, MASKED, kHalfSum>(L, E, vec, d, out);
  else if (width <= 2)
    scaled_chunks<CAP, T, MASKED, kNarrow>(L, E, vec, d, out);
  else
    scaled_chunks<CAP, T, MASKED, kWindow>(L, E, vec, d, out);
}

template <int CAP, typename T, bool MASKED>
void scaled_stat_launch(const void* x, const float* mask, const float* scale,
                        float* out, int n, long long d, long long ld,
                        int stat, int b, cudaStream_t s) {
  constexpr int B = ScaledShape<CAP>::B;
  const unsigned blocks = grid_blocks((d + B - 1) / B, kScaledThreads);
  scaled_stat_kernel<CAP, T, MASKED><<<blocks, kScaledThreads, 0, s>>>(
      (const unsigned char*)x, mask, scale, out, n, d, ld, stat, b);
}

// Runs the instance whose register capacity holds n rows.
template <typename T, bool MASKED>
int scaled_stat_dispatch(const void* x, const float* mask,
                         const float* scale, float* out, int n, long long d,
                         long long ld, int stat, int b, cudaStream_t s) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  if (n <= 4)
    scaled_stat_launch<4, T, MASKED>(x, mask, scale, out, n, d, ld, stat, b,
                                     s);
  else if (n <= 8)
    scaled_stat_launch<8, T, MASKED>(x, mask, scale, out, n, d, ld, stat, b,
                                     s);
  else if (n <= 16)
    scaled_stat_launch<16, T, MASKED>(x, mask, scale, out, n, d, ld, stat,
                                      b, s);
  else if (n <= 32)
    scaled_stat_launch<32, T, MASKED>(x, mask, scale, out, n, d, ld, stat,
                                      b, s);
  else if (n <= 64)
    scaled_stat_launch<64, T, MASKED>(x, mask, scale, out, n, d, ld, stat,
                                      b, s);
  else
    return (int)cudaErrorInvalidValue;
  return rt_status();
}

// The signature of one instance, for the explicit instantiations in
// scaled_coord_stat_{32,64}_{i8,f8}.cu and the extern declarations here.
#define RT_SCS_LAUNCH(N, T, M)                                             \
  void scaled_stat_launch<N, T, M>(const void*, const float*, const float*, \
                                   float*, int, long long, long long, int,  \
                                   int, cudaStream_t)
extern template RT_SCS_LAUNCH(32, int8_t, false);
extern template RT_SCS_LAUNCH(32, int8_t, true);
extern template RT_SCS_LAUNCH(32, __nv_fp8_e4m3, false);
extern template RT_SCS_LAUNCH(32, __nv_fp8_e4m3, true);
extern template RT_SCS_LAUNCH(64, int8_t, false);
extern template RT_SCS_LAUNCH(64, int8_t, true);
extern template RT_SCS_LAUNCH(64, __nv_fp8_e4m3, false);
extern template RT_SCS_LAUNCH(64, __nv_fp8_e4m3, true);
