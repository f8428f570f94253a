// What the kernels that read whole 32-bit words of a row need of its
// element type, and the loads of those words: the order-statistic
// template (order_stat.cuh: K1, K18, K19) and K21 (sparse_wmean.cu).  A
// word holds kLanes elements, lane c in bits [32 c / kLanes, 32 (c + 1) /
// kLanes).
//
// * value(prep(w), c): lane c as its exact fp32 value (for a code, the
//   value that the row's scale then multiplies, kScaled).  int8: the
//   byte, xor 0x80 (prep), placed in the mantissa of 2^23 by one byte
//   permute, less 2^23 + 128 (one add).  fp8 e4m3: the card's conversion
//   of two codes to two fp16 values (exact: every e4m3 value is one),
//   widened.  bf16: the 16 bits moved to the top of the word (one shift
//   or and).  fp32: the word.
// * nan_lanes(w): bit 32 (c + 1) / kLanes - 1 is set iff lane c holds a
//   NaN (int8 has none): the lane's magnitude bits plus the distance from
//   the largest non-NaN magnitude to the top bit.
// * kPadHi / kPadLo: a word whose lanes sort above / below every value
//   of a row: +-inf for the floats; for the codes the largest code of
//   each sign, which the template multiplies by an inf scale.
#pragma once

#include <cuda_fp16.h>

#include "common.cuh"

template <typename T>
struct Codes;

template <>
struct Codes<int8_t> {
  using Bits = uint8_t;
  static constexpr int kLanes = 4;
  static constexpr bool kScaled = true, kHasNaN = false;
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
  using Bits = uint8_t;
  static constexpr int kLanes = 4;
  static constexpr bool kScaled = true, kHasNaN = true;
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

template <>
struct Codes<__nv_bfloat16> {
  using Bits = uint16_t;
  static constexpr int kLanes = 2;
  static constexpr bool kScaled = false, kHasNaN = true;
  static constexpr unsigned kPadHi = 0x7f807f80u;  // +inf
  static constexpr unsigned kPadLo = 0xff80ff80u;  // -inf
  static __device__ __forceinline__ unsigned prep(unsigned w) { return w; }
  static __device__ __forceinline__ float value(unsigned w, int c) {
    return __uint_as_float(c ? w & 0xffff0000u : w << 16);
  }
  static __device__ __forceinline__ unsigned nan_lanes(unsigned w) {
    return (w & 0x7fff7fffu) + 0x007f007fu;
  }
};

template <>
struct Codes<float> {
  using Bits = uint32_t;
  static constexpr int kLanes = 1;
  static constexpr bool kScaled = false, kHasNaN = true;
  static constexpr unsigned kPadHi = 0x7f800000u;  // +inf
  static constexpr unsigned kPadLo = 0xff800000u;  // -inf
  static __device__ __forceinline__ unsigned prep(unsigned w) { return w; }
  static __device__ __forceinline__ float value(unsigned w, int) {
    return __uint_as_float(w);
  }
  static __device__ __forceinline__ unsigned nan_lanes(unsigned w) {
    return (w & 0x7fffffffu) + 0x007fffffu;
  }
};

// One load of RB bytes into W words (p aligned to RB bytes).
template <int RB, int W>
__device__ __forceinline__ void row_load_vec(const unsigned char* p,
                                             unsigned (&w)[W]) {
  if constexpr (RB == 16) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = r.x;
    w[1] = r.y;
    w[2] = r.z;
    w[3] = r.w;
  } else if constexpr (RB == 8) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = r.x;
    w[1] = r.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  }
}

// The element loads of the same words: columns j0 .. j0 + B - 1 of row p,
// a column past d read as 0.
template <typename T, int B, int W>
__device__ __forceinline__ void row_load_elems(const unsigned char* p,
                                               long long j0, long long d,
                                               unsigned (&w)[W]) {
  using Bits = typename Codes<T>::Bits;
  constexpr int L = Codes<T>::kLanes, LB = 32 / L;
#pragma unroll
  for (int q = 0; q < W; ++q) w[q] = 0u;
#pragma unroll
  for (int c = 0; c < B; ++c)
    if (j0 + c < d)
      w[c / L] |= (unsigned)__ldg(reinterpret_cast<const Bits*>(p) + j0 + c)
                  << (LB * (c % L));
}
