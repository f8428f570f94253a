// K15 sign_vote: the majority vote of signSGD, sign(sum_i sign(x_i)) per
// coordinate; (n, d) stack -> (d,) fp32 in {-1, 0, +1} (NaN where a
// voting value is NaN).  K16 masked_sign_vote: the vote of the ARRIVED
// rows only (the async path's masked sign_sgd); absent rows cast no vote.
// K20 scaled_masked_sign_vote: K16 over a QUANTIZED stack, int8 / fp8
// e4m3 codes dequantized with their row's fp32 scale.
//
// Replaces repro/kernels/masked.py:sign_vote, masked_sign_vote and
// scaled_masked_sign_vote (the Pallas TPU kernels: per (n, TILE_D) VMEM
// tile, jnp.sign of the fp32 upcast, summed over the agent axis, then
// jnp.sign; the masked ones multiply each row's signs by its mask first;
// the scaled one votes on codes.astype(f32) * scale[:, None]).  The
// synchronous compressed sign_sgd runs K15 on the codes themselves
// (repro/kernels/dispatch.py:_scaled_sign_sgd: a scale > 0 never changes
// a sign), so K15 also takes int8 and fp8 codes.
//
// Bound on this card: bytes.  It reads the voting rows once (4, 2 or 1
// bytes each; K16 and K20 never read an absent row) and writes (d,) fp32.
//
// The law.  The fp32 sum of +-1 / 0 is exact for n < 2^24, so any order
// agrees and a vote is a count.  NaN is carried apart: jnp.sign(NaN) is
// NaN and poisons the column's vote.  A vote of 0 is +0.  Where the
// reference multiplies an absent row's signs by 0 (so a NaN there still
// leaks, NaN * 0 = NaN), K16 and K20 do not read the row at all: the
// law's own "absent rows cast no vote" (ROADMAP.md P10).  K20 keeps the
// reference's dequantizing multiply (__fmul_rn, the product of
// core.flat.dequantize_rows) before the sign: an inf scale (an inf row)
// times a 0 code is NaN and poisons the column, as in the reference; K15
// on the raw codes casts a 0 vote there instead, as the JAX sync path
// does.  An e4m3 NaN code (0x7F / 0xFF) poisons its column in either;
// int8 has no NaN.
//
// K15 and K20 (sign_vote_kernel).  One coordinate a thread with a scalar
// load and a conversion a value issued some 15-20 instructions a value:
// 2.1-2.7x the bytes' bound on codes (PERF.md §6, NVIDIA H100 80GB HBM3,
// 700 W).  A sign never needs the value, so here:
// * The list.  Each block lists its voting rows in shared memory as byte
//   pointers (K15 all n, K20 those with mask > 0.5).  K20 also classifies
//   each listed scale: a block whose scales are all finite with |s| >=
//   2^-140 takes the fast path, where a negative scale flips the row's
//   signs (sign(code * s) = sign(code) * sign(s): the smallest nonzero
//   code, 2^-9 in e4m3, times 2^-140 is still nonzero, and an overflow
//   to +-inf keeps its sign); any other block (a scale that is NaN,
//   +-inf, +-0 or tiny) takes the exact path: per value the code's exact
//   value (codes.cuh), the __fmul_rn by the scale, the NaN test and the
//   sign, on the same loads, one row at a time.
// * Loads.  A thread takes the coordinates of one 16-byte load of each
//   listed row (16 codes, 8 bf16, 4 fp32), four rows loaded before their
//   votes (then two, then one), and writes its results in 16-byte
//   stores; three blocks of 256 an SM, at most 80 registers a thread (at
//   64 the code instances spilled and ran 2-3 % slower at n = 8; 8-byte
//   loads, eight rows in flight, two blocks an SM or a grid of only the
//   resident blocks were no faster: PERF.md §6).  A row or output not
//   aligned for the loads (a view offset by one element) and the last
//   partial chunk take element loads of the same words.
// * Fast path: signs from bits, all lanes of a word at once (SWAR), no
//   conversion.  For each lane of a word: "magnitude != 0" is the carry
//   of (w & MAG) + MAG into the lane's top bit (int8, two's complement:
//   also a set sign bit); a positive vote is nonzero with a clear sign
//   bit (after the flip), a negative one nonzero with a set one, so -0
//   votes 0; both move to the lane's bit 0 and one add counts them
//   (+1 / -1) into a lane field biased by its top bit (128 for 8-bit
//   lanes: a count of n <= 64 votes never leaves the field).  NaN lanes
//   are Codes<T>::nan_lanes, or-ed.  At the chunk's end each lane's
//   vote is the sign of its field less the bias, or NaN.
// K16 (masked_sign_vote_kernel) keeps its first layout: a grid-stride
// loop over coordinates, one coordinate per thread and one scalar load a
// listed row, upcast in registers, the signs added into an int.
#include <float.h>

#include <type_traits>

#include "codes.cuh"

namespace {
constexpr int kMaxN = 64;
}

// K15 / K20's shape: the bytes of a listed row a thread loads at once,
// their words, the rows loaded before their votes, and the blocks of 256
// an SM holds (at most 80 registers a thread).
constexpr int kVoteRB = 16;
constexpr int kVoteW = kVoteRB / 4;
constexpr int kVoteRows = 4;
constexpr int kVoteMinBlocks = 3;

// The fast path's scales: finite, |s| >= 2^-140 (a nonzero code times it
// never rounds to 0).
constexpr float kVoteTinyScale = 0x1p-140f;

template <typename T>
struct VoteShape {
  static constexpr int L = Codes<T>::kLanes, LB = 32 / L;
  static constexpr int B = kVoteW * L;  // coordinates a chunk
  // each lane's top bit: its sign, and the bias of its count
  static constexpr unsigned kTop =
      L == 4 ? 0x80808080u : L == 2 ? 0x80008000u : 0x80000000u;
  static constexpr unsigned kMag = ~kTop;
  static constexpr bool kTwos = std::is_same<T, int8_t>::value;
};

// One word of one row into the chunk's counts (fast path): acc's lane
// fields +1 for a positive value, -1 for a negative one; nan's lane top
// bits set where a value is NaN.  flip: kTop for a row of negative scale.
template <typename T>
__device__ __forceinline__ void vote_word(unsigned w, unsigned flip,
                                          unsigned& acc, unsigned& nan) {
  using S = VoteShape<T>;
  const unsigned t = (w & S::kMag) + S::kMag;  // top bit: magnitude != 0
  const unsigned nz = (S::kTwos ? t | w : t) & S::kTop;
  const unsigned s = w ^ flip;
  acc += ((nz & ~s) >> (S::LB - 1)) - ((nz & s) >> (S::LB - 1));
  if constexpr (Codes<T>::kHasNaN) nan |= Codes<T>::nan_lanes(w);
}

// The same word by the law as written (exact path, codes): the code's
// exact value times the scale, then its sign or NaN.
template <typename T>
__device__ __forceinline__ void vote_word_exact(unsigned w, float sc,
                                                unsigned& acc,
                                                unsigned& nan) {
  using C = Codes<T>;
  using S = VoteShape<T>;
  const unsigned u = C::prep(w);
  unsigned p = 0u, m = 0u, q = 0u;
#pragma unroll
  for (int c = 0; c < S::L; ++c) {
    const float v = __fmul_rn(C::value(u, c), sc);
    p |= (unsigned)(v > 0.f) << (S::LB * c);
    m |= (unsigned)(v < 0.f) << (S::LB * c);
    q |= (unsigned)(v != v) << (S::LB * c + S::LB - 1);
  }
  acc += p - m;
  nan |= q;
}

// R listed rows from r of the chunk at j0: their R loads first, then
// their votes (SCALED: K20's, by the fast path with the rows' flips or,
// EXACT, by the law); VEC: 16-byte loads, else element loads.
template <typename T, bool SCALED, bool EXACT, bool VEC, int R>
__device__ __forceinline__ void vote_rows(const unsigned char* const* rows,
                                          const unsigned* flip,
                                          const float* sc, int r,
                                          long long j0, long long d,
                                          unsigned (&acc)[kVoteW],
                                          unsigned (&nan)[kVoteW]) {
  unsigned w[R][kVoteW];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if constexpr (VEC)
      row_load_vec<kVoteRB>(rows[r + i] + j0 * (long long)sizeof(T), w[i]);
    else
      row_load_elems<T, VoteShape<T>::B>(rows[r + i], j0, d, w[i]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if constexpr (EXACT) {
      const float s = sc[r + i];
#pragma unroll
      for (int q = 0; q < kVoteW; ++q)
        vote_word_exact<T>(w[i][q], s, acc[q], nan[q]);
    } else {
      const unsigned f = SCALED ? flip[r + i] : 0u;
#pragma unroll
      for (int q = 0; q < kVoteW; ++q)
        vote_word<T>(w[i][q], f, acc[q], nan[q]);
    }
  }
}

// The chunk of B coordinates from j0 over the k listed rows; VEC: the
// chunk lies below d and every listed row and the output are aligned
// for 16-byte loads and stores.
template <typename T, bool SCALED, bool EXACT, bool VEC>
__device__ __forceinline__ void vote_chunk(const unsigned char* const* rows,
                                           const unsigned* flip,
                                           const float* sc, int k,
                                           long long j0, long long d,
                                           float* out) {
  using S = VoteShape<T>;
  unsigned acc[kVoteW], nan[kVoteW];
#pragma unroll
  for (int q = 0; q < kVoteW; ++q) {
    acc[q] = S::kTop;
    nan[q] = 0u;
  }
  if constexpr (EXACT) {
    // the hazards' path: one row at a time keeps its code small
#pragma unroll 1
    for (int r = 0; r < k; ++r)
      vote_rows<T, SCALED, true, VEC, 1>(rows, flip, sc, r, j0, d, acc, nan);
  } else {
    int r = 0;
    for (; r + kVoteRows <= k; r += kVoteRows)
      vote_rows<T, SCALED, false, VEC, kVoteRows>(rows, flip, sc, r, j0, d,
                                                  acc, nan);
    if (r + 2 <= k) {
      vote_rows<T, SCALED, false, VEC, 2>(rows, flip, sc, r, j0, d, acc,
                                          nan);
      r += 2;
    }
    if (r < k)
      vote_rows<T, SCALED, false, VEC, 1>(rows, flip, sc, r, j0, d, acc,
                                          nan);
  }
  float res[S::B];
#pragma unroll
  for (int i = 0; i < S::B; ++i) {
    const int q = i / S::L, sh = S::LB * (i % S::L);
    int v;
    if constexpr (S::LB == 32)
      v = (int)(acc[q] ^ S::kTop);
    else
      v = (int)((acc[q] >> sh) & ((1u << S::LB) - 1u)) - (1 << (S::LB - 1));
    const bool is_nan = (nan[q] >> (sh + S::LB - 1)) & 1u;
    res[i] = is_nan ? __int_as_float(0x7fc00000) : (float)((v > 0) - (v < 0));
  }
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < S::B; i += 4)
      *reinterpret_cast<float4*>(out + j0 + i) =
          make_float4(res[i], res[i + 1], res[i + 2], res[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < S::B; ++i)
      if (j0 + i < d) out[j0 + i] = res[i];
  }
}

template <typename T, bool SCALED, bool EXACT>
__device__ __forceinline__ void vote_chunks(const unsigned char* const* rows,
                                            const unsigned* flip,
                                            const float* sc, int k,
                                            bool vec, long long d,
                                            float* out) {
  constexpr int B = VoteShape<T>::B;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long chunks = (d + B - 1) / B;
  const long long full = vec ? d / B : 0;
  long long ch = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; ch < full; ch += stride)
    vote_chunk<T, SCALED, EXACT, true>(rows, flip, sc, k, ch * B, d, out);
  for (; ch < chunks; ch += stride)
    vote_chunk<T, SCALED, EXACT, false>(rows, flip, sc, k, ch * B, d, out);
}

// SCALED: K20 (the rows with mask > 0.5, codes times their scale), else
// K15 (every row, no scale).
template <typename T, bool SCALED>
__global__ void __launch_bounds__(256, kVoteMinBlocks)
sign_vote_kernel(const unsigned char* __restrict__ x,
                 const float* __restrict__ scale,
                 const float* __restrict__ mask, float* __restrict__ out,
                 int n, long long d, long long ld) {
  __shared__ const unsigned char* rows_s[kMaxN];
  __shared__ unsigned flip_s[kMaxN];
  __shared__ float sc_s[kMaxN];
  __shared__ unsigned list_w[2];
  const int t = threadIdx.x;
  bool listed = false;
  if (t < kMaxN) {
    listed = t < n && (!SCALED || mask[t] > 0.5f);
    const unsigned bits = __ballot_sync(0xffffffffu, listed);
    if ((t & 31) == 0) list_w[t >> 5] = bits;
  }
  __syncthreads();
  const unsigned w0 = list_w[0], w1 = list_w[1];
  const int k = __popc(w0) + __popc(w1);
  int exact = 0, misaligned = 0;
  if (listed) {
    const int pos = t < 32 ? __popc(w0 & ((1u << t) - 1u))
                           : __popc(w0) + __popc(w1 & ((1u << (t - 32)) - 1u));
    const unsigned char* p = x + (long long)t * ld * (long long)sizeof(T);
    rows_s[pos] = p;
    if constexpr (SCALED) {
      const float s = scale[t];
      sc_s[pos] = s;
      flip_s[pos] = s < 0.f ? VoteShape<T>::kTop : 0u;
      exact = !(fabsf(s) >= kVoteTinyScale && fabsf(s) <= FLT_MAX);
    }
    misaligned = reinterpret_cast<uintptr_t>(p) % kVoteRB != 0;
  }
  if (t == 0) misaligned |= reinterpret_cast<uintptr_t>(out) % 16 != 0;
  // block-uniform: the law's path; vector loads and stores
  const bool any_exact = __syncthreads_or(exact);
  const bool vec = !__syncthreads_or(misaligned);
  if constexpr (SCALED) {
    if (any_exact) {
      vote_chunks<T, true, true>(rows_s, flip_s, sc_s, k, vec, d, out);
      return;
    }
  }
  vote_chunks<T, SCALED, false>(rows_s, flip_s, sc_s, k, vec, d, out);
}

template <typename T, bool SCALED>
int sign_vote_run(const void* x, const float* scale, const float* mask,
                  float* out, int n, long long d, long long ld,
                  cudaStream_t s) {
  const int threads = 256;
  constexpr int B = VoteShape<T>::B;
  const unsigned blocks = grid_blocks((d + B - 1) / B, threads);
  sign_vote_kernel<T, SCALED><<<blocks, threads, 0, s>>>(
      (const unsigned char*)x, scale, mask, out, n, d, ld);
  return rt_status();
}

template <typename T>
__global__ void __launch_bounds__(256)
masked_sign_vote_kernel(const T* __restrict__ x,
                        const float* __restrict__ mask,
                        float* __restrict__ out, int n, long long d,
                        long long ld) {
  __shared__ int rows[kMaxN];
  __shared__ int nrows;
  if (threadIdx.x == 0) {
    int m = 0;
    for (int i = 0; i < n; ++i)
      if (mask[i] > 0.5f) rows[m++] = i;
    nrows = m;
  }
  __syncthreads();
  const int m = nrows;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    int votes = 0;
    bool nan = false;
    for (int r = 0; r < m; ++r) {
      const float v = to_f32(x[(long long)rows[r] * ld + j]);
      nan |= v != v;
      votes += (v > 0.f) - (v < 0.f);
    }
    out[j] = nan ? __int_as_float(0x7fc00000)
                 : (float)((votes > 0) - (votes < 0));
  }
}

template <typename T>
int masked_sign_vote_run(const void* x, const float* mask, float* out, int n,
                         long long d, long long ld, cudaStream_t s) {
  const int threads = 256;
  const unsigned blocks = grid_blocks(d, threads);
  masked_sign_vote_kernel<T><<<blocks, threads, 0, s>>>((const T*)x, mask,
                                                       out, n, d, ld);
  return rt_status();
}

// K15 takes fp32, bf16 and (on the sync path's codes) int8 / e4m3 codes.
RT_EXPORT int rt_sign_vote(const void* x, int dtype, float* out, int n,
                           long long d, long long ld, void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  if (d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == RT_F32)
    return sign_vote_run<float, false>(x, nullptr, nullptr, out, n, d, ld, s);
  if (dtype == RT_BF16)
    return sign_vote_run<__nv_bfloat16, false>(x, nullptr, nullptr, out, n,
                                               d, ld, s);
  if (dtype == RT_I8)
    return sign_vote_run<int8_t, false>(x, nullptr, nullptr, out, n, d, ld,
                                        s);
  if (dtype == RT_F8)
    return sign_vote_run<__nv_fp8_e4m3, false>(x, nullptr, nullptr, out, n,
                                               d, ld, s);
  return (int)cudaErrorInvalidValue;
}

// K16: dtype RT_F32 or RT_BF16; mask: (n,) fp32, > 0.5 = arrived.
RT_EXPORT int rt_masked_sign_vote(const void* x, int dtype, const float* mask,
                                  float* out, int n, long long d,
                                  long long ld, void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  if (d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == RT_F32)
    return masked_sign_vote_run<float>(x, mask, out, n, d, ld, s);
  if (dtype == RT_BF16)
    return masked_sign_vote_run<__nv_bfloat16>(x, mask, out, n, d, ld, s);
  return (int)cudaErrorInvalidValue;
}

// K20: dtype RT_I8 or RT_F8; scale: (n,) fp32; mask: (n,) fp32, > 0.5 =
// arrived.
RT_EXPORT int rt_scaled_masked_sign_vote(const void* x, int dtype,
                                         const float* scale,
                                         const float* mask, float* out,
                                         int n, long long d, long long ld,
                                         void* stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  if (d <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == RT_I8)
    return sign_vote_run<int8_t, true>(x, scale, mask, out, n, d, ld, s);
  if (dtype == RT_F8)
    return sign_vote_run<__nv_fp8_e4m3, true>(x, scale, mask, out, n, d, ld,
                                              s);
  return (int)cudaErrorInvalidValue;
}
