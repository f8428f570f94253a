// Shared helpers of the aggregation kernels (sm_90a, plain C interface).
//
// Every entry point is `extern "C"`, takes raw device pointers, 64-bit
// sizes and strides and a cudaStream_t (passed as void*), launches on that
// stream without synchronising, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RT_EXPORT extern "C" __attribute__((visibility("default")))

// dtype codes shared with repro_torch/kernels/build.py: the float arenas,
// and the int8 / fp8 (e4m3) codes of a quantized arena
enum { RT_F32 = 0, RT_BF16 = 1, RT_I8 = 2, RT_F8 = 3 };

// Exact upcasts to fp32 (every bf16, int8 and e4m3 value is an fp32 value;
// an e4m3 NaN code, 0x7F / 0xFF, stays NaN).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}

// min / max that PROPAGATE NaN, like jnp.minimum / jnp.maximum (fminf and
// fmaxf drop a NaN operand).  a + b is NaN iff either operand is.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// Batcher's odd-even merge sort of v[LO .. HI] (both included) with fminf
// / fmaxf: 5, 19, 63, 191 and 543 compare-exchanges for 4, 8, 16, 32 and
// 64 values, all at compile-time positions.  Exact on NaN-free data only.
__device__ __forceinline__ void batcher_cx(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmaxf(a, b);
  a = lo;
}

template <int CAP, int LO, int HI, int R>
__device__ __forceinline__ void batcher_merge(float (&v)[CAP]) {
  constexpr int STEP = 2 * R;
  if constexpr (STEP < HI - LO) {
    batcher_merge<CAP, LO, HI, STEP>(v);
    batcher_merge<CAP, LO + R, HI, STEP>(v);
#pragma unroll
    for (int i = LO + R; i < HI - R; i += STEP) batcher_cx(v[i], v[i + R]);
  } else {
    batcher_cx(v[LO], v[LO + R]);
  }
}

template <int CAP, int LO, int HI>
__device__ __forceinline__ void batcher_sort(float (&v)[CAP]) {
  if constexpr (HI - LO >= 1) {
    constexpr int MID = LO + (HI - LO) / 2;
    batcher_sort<CAP, LO, MID>(v);
    batcher_sort<CAP, MID + 1, HI>(v);
    batcher_merge<CAP, LO, HI, 1>(v);
  }
}

static inline int rt_status() { return (int)cudaGetLastError(); }

// Blocks of a grid-stride launch over d items: enough to fill every SM a
// few times over, never more than the items need.
static inline unsigned grid_blocks(long long d, int threads) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const long long need = (d + threads - 1) / threads;
  const long long cap = (long long)sms * 16;
  return (unsigned)(need < cap ? need : cap);
}
