// Shared helpers of the port's hand-written Hopper kernels (sm_90a).
//
// Each kernel reads bf16 or f32 and does all of its arithmetic in f32. Masks
// substitute the FINITE -2e38 (ops/attention.py NEG_INF), never -inf, so a
// row whose keys are all masked stays finite, as in the plain versions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define LLMK_NEG_INF (-2.0e38f)
#define LLMK_FULL_MASK 0xffffffffu

// dtype codes shared with kernels/__init__.py
#define LLMK_F32 0
#define LLMK_BF16 1
#define LLMK_I8 2  // pool storage only (paged_write_window.cu)

namespace llmk {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
// round to nearest even, as torch's .to(torch.bfloat16)
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Gemma-2-style tanh soft-capping; cap <= 0 means none.
__device__ __forceinline__ float apply_softcap(float x, float cap) {
  return cap > 0.f ? cap * tanhf(x / cap) : x;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(LLMK_FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(LLMK_FULL_MASK, v, o);
  return v;
}

}  // namespace llmk

// Expand the statement once per supported head_dim, with D bound as a
// constant (the head dims kernels/__init__.py accepts: 8, 16, 32, 64, 128).
#define LLMK_DISPATCH_D(d, ...)                                 \
  switch (d) {                                                  \
    case 8: { constexpr int D = 8; __VA_ARGS__; break; }        \
    case 16: { constexpr int D = 16; __VA_ARGS__; break; }      \
    case 32: { constexpr int D = 32; __VA_ARGS__; break; }      \
    case 64: { constexpr int D = 64; __VA_ARGS__; break; }      \
    case 128: { constexpr int D = 128; __VA_ARGS__; break; }    \
    default: return (int)cudaErrorInvalidValue;                 \
  }
