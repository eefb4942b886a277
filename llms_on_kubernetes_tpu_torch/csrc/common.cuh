// Shared helpers of the port's hand-written Hopper kernels (sm_90a).
//
// Each kernel reads bf16 or f32 and accumulates in f32: on the CUDA cores for
// f32 inputs, on the tensor cores (mma.sync, bf16 products, f32 sums) for
// the bf16 attention bodies. Masks substitute the FINITE -2e38
// (ops/attention.py NEG_INF), never -inf, so a row whose keys are all
// masked stays finite, as in the plain versions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#define LLMK_NEG_INF (-2.0e38f)
#define LLMK_FULL_MASK 0xffffffffu

// dtype codes shared with kernels/__init__.py
#define LLMK_F32 0
#define LLMK_BF16 1
#define LLMK_I8 2  // pool storage only (paged_write_window.cu)

namespace llmk {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

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

// -- asynchronous copies (sm_80+): global -> shared without registers ------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Copy BYTES (16, 8 or 4) from global src to shared dst, both aligned to
// BYTES; when !in, nothing is read and dst is filled with zeros.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in) {
  static_assert(BYTES == 16 || BYTES == 8 || BYTES == 4, "cp.async copies 16, 8 or 4 bytes");
  const int n = in ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- tensor cores (sm_80+ mma.sync, bf16 in, f32 accumulate) -----------------

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b: a 16x16 (row-major fragment), b 16x8 (column-major), bf16 -> f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as bf16x2, round to nearest even; lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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
