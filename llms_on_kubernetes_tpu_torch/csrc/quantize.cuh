// Per-token symmetric int8 quantization of one KV row, shared by the
// kernels that store into an int8 pool: quantize_row (a warp a row) for
// the fused decode append (paged_decode.cuh, kernel 5), quantize_vec (16
// bytes a lane) for the windowed append (paged_write_window.cu, kernel 7).
// Both run the same chain element for element, so both kernels store the
// same bytes.
//
// The chain is engine/cache.quantize_kv's (and the JAX quantize_kv's, run
// eagerly): amax = max |x| over the row in f32 (shuffles, exact),
// s = max(amax, 1e-8) / 127 and rint(x / s) as IEEE divisions (the kernels
// build without fast math; round half to even, as torch.round), clamped to
// +-127.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace llmk {

// Quantize the D-element row `src` (T = float or bf16, widened to f32).
// Every lane of the warp calls it; lane `lane` gets element lane + 32 * c
// in q[c] (0 past D), and every lane gets the row's scale as the result.
template <typename T, int D>
__device__ __forceinline__ float quantize_row(const T* __restrict__ src, int lane,
                                              int8_t (&q)[(D + 31) / 32]) {
  constexpr int kPerLane = (D + 31) / 32;
  float x[kPerLane];
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) {
    const int i = lane + 32 * c;
    x[c] = i < D ? to_float(src[i]) : 0.f;
    amax = fmaxf(amax, fabsf(x[c]));
  }
  const float s = fmaxf(warp_max(amax), 1e-8f) / 127.0f;
#pragma unroll
  for (int c = 0; c < kPerLane; ++c)
    q[c] = (int8_t)fminf(fmaxf(rintf(x[c] / s), -127.f), 127.f);
  return s;
}

// The same chain for a row spread over an aligned group of L lanes (L a
// power of two), each holding V consecutive elements (one 16-byte vector
// of the source row) in x. Every lane of the warp calls it; q gets this
// lane's V values and every lane of the group the row's scale.
template <int L, int V>
__device__ __forceinline__ float quantize_vec(const float (&x)[V], int8_t (&q)[V]) {
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < V; ++c) amax = fmaxf(amax, fabsf(x[c]));
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(LLMK_FULL_MASK, amax, o));
  const float s = fmaxf(amax, 1e-8f) / 127.0f;
#pragma unroll
  for (int c = 0; c < V; ++c) q[c] = (int8_t)fminf(fmaxf(rintf(x[c] / s), -127.f), 127.f);
  return s;
}

}  // namespace llmk
