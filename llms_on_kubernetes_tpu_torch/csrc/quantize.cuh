// Per-token symmetric int8 quantization of one KV row by one warp, shared by
// the kernels that store into an int8 pool: the fused decode append
// (paged_decode.cuh, kernel 5) and the windowed append
// (paged_write_window.cu, kernel 7). Both therefore store the same bytes
// from one source.
//
// The chain is engine/cache.quantize_kv's (and the JAX quantize_kv's, run
// eagerly): amax = max |x| over the row in f32 (a warp shuffle, exact),
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

}  // namespace llmk
