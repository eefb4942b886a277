// Flash prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel llms_on_kubernetes_tpu/ops/pallas_flash.py::
// flash_prefill_attention (body _flash_kernel). Semantics are those of the
// plain version, ops/attention.py::prefill_attention: causal GQA
// self-attention over a padded prompt bucket, query head h reading KV head
// h / group, keys masked at or beyond lengths[b] and outside an optional
// sliding window, optional tanh softcap applied before the mask, f32 softmax.
//
// What bounds it on the H100: at a 1024-token bucket of Llama-3-8B the work
// is ~8.6 GFLOP per layer against ~21 MB of q/k/v/out, so the card's bound
// is its tensor-core rate. This first version does its products on the f32
// CUDA cores (no mma.sync/wgmma yet) and is limited by instruction issue;
// the tensor-core pipeline is later work.
//
// Design: the TPU kernel streamed a head's WHOLE K/V through VMEM per query
// block, one program at a time. Here blocks run in parallel: grid =
// (query block of 16 rows, query head, batch row), 4 warps of 4 query rows
// each. The block walks 32-key tiles of K/V staged in shared memory (f32,
// K rows padded to D+1 floats so lane j reading key j is conflict-free);
// lane j scores key j against a query row, the warp keeps an online softmax
// (running max, denominator, and d/32 output columns per lane) and merges
// each tile with 32 shuffles. Tiles wholly above the causal diagonal, past
// the row length, or before the sliding window are skipped. A masked logit
// is replaced by the finite -2e38, so rows with no valid key stay finite
// (those rows are padding and their values are don't-care).
#include "common.cuh"

using namespace llmk;

namespace {

constexpr int kBQ = 16;       // query rows per block
constexpr int kBK = 32;       // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kRows = kBQ / kWarps;  // query rows per warp

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ lengths,
                     T* __restrict__ out, int T_len, int n_q, int n_kv,
                     float scale, int window, float cap) {
  constexpr int DPL = (D + 31) / 32;  // output columns per lane
  __shared__ float sQ[kBQ][D];
  __shared__ float sK[kBK][D + 1];
  __shared__ float sV[kBK][D];

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_q / n_kv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int length = lengths[b];

  for (int idx = tid; idx < kBQ * D; idx += blockDim.x) {
    const int r = idx / D, i = idx % D, t = q0 + r;
    sQ[r][i] = t < T_len ? to_float(q[((size_t)(b * T_len + t) * n_q + h) * D + i]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  // keys any row of this block may attend to: [k_begin, k_end)
  const int q_last = min(q0 + kBQ, T_len) - 1;
  const int k_end = min(q_last + 1, length);
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / kBK) * kBK;
  __syncthreads();

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    for (int idx = tid; idx < kBK * D; idx += blockDim.x) {
      const int j = idx / D, i = idx % D, key = k0 + j;
      const bool in = key < T_len;
      const size_t off = ((size_t)(b * T_len + (in ? key : 0)) * n_kv + kvh) * D + i;
      sK[j][i] = in ? to_float(k[off]) : 0.f;
      sV[j][i] = in ? to_float(v[off]) : 0.f;
    }
    __syncthreads();

    const int key = k0 + lane;
    const bool exists = key < T_len;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = warp * kRows + r;
      const int t = q0 + row;
      float s = 0.f;
#pragma unroll 16
      for (int i = 0; i < D; ++i) s = fmaf(sQ[row][i], sK[lane][i], s);
      s = apply_softcap(s * scale, cap);
      const bool valid = exists && key <= t && key < length &&
                         (window <= 0 || key > t - window);
      if (!valid) s = LLMK_NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(exists ? s : -INFINITY));
      const float alpha = expf(m[r] - m_new);
      const float p = exists ? expf(s - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p);
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
#pragma unroll 8
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(LLMK_FULL_MASK, p, j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int i = lane + 32 * c;
          if (i < D) acc[r][c] = fmaf(pj, sV[j][i], acc[r][c]);
        }
      }
      m[r] = m_new;
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = q0 + warp * kRows + r;
    if (t >= T_len) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int i = lane + 32 * c;
      if (i < D) out[((size_t)(b * T_len + t) * n_q + h) * D + i] = from_float<T>(acc[r][c] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int B, int T_len, int n_q, int n_kv, int d, float scale,
           int window, float cap, cudaStream_t stream) {
  const dim3 grid((T_len + kBQ - 1) / kBQ, n_q, B);
  LLMK_DISPATCH_D(d, flash_prefill_kernel<T, D><<<grid, kWarps * 32, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)lengths, (T*)out,
      T_len, n_q, n_kv, scale, window, cap));
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, T, n_q, d], k/v [B, T, n_kv, d], lengths [B] int32, out [B, T, n_q, d];
// all contiguous. window <= 0 means none, cap <= 0 means no softcap.
// Returns cudaGetLastError() after the launch.
extern "C" int llmk_flash_prefill(const void* q, const void* k, const void* v,
                                  const void* lengths, void* out, int B, int T_len,
                                  int n_q, int n_kv, int d, float scale, int window,
                                  float cap, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == LLMK_F32)
    return launch<float>(q, k, v, lengths, out, B, T_len, n_q, n_kv, d, scale, window, cap, s);
  if (dtype == LLMK_BF16)
    return launch<__nv_bfloat16>(q, k, v, lengths, out, B, T_len, n_q, n_kv, d, scale, window, cap, s);
  return (int)cudaErrorInvalidValue;
}
