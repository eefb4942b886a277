// Flash prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel llms_on_kubernetes_tpu/ops/pallas_flash.py::
// flash_prefill_attention (body _flash_kernel). Semantics are those of the
// plain version, ops/attention.py::prefill_attention: causal GQA
// self-attention over a padded prompt bucket, query head h reading KV head
// h / group, keys masked at or beyond lengths[b] and outside an optional
// sliding window, optional tanh softcap applied before the mask, f32 softmax.
// A masked logit is replaced by the finite -2e38, so every row stays finite.
//
// Image groups (gemma-3's bidirectional image blocks, ops/attention.py's
// mm_groups): with mm_lo / mm_hi non-null, position t of row b also sees
// the keys [mm_lo[b, t], mm_hi[b, t]) -- its image's own run, past the
// causal and window tests (the length mask still applies; text positions
// hold an empty span). A block widens its key range to the spans of its
// rows, a warp keeps every tile that meets one of its rows' spans, and a
// tile that is not wholly visible tests the span key by key. With null
// spans the kernel computes exactly what it computes without them.
//
// What bounds it on the H100: at a 1024-token bucket of Llama-3-8B the work
// is ~6.6 GFLOP per layer against ~10 MB of q/k/v/out, so the card's bound
// is its bf16 tensor-core rate (989 TFLOP/s dense).
//
// Two bodies:
//
// - bf16, head_dim >= 16: tensor cores. A block owns a 64-row query tile of
//   one (batch row, query head), 4 warps of 16 rows, and walks 64-key K/V
//   tiles. Q and the K/V tiles are staged in shared memory as bf16 by
//   16-byte cp.async copies, rows padded by 16 bytes so that ldmatrix reads
//   them without bank conflicts; K/V are double-buffered, so tile j+1 is in
//   flight while tile j is computed. S = Q K^T and O += P V are
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate), K read by ldmatrix and V
//   by ldmatrix.trans; the online softmax (running max and sum per row) stays
//   in f32 registers. P is rounded to bf16 for the P V product -- the TPU
//   kernel keeps p in f32 (pallas_flash.py:79-82); the difference is a
//   relative 2^-9 per probability, inside the bf16 checks' 2e-2 of a row's
//   max. K tiles wholly above a warp's diagonal, past the row length or
//   before the sliding window are skipped, and query tiles whose rows all
//   lie at or past lengths[b] write zeros without a key loop (those rows are
//   padding: the decoder sends their K/V to the trash page and never reads
//   their output). The longest query tiles of every head are dispatched first.
//   Head dims 16 to 256 (96 is phi-3's: six 16-deep steps; 256 gemma-2's).
//   Up to 128 a warp keeps Q's mma fragments in registers; at 256 they
//   would take 64 registers beside the 128 output accumulators, so Q is
//   re-read from shared memory at each K tile. At 256 the tiles take 165 KB
//   of shared memory (one block an SM) and ptxas still spills 240 bytes
//   (PERF.md kernel table).
// - float32, and bf16 with head_dim 8: the f32 CUDA-core body of the first
//   port (16 query rows a block, 4 warps, 32-key tiles, lane j scores key j),
//   its tiles in dynamic shared memory (82 KB at head_dim 256).
//   The float32 checks (1e-4 against the plain version, the debug-tiny
//   reference on the card) need full f32 products, which TF32 tensor cores
//   would not give; head_dim 8 is below one 16-deep mma step.
#include "common.cuh"

using namespace llmk;

namespace {

// -- f32 CUDA-core body ------------------------------------------------------

constexpr int kBQ = 16;       // query rows per block
constexpr int kBK = 32;       // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kRows = kBQ / kWarps;  // query rows per warp

// shared bytes of the f32 body: Q [kBQ][D], K [kBK][D + 1], V [kBK][D] as
// f32 (82 KB at D 256: past the 48 KB a static array may take, so the
// body uses dynamic shared memory with the attribute set at launch)
template <int D>
constexpr size_t simt_smem() {
  return sizeof(float) * ((size_t)kBQ * D + (size_t)kBK * (D + 1) + (size_t)kBK * D);
}

// zeros in rows [q0, q0 + rows) of a (batch row, head) slice: query rows at or
// past the length, which are padding
template <typename T, int D>
__device__ __forceinline__ void zero_rows(T* out, size_t row_stride, int q0, int rows,
                                          int T_len) {
  for (int idx = threadIdx.x; idx < rows * D; idx += blockDim.x) {
    const int t = q0 + idx / D;
    if (t < T_len) out[(size_t)t * row_stride + idx % D] = from_float<T>(0.f);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_prefill_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const int* __restrict__ lengths, T* __restrict__ out, int T_len, int n_q,
                   int n_kv, float scale, int window, float cap, const int* __restrict__ mm_lo,
                   const int* __restrict__ mm_hi) {
  constexpr int DPL = (D + 31) / 32;  // output columns per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float (*sQ)[D] = reinterpret_cast<float (*)[D]>(smem);
  float (*sK)[D + 1] = reinterpret_cast<float (*)[D + 1]>(smem + sizeof(float) * kBQ * D);
  float (*sV)[D] = reinterpret_cast<float (*)[D]>(smem + sizeof(float) * (kBQ * D + kBK * (D + 1)));

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_q / n_kv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int length = lengths[b];
  if (q0 >= length) {
    zero_rows<T, D>(out + ((size_t)b * T_len * n_q + h) * D, (size_t)n_q * D, q0, kBQ, T_len);
    return;
  }

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

  // keys any row of this block may attend to: [k_begin, k_end), widened
  // to its rows' image spans
  const int q_last = min(q0 + kBQ, T_len) - 1;
  int k_end = min(q_last + 1, length);
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  int span_lo[kRows], span_hi[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) span_lo[r] = span_hi[r] = 0;
  if (mm_lo != nullptr) {
    for (int t = q0; t <= q_last; ++t) {
      const int lo = mm_lo[(size_t)b * T_len + t], hi = mm_hi[(size_t)b * T_len + t];
      if (lo < hi) {
        k_begin = min(k_begin, lo);
        k_end = max(k_end, min(hi, length));
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = q0 + warp * kRows + r;
      if (t < T_len) {
        span_lo[r] = mm_lo[(size_t)b * T_len + t];
        span_hi[r] = mm_hi[(size_t)b * T_len + t];
      }
    }
  }
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
      const bool valid = exists && key < length &&
                         ((key <= t && (window <= 0 || key > t - window)) ||
                          (key >= span_lo[r] && key < span_hi[r]));
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

// -- bf16 tensor-core body ---------------------------------------------------

constexpr int kTcRows = 64;   // query rows per block: 16 per warp
constexpr int kTcKeys = 64;   // keys per K/V tile
constexpr int kTcWarps = 4;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct TcLayout {
  static_assert(D % 16 == 0, "the tensor-core body takes head_dim a multiple of 16");
  static constexpr int kChunks = D / 8;        // 16-byte chunks per row
  static constexpr int kStride = D + 8;        // bf16 per shared row: +16 bytes, so
                                               // 8 rows' 16-byte chunks hit 8 bank groups
  static constexpr int kTile = 64 * kStride;   // bf16 per 64-row tile
  // Q, then two stages of K and V
  static constexpr size_t kSmem = sizeof(__nv_bfloat16) * 5 * kTile;
};

// 64 rows [r0, r0 + 64) of one head's rows (stride elements apart) into a
// padded shared tile by 16-byte cp.async; rows at or past `limit` are zeros
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t stride, int r0, int limit) {
  using L = TcLayout<D>;
  static_assert(64 * L::kChunks % (kTcWarps * 32) == 0, "whole copies per thread");
#pragma unroll
  for (int n = 0; n < 64 * L::kChunks / (kTcWarps * 32); ++n) {
    const int idx = threadIdx.x + n * kTcWarps * 32;
    const int r = idx / L::kChunks, c = idx % L::kChunks, t = r0 + r;
    const bool in = t < limit;
    cp_async<16>(dst + r * L::kStride + c * 8, src + (size_t)(in ? t : 0) * stride + c * 8, in);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcWarps * 32)
flash_prefill_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
                 __nv_bfloat16* __restrict__ out, int T_len, int n_q, int n_kv, float scale,
                 int window, float cap, const int* __restrict__ mm_lo,
                 const int* __restrict__ mm_hi) {
  using L = TcLayout<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + L::kTile;      // [2][64][kStride]
  __nv_bfloat16* sV = sK + 2 * L::kTile;  // [2][64][kStride]

  // grid (head, query tile, batch row), tiles in reverse: every head's
  // longest tiles are dispatched before any shorter one
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;
  const int b = blockIdx.z;
  const int kvh = h / (n_q / n_kv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int length = lengths[b];
  const size_t q_stride = (size_t)n_q * D, kv_stride = (size_t)n_kv * D;
  const __nv_bfloat16* qh = q + (size_t)b * T_len * q_stride + (size_t)h * D;
  const __nv_bfloat16* kh = k + (size_t)b * T_len * kv_stride + (size_t)kvh * D;
  const __nv_bfloat16* vh = v + (size_t)b * T_len * kv_stride + (size_t)kvh * D;
  __nv_bfloat16* oh = out + (size_t)b * T_len * q_stride + (size_t)h * D;
  if (q0 >= length) {
    zero_rows<__nv_bfloat16, D>(oh, q_stride, q0, kTcRows, T_len);
    return;
  }

  // this warp's rows: row0 + g and row0 + g + 8 (fragment row g = lane / 4)
  const int row0 = q0 + warp * 16;
  const int g = lane >> 2, tq = lane & 3;

  // keys any row of this block may attend to: [k_begin, k_end), widened
  // to its rows' image spans; [w_lo, w_hi) the union of this warp's spans
  // and span_lo / span_hi those of this thread's rows g and g + 8
  int k_end = min(min(q0 + kTcRows, T_len), length);
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  int w_lo = T_len, w_hi = 0;
  int span_lo[2] = {0, 0}, span_hi[2] = {0, 0};
  if (mm_lo != nullptr) {
    __shared__ int s_lo, s_hi;
    if (threadIdx.x == 0) s_lo = k_begin, s_hi = k_end;
    __syncthreads();
    if (threadIdx.x < kTcRows && q0 + threadIdx.x < T_len) {
      const size_t i = (size_t)b * T_len + q0 + threadIdx.x;
      if (mm_lo[i] < mm_hi[i]) {
        atomicMin(&s_lo, mm_lo[i]);
        atomicMax(&s_hi, min(mm_hi[i], length));
      }
    }
    if (lane < 16 && row0 + lane < T_len) {
      const size_t i = (size_t)b * T_len + row0 + lane;
      if (mm_lo[i] < mm_hi[i]) w_lo = mm_lo[i], w_hi = mm_hi[i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      w_lo = min(w_lo, __shfl_xor_sync(LLMK_FULL_MASK, w_lo, off));
      w_hi = max(w_hi, __shfl_xor_sync(LLMK_FULL_MASK, w_hi, off));
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = row0 + g + hr * 8;
      if (t < T_len) {
        span_lo[hr] = mm_lo[(size_t)b * T_len + t];
        span_hi[hr] = mm_hi[(size_t)b * T_len + t];
      }
    }
    __syncthreads();
    k_begin = s_lo, k_end = s_hi;
  }
  k_begin -= k_begin % kTcKeys;
  const int n_tiles = (k_end - k_begin + kTcKeys - 1) / kTcKeys;

  load_tile<D>(sQ, qh, q_stride, q0, T_len);
  load_tile<D>(sK, kh, kv_stride, k_begin, T_len);
  load_tile<D>(sV, vh, kv_stride, k_begin, T_len);
  cp_async_commit();

  // Q as mma A fragments, one per 16-deep step, kept in registers up to
  // head_dim 128; past it (256: 64 registers) they are re-read from sQ by
  // ldmatrix at each K tile, which leaves room for the 128 accumulators
  constexpr bool kQRegs = D <= 128;
  uint32_t qf[kQRegs ? D / 16 : 1][4];
  float o[D / 8][4];                // O accumulators: D / 8 column tiles of 8
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // running max (log2 units) of rows g, g + 8
  float l_r[2] = {0.f, 0.f};              // this thread's part of the running sums
  const float scale_l2 = scale * kLog2e;
  const float neg_l2 = LLMK_NEG_INF * kLog2e;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * kTcKeys;
    if (j + 1 < n_tiles) {  // tile j + 1 goes in flight before tile j is computed
      const int nb = (j + 1) & 1;
      load_tile<D>(sK + nb * L::kTile, kh, kv_stride, k0 + kTcKeys, T_len);
      load_tile<D>(sV + nb * L::kTile, vh, kv_stride, k0 + kTcKeys, T_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* q_row = sQ + (warp * 16 + (lane & 15)) * L::kStride + (lane >> 4) * 8;
    if constexpr (kQRegs) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qf[kk], q_row + kk * 16);
      }
    }
    const __nv_bfloat16* tK = sK + (j & 1) * L::kTile;
    const __nv_bfloat16* tV = sV + (j & 1) * L::kTile;
    // a tile wholly above this warp's diagonal, or before its window, adds
    // nothing unless it meets one of the warp's image spans
    const bool seen = (k0 <= row0 + 15 && (window <= 0 || k0 + kTcKeys - 1 > row0 - window)) ||
                      (k0 < w_hi && k0 + kTcKeys > w_lo);
    if (seen) {
      float s[kTcKeys / 8][4];
#pragma unroll
      for (int n = 0; n < kTcKeys / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[4];
        if constexpr (kQRegs) {
          qa[0] = qf[kk][0], qa[1] = qf[kk][1], qa[2] = qf[kk][2], qa[3] = qf[kk][3];
        } else {
          ldmatrix_x4(qa, q_row + kk * 16);
        }
#pragma unroll
        for (int np = 0; np < kTcKeys / 16; ++np) {
          uint32_t kb[4];
          ldmatrix_x4(kb, tK + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * L::kStride +
                              kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qa, kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        }
      }
      // scale, softcap, then the masks; only tiles that cut a mask test each key
      const bool whole = k0 + kTcKeys - 1 <= row0 && k0 + kTcKeys <= length &&
                         k0 + kTcKeys <= T_len && (window <= 0 || k0 > row0 + 15 - window);
#pragma unroll
      for (int n = 0; n < kTcKeys / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = cap > 0.f ? apply_softcap(s[n][e] * scale, cap) * kLog2e
                              : s[n][e] * scale_l2;
          if (!whole) {
            const int key = k0 + n * 8 + tq * 2 + (e & 1);
            const int hr = e >> 1;
            const int t = row0 + g + hr * 8;
            if (key >= T_len)
              x = -INFINITY;  // no such key: no weight at all
            else if (key >= length ||
                     ((key > t || (window > 0 && key <= t - window)) &&
                      !(key >= span_lo[hr] && key < span_hi[hr])))
              x = neg_l2;
          }
          s[n][e] = x;
        }
      }
      // online softmax, rows g (hr 0) and g + 8 (hr 1): the 4 threads of a row
      // group hold its 64 keys, 16 each
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < kTcKeys / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * hr], s[n][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(LLMK_FULL_MASK, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(LLMK_FULL_MASK, mx, 2));
        const float m_new = fmaxf(m_r[hr], mx);
        const float alpha = exp2f(m_r[hr] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < kTcKeys / 8; ++n) {
          s[n][2 * hr] = exp2f(s[n][2 * hr] - m_new);
          s[n][2 * hr + 1] = exp2f(s[n][2 * hr + 1] - m_new);
          sum += s[n][2 * hr] + s[n][2 * hr + 1];
        }
        l_r[hr] = l_r[hr] * alpha + sum;
        m_r[hr] = m_new;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          o[i][2 * hr] *= alpha;
          o[i][2 * hr + 1] *= alpha;
        }
      }
      // O += P V, 16 keys a step; P's accumulator layout is the A fragment's
#pragma unroll
      for (int kk = 0; kk < kTcKeys / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, tV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                         L::kStride + dp * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
          mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // normalise, stage this warp's 16 rows in its part of sQ (which no other
  // warp reads, and this one no longer), then store 16-byte vectors
  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_r[hr];
    l += __shfl_xor_sync(LLMK_FULL_MASK, l, 1);
    l += __shfl_xor_sync(LLMK_FULL_MASK, l, 2);
    inv[hr] = l > 0.f ? 1.f / l : 0.f;
  }
  __nv_bfloat16* sO = sQ + warp * 16 * L::kStride;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<uint32_t*>(sO + (g + 8 * hr) * L::kStride + i * 8 + tq * 2) =
          pack_bf16(o[i][2 * hr] * inv[hr], o[i][2 * hr + 1] * inv[hr]);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * L::kChunks; idx += 32) {
    const int r = idx / L::kChunks, c = idx % L::kChunks, t = row0 + r;
    if (t < T_len)
      *reinterpret_cast<uint4*>(oh + (size_t)t * q_stride + c * 8) =
          *reinterpret_cast<const uint4*>(sO + r * L::kStride + c * 8);
  }
}

template <typename T, int D>
int launch_simt(const void* q, const void* k, const void* v, const void* lengths, void* out,
                int B, int T_len, int n_q, int n_kv, float scale, int window, float cap,
                const int* mm_lo, const int* mm_hi, cudaStream_t stream) {
  constexpr size_t smem = simt_smem<D>();
  static bool smem_set = false;  // per instantiation; one card per process
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_simt<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const dim3 grid((T_len + kBQ - 1) / kBQ, n_q, B);
  flash_prefill_simt<T, D><<<grid, kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)lengths, (T*)out, T_len, n_q, n_kv,
      scale, window, cap, mm_lo, mm_hi);
  return (int)cudaGetLastError();
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* lengths, void* out,
              int B, int T_len, int n_q, int n_kv, float scale, int window, float cap,
              const int* mm_lo, const int* mm_hi, cudaStream_t stream) {
  constexpr size_t smem = TcLayout<D>::kSmem;
  static bool smem_set = false;  // per head dim; one card per process
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const dim3 grid(n_q, (T_len + kTcRows - 1) / kTcRows, B);
  flash_prefill_tc<D><<<grid, kTcWarps * 32, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const int*)lengths, (__nv_bfloat16*)out, T_len, n_q, n_kv, scale, window, cap, mm_lo,
      mm_hi);
  return (int)cudaGetLastError();
}

// bf16: tensor cores from head_dim 16, the CUDA-core body below it
template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* lengths, void* out,
                int B, int T_len, int n_q, int n_kv, float scale, int window, float cap,
                const int* mm_lo, const int* mm_hi, cudaStream_t stream) {
  if constexpr (D >= 16)
    return launch_tc<D>(q, k, v, lengths, out, B, T_len, n_q, n_kv, scale, window, cap, mm_lo,
                        mm_hi, stream);
  else
    return launch_simt<__nv_bfloat16, D>(q, k, v, lengths, out, B, T_len, n_q, n_kv, scale,
                                         window, cap, mm_lo, mm_hi, stream);
}

}  // namespace

// q [B, T, n_q, d], k/v [B, T, n_kv, d], lengths [B] int32, out [B, T, n_q, d];
// all contiguous and 16-byte aligned. window <= 0 means none, cap <= 0 means
// no softcap. mm_lo / mm_hi [B, T] int32: each position's image span, or
// both null for none. Returns cudaGetLastError() after the launch.
extern "C" int llmk_flash_prefill(const void* q, const void* k, const void* v,
                                  const void* lengths, void* out, int B, int T_len,
                                  int n_q, int n_kv, int d, float scale, int window,
                                  float cap, const void* mm_lo, const void* mm_hi, int dtype,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* lo = (const int*)mm_lo;
  const int* hi = (const int*)mm_hi;
  if ((lo == nullptr) != (hi == nullptr)) return (int)cudaErrorInvalidValue;
  if (dtype == LLMK_F32) {
    LLMK_DISPATCH_D(d, return (launch_simt<float, D>(q, k, v, lengths, out, B, T_len, n_q,
                                                     n_kv, scale, window, cap, lo, hi, s)));
  }
  if (dtype == LLMK_BF16) {
    LLMK_DISPATCH_D(d, return (launch_bf16<D>(q, k, v, lengths, out, B, T_len, n_q, n_kv,
                                              scale, window, cap, lo, hi, s)));
  }
  return (int)cudaErrorInvalidValue;
}
