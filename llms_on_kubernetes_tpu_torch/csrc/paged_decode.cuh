// Paged decode attention for Hopper (sm_90a), over a float pool or an int8
// pool, with and without the fused append of the current token's K/V.
// Instantiated by paged_decode.cu (float pools: the pool holds q's dtype)
// and paged_decode_int8.cu (int8 pools with a per-token f32 scale).
//
// Semantics are those of the plain versions in ops/paged_attention.py:
// single-token GQA attention of q [B, n_q, d] over keys [0, lengths[b])
// of slot b, read through page_table [B, pps] from the head-major pool
// [n_kv, P, page, d], an optional sliding window (keys >= length - window)
// and an optional tanh softcap. An int8 pool holds per-token scales
// [n_kv, P, page]: a key's K scale multiplies its logit and its V scale its
// probability before p.v (q.(k*s) == (q.k)*s), so rows are never
// dequantized. WRITE=true also appends k_new/v_new [B, n_kv, d] in place at
// position length - 1, and only when length > 0: the bytes write_tokens
// would store, in the same row -- for an int8 pool the row quantized as
// engine/cache.quantize_kv quantizes it, and its scale.
//
// What bounds it on the H100: decode reads each cached K/V byte once and
// does ~2 * group FLOPs per byte pair, far below the ~295 FLOP/byte ridge,
// so the bound is device memory (3.35 TB/s); an int8 pool moves d + 4
// bytes a row and side instead of 2 * d. Reaching the bound takes many
// bytes in flight: enough blocks, and wide independent loads.
//
// Design: the TPU kernels folded every KV head into one program per slot
// because their grid runs in order on one core. Here the grid is
// (KV head, slot, key split): a slot's keys are cut into splits of
// kSplitKeys positions, one block each, so a batch of 8 slots x 8 heads at
// 2048 positions is 512 blocks, not 64. Inside a block, 4 warps take
// 32-key tiles round robin. For a tile, each lane looks up its own key's
// page in the page table (one load per lane, all in parallel; only pages
// covering [0, length) are read, so no stale row or scale is touched and
// the TPU kernels' stale-V zeroing has no counterpart) and its key's two
// scales, then the warp copies the 32 K and V rows into shared memory with
// coalesced 16-byte loads (8-byte for an int8 row of 8). Lane j scores key
// j against every query row of the group (K rows padded to an odd number
// of words: conflict-free), the warp keeps an online softmax per row in
// f32, the block merges its warps, and each block writes an unnormalised
// partial (max, sum, accumulator). A second, small kernel merges the
// splits and writes the output; an idle slot (length 0) has no keys and
// gets zeros.
//
// The fused kernels attend to the current token without reading it back
// from the pool: its row comes from k_new/v_new (float) or from the block's
// own quantized copy in shared memory (int8) and takes the tile position
// the key has in the unfused kernel, so both kernels sum in the same order
// and kv_write "fused" and "dus" give bit-identical outputs. The TPU
// kernels' 8-row (and, for int8, full-page scale) read-modify-writes are
// Mosaic tiling artefacts; here the append is one direct row store per
// side (plus one scale store), made by one block: key split 0 (float), or
// the split that holds position length - 1 (int8), which quantizes the row
// once -- amax by warp shuffles (exact), s = max(amax, 1e-8) / 127 and
// rint(x / s) with IEEE division (no fast math), clamped to +-127 -- and
// uses those bytes both for the store and for its own tile.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace llmk {

constexpr int kWarps = 4;
constexpr int kTile = 32;        // keys per warp tile: one per lane
constexpr int kMaxGroup = 8;     // query heads per KV head the kernel serves
constexpr int kSplitKeys = 256;  // key positions per block (kernels/__init__.py)

// KV is the pool's storage type: float, __nv_bfloat16 or int8_t
template <typename KV, int D>
struct Layout {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kRowBytes = D * (int)sizeof(KV);
  static_assert(kRowBytes % 8 == 0, "a pool row must be a whole number of 8-byte vectors");
  // widest load a row divides into
  using Vec = typename std::conditional<kRowBytes % 16 == 0, uint4, uint2>::type;
  static constexpr int kVecWords = (int)sizeof(Vec) / 4;
  static constexpr int kWords = kRowBytes / 4;  // 32-bit words per row
  static constexpr int kVecs = kRowBytes / (int)sizeof(Vec);  // vectors per row
  // padded K row: an odd number of words, so lane j reading row j hits a
  // bank of its own
  static constexpr int kKStride = kWords + 1;
  // int8 WRITE: the quantized current K and V rows and their two scales
  static constexpr size_t kNewBytes = kQuant ? 2 * kRowBytes + 16 : 0;
  static constexpr size_t kSmem = kNewBytes + sizeof(float) * kMaxGroup * D +
                                  sizeof(uint32_t) * kWarps * kTile * (kKStride + kWords) +
                                  sizeof(float) * 2 * kWarps * kMaxGroup;
  // the warps' accumulators reuse the K/V tiles after the key loop
  static_assert(kMaxGroup * D <= kTile * (kKStride + kWords), "sAcc must fit the tiles");
};

// element i of a row held as 32-bit words
template <typename KV>
__device__ __forceinline__ float elem(const uint32_t* row, int i);
template <>
__device__ __forceinline__ float elem<float>(const uint32_t* row, int i) {
  return __uint_as_float(row[i]);
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint32_t* row, int i) {
  const uint32_t w = row[i >> 1];
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}
template <>
__device__ __forceinline__ float elem<int8_t>(const uint32_t* row, int i) {
  // byte i & 3 of the word, sign-extended by the arithmetic shift
  return (float)((int)(row[i >> 2] << (24 - 8 * (i & 3))) >> 24);
}

__device__ __forceinline__ void put_words(uint32_t* dst, uint4 v) {
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}
__device__ __forceinline__ void put_words(uint32_t* dst, uint2 v) {
  dst[0] = v.x;
  dst[1] = v.y;
}

// T: q, k_new/v_new and out dtype (float or bf16); KV: the pool's storage
// type (T itself, or int8_t with k_scale/v_scale)
template <typename T, typename KV, int D, bool WRITE>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, KV* __restrict__ k_pool,
                    float* __restrict__ k_scale, KV* __restrict__ v_pool,
                    float* __restrict__ v_scale, const int* __restrict__ page_table,
                    const int* __restrict__ lengths, const T* __restrict__ k_new,
                    const T* __restrict__ v_new, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_acc, int n_q,
                    int n_kv, int pool_pages, int page, int pps, int n_split,
                    float scale, int window, float cap) {
  using L = Layout<KV, D>;
  using Vec = typename L::Vec;
  constexpr bool QUANT = L::kQuant;
  constexpr int DPL = (D + 31) / 32;  // accumulator columns per lane
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sNew = reinterpret_cast<int8_t*>(smem);                      // [2][D]: K, V
  float* sNewScale = reinterpret_cast<float*>(smem + 2 * L::kRowBytes);  // [2]
  float* sQ = reinterpret_cast<float*>(smem + L::kNewBytes);           // [kMaxGroup][D]
  uint32_t* sK = reinterpret_cast<uint32_t*>(sQ + kMaxGroup * D);      // [kWarps][kTile][kKStride]
  uint32_t* sV = sK + kWarps * kTile * L::kKStride;                    // [kWarps][kTile][kWords]
  float* sM = reinterpret_cast<float*>(sV + kWarps * kTile * L::kWords);  // [kWarps][kMaxGroup]
  float* sL = sM + kWarps * kMaxGroup;
  float* sAcc = reinterpret_cast<float*>(sK);  // [kWarps][kMaxGroup][D], after the loop

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int group = n_q / n_kv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int length = lengths[b];
  const int cur = length - 1;  // the current token's position
  const int* pt = page_table + (size_t)b * pps;
  const size_t new_row = ((size_t)b * n_kv + kvh) * D;

  if constexpr (WRITE && !QUANT) {
    if (split == 0 && length > 0) {
      const size_t r = ((size_t)kvh * pool_pages + pt[cur / page]) * page + cur % page;
      for (int i = tid; i < D; i += blockDim.x) {
        k_pool[r * D + i] = k_new[new_row + i];
        v_pool[r * D + i] = v_new[new_row + i];
      }
    }
  }
  if constexpr (WRITE && QUANT) {
    // warp 0 quantizes the K row, warp 1 the V row (quantize_kv's chain)
    if (length > 0 && split == cur / kSplitKeys && warp < 2) {
      const T* src = warp == 0 ? k_new : v_new;
      KV* dst = warp == 0 ? k_pool : v_pool;
      float* dst_scale = warp == 0 ? k_scale : v_scale;
      float x[DPL];
      float amax = 0.f;
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int i = lane + 32 * c;
        x[c] = i < D ? to_float(src[new_row + i]) : 0.f;
        amax = fmaxf(amax, fabsf(x[c]));
      }
      const float s = fmaxf(warp_max(amax), 1e-8f) / 127.0f;
      const size_t r = ((size_t)kvh * pool_pages + pt[cur / page]) * page + cur % page;
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int i = lane + 32 * c;
        if (i < D) {
          const int8_t v = (int8_t)fminf(fmaxf(rintf(x[c] / s), -127.f), 127.f);
          sNew[warp * L::kRowBytes + i] = v;
          dst[r * D + i] = v;
        }
      }
      if (lane == 0) {
        sNewScale[warp] = s;
        dst_scale[r] = s;
      }
    }
  }
  for (int idx = tid; idx < group * D; idx += blockDim.x) {
    const int g = idx / D, i = idx % D;
    sQ[g * D + i] = to_float(q[((size_t)b * n_q + kvh * group + g) * D + i]);
  }
  __syncthreads();

  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][DPL];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[g][c] = 0.f;
  }

  const int k_begin = window > 0 ? max(0, length - window) : 0;
  const int lo = max(k_begin, split * kSplitKeys);
  const int hi = min(length, (split + 1) * kSplitKeys);
  uint32_t* wK = sK + warp * kTile * L::kKStride;
  uint32_t* wV = sV + warp * kTile * L::kWords;

  for (int t0 = lo + warp * kTile; t0 < hi; t0 += kWarps * kTile) {
    // each lane finds its own key's row (and, int8, its scales); the warp
    // then copies all 32 rows
    const int key = t0 + lane;
    unsigned long long krow = 0, vrow = 0;
    float ksc = 0.f, vsc = 0.f;
    if (key < hi) {
      if (WRITE && key == cur) {
        if constexpr (QUANT) {
          krow = (unsigned long long)sNew;
          vrow = (unsigned long long)(sNew + L::kRowBytes);
          ksc = sNewScale[0];
          vsc = sNewScale[1];
        } else {
          krow = (unsigned long long)(k_new + new_row);
          vrow = (unsigned long long)(v_new + new_row);
        }
      } else {
        const size_t r = ((size_t)kvh * pool_pages + pt[key / page]) * page + key % page;
        krow = (unsigned long long)(k_pool + r * D);
        vrow = (unsigned long long)(v_pool + r * D);
        if constexpr (QUANT) {
          ksc = k_scale[r];
          vsc = v_scale[r];
        }
      }
    }
#pragma unroll 8
    for (int idx = lane; idx < kTile * L::kVecs; idx += 32) {
      const int j = idx / L::kVecs, c = idx % L::kVecs;
      const Vec* kj = reinterpret_cast<const Vec*>(__shfl_sync(LLMK_FULL_MASK, krow, j));
      const Vec* vj = reinterpret_cast<const Vec*>(__shfl_sync(LLMK_FULL_MASK, vrow, j));
      // both loads before either store: the rows are read through generic
      // pointers, which the compiler must assume may alias the tiles
      const Vec zero{};
      const Vec kv = kj ? kj[c] : zero;
      const Vec vv = vj ? vj[c] : zero;
      put_words(wK + j * L::kKStride + L::kVecWords * c, kv);
      reinterpret_cast<Vec*>(wV)[j * L::kVecs + c] = vv;
    }
    __syncwarp();

    const bool valid = key < hi;
    float s[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) s[g] = 0.f;
    const uint32_t* krow_s = wK + lane * L::kKStride;
#pragma unroll 8
    for (int i = 0; i < D; ++i) {
      const float kf = elem<KV>(krow_s, i);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < group) s[g] = fmaf(sQ[g * D + i], kf, s[g]);
    }
    float p[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      p[g] = 0.f;
      if (g < group) {
        // int8: the key's K scale multiplies its logit
        const float sg = apply_softcap(QUANT ? s[g] * ksc * scale : s[g] * scale, cap);
        const float m_new = fmaxf(m[g], warp_max(valid ? sg : -INFINITY));
        const float alpha = expf(m[g] - m_new);
        p[g] = valid ? expf(sg - m_new) : 0.f;
        l[g] = l[g] * alpha + warp_sum(p[g]);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[g][c] *= alpha;
        m[g] = m_new;
        // int8: the key's V scale multiplies its probability in p.v only
        if (QUANT) p[g] *= vsc;
      }
    }
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float vj[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int i = lane + 32 * c;
        vj[c] = i < D ? elem<KV>(wV + j * L::kWords, i) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) {
          const float pj = __shfl_sync(LLMK_FULL_MASK, p[g], j);
#pragma unroll
          for (int c = 0; c < DPL; ++c) acc[g][c] = fmaf(pj, vj[c], acc[g][c]);
        }
      }
    }
    __syncwarp();
  }

  // merge the warps' partial softmax sums into this split's partial
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      sM[warp * kMaxGroup + g] = m[g];
      sL[warp * kMaxGroup + g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < group) {
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int i = lane + 32 * c;
        if (i < D) sAcc[(warp * kMaxGroup + g) * D + i] = acc[g][c];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < group * D; idx += blockDim.x) {
    const int g = idx / D, i = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sM[w * kMaxGroup + g]);
    float den = 0.f, num = 0.f;
    if (mx > -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float e = expf(sM[w * kMaxGroup + g] - mx);
        den += sL[w * kMaxGroup + g] * e;
        num += sAcc[(w * kMaxGroup + g) * D + i] * e;
      }
    }
    const size_t part = ((size_t)b * n_q + kvh * group + g) * n_split + split;
    part_acc[part * D + i] = num;
    if (i == 0) {
      part_m[part] = mx;
      part_l[part] = den;
    }
  }
}

// One block per (slot, query head), one thread per output column: merge
// the key splits' partials and normalise.
template <typename T, int D>
__global__ void paged_decode_merge(const float* __restrict__ part_m,
                                   const float* __restrict__ part_l,
                                   const float* __restrict__ part_acc, T* __restrict__ out,
                                   int n_split) {
  const size_t row = blockIdx.x;
  const int i = threadIdx.x;
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, part_m[row * n_split + s]);
  float den = 0.f, num = 0.f;
  if (mx > -INFINITY) {
    for (int s = 0; s < n_split; ++s) {
      const float e = expf(part_m[row * n_split + s] - mx);
      den += part_l[row * n_split + s] * e;
      num += part_acc[(row * n_split + s) * D + i] * e;
    }
  }
  out[row * D + i] = from_float<T>(den > 0.f ? num / den : 0.f);
}

template <typename T, typename KV, int D, bool WRITE>
int paged_decode_launch_one(const void* q, void* k_pool, void* k_scale, void* v_pool,
                            void* v_scale, const void* page_table, const void* lengths,
                            const void* k_new, const void* v_new, void* part_m, void* part_l,
                            void* part_acc, void* out, int B, int n_q, int n_kv,
                            int pool_pages, int page, int pps, int n_split, float scale,
                            int window, float cap, cudaStream_t stream) {
  constexpr size_t smem = Layout<KV, D>::kSmem;
  static bool smem_set = false;  // per instantiation; one card per process
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T, KV, D, WRITE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  paged_decode_kernel<T, KV, D, WRITE><<<dim3(n_kv, B, n_split), kWarps * 32, smem, stream>>>(
      (const T*)q, (KV*)k_pool, (float*)k_scale, (KV*)v_pool, (float*)v_scale,
      (const int*)page_table, (const int*)lengths, (const T*)k_new, (const T*)v_new,
      (float*)part_m, (float*)part_l, (float*)part_acc, n_q, n_kv, pool_pages, page, pps,
      n_split, scale, window, cap);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_decode_merge<T, D><<<B * n_q, D, 0, stream>>>(
      (const float*)part_m, (const float*)part_l, (const float*)part_acc, (T*)out, n_split);
  return (int)cudaGetLastError();
}

// KV = T for a float pool (k_scale/v_scale unused), int8_t for an int8 pool
template <typename T, typename KV>
int paged_decode_launch(const void* q, void* k_pool, void* k_scale, void* v_pool,
                        void* v_scale, const void* page_table, const void* lengths,
                        const void* k_new, const void* v_new, void* part_m, void* part_l,
                        void* part_acc, void* out, int B, int n_q, int n_kv, int pool_pages,
                        int page, int pps, int n_split, int d, float scale, int window,
                        float cap, int write, cudaStream_t stream) {
  if (n_q % n_kv != 0 || n_q / n_kv > kMaxGroup) return (int)cudaErrorInvalidValue;
  if (n_split != (pps * page + kSplitKeys - 1) / kSplitKeys) return (int)cudaErrorInvalidValue;
  if (write) {
    LLMK_DISPATCH_D(d, return (paged_decode_launch_one<T, KV, D, true>(
        q, k_pool, k_scale, v_pool, v_scale, page_table, lengths, k_new, v_new, part_m,
        part_l, part_acc, out, B, n_q, n_kv, pool_pages, page, pps, n_split, scale, window,
        cap, stream)));
  } else {
    LLMK_DISPATCH_D(d, return (paged_decode_launch_one<T, KV, D, false>(
        q, k_pool, k_scale, v_pool, v_scale, page_table, lengths, k_new, v_new, part_m,
        part_l, part_acc, out, B, n_q, n_kv, pool_pages, page, pps, n_split, scale, window,
        cap, stream)));
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace llmk
