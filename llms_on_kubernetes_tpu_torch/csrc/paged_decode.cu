// Paged decode attention for Hopper (sm_90a), with and without the fused
// append of the current token's K/V.
//
// Replaces two TPU kernels of llms_on_kubernetes_tpu/ops/pallas_paged.py:
//   WRITE=false: pallas_paged_attention        (body _paged_kernel)
//   WRITE=true:  pallas_paged_attention_write  (body _paged_kernel_write)
// Semantics are those of the plain versions in ops/paged_attention.py:
// single-token GQA attention of q [B, n_q, d] over keys [0, lengths[b])
// of slot b, read through page_table [B, pps] from the head-major pool
// [n_kv, P, page, d], an optional sliding window (keys >= length - window)
// and an optional tanh softcap. WRITE=true also stores k_new/v_new
// [B, n_kv, d] (already in the pool dtype) in place at position
// length - 1, and only when length > 0: the bytes write_tokens would
// store, in the same row.
//
// What bounds it on the H100: decode reads each cached K/V byte once and
// does ~2 * group FLOPs per byte pair, far below the ~295 FLOP/byte ridge,
// so the bound is device memory (3.35 TB/s). Reaching it takes many bytes
// in flight: enough blocks, and wide independent loads.
//
// Design: the TPU kernel folded every KV head into one program per slot
// because its grid runs in order on one core. Here the grid is
// (KV head, slot, key split): a slot's keys are cut into splits of
// kSplitKeys positions, one block each, so a batch of 8 slots x 8 heads at
// 2048 positions is 512 blocks, not 64. Inside a block, 4 warps take
// 32-key tiles round robin. For a tile, each lane looks up its own key's
// page in the page table (one load per lane, all in parallel; only pages
// covering [0, length) are read, so no stale row is touched and the TPU
// kernel's stale-V zeroing has no counterpart), then the warp copies the
// 32 K and V rows into shared memory with coalesced 16-byte loads. Lane j
// scores key j against every query row of the group (K rows padded to an
// odd number of words: conflict-free), the warp keeps an online softmax per
// row in f32, the block merges its warps, and each block writes an
// unnormalised partial (max, sum, accumulator). A second, small kernel
// merges the splits and writes the output; an idle slot (length 0) has no
// keys and gets zeros.
//
// The fused kernel attends to the current token without reading it back
// from the pool: its K/V come from k_new/v_new and take the tile position
// the key has in the unfused kernel, so both kernels sum in the same order
// and the fused and unfused decode paths give bit-identical outputs. The
// TPU kernel's 8-row read-modify-write of the append is a Mosaic tiling
// artefact; here the append is one direct row store per side, made by the
// key split 0 block.
#include <stdint.h>

#include "common.cuh"

using namespace llmk;

namespace {

constexpr int kWarps = 4;
constexpr int kTile = 32;        // keys per warp tile: one per lane
constexpr int kMaxGroup = 8;     // query heads per KV head the kernel serves
constexpr int kSplitKeys = 256;  // key positions per block (kernels/__init__.py)

template <typename T, int D>
struct Layout {
  static constexpr int kWords = D * (int)sizeof(T) / 4;  // 32-bit words per row
  static constexpr int kVecs = D * (int)sizeof(T) / 16;  // 16-byte vectors per row
  // padded K row: an odd number of words, so lane j reading row j hits a
  // bank of its own
  static constexpr int kKStride = kWords + 1;
  static constexpr size_t kSmem = sizeof(float) * kMaxGroup * D +
                                  sizeof(uint32_t) * kWarps * kTile * (kKStride + kWords) +
                                  sizeof(float) * 2 * kWarps * kMaxGroup;
};

// element i of a row held as 32-bit words
template <typename T>
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

template <typename T, int D, bool WRITE>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, T* __restrict__ k_pool,
                    T* __restrict__ v_pool, const int* __restrict__ page_table,
                    const int* __restrict__ lengths, const T* __restrict__ k_new,
                    const T* __restrict__ v_new, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_acc, int n_q,
                    int n_kv, int pool_pages, int page, int pps, int n_split,
                    float scale, int window, float cap) {
  using L = Layout<T, D>;
  constexpr int DPL = (D + 31) / 32;  // accumulator columns per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);                          // [kMaxGroup][D]
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
  const int* pt = page_table + (size_t)b * pps;
  const size_t new_row = ((size_t)b * n_kv + kvh) * D;

  if (WRITE && split == 0 && length > 0) {
    const int pos = length - 1;
    const size_t r = (((size_t)kvh * pool_pages + pt[pos / page]) * page + pos % page) * D;
    for (int i = tid; i < D; i += blockDim.x) {
      k_pool[r + i] = k_new[new_row + i];
      v_pool[r + i] = v_new[new_row + i];
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
    // each lane finds its own key's row; the warp then copies all 32 rows
    const int key = t0 + lane;
    unsigned long long krow = 0, vrow = 0;
    if (key < hi) {
      if (WRITE && key == length - 1) {
        krow = (unsigned long long)(k_new + new_row);
        vrow = (unsigned long long)(v_new + new_row);
      } else {
        const size_t r =
            (((size_t)kvh * pool_pages + pt[key / page]) * page + key % page) * D;
        krow = (unsigned long long)(k_pool + r);
        vrow = (unsigned long long)(v_pool + r);
      }
    }
#pragma unroll 8
    for (int idx = lane; idx < kTile * L::kVecs; idx += 32) {
      const int j = idx / L::kVecs, c = idx % L::kVecs;
      const uint4* kj = reinterpret_cast<const uint4*>(__shfl_sync(LLMK_FULL_MASK, krow, j));
      const uint4* vj = reinterpret_cast<const uint4*>(__shfl_sync(LLMK_FULL_MASK, vrow, j));
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      const uint4 kv = kj ? kj[c] : zero;
      const uint4 vv = vj ? vj[c] : zero;
      uint32_t* dk = wK + j * L::kKStride + 4 * c;
      dk[0] = kv.x;
      dk[1] = kv.y;
      dk[2] = kv.z;
      dk[3] = kv.w;
      reinterpret_cast<uint4*>(wV)[j * L::kVecs + c] = vv;
    }
    __syncwarp();

    const bool valid = key < hi;
    float s[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) s[g] = 0.f;
    const uint32_t* krow_s = wK + lane * L::kKStride;
#pragma unroll 8
    for (int i = 0; i < D; ++i) {
      const float kf = elem<T>(krow_s, i);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < group) s[g] = fmaf(sQ[g * D + i], kf, s[g]);
    }
    float p[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      p[g] = 0.f;
      if (g < group) {
        const float sg = apply_softcap(s[g] * scale, cap);
        const float m_new = fmaxf(m[g], warp_max(valid ? sg : -INFINITY));
        const float alpha = expf(m[g] - m_new);
        p[g] = valid ? expf(sg - m_new) : 0.f;
        l[g] = l[g] * alpha + warp_sum(p[g]);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[g][c] *= alpha;
        m[g] = m_new;
      }
    }
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float vj[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int i = lane + 32 * c;
        vj[c] = i < D ? elem<T>(wV + j * L::kWords, i) : 0.f;
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

template <typename T, int D, bool WRITE>
int launch_one(const void* q, void* k_pool, void* v_pool, const void* page_table,
               const void* lengths, const void* k_new, const void* v_new, void* part_m,
               void* part_l, void* part_acc, void* out, int B, int n_q, int n_kv,
               int pool_pages, int page, int pps, int n_split, float scale, int window,
               float cap, cudaStream_t stream) {
  constexpr size_t smem = Layout<T, D>::kSmem;
  static bool smem_set = false;  // per instantiation; one card per process
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T, D, WRITE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  paged_decode_kernel<T, D, WRITE><<<dim3(n_kv, B, n_split), kWarps * 32, smem, stream>>>(
      (const T*)q, (T*)k_pool, (T*)v_pool, (const int*)page_table, (const int*)lengths,
      (const T*)k_new, (const T*)v_new, (float*)part_m, (float*)part_l, (float*)part_acc,
      n_q, n_kv, pool_pages, page, pps, n_split, scale, window, cap);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_decode_merge<T, D><<<B * n_q, D, 0, stream>>>(
      (const float*)part_m, (const float*)part_l, (const float*)part_acc, (T*)out, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, void* k_pool, void* v_pool, const void* page_table,
           const void* lengths, const void* k_new, const void* v_new, void* part_m,
           void* part_l, void* part_acc, void* out, int B, int n_q, int n_kv,
           int pool_pages, int page, int pps, int n_split, int d, float scale, int window,
           float cap, int write, cudaStream_t stream) {
  if (n_q % n_kv != 0 || n_q / n_kv > kMaxGroup) return (int)cudaErrorInvalidValue;
  if (n_split != (pps * page + kSplitKeys - 1) / kSplitKeys) return (int)cudaErrorInvalidValue;
  if (write) {
    LLMK_DISPATCH_D(d, return (launch_one<T, D, true>(
        q, k_pool, v_pool, page_table, lengths, k_new, v_new, part_m, part_l, part_acc,
        out, B, n_q, n_kv, pool_pages, page, pps, n_split, scale, window, cap, stream)));
  } else {
    LLMK_DISPATCH_D(d, return (launch_one<T, D, false>(
        q, k_pool, v_pool, page_table, lengths, k_new, v_new, part_m, part_l, part_acc,
        out, B, n_q, n_kv, pool_pages, page, pps, n_split, scale, window, cap, stream)));
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, n_q, d]; k_pool/v_pool [n_kv, pool_pages, page, d]; page_table
// [B, pps] int32 (global page ids); lengths [B] int32 (keys including the
// current token); out [B, n_q, d]; k_new/v_new [B, n_kv, d] in the pool
// dtype, read only when write != 0. Scratch: part_m/part_l [B, n_q, n_split]
// and part_acc [B, n_q, n_split, d] float32, n_split = ceil(pps * page /
// 256). All contiguous and 16-byte aligned, q/pool/out one dtype.
// window <= 0 means none, cap <= 0 means no softcap.
// Returns cudaGetLastError() after the launches.
extern "C" int llmk_paged_decode(const void* q, void* k_pool, void* v_pool,
                                 const void* page_table, const void* lengths,
                                 const void* k_new, const void* v_new, void* part_m,
                                 void* part_l, void* part_acc, void* out, int B, int n_q,
                                 int n_kv, int pool_pages, int page, int pps, int n_split,
                                 int d, float scale, int window, float cap, int write,
                                 int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == LLMK_F32)
    return launch<float>(q, k_pool, v_pool, page_table, lengths, k_new, v_new, part_m,
                         part_l, part_acc, out, B, n_q, n_kv, pool_pages, page, pps,
                         n_split, d, scale, window, cap, write, s);
  if (dtype == LLMK_BF16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, page_table, lengths, k_new, v_new,
                                 part_m, part_l, part_acc, out, B, n_q, n_kv, pool_pages,
                                 page, pps, n_split, d, scale, window, cap, write, s);
  return (int)cudaErrorInvalidValue;
}
