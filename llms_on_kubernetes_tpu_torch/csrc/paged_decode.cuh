// Paged decode attention for Hopper (sm_90a), over a float pool or an int8
// pool, with and without the fused append of the current token's K/V.
// Instantiated by paged_decode.cu (float pools: the pool holds q's dtype;
// kernels 2 and 3 of the port's table) and paged_decode_int8.cu (int8 pools
// with a per-token f32 scale; kernels 4 and 5).
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
// bytes a row and side instead of 2 * d. Reaching it takes many bytes in
// flight and little work per byte: the first design (one 32-key tile per
// warp loaded through registers, lane-per-key f32 dot products, a second
// kernel merging the splits) measured ~11x above the bound, its time split
// about evenly between loads and arithmetic (PERF.md, kernel findings).
//
// Design: grid (KV head, slot, 256-key split), 4 warps a block.
// - A split that holds no key of [max(window start, split start), length)
//   returns at once, before it reads q: only the splits that hold keys
//   work (an idle slot's split 0 writes zeros).
// - Each warp walks 16-key tiles of its split, round robin (up to four),
//   through a ring of two stages in shared memory: tile i + 1's page lookups
//   (one lane a key) and 16-byte cp.async copies of its K and V rows (8-byte
//   for an int8 row of 8; int8 scales 4-byte) are issued before tile i is
//   scored.
//   Rows are stored in the pool's own type, 16-byte chunks XOR-swizzled by
//   row so that both ldmatrix and lane-per-row reads are conflict-free
//   (a permutation within the row at any chunk count: a bf16 row of
//   head_dim 96 has 12). Keys outside the split's range are zero-filled
//   and masked. A float32 pool at head_dim 256 (64 KB a warp's two stages)
//   keeps one stage: the next tile is issued after this one is read.
// - bf16 q (head_dim >= 16): the scores and p.v are mma.sync.m16n8k16 (bf16
//   in, f32 accumulate) with the group's query rows padded to 16; q's
//   fragments come straight from global memory into registers. An int8
//   tile is first widened to bf16 in shared memory (int8 values are exact
//   in bf16); the scales stay f32 and multiply the logit and p. p is
//   rounded to bf16 for the product, inside the bf16 checks' tolerance.
// - float32 q (and bf16 with head_dim 8): CUDA-core FMAs in f32, lane j and
//   j + 16 scoring key j, so the 1e-4 checks hold.
// - The warps' online softmax states merge in shared memory into the
//   block's partial. A slot with one working split writes its output
//   directly. Otherwise each split writes its partial to a workspace and
//   the last block of a (slot, KV head) to finish -- an atomic counter in a
//   per-device workspace tells it, and it resets the counter to 0 -- merges
//   the partials in split order (not arrival order, so every run gives the
//   same bits) and writes the output: one launch a call.
//
// The fused kernels attend to the current token without reading it back
// from the pool: its row comes from k_new/v_new (float) or from the block's
// own quantized copy in shared memory (int8) and takes the tile position
// the key has in the unfused kernel, so both kernels sum in the same order
// and kv_write "fused" and "dus" give bit-identical outputs. The TPU
// kernels' 8-row (and, for int8, full-page scale) read-modify-writes are
// Mosaic tiling artefacts; here the append is one direct row store per
// side (plus one scale store), made by the block whose split holds
// position length - 1. For an int8 pool it quantizes the row once with
// quantize.cuh's quantize_row (the function the windowed append of
// paged_write_window.cu uses) and uses those bytes both for the store and
// for its own tile.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "quantize.cuh"

namespace llmk {

constexpr int kWarps = 4;
constexpr int kTile = 16;        // keys per warp tile
constexpr int kMaxGroup = 8;     // query heads per KV head the kernel serves
constexpr int kSplitKeys = 256;  // key positions per block (ops/paged_attention.py)

// T: q's dtype; KV: the pool's storage type (float, __nv_bfloat16 or int8_t)
template <typename T, typename KV, int D>
struct Layout {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value && D >= 16;
  static constexpr int kRowBytes = D * (int)sizeof(KV);
  static_assert(kRowBytes % 8 == 0, "a pool row must be a whole number of 8-byte vectors");
  static constexpr int kCopy = kRowBytes >= 16 ? 16 : 8;  // bytes a cp.async
  static constexpr int kChunks = kRowBytes / kCopy;        // copies a row
  static constexpr int kTileBytes = kTile * kRowBytes;
  // a ring stage: K rows, V rows, and for int8 the keys' K and V scales
  static constexpr int kStageBytes = 2 * kTileBytes + (kQuant ? 2 * kTile * 4 : 0);
  // int8 under mma: the warp's tile widened to bf16, K then V
  static constexpr int kWideBytes = kQuant && kMma ? 2 * kTile * D * 2 : 0;
  // int8 WRITE: the quantized current K and V rows and their two scales
  static constexpr int kNewBytes = kQuant ? 2 * kRowBytes + 16 : 0;
  // f32 query rows for the CUDA-core scores
  static constexpr int kQBytes = kMma ? 0 : (int)sizeof(float) * kMaxGroup * D;
  // after the key loop: the warps' (max, sum, accumulator) per query row
  static constexpr int kMergeBytes = (int)sizeof(float) * kWarps * kMaxGroup * (D + 2);
  // two ring stages a warp, so tile i + 1 loads while tile i is scored;
  // one where two would pass the 227 KB a block may hold (f32 at head_dim
  // 256: 64 KB a warp), and the next tile then loads after this one
  static constexpr int kStages =
      kNewBytes + kQBytes + kWarps * (2 * kStageBytes + kWideBytes) <= 232448 ? 2 : 1;
  static constexpr int kWarpBytes = kStages * kStageBytes + kWideBytes;
  static constexpr int kLoopBytes =
      kWarps * kWarpBytes > kMergeBytes ? kWarps * kWarpBytes : kMergeBytes;
  static constexpr size_t kSmem = (size_t)kNewBytes + kQBytes + kLoopBytes;
  static_assert(kSmem <= 232448, "a block holds at most 227 KB of shared memory");
};

// position of 16-byte (or 8-byte) chunk c of row r of a tile: XOR-swizzled so
// that 8 consecutive rows' chunk c lie in 8 distinct 16-byte bank groups.
// A permutation of [0, CHUNKS) for any CHUNKS: a row of 12 chunks (bf16 at
// head_dim 96) swizzles chunks 0-7 as a row of 8 and 8-11 as a row of 4,
// one of 6 (int8 at 96) as 4 then 2, so no chunk leaves its row.
template <int CHUNKS>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (CHUNKS % 8 == 0) {
    return c ^ (r & 7);
  } else if constexpr ((CHUNKS & (CHUNKS - 1)) == 0) {
    return c ^ ((r / (8 / CHUNKS)) & (CHUNKS - 1));
  } else {
    constexpr int HEAD = CHUNKS > 8 ? CHUNKS / 8 * 8 : (CHUNKS > 4 ? 4 : 2);
    return c < HEAD ? swz<HEAD>(r, c) : HEAD + swz<CHUNKS - HEAD>(r, c - HEAD);
  }
}

// element i of row r of a tile of KV rows (CUDA-core path)
template <typename KV, int D>
__device__ __forceinline__ float tile_elem(const unsigned char* tile, int r, int i) {
  using L = Layout<float, KV, D>;
  const int byte = i * (int)sizeof(KV);
  return to_float(*reinterpret_cast<const KV*>(
      tile + r * L::kRowBytes + swz<L::kChunks>(r, byte / L::kCopy) * L::kCopy +
      byte % L::kCopy));
}

// 16 int8 values (one uint4) as 16 bf16 (two uint4), exactly
__device__ __forceinline__ void widen_int8(uint4 raw, uint4& lo, uint4& hi) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int x = (int)w[i];
    o[2 * i] = pack_bf16((float)((x << 24) >> 24), (float)((x << 16) >> 24));
    o[2 * i + 1] = pack_bf16((float)((x << 8) >> 24), (float)(x >> 24));
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

template <typename T, typename KV, int D, bool WRITE>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, KV* __restrict__ k_pool,
                    float* __restrict__ k_scale, KV* __restrict__ v_pool,
                    float* __restrict__ v_scale, const int* __restrict__ page_table,
                    const int* __restrict__ lengths, const T* __restrict__ k_new,
                    const T* __restrict__ v_new, float* __restrict__ part,
                    int* __restrict__ counters, T* __restrict__ out, int n_q, int n_kv,
                    int pool_pages, int page, int pps, int n_split, float scale, int window,
                    float cap) {
  using L = Layout<T, KV, D>;
  constexpr bool QUANT = L::kQuant;
  constexpr bool MMA = L::kMma;
  constexpr int DPL = (D + 31) / 32;  // CUDA-core accumulator columns per lane
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  int8_t* sNew = reinterpret_cast<int8_t*>(smem);                        // [2][D]: K, V
  float* sNewScale = reinterpret_cast<float*>(smem + 2 * L::kRowBytes);  // [2]
  float* sQ = reinterpret_cast<float*>(smem + L::kNewBytes);             // [kMaxGroup][D]
  unsigned char* sLoop = smem + L::kNewBytes + L::kQBytes;
  // after the loop: sM, sL [kWarps][kMaxGroup], sAcc [kWarps][kMaxGroup][D]
  float* sM = reinterpret_cast<float*>(sLoop);
  float* sL = sM + kWarps * kMaxGroup;
  float* sAcc = sL + kWarps * kMaxGroup;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int group = n_q / n_kv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int length = lengths[b];
  T* out_rows = out + ((size_t)b * n_q + kvh * group) * D;
  if (length <= 0) {  // an idle slot: zeros, nothing appended
    if (split == 0)
      for (int idx = tid; idx < group * D; idx += blockDim.x) out_rows[idx] = from_float<T>(0.f);
    return;
  }
  const int cur = length - 1;  // the current token's position
  const int k_begin = window > 0 ? max(0, length - window) : 0;
  const int first = k_begin / kSplitKeys, last = cur / kSplitKeys;
  if (split < first || split > last) return;  // no key here: no work
  const int n_active = last - first + 1;
  const int* pt = page_table + (size_t)b * pps;
  const size_t new_row = ((size_t)b * n_kv + kvh) * D;

  if constexpr (WRITE && !QUANT) {
    if (split == last) {
      const size_t r = ((size_t)kvh * pool_pages + pt[cur / page]) * page + cur % page;
      for (int i = tid; i < D; i += blockDim.x) {
        k_pool[r * D + i] = k_new[new_row + i];
        v_pool[r * D + i] = v_new[new_row + i];
      }
    }
  }
  if constexpr (WRITE && QUANT) {
    // warp 0 quantizes the K row, warp 1 the V row (quantize.cuh)
    if (split == last && warp < 2) {
      const T* src = warp == 0 ? k_new : v_new;
      KV* dst = warp == 0 ? k_pool : v_pool;
      float* dst_scale = warp == 0 ? k_scale : v_scale;
      int8_t qv[DPL];
      const float s = quantize_row<T, D>(src + new_row, lane, qv);
      const size_t r = ((size_t)kvh * pool_pages + pt[cur / page]) * page + cur % page;
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int i = lane + 32 * c;
        if (i < D) {
          sNew[warp * L::kRowBytes + i] = qv[c];
          dst[r * D + i] = qv[c];
        }
      }
      if (lane == 0) {
        sNewScale[warp] = s;
        dst_scale[r] = s;
      }
    }
  }
  if constexpr (!MMA) {
    for (int idx = tid; idx < group * D; idx += blockDim.x)
      sQ[idx] = to_float(q[((size_t)b * n_q + kvh * group) * D + idx]);
  }
  __syncthreads();

  // this split's keys [lo, hi), cut into 16-key tiles from the split's start;
  // warp w takes tiles w, w + 4, ... of those that hold keys
  const int base = split * kSplitKeys;
  const int lo = max(k_begin, base), hi = min(length, base + kSplitKeys);
  const int t_first = (lo - base) / kTile, t_last = (hi - 1 - base) / kTile;
  const int my_first = t_first + (warp - t_first % kWarps + kWarps) % kWarps;
  const int n_mine = my_first <= t_last ? (t_last - my_first) / kWarps + 1 : 0;
  unsigned char* ring = sLoop + warp * L::kWarpBytes;        // [kStages] stages
  unsigned char* wide = ring + L::kStages * L::kStageBytes;  // int8 under mma: [2][kTile][D] bf16

  // tile i of this warp into stage i % kStages: lanes j and j + 16 look up
  // key j's row; the warp copies the 16 K and 16 V rows (and int8 scales)
  auto issue = [&](int i) {
    unsigned char* st = ring + (i % L::kStages) * L::kStageBytes;
    const int key = base + (my_first + i * kWarps) * kTile + (lane & 15);
    const bool in = key >= lo && key < hi;
    size_t r = 0;
    const KV* krow = k_pool;
    const KV* vrow = v_pool;
    bool copy = in;
    if (in) {
      r = ((size_t)kvh * pool_pages + pt[key / page]) * page + key % page;
      krow = k_pool + r * D;
      vrow = v_pool + r * D;
      if (WRITE && key == cur) {
        if constexpr (QUANT) {
          copy = false;  // from sNew once the stage has landed
        } else {
          krow = reinterpret_cast<const KV*>(k_new + new_row);
          vrow = reinterpret_cast<const KV*>(v_new + new_row);
        }
      }
    }
    constexpr int kCopies = 2 * kTile * L::kChunks;  // per stage
#pragma unroll
    for (int n = 0; n < (kCopies + 31) / 32; ++n) {
      const int idx = lane + 32 * n;
      const int side = idx / (kTile * L::kChunks);
      const int j = (idx / L::kChunks) % kTile, c = idx % L::kChunks;
      // lane j's two row addresses, then this lane's side of them
      const unsigned long long ks = __shfl_sync(LLMK_FULL_MASK, (unsigned long long)krow, j);
      const unsigned long long vs = __shfl_sync(LLMK_FULL_MASK, (unsigned long long)vrow, j);
      const bool cj = __shfl_sync(LLMK_FULL_MASK, copy, j);
      if (idx < kCopies)
        cp_async<L::kCopy>(st + side * L::kTileBytes + j * L::kRowBytes +
                               swz<L::kChunks>(j, c) * L::kCopy,
                           reinterpret_cast<const unsigned char*>(side ? vs : ks) +
                               c * L::kCopy,
                           cj);
    }
    if constexpr (QUANT) {
      float* sc = reinterpret_cast<float*>(st + 2 * L::kTileBytes);  // [2][kTile]
      const float* src = lane < 16 ? k_scale + r : v_scale + r;
      cp_async<4>(sc + (lane < 16 ? 0 : kTile) + (lane & 15), src, copy);
    }
    cp_async_commit();
  };

  // online softmax state: CUDA cores keep every query row of the group per
  // lane; mma keeps row g = lane / 4 (columns 2 * (lane % 4) + {0, 1} of each
  // 8-column tile of the accumulator; its rows 8..15 are padding, never kept)
  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][DPL];
  uint32_t qf[MMA ? D / 16 : 1][4];
  float o[MMA ? D / 8 : 1][2];
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int gg = 0; gg < kMaxGroup; ++gg) {
    m[gg] = -INFINITY;
    l[gg] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[gg][c] = 0.f;
  }
  if constexpr (MMA) {
    // rows g >= group and the fragment's rows 8..15 are padding (zeros)
    const T* qrow = q + ((size_t)b * n_q + kvh * group + g) * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][0] = g < group ? *reinterpret_cast<const uint32_t*>(qrow + kk * 16 + tq * 2) : 0u;
      qf[kk][2] = g < group ? *reinterpret_cast<const uint32_t*>(qrow + kk * 16 + 8 + tq * 2)
                            : 0u;
      qf[kk][1] = qf[kk][3] = 0u;
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = 0.f;
  }

  if (n_mine > 0) issue(0);
  for (int i = 0; i < n_mine; ++i) {
    if (L::kStages == 2 && i + 1 < n_mine) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    unsigned char* st = ring + (i % L::kStages) * L::kStageBytes;
    const int t0 = base + (my_first + i * kWarps) * kTile;
    const float* ksc = reinterpret_cast<const float*>(st + 2 * L::kTileBytes);
    const float* vsc = ksc + kTile;
    if constexpr (WRITE && QUANT) {
      // the current token's row and scales from the block's own quantized copy
      if (cur >= t0 && cur < t0 + kTile) {
        const int j = cur - t0;
        for (int idx = lane; idx < 2 * L::kRowBytes; idx += 32) {
          const int side = idx / L::kRowBytes, byte = idx % L::kRowBytes;
          st[side * L::kTileBytes + j * L::kRowBytes +
             swz<L::kChunks>(j, byte / L::kCopy) * L::kCopy + byte % L::kCopy] =
              sNew[side * L::kRowBytes + byte];
        }
        if (lane < 2) reinterpret_cast<float*>(st + 2 * L::kTileBytes)[lane * kTile + j] =
            sNewScale[lane];
        __syncwarp();
      }
    }

    if constexpr (MMA) {
      // bf16 K and V tiles [kTile][D], 16-byte chunks swizzled by row
      constexpr int WC = D / 8;  // 16-byte chunks of a bf16 row
      const unsigned char* tK = st;
      const unsigned char* tV = st + L::kTileBytes;
      if constexpr (QUANT) {
        for (int idx = lane; idx < 2 * kTile * L::kChunks; idx += 32) {
          const int side = idx / (kTile * L::kChunks);
          const int j = (idx / L::kChunks) % kTile, c = idx % L::kChunks;
          uint4 lo4, hi4;
          widen_int8(*reinterpret_cast<const uint4*>(st + side * L::kTileBytes +
                                                     j * L::kRowBytes +
                                                     swz<L::kChunks>(j, c) * 16),
                     lo4, hi4);
          unsigned char* w = wide + side * kTile * D * 2 + j * D * 2;
          *reinterpret_cast<uint4*>(w + swz<WC>(j, 2 * c) * 16) = lo4;
          *reinterpret_cast<uint4*>(w + swz<WC>(j, 2 * c + 1) * 16) = hi4;
        }
        __syncwarp();
        tK = wide;
        tV = wide + kTile * D * 2;
      }
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kb[4];
        const int j = (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(kb, tK + j * D * 2 + swz<WC>(j, 2 * kk + ((lane >> 3) & 1)) * 16);
        mma_bf16(s[0], qf[kk], kb[0], kb[1]);
        mma_bf16(s[1], qf[kk], kb[2], kb[3]);
      }
      // row g's logits for keys 8n + 2 tq + e
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * n + 2 * tq + e;
          const float raw = QUANT ? s[n][e] * ksc[j] * scale : s[n][e] * scale;
          const float x = apply_softcap(raw, cap);
          s[n][e] = t0 + j >= lo && t0 + j < hi ? x : -INFINITY;
          mx = fmaxf(mx, s[n][e]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(LLMK_FULL_MASK, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(LLMK_FULL_MASK, mx, 2));
      const float m_new = fmaxf(m[0], mx);
      const float alpha = expf(m[0] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[n][e] - m_new);
          sum += p;
          // int8: the key's V scale multiplies its probability in p.v only
          s[n][e] = QUANT ? p * vsc[8 * n + 2 * tq + e] : p;
        }
      }
      l[0] = l[0] * alpha + sum;
      m[0] = m_new;
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), 0u, pack_bf16(s[1][0], s[1][1]),
                              0u};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        const int j = (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(vb, tV + j * D * 2 + swz<WC>(j, 2 * dp + (lane >> 4)) * 16);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float c[4] = {o[2 * dp + h][0] * alpha, o[2 * dp + h][1] * alpha, 0.f, 0.f};
          mma_bf16(c, pa, vb[2 * h], vb[2 * h + 1]);
          o[2 * dp + h][0] = c[0];
          o[2 * dp + h][1] = c[1];
        }
      }
    } else {
      // CUDA cores: lanes j and j + 16 score key j against every query row
      const int j = lane & 15;
      const bool valid = t0 + j >= lo && t0 + j < hi;
      float s[kMaxGroup];
#pragma unroll
      for (int gg = 0; gg < kMaxGroup; ++gg) s[gg] = 0.f;
#pragma unroll 8
      for (int i = 0; i < D; ++i) {
        const float kf = tile_elem<KV, D>(st, j, i);
#pragma unroll
        for (int gg = 0; gg < kMaxGroup; ++gg)
          if (gg < group) s[gg] = fmaf(sQ[gg * D + i], kf, s[gg]);
      }
      float p[kMaxGroup];
#pragma unroll
      for (int gg = 0; gg < kMaxGroup; ++gg) {
        p[gg] = 0.f;
        if (gg < group) {
          // int8: the key's K scale multiplies its logit
          const float sg = apply_softcap(QUANT ? s[gg] * ksc[j] * scale : s[gg] * scale, cap);
          const float m_new = fmaxf(m[gg], warp_max(valid ? sg : -INFINITY));
          const float alpha = expf(m[gg] - m_new);
          p[gg] = valid ? expf(sg - m_new) : 0.f;
          l[gg] = l[gg] * alpha + warp_sum(lane < 16 ? p[gg] : 0.f);
#pragma unroll
          for (int c = 0; c < DPL; ++c) acc[gg][c] *= alpha;
          m[gg] = m_new;
          // int8: the key's V scale multiplies its probability in p.v only
          if (QUANT) p[gg] *= vsc[j];
        }
      }
      const unsigned char* tV = st + L::kTileBytes;
#pragma unroll 4
      for (int jj = 0; jj < kTile; ++jj) {
        float vj[DPL];
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int i = lane + 32 * c;
          vj[c] = i < D ? tile_elem<KV, D>(tV, jj, i) : 0.f;
        }
#pragma unroll
        for (int gg = 0; gg < kMaxGroup; ++gg) {
          if (gg < group) {
            const float pj = __shfl_sync(LLMK_FULL_MASK, p[gg], jj);
#pragma unroll
            for (int c = 0; c < DPL; ++c) acc[gg][c] = fmaf(pj, vj[c], acc[gg][c]);
          }
        }
      }
    }
    __syncwarp();  // the stage is read before issue() refills it
    if (L::kStages == 1 && i + 1 < n_mine) issue(i + 1);
  }

  // merge the warps' softmax states into this split's (max, sum, accumulator)
  __syncthreads();
  if constexpr (MMA) {
    float lw = l[0];
    lw += __shfl_xor_sync(LLMK_FULL_MASK, lw, 1);
    lw += __shfl_xor_sync(LLMK_FULL_MASK, lw, 2);
    if (g < group) {
      if (tq == 0) {
        sM[warp * kMaxGroup + g] = m[0];
        sL[warp * kMaxGroup + g] = lw;
      }
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        sAcc[(warp * kMaxGroup + g) * D + 8 * i + 2 * tq] = o[i][0];
        sAcc[(warp * kMaxGroup + g) * D + 8 * i + 2 * tq + 1] = o[i][1];
      }
    }
  } else {
    if (lane == 0) {
#pragma unroll
      for (int gg = 0; gg < kMaxGroup; ++gg) {
        sM[warp * kMaxGroup + gg] = m[gg];
        sL[warp * kMaxGroup + gg] = l[gg];
      }
    }
#pragma unroll
    for (int gg = 0; gg < kMaxGroup; ++gg) {
      if (gg < group) {
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int i = lane + 32 * c;
          if (i < D) sAcc[(warp * kMaxGroup + gg) * D + i] = acc[gg][c];
        }
      }
    }
  }
  __syncthreads();
  // partials: max and sum [B][n_kv][n_split][group], then the accumulators
  // [B][n_kv][n_split][group][D]
  const size_t n_rows = (size_t)gridDim.y * n_q * n_split;
  float* part_m = part;
  float* part_l = part + n_rows;
  float* part_acc = part + 2 * n_rows;
  const size_t slot_part = ((size_t)b * n_kv + kvh) * n_split;
  for (int idx = tid; idx < group * D; idx += blockDim.x) {
    const int gg = idx / D, i = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sM[w * kMaxGroup + gg]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(sM[w * kMaxGroup + gg] - mx);  // a warp without keys: 0
      den += sL[w * kMaxGroup + gg] * e;
      num += sAcc[(w * kMaxGroup + gg) * D + i] * e;
    }
    if (n_active == 1) {
      out_rows[idx] = from_float<T>(num / den);
    } else {
      const size_t row = (slot_part + split) * group + gg;
      part_acc[row * D + i] = num;
      if (i == 0) {
        part_m[row] = mx;
        part_l[row] = den;
      }
    }
  }
  if (n_active == 1) return;

  // the last of the slot's working splits to arrive merges them all, in
  // split order, and puts the counter back to 0 for the next call
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&counters[(size_t)b * n_kv + kvh], 1) == n_active - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int idx = tid; idx < group * D; idx += blockDim.x) {
    const int gg = idx / D, i = idx % D;
    float mx = -INFINITY;
    for (int sp = first; sp <= last; ++sp)
      mx = fmaxf(mx, __ldcg(part_m + (slot_part + sp) * group + gg));
    float den = 0.f, num = 0.f;
    for (int sp = first; sp <= last; ++sp) {
      const size_t row = (slot_part + sp) * group + gg;
      const float e = expf(__ldcg(part_m + row) - mx);
      den += __ldcg(part_l + row) * e;
      num += __ldcg(part_acc + row * D + i) * e;
    }
    out_rows[idx] = from_float<T>(num / den);
  }
  if (tid == 0) counters[(size_t)b * n_kv + kvh] = 0;
}

template <typename T, typename KV, int D, bool WRITE>
int paged_decode_launch_one(const void* q, void* k_pool, void* k_scale, void* v_pool,
                            void* v_scale, const void* page_table, const void* lengths,
                            const void* k_new, const void* v_new, void* part, void* counters,
                            void* out, int B, int n_q, int n_kv, int pool_pages, int page,
                            int pps, int n_split, float scale, int window, float cap,
                            cudaStream_t stream) {
  constexpr size_t smem = Layout<T, KV, D>::kSmem;
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
      (float*)part, (int*)counters, (T*)out, n_q, n_kv, pool_pages, page, pps, n_split, scale,
      window, cap);
  return (int)cudaGetLastError();
}

// KV = T for a float pool (k_scale/v_scale unused), int8_t for an int8 pool
template <typename T, typename KV>
int paged_decode_launch(const void* q, void* k_pool, void* k_scale, void* v_pool,
                        void* v_scale, const void* page_table, const void* lengths,
                        const void* k_new, const void* v_new, void* part, void* counters,
                        void* out, int B, int n_q, int n_kv, int pool_pages, int page,
                        int pps, int n_split, int d, float scale, int window, float cap,
                        int write, cudaStream_t stream) {
  if (n_q % n_kv != 0 || n_q / n_kv > kMaxGroup) return (int)cudaErrorInvalidValue;
  if (n_split != (pps * page + kSplitKeys - 1) / kSplitKeys) return (int)cudaErrorInvalidValue;
  if (write) {
    LLMK_DISPATCH_D(d, return (paged_decode_launch_one<T, KV, D, true>(
        q, k_pool, k_scale, v_pool, v_scale, page_table, lengths, k_new, v_new, part,
        counters, out, B, n_q, n_kv, pool_pages, page, pps, n_split, scale, window, cap,
        stream)));
  } else {
    LLMK_DISPATCH_D(d, return (paged_decode_launch_one<T, KV, D, false>(
        q, k_pool, k_scale, v_pool, v_scale, page_table, lengths, k_new, v_new, part,
        counters, out, B, n_q, n_kv, pool_pages, page, pps, n_split, scale, window, cap,
        stream)));
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace llmk
