// The routed expert FFN's body for Hopper (sm_90a), shared by the bf16
// expert kernel (moe_experts.cu) and the int8 one (moe_experts_w8.cu): the
// template argument W8 picks the weight tiles and the epilogue, nothing
// else, so both kernels run one walk, one K split and one order of sums
// (the int8 kernel's decode tiles run moe_spread, below: the same split and
// order of sums, reached another way).
//
// For every expert-major row r of expert e (ops/moe.py::moe_route puts
// each kept (token, choice) claim at a row of rows [offset_e, offset_e +
// count_e)), with f32 sums and round() to bf16:
//
//   bf16 weights: h[r] = round(round(SiLU(round(x[src[r]] W_gate[e]))) * round(x[src[r]] W_up[e]))
//                 y[r] = round(h[r] W_down[e])
//   int8 weights: g = round(round(x[src[r]] Wg[e]) * round(sg[e])), u likewise with Wu, su,
//                 h[r] = round(round(SiLU(g)) * u)
//                 y[r] = round(round(h[r] Wd[e]) * round(sd[e]))
//
// (the int8 lines are the JAX qeinsum's two roundings, ops/quant.py:311,
// per product; the plain versions are ops/moe.py::moe_experts_plain). Two
// launches of one body: gate/up (GATED: A rows gathered through src, the
// SiLU product in the epilogue, h [R, F]) and down (A = h's rows in place,
// y [R, D]). Weights keep the JAX layouts: W_gate and W_up [E, D, F],
// W_down [E, F, D], each [K, N] row-major for its expert; int8 scales
// [E, N] f32 (the QTensor's [E, 1, N], the same bytes).
//
// The order of sums (moe_split, mirrored by ops/moe.py::moe_splits): K is
// cut into S slices, S a power of two from K and the columns a launch
// streams (2F for gate/up, D for down) alone (hopper.cuh make_split, units
// of 64 rows, or 32 where 64 does not divide K). Every output is
//   1. per slice, one f32 wgmma chain of 16-deep steps in increasing k,
//      started by its first step (scale-d 0, no zeroing);
//   2. the slice results summed in slice order, ((c0 + c1) + c2) + ...,
//      in f32;
//   3. the epilogue: the roundings above.
// The kernel computes exactly this, from the same fragments on the same
// instructions in every tile size, so a row's result is the same bits at
// any R, wherever it falls in a tile (held on the card: chip_smoke.py phase
// 9 A and tests/test_torch_cuda.py hold a row alone, on 8-row tiles, to
// the same row among R rows, on tiles of up to 128).
//
// Every launch computes out^T = W^T x^T on wgmma (hopper.cuh): a 64-column
// weight tile is the A operand, in registers, and the rows of x or h are
// the shared-memory B operand, so the rows are wgmma's N and a tile pads at
// most to 8 rows. A bf16 tile ([64 k, 64 columns], 128-byte rows, 128-byte
// swizzle) is read by ldmatrix.trans; an int8 tile ([64 k, 64 columns],
// 64-byte rows, 64-byte swizzle, half the bytes) by ldmatrix.trans too, as
// b16 words (one x4 for two steps; 16-bit shared loads measured 5% slower
// at Mixtral's decode shape), converted to bf16 in registers (s8_word,
// exact: no bf16 copy of a weight is ever written). Column 16 wn + 2c + h
// of an int8 tile is A row c + 8h of warp wn (column 16 wn + c + 8h for
// bf16). Hopper's
// TMA has no row gather: the gate/up launch copies its rows x[src[r]] 16
// bytes at a time with cp.async into the swizzle the descriptor reads
// (completion counted on the stage's mbarrier: cp.async.mbarrier.arrive
// .noinc; a one-row TMA box a row lands right too, but measured 2.6x slower
// at 32,768 rows: the TMA issue is the cost); the down launch reads h's rows
// in place by TMA. A block's two 64-column weight tiles are, for gate/up,
// the gate and the up columns of the same 64 outputs, for down 128 output
// columns.
//
// moe_stream, in tiles of 8, 16, 32, 64 or 128 rows (the least that holds
// min(R, tokens), the most rows an expert can take): one persistent block
// an SM walks the work list (row tile within an expert, column tile), row
// tile by row tile, so the blocks that run side by side share one row
// tile's rows and one expert's weights in L2 (walking an expert's column
// tiles over its row tiles instead measured slower, at both models'
// widths); the list comes from tables of each expert's first tile and row,
// built in shared memory from the counts when the block starts. A producer
// warpgroup keeps a ring of 4 to 8 stages full (TMA weight tiles, the
// gathered rows by cp.async) and gives its registers to two consumer
// warpgroups (setmaxnreg); consumer T runs weight tile T through every
// slice in order, the slice's chain and the sum of the finished slices in
// registers, and the epilogue stages the tile in shared memory for 16-byte
// row stores while the producer already loads the next item. The grid is
// one block an SM and the work is found on the card with no host read, so
// a captured CUDA graph holds the two launches as they are. The int8
// kernel runs its tiles of 8 to 32 rows on a body of its own, moe_spread
// (below), where its K split allows.
//
// ptxas serializes every wgmma of a function (C7520, printed by
// chip_smoke.py's ptxas report) that touches an accumulator while a wgmma
// is in flight or puts code it takes as divergent there: hence scale-d 0
// starts, the slice sums only after wait_group 0, loop bounds made uniform
// with a shuffle, and copies issued as predicated instructions.
#pragma once

#include <type_traits>

#include "hopper.cuh"

using namespace llmk;

namespace {

constexpr int kCols = 64;                // weight columns a wgmma tile (its A rows)
constexpr int kMaxPow2Rows = 64;         // rows a tile of 8 to 64 at most
constexpr int kPreRows = 128;            // rows a tile above: the widest wgmma it runs
constexpr int kMaxExperts = 512;         // the tile tables (shared memory)

// bytes of a staged [64 k, 64 columns] weight tile: bf16, or int8 (W8)
template <bool W8>
constexpr int kWTile = kBK * kCols * (W8 ? 1 : 2);

// the K split of a launch over K rows that streams Nw weight columns an
// expert (2F for gate/up, D for down)
__host__ __device__ inline Split moe_split(int K, int Nw) {
  return make_split(K, Nw, K % kBK == 0 ? kBK : 32);
}

// column tiles of a launch: 64 outputs (128 weight columns) for gate/up,
// 128 for down
__host__ __device__ inline int col_tiles(int N, bool gated) {
  return gated ? (N + kCols - 1) / kCols : (N + 2 * kCols - 1) / (2 * kCols);
}

// h = round(round(SiLU(g)) * u) for rounded g and u, SiLU as torch computes
// it in float: g / (1 + exp(-g))
__device__ __forceinline__ float silu_mul(float acc_g, float acc_u) {
  const float g = round_bf16(acc_g), u = round_bf16(acc_u);
  const float s = round_bf16(g / (1.0f + expf(-g)));
  return s * u;
}

// one arrival where `on` (predicated, not branched: see hopper.cuh
// tma_load_if)
__device__ __forceinline__ void mbar_arrive_if(bool on, uint64_t* bar) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %1, 0;\n"
      " @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_addr(bar)), "r"((int)on)
      : "memory");
}

// where `on`: 16 bytes from src to dst (zeros where !in)
__device__ __forceinline__ void cp16_if(bool on, void* dst, const void* src, bool in) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %3, 0;\n"
      " @p cp.async.cg.shared.global [%0], [%1], 16, %2;\n}\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(in ? 16 : 0), "r"((int)on)
      : "memory");
}

// one arrival on the stage's mbarrier once every copy this thread has
// issued so far has landed
__device__ __forceinline__ void cp_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// rows written by cp.async (the generic proxy), then read by wgmma (the
// async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- the work list: tiles of BM rows within each expert, experts in order ----

// the tile tables, by one warp: tstart[e] the first tile of
// expert e (tiles of BM rows), rstart[e] its first row; entry E holds the
// totals
__device__ void tile_tables(const int* __restrict__ counts, int E, int BM, int* tstart,
                            int* rstart) {
  const int lane = threadIdx.x % 32;
  int tbase = 0, rbase = 0;
  for (int c0 = 0; c0 < E; c0 += 32) {
    const int e = c0 + lane;
    const int cnt = e < E ? counts[e] : 0;
    const int nt = (cnt + BM - 1) / BM;
    int ti = nt, ri = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int ta = __shfl_up_sync(LLMK_FULL_MASK, ti, o);
      const int ra = __shfl_up_sync(LLMK_FULL_MASK, ri, o);
      if (lane >= o) ti += ta, ri += ra;
    }
    if (e < E) tstart[e] = tbase + ti - nt, rstart[e] = rbase + ri - cnt;
    tbase += __shfl_sync(LLMK_FULL_MASK, ti, 31);
    rbase += __shfl_sync(LLMK_FULL_MASK, ri, 31);
  }
  if (lane == 0) tstart[E] = tbase, rstart[E] = rbase;
}

// (expert, first row, rows) of tile t < tstart[E] from the tables: the last
// expert whose first tile is at most t (experts without rows start where the
// next one does, so the search passes them)
__device__ __forceinline__ int3 lookup_tile(const int* tstart, const int* rstart, int E, int t,
                                            int BM) {
  int lo = 0, hi = E;  // tstart[lo] <= t < tstart[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (tstart[mid] <= t) lo = mid; else hi = mid;
  }
  const int local = t - tstart[lo];
  return make_int3(lo, rstart[lo] + local * BM,
                   min(BM, rstart[lo + 1] - rstart[lo] - local * BM));
}

// -- fragments ----------------------------------------------------------------

// byte offset of (row r, byte b) in a tile of 64-byte rows, 64-byte swizzle
// (16-byte chunk c of row r lands at chunk c ^ ((r / 2) % 4))
__device__ __forceinline__ int swz64(int r, int b) {
  return r * 64 + ((((b >> 4) ^ (r >> 1)) & 3) << 4) + (b & 15);
}

// bytes J and 2 + J of w (k rows 2tq and 2tq + 1 of one column, as
// ldmatrix.trans gives them) as one bf16 pair, exactly: s8_pair on one word
template <int J>
__device__ __forceinline__ uint32_t s8_word(uint32_t w) {
  constexpr uint32_t kSel = J | (J << 4) | ((2 + J) << 8) | ((2 + J) << 12);
  const uint32_t p = __byte_perm(w, 0u, kSel);
  const uint32_t v = (p & 0x007F007Fu) | 0x43004300u;  // 128 + l
  const uint32_t s = (p & 0x00800080u) | 0x43004300u;  // 128 + 128 h
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(s), "r"(0xBF80BF80u), "r"(v));
  return r;  // v - s
}

// A fragments of the four steps of a staged 64-deep tile for warp wn. bf16:
// the tile's columns 16 wn .. + 15 as wgmma rows, k rows 16 kk .. + 15, by
// ldmatrix.trans (matrix j of four: columns + 8 (j & 1), k rows + 8 (j >>
// 1)). int8: the tile read as b16 words (two columns a word), the warp's
// 16-byte chunk of 32 k rows by one ldmatrix.x4.trans (matrix j: k rows 8j
// .. 8j + 7, its 8 rows 64 bytes apart in 4 distinct chunks of the 64-byte
// swizzle, so no bank conflict), which gives lane (g, tq) the words of
// columns 16 wn + 2g, + 1 (A rows g and g + 8) at k rows 2tq and 2tq + 1 in
// one register: k rows 16 kk + 2tq, + 1, + 8, + 9 of two steps; converted
// exactly
template <bool W8>
__device__ __forceinline__ void w_frags(uint32_t (&f)[kBK / 16][4], const uint8_t* w, int wn,
                                        int lane) {
  if constexpr (W8) {
#pragma unroll
    for (int h = 0; h < kBK / 32; ++h) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, w + swz64(32 * h + lane, wn * 16));
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t(&fk)[4] = f[2 * h + j];
        fk[0] = s8_word<0>(r[2 * j]), fk[1] = s8_word<1>(r[2 * j]);
        fk[2] = s8_word<0>(r[2 * j + 1]), fk[3] = s8_word<1>(r[2 * j + 1]);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const int k = kk * 16 + ((lane >> 4) & 1) * 8 + (lane & 7);
      ldmatrix_x4_trans(f[kk], w + swz(k, wn * 32 + ((lane >> 3) & 1) * 16));
    }
  }
}

// the weight column (within a 64-column tile) of accumulator element i of
// lane g's warp wn: A row g + 8 ((i >> 1) & 1)
template <bool W8>
__device__ __forceinline__ int acc_col(int i, int wn, int g) {
  return W8 ? 16 * wn + 2 * g + ((i >> 1) & 1) : 16 * wn + g + 8 * ((i >> 1) & 1);
}

// the gate/up launch's rows of one stage, by one warpgroup: NROWS rows of
// x [*, K] at k0 through the row indices `arow` (-1: zeros), 16-byte chunks
// into a tile of 128-byte rows (128-byte swizzle); thread i copies chunks
// i, i + 128, ...; the caller then arrives on the stage's barrier
// (cp_arrive; gathering with fewer threads measured slower: the copies'
// issue, not their arrivals, is what costs)
template <int NROWS>
__device__ __forceinline__ void gather_rows(uint8_t* dst, const __nv_bfloat16* x,
                                            const int* arow, int k0, int K, int tid) {
  constexpr int kChunks = NROWS * 8;
#pragma unroll 2
  for (int j = 0; j < (kChunks + 127) / 128; ++j) {
    const int q = tid + j * 128, r = (q / 8) % NROWS, c = q % 8;
    const int ar = arow[r];
    const bool in = ar >= 0 && k0 + 8 * c < K;
    cp16_if(q < kChunks, dst + swz(r, 16 * c),
            x + (in ? (size_t)ar * K + k0 + 8 * c : 0), in);
  }
}

// -- the body: persistent blocks, a producer and two consumers ----------------

template <int NX, bool W8>
struct StreamCfg {
  static constexpr int kConsumers = 256;             // warpgroup T: weight tile T
  static constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
  // registers a thread (setmaxnreg): the consumers take what the producer
  // gives up, within what the block holds at launch (168 a thread: 65,536
  // over 384 threads, in steps of 8); asking for more than that would
  // stall setmaxnreg.inc for good
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kConsumerRegs = 232, kProducerRegs = 40;
  static_assert(kConsumers * kConsumerRegs + 128 * kProducerRegs <= kThreads * kLaunchRegs,
                "registers");
  static_assert(NX % 8 == 0 && NX <= kPreRows, "tiles of 8 to 128 rows");
  static constexpr int kWT = kWTile<W8>;
  static constexpr int kXTile = NX * 128;            // bytes: NX rows of 64 bf16
  static constexpr int kStage = kXTile + 2 * kWT;
  static constexpr int kOStride = 2 * kCols + 8;     // bf16 a staged output row
  static constexpr int kOut = NX * kOStride * 2;
  static constexpr int kUp = NX / 2 * 128 * 2;       // the up warpgroup's rounded sums
  // as many stages as fit (at most 8) beside 1024 for alignment, the
  // output tile and the up sums
  static constexpr int kFit =
      (232448 - 1024 - 256 - 8 * (kMaxExperts + 1) - 4 * NX - kOut - kUp) / kStage;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kSmem = 1024 + kStages * kStage + kOut + kUp;
  static_assert(kStages >= 4, "a ring of at least 4 stages");
  static_assert(kXTile % 1024 == 0 && kWT % 1024 == 0, "swizzled tiles 1024-aligned");
};

// scale0, scale1: the int8 launches' scales [E, N] f32 of tile 0 and tile 1
// (gate and up, or down twice); unread for bf16
template <int NX, bool GATED, bool W8>
__global__ void __launch_bounds__(StreamCfg<NX, W8>::kThreads, 1)
moe_stream(const __grid_constant__ CUtensorMap tw0, const __grid_constant__ CUtensorMap tw1,
           const __grid_constant__ CUtensorMap ta, const __nv_bfloat16* __restrict__ x,
           const int* __restrict__ src, const int* __restrict__ counts,
           const float* __restrict__ scale0, const float* __restrict__ scale1,
           __nv_bfloat16* __restrict__ out, int E, int K, int N) {
  using C = StreamCfg<NX, W8>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[C::kStages], empty[C::kStages];
  __shared__ int tstart[kMaxExperts + 1], rstart[kMaxExperts + 1];
  __shared__ int arow[NX];  // gate/up: the x row of each row of the producer's item
  uint8_t* ring = align1024(smem_raw);
  __nv_bfloat16* ostage = reinterpret_cast<__nv_bfloat16*>(ring + C::kStages * C::kStage);
  __nv_bfloat16* ustage = ostage + C::kOut / 2;
  const Split sp = moe_split(K, GATED ? 2 * N : N);
  const int warp = __shfl_sync(LLMK_FULL_MASK, (int)threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int ncol = col_tiles(N, GATED);
  int per_item = 0;  // staged tiles an item
  for (int s = 0; s < sp.S; ++s)
    per_item += (slice_edge(sp, s + 1) - slice_edge(sp, s) + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s)
      mbar_init_n(&full[s], GATED ? 129 : 1), mbar_init_n(&empty[s], C::kConsumers / 32);
    mbar_init_fence();
  }
  if (warp == 0) tile_tables(counts, E, NX, tstart, rstart);
  __syncthreads();
  // work items, broadcast from lane 0 so that the compiler sees the walk's
  // bounds as uniform (ptxas C7520)
  const int total = __shfl_sync(LLMK_FULL_MASK, ncol * tstart[E], 0);

  if (warp >= C::kConsumers / 32) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    const int p = threadIdx.x - C::kConsumers;
    int it = 0;
    for (int w = blockIdx.x; w < total; w += gridDim.x) {
      const int3 tl = lookup_tile(tstart, rstart, E, w / ncol, NX);
      const int c0 = (w % ncol) * (GATED ? kCols : 2 * kCols), wrow = tl.x * K;
      if constexpr (GATED) {  // the item's x rows, once every thread is past the last item's
        named_sync(3, 128);
        if (p < NX) arow[p] = p < tl.z ? src[tl.y + p] : -1;
        named_sync(3, 128);
      }
      TileCursor ld;
      ld.start(sp);
      for (int j = 0; j < per_item; ++j, ++it) {
        const int s = it % C::kStages;
        if (it >= C::kStages) mbar_wait(&empty[s], (it / C::kStages - 1) & 1);
        uint8_t* st = ring + s * C::kStage;
        if (p == 0) {
          mbar_expect(&full[s], 2 * C::kWT + (GATED ? 0 : C::kXTile));
          tma_load(st + C::kXTile, &tw0, c0, wrow + ld.k0, &full[s]);
          tma_load(st + C::kXTile + C::kWT, &tw1, GATED ? c0 : c0 + kCols, wrow + ld.k0,
                   &full[s]);
          if (!GATED) tma_load(st, &ta, ld.k0, tl.y, &full[s]);
        }
        if constexpr (GATED) {
          gather_rows<NX>(st, x, arow, ld.k0, K, p);
          cp_arrive(&full[s]);
        }
        ld.next(sp);
      }
    }
    if constexpr (GATED) cp_async_wait<0>();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));

  const int T = warp / 4, wn = warp % 4, g = lane >> 2, tq = lane & 3;
  const int tw = threadIdx.x % 128;  // the thread within its warpgroup
  const int bid = blockIdx.x, grid = gridDim.x;
  const int items = total > bid ? (total - bid + grid - 1) / grid : 0;
  const int my_tiles = items * per_item;

  // chain: the current slice's (element i: tile row 8 (i >> 2) + 2tq + (i &
  // 1), weight column acc_col(i) of tile T); tot: the finished slices
  // summed in order
  float chain[NX / 2], tot[NX / 2];
#pragma unroll
  for (int i = 0; i < NX / 2; ++i) chain[i] = tot[i] = 0.f;
  uint32_t af[2][kBK / 16][4];
  auto arrive_frags = [&](uint32_t(&f)[kBK / 16][4], int t) {
    mbar_wait(&full[t % C::kStages], (t / C::kStages) & 1);
    if constexpr (GATED) fence_async_smem();
    w_frags<W8>(f, ring + (t % C::kStages) * C::kStage + C::kXTile + T * C::kWT, wn, lane);
  };
  // the item's epilogue, with no wgmma in flight: gate/up, the up
  // warpgroup's rounded sums pass through shared memory to the gate
  // warpgroup, which stages h; down, both stage y; then 16-byte row stores.
  // int8: each sum is first rounded and times its column's rounded scale
  auto epilogue = [&](int w) {
    const int3 tl = lookup_tile(tstart, rstart, E, w / ncol, NX);
    const int row0 = __shfl_sync(LLMK_FULL_MASK, tl.y, 0);
    const int rows = __shfl_sync(LLMK_FULL_MASK, tl.z, 0), c = w % ncol;
    const int nc = c * (GATED ? kCols : 2 * kCols);
    float sc[2] = {1.f, 1.f};  // the scales of this thread's two columns
    if constexpr (W8) {
      const float* s = T == 0 ? scale0 : scale1;
      const int e = __shfl_sync(LLMK_FULL_MASK, tl.x, 0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = nc + (GATED ? 0 : T * kCols) + acc_col<W8>(2 * h, wn, g);
        sc[h] = col < N ? round_bf16(s[(size_t)e * N + col]) : 0.f;
      }
    }
    auto scaled = [&](int i) { return W8 ? round_bf16(tot[i]) * sc[(i >> 1) & 1] : tot[i]; };
    named_sync(2, C::kConsumers);  // the previous item's stores are done
    if constexpr (GATED) {
      if (T == 1) {
#pragma unroll
        for (int i = 0; i < NX / 2; ++i) ustage[i * 128 + tw] = __float2bfloat16_rn(scaled(i));
      }
      named_sync(2, C::kConsumers);
      if (T == 0) {
#pragma unroll
        for (int i = 0; i < NX / 2; ++i) {
          const float h = silu_mul(scaled(i), __bfloat162float(ustage[i * 128 + tw]));
          ostage[(8 * (i >> 2) + 2 * tq + (i & 1)) * C::kOStride + acc_col<W8>(i, wn, g)] =
              __float2bfloat16_rn(h);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < NX / 2; ++i)
        ostage[(8 * (i >> 2) + 2 * tq + (i & 1)) * C::kOStride + T * kCols +
               acc_col<W8>(i, wn, g)] = __float2bfloat16_rn(scaled(i));
    }
    named_sync(2, C::kConsumers);
    constexpr int kChunks = (GATED ? kCols : 2 * kCols) / 8;  // 16-byte chunks a row
#pragma unroll
    for (int j = 0; j < (NX * kChunks + C::kConsumers - 1) / C::kConsumers; ++j) {
      const int q = threadIdx.x + j * C::kConsumers, r = q / kChunks, ch = q % kChunks;
      if (r < rows && nc + 8 * ch < N)
        *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * N + nc + 8 * ch) =
            *reinterpret_cast<const uint4*>(ostage + r * C::kOStride + 8 * ch);
    }
  };

  TileCursor cur;
  cur.start(sp);
  int w = blockIdx.x;
  // tile t of this block's walk: its steps on af[P];
  // while they run, tile t - 1's are waited for, its stage released and tile
  // t + 1's fragments read; where a slice ends, its chain joins the sum
  // (wait_group 0 first), and where the item ends, the epilogue
  auto run = [&](auto parity, int t) {
    constexpr int P = decltype(parity)::value;
    const uint8_t* st = ring + (t % C::kStages) * C::kStage;
    const int k0 = cur.k0, steps = min(kBK, cur.ke - k0) / 16;
    const bool first = k0 == slice_edge(sp, cur.s);
    auto step = [&](int kk) {
      wgmma_rs<NX>(chain, af[P][kk], desc_b(st + kk * 32), !(first && kk == 0));
    };
    wg_fence();
    if (steps == kBK / 16) {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) step(kk);
    } else {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        if (kk < steps) step(kk);
    }
    wg_commit();
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // tile t - 1's done
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) pin(af[1 - P][kk]);
    // tile t - 1's stage, one arrival a warp (its lanes' reads are done:
    // the wgmma that read it has completed)
    mbar_arrive_if(t > 0 && lane == 0, &empty[(t - 1 + C::kStages) % C::kStages]);
    if (t + 1 < my_tiles) arrive_frags(af[1 - P], t + 1);
    if (cur.last()) {  // the slice's chain is whole: add it, slice order
      wg_wait();
      pin(chain);
      const bool s0 = cur.s == 0;
#pragma unroll
      for (int i = 0; i < NX / 2; ++i) tot[i] = s0 ? chain[i] : tot[i] + chain[i];
      if (cur.s == sp.S - 1) {
        epilogue(w);
        w += gridDim.x;
      }
    }
    cur.next(sp);
    if (cur.s == sp.S) cur.start(sp);
  };
  if (my_tiles) arrive_frags(af[0], 0);
  for (int t = 0; t < my_tiles; t += 2) {
    run(std::integral_constant<int, 0>(), t);
    if (t + 1 < my_tiles) run(std::integral_constant<int, 1>(), t + 1);
  }
}

// -- the int8 decode body: slices side by side, spread over a cluster ---------------
//
// moe_spread, the int8 kernel's tiles of 8 to 32 rows (decode). The same
// walk, split, fragments and order of sums as moe_stream, so a row's bits
// are the same, reached another way: a consumer warpgroup runs kChains
// slices side by side, one chain each (a stage holds a 64-deep tile of
// each, 128 k rows: one barrier round trip and one wait_group for two
// independent chains), and where a launch makes few items for the card (the
// Mixtral down launch: 32 column tiles x 6-8 experts over 132 SMs), an
// item's S slices spread over a thread-block cluster of S / kChains blocks,
// each running one group of kChains slices (make_split's slice groups). Items
// go to clusters as they went to blocks. At an item's end each block puts
// its chains (spread) or, alone, the sum of its slices in order (local) in
// a partial buffer in shared memory (two, by item parity), one lane
// arrives on each cluster block's `ready` barrier, all wait on their own,
// and fold their block's share of the item's outputs over all the
// cluster's partials in slice order,
// ((c0 + c1) + c2) + ..., reading them through distributed shared memory,
// then the epilogue's roundings, from registers to 8-byte row stores. A
// block waits for every block's arrival for item i + 1 before writing item
// i + 2's partials into the buffer item i used: every block has read item
// i's by then. The grid (clusters that fit the card, at most one block an
// SM) follows from the widths and the tile size alone, so a captured graph
// replays it as it is. Measured on one H100 (scripts/time_moe_variants.py
// --w8): Mixtral-8x7B R 16 about 0.47 ms against moe_stream's 0.71 (bound
// 0.316); one chain a warpgroup 15% slower, never spread 2% slower (its
// down launch 8%), no wgmma at all 3% faster, no weight loads 13% faster,
// no fold 8% faster. The fold's partials are loaded 8 at a time before
// they are summed: one at a time, each remote load's latency in turn,
// cost the spread its gain.
constexpr int kChains = 2;        // slices a consumer warpgroup runs side by side
constexpr int kSpreadItems = 4;   // spread where column tiles x experts < this x SMs

template <int NX>
struct SpreadCfg {
  static constexpr int kConsumers = 256;             // warpgroup T: weight tile T
  static constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kConsumerRegs = 232, kProducerRegs = 40;
  static_assert(kConsumers * kConsumerRegs + 128 * kProducerRegs <= kThreads * kLaunchRegs,
                "registers");
  static_assert(NX % 8 == 0 && NX <= 32, "tiles of 8 to 32 rows");
  static constexpr int kWT = kBK * kCols;            // an int8 [64 k, 64 columns] tile
  static constexpr int kXTile = NX * 128;            // NX rows of 64 bf16
  static constexpr int kSub = kXTile + 2 * kWT;      // one slice's tiles in a stage
  static constexpr int kStage = kChains * kSub;
  static constexpr int kPStride = kCols + 4;         // floats a partial row
  static constexpr int kEntry = 2 * NX * kPStride;   // floats: a chain of both tiles
  static constexpr int kPart = kChains * kEntry;     // floats a partial buffer
  static constexpr int kFit = (232448 - 1024 - 512 - 8 * (kMaxExperts + 1) - 4 * NX -
                               2 * kPart * 4) / kStage;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kSmem = 1024 + kStages * kStage + 2 * kPart * 4;
  static_assert(kStages >= 4, "a ring of at least 4 stages");
  static_assert(kXTile % 1024 == 0 && kWT % 1024 == 0, "swizzled tiles 1024-aligned");
};

// the launches this body takes: K cut into at least kChains slices of one
// whole number of 64-row tiles each, so every stage is kChains whole tiles
// (a branch around a short tile's steps beside the fold made ptxas
// serialize the wgmma of the 8-row instantiations, C7520)
__host__ __device__ inline bool spread_split(int K, int Nw) {
  const Split sp = moe_split(K, Nw);
  return K % kBK == 0 && sp.S >= kChains && (K / kBK) % sp.S == 0;
}

__device__ __forceinline__ uint32_t cluster_reg(int which) {
  uint32_t v;
  if (which == 0) asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(v));
  else if (which == 1) asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(v));
  else if (which == 2) asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(v));
  else asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(v));
  return v;
}

// every thread of every block of the cluster (not aligned: the producer and
// the consumers reach it from different code)
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// one arrival on cluster block `rank`'s copy of the barrier at `bar`
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, int rank) {
  asm volatile(
      "{\n .reg .b32 ra;\n mapa.shared::cluster.u32 ra, %0, %1;\n"
      " mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n}\n" ::"r"(smem_addr(bar)),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// four floats at `p` (16-byte aligned, this block's shared memory) of
// cluster block `rank`'s copy
__device__ __forceinline__ float4 ld_dsmem4(const float* p, int rank) {
  float4 v;
  asm volatile(
      "{\n .reg .b32 ra;\n mapa.shared::cluster.u32 ra, %4, %5;\n"
      " ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [ra];\n}\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "r"(smem_addr(p)), "r"(rank)
      : "memory");
  return v;
}

template <int NX, bool GATED>
__global__ void __launch_bounds__(SpreadCfg<NX>::kThreads, 1)
moe_spread(const __grid_constant__ CUtensorMap tw0, const __grid_constant__ CUtensorMap tw1,
           const __grid_constant__ CUtensorMap ta, const __nv_bfloat16* __restrict__ x,
           const int* __restrict__ src, const int* __restrict__ counts,
           const float* __restrict__ scale0, const float* __restrict__ scale1,
           __nv_bfloat16* __restrict__ out, int E, int K, int N) {
  using C = SpreadCfg<NX>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[C::kStages], empty[C::kStages], ready[2];
  __shared__ int tstart[kMaxExperts + 1], rstart[kMaxExperts + 1];
  __shared__ int arow[NX];  // gate/up: the x row of each row of the producer's item
  uint8_t* ring = align1024(smem_raw);
  float* part = reinterpret_cast<float*>(ring + C::kStages * C::kStage);
  const Split sp = moe_split(K, GATED ? 2 * N : N);
  const int warp = __shfl_sync(LLMK_FULL_MASK, (int)threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int ncol = col_tiles(N, GATED);
  // the cluster: KC blocks (1: local), this block's rank, the cluster's
  // index and the clusters of the grid
  const int KC = __shfl_sync(LLMK_FULL_MASK, (int)cluster_reg(1), 0);
  const int rank = __shfl_sync(LLMK_FULL_MASK, (int)cluster_reg(0), 0);
  const int cl = __shfl_sync(LLMK_FULL_MASK, (int)cluster_reg(2), 0);
  const int ncl = __shfl_sync(LLMK_FULL_MASK, (int)cluster_reg(3), 0);
  // this block's slice groups: its own (spread), or every group (local);
  // every slice is `rounds` whole 64-row tiles (spread_split), L rows
  const int g_lo = KC > 1 ? rank : 0;
  const int g_hi = KC > 1 ? rank + 1 : sp.S / kChains;
  const int L = K / sp.S, rounds = L / kBK;
  const int per_item = (g_hi - g_lo) * rounds;  // stages an item
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s)
      mbar_init_n(&full[s], GATED ? 129 : 1), mbar_init_n(&empty[s], C::kConsumers / 32);
    for (int b = 0; b < 2; ++b) mbar_init_n(&ready[b], KC);  // one arrival a block
    mbar_init_fence();
  }
  if (warp == 0) tile_tables(counts, E, NX, tstart, rstart);
  cluster_sync_all();  // every block's barriers are set up before any remote arrival
  const int total = __shfl_sync(LLMK_FULL_MASK, ncol * tstart[E], 0);

  if (warp >= C::kConsumers / 32) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    const int p = threadIdx.x - C::kConsumers;
    int it = 0;
    for (int w = cl; w < total; w += ncl) {
      const int3 tl = lookup_tile(tstart, rstart, E, w / ncol, NX);
      const int c0 = (w % ncol) * (GATED ? kCols : 2 * kCols), wrow = tl.x * K;
      if constexpr (GATED) {  // the item's x rows, once every thread is past the last item's
        named_sync(3, 128);
        if (p < NX) arow[p] = p < tl.z ? src[tl.y + p] : -1;
        named_sync(3, 128);
      }
      for (int g = g_lo; g < g_hi; ++g) {
        for (int j = 0; j < rounds; ++j, ++it) {
          const int s = it % C::kStages;
          if (it >= C::kStages) mbar_wait(&empty[s], (it / C::kStages - 1) & 1);
          uint8_t* st = ring + s * C::kStage;
          if (p == 0) {
            mbar_expect(&full[s], kChains * (2 * C::kWT + (GATED ? 0 : C::kXTile)));
#pragma unroll
            for (int i = 0; i < kChains; ++i) {
              uint8_t* sub = st + i * C::kSub;
              const int k0 = (g * kChains + i) * L + j * kBK;
              tma_load(sub + C::kXTile, &tw0, c0, wrow + k0, &full[s]);
              tma_load(sub + C::kXTile + C::kWT, &tw1, GATED ? c0 : c0 + kCols, wrow + k0,
                       &full[s]);
              if (!GATED) tma_load(sub, &ta, k0, tl.y, &full[s]);
            }
          }
          if constexpr (GATED) {
#pragma unroll
            for (int i = 0; i < kChains; ++i)
              gather_rows<NX>(st + i * C::kSub, x, arow, (g * kChains + i) * L + j * kBK, K, p);
            cp_arrive(&full[s]);
          }
        }
      }
    }
    if constexpr (GATED) cp_async_wait<0>();
    cluster_sync_all();  // no block leaves while another may read its partials
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));

  const int T = warp / 4, wn = warp % 4, g = lane >> 2, tq = lane & 3;
  const int my_items = total > cl ? (total - cl + ncl - 1) / ncl : 0;
  const int my_stages = my_items * per_item;

  // chain[i]: slice g_cur kChains + i's chain of the current item (element
  // e: tile row 8 (e >> 2) + 2tq + (e & 1), weight column acc_col(e) of
  // tile T); tot (local): the item's finished slices summed in order
  float chain[kChains][NX / 2], tot[NX / 2];
#pragma unroll
  for (int i = 0; i < kChains; ++i)
#pragma unroll
    for (int e = 0; e < NX / 2; ++e) chain[i][e] = 0.f;
#pragma unroll
  for (int e = 0; e < NX / 2; ++e) tot[e] = 0.f;
  uint32_t af[2][kChains][kBK / 16][4];
  auto arrive_frags = [&](uint32_t(&f)[kChains][kBK / 16][4], int t) {
    mbar_wait(&full[t % C::kStages], (t / C::kStages) & 1);
    if constexpr (GATED) fence_async_smem();
    const uint8_t* st = ring + (t % C::kStages) * C::kStage + C::kXTile + T * C::kWT;
#pragma unroll
    for (int i = 0; i < kChains; ++i) w_frags<true>(f[i], st + i * C::kSub, wn, lane);
  };

  // item w's end, with no wgmma in flight: this block's partials (spread:
  // its chains; local: tot) into buffer n & 1; this thread's share of the
  // item's outputs (its tile, columns and scales, the scales' loads in
  // flight across the barrier); the consumers' named barrier, then one
  // lane's release arrival on each cluster block's `ready` (it covers the
  // other threads' partials: they are ordered before it by the barrier),
  // the wait for every block's; then the share summed over the S slices
  // in order and rounded as the epilogue of moe_stream rounds it
  constexpr int kQuads = (GATED ? kCols : 2 * kCols) / 4;  // 4-column groups a row
  constexpr int kIters = (NX * kQuads + C::kConsumers - 1) / C::kConsumers;
  auto fold = [&](int w, int n) {
    float* buf = part + (n & 1) * C::kPart;
    float* mine = buf + T * NX * C::kPStride + 16 * wn + 2 * g;
#pragma unroll
    for (int q = 0; q < NX / 8; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 8 * q + 2 * tq + h, e0 = 4 * q + h;
        if (KC > 1) {
#pragma unroll
          for (int i = 0; i < kChains; ++i)
            *reinterpret_cast<float2*>(mine + i * C::kEntry + row * C::kPStride) =
                make_float2(chain[i][e0], chain[i][e0 + 2]);
        } else {
          *reinterpret_cast<float2*>(mine + row * C::kPStride) = make_float2(tot[e0], tot[e0 + 2]);
        }
      }
    const int3 tl = lookup_tile(tstart, rstart, E, w / ncol, NX);
    const int nc = (w % ncol) * (GATED ? kCols : 2 * kCols);
    float4 sa[kIters], sb[kIters];
    bool on[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int q = (rank + it * KC) * C::kConsumers + (int)threadIdx.x;
      const int m = q / kQuads, col = nc + (q % kQuads) * 4;
      on[it] = q < NX * kQuads && m < tl.z && col < N;
      if (on[it]) {
        sa[it] = *reinterpret_cast<const float4*>(scale0 + (size_t)tl.x * N + col);
        if constexpr (GATED) sb[it] = *reinterpret_cast<const float4*>(scale1 + (size_t)tl.x * N + col);
      }
    }
    named_sync(1, C::kConsumers);
    if (threadIdx.x < KC) {  // one lane a cluster block, side by side
      asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
      mbar_arrive_remote(&ready[n & 1], threadIdx.x);
    }
    mbar_wait_cluster(&ready[n & 1], (n >> 1) & 1);

    const int entries = KC > 1 ? sp.S : 1;
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      if (!on[it]) continue;
      const int q = (rank + it * KC) * C::kConsumers + (int)threadIdx.x;
      const int m = q / kQuads, c4 = (q % kQuads) * 4, col = nc + c4;
      // gate/up: the gate tile (0) and the up tile (1) at c4; down: tile c4 / 64
      const int t0 = GATED ? 0 : c4 / kCols, tc = GATED ? c4 : c4 % kCols;
      const int off = m * C::kPStride + tc;
      // the partials kLoads at a time: their loads first (in flight side by
      // side), then their sums in slice order
      constexpr int kLoads = 8;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      for (int s0 = 0; s0 < entries; s0 += kLoads) {
        float4 va[kLoads], vb[kLoads];
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const int s = s0 + j;
          if (s >= entries) break;
          const int blk = KC > 1 ? s / kChains : rank, slot = KC > 1 ? s % kChains : 0;
          const float* base = buf + slot * C::kEntry + off;
          va[j] = ld_dsmem4(base + t0 * NX * C::kPStride, blk);
          if constexpr (GATED) vb[j] = ld_dsmem4(base + NX * C::kPStride, blk);
        }
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const int s = s0 + j;
          if (s >= entries) break;
          if (s == 0) {
            a = va[j];
            if constexpr (GATED) b = vb[j];
            continue;
          }
          a.x = a.x + va[j].x, a.y = a.y + va[j].y, a.z = a.z + va[j].z, a.w = a.w + va[j].w;
          if constexpr (GATED)
            b.x = b.x + vb[j].x, b.y = b.y + vb[j].y, b.z = b.z + vb[j].z, b.w = b.w + vb[j].w;
        }
      }
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
      const float s0v[4] = {sa[it].x, sa[it].y, sa[it].z, sa[it].w};
      float r[4];
      if constexpr (GATED) {
        const float s1v[4] = {sb[it].x, sb[it].y, sb[it].z, sb[it].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float u = __bfloat162float(__float2bfloat16_rn(round_bf16(bv[j]) * round_bf16(s1v[j])));
          r[j] = silu_mul(round_bf16(av[j]) * round_bf16(s0v[j]), u);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) r[j] = round_bf16(av[j]) * round_bf16(s0v[j]);
      }
      *reinterpret_cast<uint2*>(out + (size_t)(tl.y + m) * N + col) =
          make_uint2(pack_bf16(r[0], r[1]), pack_bf16(r[2], r[3]));
    }
  };

  int w = cl, n = 0;           // the item, and its index in this cluster's walk
  int gc = g_lo, j = 0;        // the stage's slice group and round
  // stage t of this block's walk: its steps on af[P]; while they run, stage
  // t - 1's are waited for, its stage released and stage t + 1's fragments
  // read; where a group ends (wait_group 0 first) its chains join tot in
  // slice order (local), and where the item ends, the fold
  auto run = [&](auto parity, int t) {
    constexpr int P = decltype(parity)::value;
    const uint8_t* st = ring + (t % C::kStages) * C::kStage;
    const bool first = j == 0;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < kChains; ++i) {
        const uint8_t* xs = st + i * C::kSub;
        wgmma_rs<NX>(chain[i], af[P][i][kk], desc_b(xs + kk * 32), !(first && kk == 0));
      }
    wg_commit();
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // stage t - 1's done
#pragma unroll
    for (int i = 0; i < kChains; ++i)
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) pin(af[1 - P][i][kk]);
    mbar_arrive_if(t > 0 && lane == 0, &empty[(t - 1 + C::kStages) % C::kStages]);
    if (t + 1 < my_stages) arrive_frags(af[1 - P], t + 1);
    if (j == rounds - 1) {  // the group's chains are whole
      wg_wait();
#pragma unroll
      for (int i = 0; i < kChains; ++i) pin(chain[i]);
      if (KC == 1) {
        const bool s0 = gc == 0;
#pragma unroll
        for (int i = 0; i < kChains; ++i)
#pragma unroll
          for (int e = 0; e < NX / 2; ++e)
            tot[e] = s0 && i == 0 ? chain[i][e] : tot[e] + chain[i][e];
      }
      if (gc == g_hi - 1) {
        fold(w, n);
        w += ncl, ++n;
      }
      j = 0;
      gc = gc == g_hi - 1 ? g_lo : gc + 1;
    } else {
      ++j;
    }
  };
  if (my_stages) arrive_frags(af[0], 0);
  for (int t = 0; t < my_stages; t += 2) {
    run(std::integral_constant<int, 0>(), t);
    if (t + 1 < my_stages) run(std::integral_constant<int, 1>(), t + 1);
  }
  cluster_sync_all();  // no block leaves while another may read its partials
}

// -- launches -------------------------------------------------------------------

// the tensor maps of one launch: the two weight tiles' maps over [E K, N]
// in boxes of 64 k x 64 columns (down: the same map twice), and h [R, K] in
// boxes of `arows` x 64 (down only)
struct Maps {
  CUtensorMap w0, w1, a;
};

template <bool W8>
int make_maps(Maps& m, bool gated, const void* w0, const void* w1, const void* a, int R, int E,
              int K, int N, int arows) {
  const auto wt = W8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto wz = W8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  const int elt = W8 ? 1 : 2;
  if (int e = make_map(&m.w0, w0, wt, elt, E * K, N, kBK, kCols, wz)) return e;
  if (int e = make_map(&m.w1, gated ? w1 : w0, wt, elt, E * K, N, kBK, kCols, wz)) return e;
  if (gated) {
    m.a = m.w0;  // unused: the rows are gathered by cp.async
    return 0;
  }
  return make_map(&m.a, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, R, K, arows, kBK);
}

// the card's SMs into `sms`, asked once
inline int sm_count(int& sms) {
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <int NX, bool GATED, bool W8>
int launch_stream(const Maps& m, const void* x, const int* src, const int* counts,
                  const float* s0, const float* s1, void* out, int E, int K, int N,
                  cudaStream_t stream) {
  using C = StreamCfg<NX, W8>;
  constexpr auto kernel = moe_stream<NX, GATED, W8>;
  static bool smem_set = false;
  static int sms = 0;
  if (int e = set_smem(kernel, C::kSmem, smem_set)) return e;
  if (int e = sm_count(sms)) return e;
  moe_stream<NX, GATED, W8><<<sms, C::kThreads, C::kSmem, stream>>>(
      m.w0, m.w1, m.a, (const __nv_bfloat16*)x, src, counts, s0, s1, (__nv_bfloat16*)out, E, K,
      N);
  return (int)cudaGetLastError();
}

// rows a tile for R rows over Nx tokens and E experts: a power of two from
// 8 to 64, else 128, that holds the rows an expert takes: at most min(R, Nx)
// (one row a token), and, where fewer, four times an expert's even share 4
// R / E (an expert with more gets more tiles: a tile of 64 rows for 4 of
// them streamed 1.16x slower at R 512 than one of 16)
inline int tile_rows(int R, int Nx, int E) {
  int most = R < Nx ? R : Nx;
  const int share = 4 * R / E;
  if (share < most) most = share > 8 ? share : 8;
  return most > kMaxPow2Rows ? kPreRows : most <= 8 ? 8 : pow2_ceil(most);
}

// blocks an item's slices spread over in the int8 decode body: S / kChains
// where the launch makes few items for the card (its column tiles times the
// experts under kSpreadItems times the SMs), else 1 (each block runs every
// slice of its items), or 0 where the body does not take the launch
// (spread_split: moe_stream runs it); from the widths alone
inline int spread_blocks(int K, int N, bool gated, int E, int sms) {
  if (!spread_split(K, gated ? 2 * N : N)) return 0;  // moe_stream's launch
  const int S = moe_split(K, gated ? 2 * N : N).S;
  if (S <= kChains || col_tiles(N, gated) * E >= kSpreadItems * sms) return 1;
  return S / kChains;
}

// the int8 decode body on clusters of KC blocks, as many clusters as fit
// the card at once (asked once an instantiation and cluster size)
template <int NX, bool GATED>
int launch_spread(const Maps& m, const void* x, const int* src, const int* counts,
                  const float* s0, const float* s1, void* out, int E, int K, int N,
                  cudaStream_t stream) {
  using C = SpreadCfg<NX>;
  constexpr auto kernel = moe_spread<NX, GATED>;
  static bool smem_set = false;
  static int sms = 0, clusters[kMaxCluster + 1] = {};
  if (int e = set_smem(kernel, C::kSmem, smem_set)) return e;
  if (int e = sm_count(sms)) return e;
  const int KC = spread_blocks(K, N, GATED, E, sms);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = KC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters[KC] == 0) {
    cfg.gridDim = dim3(KC);
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    clusters[KC] = n;
  }
  cfg.gridDim = dim3(clusters[KC] * KC);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, m.w0, m.w1, m.a,
                                           (const __nv_bfloat16*)x, src, counts, s0, s1,
                                           (__nv_bfloat16*)out, E, K, N);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <bool GATED, bool W8>
int launch(const void* x, const int* src, const int* counts, const void* w0, const void* w1,
           const float* s0, const float* s1, void* out, int R, int Nx, int E, int K, int N,
           cudaStream_t stream) {
  const int nx = tile_rows(R, Nx, E);
  Maps m;
  if (int e = make_maps<W8>(m, GATED, w0, w1, x, R, E, K, N, nx)) return e;
  if constexpr (W8) {  // tiles of 8 to 32 rows, slices of whole tiles: the decode body
    if (spread_split(K, GATED ? 2 * N : N)) switch (nx) {
      case 8: return launch_spread<8, GATED>(m, x, src, counts, s0, s1, out, E, K, N, stream);
      case 16: return launch_spread<16, GATED>(m, x, src, counts, s0, s1, out, E, K, N, stream);
      case 32: return launch_spread<32, GATED>(m, x, src, counts, s0, s1, out, E, K, N, stream);
      default: break;
    }
  }
  switch (nx) {
    case 8: return launch_stream<8, GATED, W8>(m, x, src, counts, s0, s1, out, E, K, N, stream);
    case 16: return launch_stream<16, GATED, W8>(m, x, src, counts, s0, s1, out, E, K, N, stream);
    case 32: return launch_stream<32, GATED, W8>(m, x, src, counts, s0, s1, out, E, K, N, stream);
    case 64: return launch_stream<64, GATED, W8>(m, x, src, counts, s0, s1, out, E, K, N, stream);
    case kPreRows:
      return launch_stream<kPreRows, GATED, W8>(m, x, src, counts, s0, s1, out, E, K, N, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// both launches: gate/up into h, then down into y (the first's error, else
// the second's)
template <bool W8>
int moe_experts(const void* x, const void* src, const void* counts, const void* w_gate,
                const void* w_up, const void* w_down, const float* s_gate, const float* s_up,
                const float* s_down, void* h, void* y, int R, int Nx, int E, int D, int F,
                void* stream) {
  if (R < 1 || Nx < 1 || E < 1 || E > kMaxExperts || D < 32 || D % 32 || F < 32 || F % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* s = (const int*)src;
  const int* c = (const int*)counts;
  const int e = launch<true, W8>(x, s, c, w_gate, w_up, s_gate, s_up, h, R, Nx, E, D, F, st);
  if (e) return e;
  return launch<false, W8>(h, nullptr, c, w_down, nullptr, s_down, s_down, y, R, Nx, E, F, D,
                           st);
}

}  // namespace
