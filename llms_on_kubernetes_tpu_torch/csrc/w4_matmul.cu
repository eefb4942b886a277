// Grouped weight-only int4 matrix product (W4A16) for Hopper (sm_90a): AWQ
// checkpoints served natively, as grouped int4 with per-group scales and
// zero points.
//
// The port's own kernel: the JAX package computes this product in
// llms_on_kubernetes_tpu/ops/quant.py:238 group_qeinsum, a lax.scan over
// the groups that it leaves to XLA. Semantics are those of the plain
// version, ops/quant.py::group_qeinsum_plain, for x [M, K] and a weight of
// G groups of gs rows (K = G gs):
//
//   acc[m, n] = over groups g, in order:
//               (acc + part * scale[g, n]) - xsum[m, g] * zero_scaled[g, n]
//   part      = sum_{i in g} x[m, i] * q[g, i, n]          (f32 sums)
//   xsum      = round_x(sum_{i in g} x[m, i])
//   out[m, n] = round_x(acc[m, n])
//
// with round_x rounding to x's dtype (bf16 or f32; the identity for f32),
// q the centered int4 values (-8..7, stored int8 [G, gs, N], or lane-packed
// int8 [G, gs/2, N]: element 2i in the low nibble of byte i, 2i + 1 in its
// high nibble), scale and zero_scaled f32 [G, N]. Each group step is
// rounded operation by operation (no contraction into fma), as the plain
// version rounds it.
//
// What bounds it on the H100: at decode (M up to 64) the weight's bytes,
// K N / 2 packed plus 8 bytes a group and column of scales (a Qwen3-8B
// forward moves 4.0 GB: 1.18 ms at 3.35 TB/s); at prefill the bf16
// tensor-core rate, which only wgmma reaches.
//
// The K split (w4_split, mirrored by ops/quant.py::w4_splits): W8A16's
// (hopper.cuh make_split) with whole groups as the unit, so S, a power of
// two, and the slice edges follow from K, N and gs alone, never from M.
// Every bf16 output is
//   1. per slice, the groups in order: a fresh f32 chain per group (its
//      first wgmma step starts it, scale-d 0), one step of 16 k at a time
//      in increasing k, then the group step above with xsum taken in the
//      fixed order below;
//   2. the slice results summed in slice order, ((a0 + a1) + a2) + ..., f32;
//   3. one rounding to bf16.
// Both bf16 bodies compute exactly this, from the same fragments on the
// same instructions, so a row's result is the same at any M, at any place
// in the call and on either body (held bit for bit on the card:
// chip_smoke.py phase 2 and tests/test_torch_cuda.py).
//
// The bf16 bodies compute out^T = w^T x^T on wgmma (hopper.cuh): the
// converted weight is the A operand, in registers, and x the B operand, in
// shared memory, so M is wgmma's N (8, 16, 32, 64, or 128 at prefill) and a
// decode tile pads no row. A packed byte holds rows 2i and 2i + 1 of one
// column: exactly the (k, k + 1) pair of one A register. A warp reads its
// two 32-bit words of a 16-deep step (packed rows 8 kk + tq and + 4) and
// converts each byte without I2F (nibble_pair: byte_perm, lop3, one
// fma.bf16x2); int8 storage takes W8A16's s8_pair on four words. Each
// 64-deep tile comes into a ring of stages by TMA on an mbarrier: x [rows,
// 64] and the weight [64 k, 128 columns] with 128-byte swizzle, and the
// scale and zero_scaled rows of every group the tile touches ([GR, 128]
// f32, unswizzled).
//
// xsum on the tensor cores: each step also issues one m64n8k16 wgmma with
// 64 rows of the staged x tile as the shared-memory A operand and a tile of
// ones as B, into a chain that starts with every group. So a row's xsum is
// wgmma's sum of each 16 values, chained over the group's steps in k order:
// an order fixed by gs alone, whatever M and the row's place in the tile
// (the decode body's x tile of NX < 64 rows leaves A rows NX..63 to
// whatever shared memory holds there: their sums are never read). At the
// group's end the rows' sums are rounded to bf16 and passed through shared
// memory to the threads whose outputs need them.
//
// The tile loop of both bodies: a tile's wgmma steps go out, then, while
// they run, the previous tile's are waited for (wait_group 1), its stage is
// freed and refilled, and the next tile's fragments are converted; the
// chains are waited for (wait_group 0) only where a group ends, so a
// group's tiles run back to back. ptxas serializes every wgmma of a
// function (C7520, printed by chip_smoke.py's ptxas report) that writes or
// reads an accumulator between a wgmma and its wait, or that puts code it
// takes as divergent there: hence the scale-d 0 starts (no zeroing), group
// steps only after wait_group 0, loop bounds made uniform with a shuffle,
// and TMA copies issued as predicated instructions (hopper.cuh
// tma_load_if), not under a branch on the thread.
//
// - w4_matmul_decode (M <= 64, and M > 64 where the prefill body would
//   have fewer than kMinPrefillBlocks blocks): a block holds NX rows of x
//   and a slab of 128 columns; warpgroup g of cluster block r runs slice r
//   * WK + g over the slab, as two 64-column wgmma tiles, through a TMA
//   ring of its own (its first thread loads it), so the two warpgroups meet
//   only at the fold. The slices' results go to shared memory, and after a
//   cluster barrier each block sums its share of the slab's outputs over
//   all S slices in slice order through distributed shared memory. No
//   workspace, no second launch, no counter and no float atomics: a
//   captured CUDA graph holds one kernel node and nothing but the operands.
// - w4_matmul_prefill: a block holds 128 rows of x and 128 columns;
//   consumer warpgroup T computes wgmma tile T (64 columns) at width 128
//   and runs every slice in order; a producer warpgroup's first thread
//   loads the ring (full and empty mbarriers) and gives its registers to
//   the consumers (setmaxnreg: 232 a consumer thread). The consumers hold
//   the group chain and the slice's running result in registers (64
//   floats each) and meet at no barrier in the loop (each sums all 128
//   rows' xsums itself); the sum of the finished slices lives in shared
//   memory, 64 floats a thread, touched once a slice.
//
// The float32 body (w4_matmul_simt): the CUDA cores, 32 rows by 64 columns a
// block, each thread 4 by 4 outputs, one fmaf a product in increasing k and
// one chain over all groups (never split), as W8A16's float32 body.
#include <cooperative_groups.h>

#include <type_traits>

#include "hopper.cuh"

using namespace llmk;
namespace cg = cooperative_groups;

namespace {

// -- the K split and the staged group rows ----------------------------------

__host__ __device__ inline Split w4_split(int K, int N, int gs) { return make_split(K, N, gs); }

// the most groups one 64-deep tile touches: tiles start kBK apart from a
// slice's first row, which starts a group
__host__ __device__ inline int w4_group_rows(int gs) {
  int most = 1, o = 0;
  do {
    const int n = (o + kBK - 1) / gs + 1;
    most = n > most ? n : most;
    o = (o + kBK) % gs;
  } while (o != 0);
  return most;
}

constexpr int kMaxGR = 4;  // w4_group_rows(16), the most for any gs

// acc + part * s - xs * z, each operation rounded on its own
__device__ __forceinline__ float group_step(float acc, float part, float s, float xs, float z) {
  return __fsub_rn(__fadd_rn(acc, __fmul_rn(part, s)), __fmul_rn(xs, z));
}

// the tile of ones xsum's wgmma takes as B: 1024 bytes of bf16 1.0, written
// by the block's threads, then handed to the async proxy
__device__ __forceinline__ void fill_ones(uint8_t* ones) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    reinterpret_cast<uint32_t*>(ones)[i] = 0x3F803F80u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bytes of one staged weight tile: 64 k rows by 128 columns
template <bool PACKED>
constexpr int w_tile() { return PACKED ? kBK / 2 * kSlab : kBK * kSlab; }

// staged scale and zero_scaled rows of one tile: GR rows of 128 f32 each
__host__ __device__ inline int s_tile(int GR) { return GR * kSlab * 4; }

__host__ __device__ inline int round1024(int b) { return (b + 1023) & ~1023; }

// A fragments of wgmma tile T for step kk of a staged weight tile
template <int T, bool PACKED>
__device__ __forceinline__ void w4_frags(uint32_t (&f)[4], const uint8_t* b, int kk, int wn,
                                         int g, int tq) {
  if constexpr (PACKED) {
    // packed rows 8 kk + tq (k 2tq, 2tq + 1 of the step) and + 4 (k 2tq + 8,
    // 2tq + 9), columns 4g .. 4g + 3 of the warp's 32
    const int r = kk * 8 + tq, c = wn * 32 + g * 4;
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(b + swz(r, c));
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(b + swz(r + 4, c));
    const uint32_t h0 = w0 >> 4, h1 = w1 >> 4;
    f[0] = nibble_pair<2 * T>(w0, h0), f[1] = nibble_pair<2 * T + 1>(w0, h0);
    f[2] = nibble_pair<2 * T>(w1, h1), f[3] = nibble_pair<2 * T + 1>(w1, h1);
  } else {
    uint32_t wd[4];
    step_words(wd, b, kk, wn, g, tq);
    step_frags<T>(f, wd);
  }
}

// which of a tile's four steps end a group (bit j: the group ends after
// step j), for the tile of `steps` steps at K row k0
__device__ __forceinline__ int group_ends(int k0, int steps, int gs) {
  int ends = 0;
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j)
    if (j < steps && (k0 + 16 * (j + 1)) % gs == 0) ends |= 1 << j;
  return ends;
}

// -- decode body: M <= 64, and M > 64 on a short prefill grid ----------------

template <int NX, int WK, bool PACKED>
struct DecCfg {
  static constexpr int kThreads = 128 * WK;          // WK slice groups (warpgroups)
  // a ring per warpgroup, within 227 KB at the most group rows (GR 4)
  static constexpr int kStages = PACKED && NX <= 16 ? 8 : 4;
  // two chain parities, the groups' steps pipelined, where the registers
  // allow
  static constexpr bool kPipe = NX <= 32;
  static_assert(NX <= 64, "the decode body holds at most 64 rows");
  static constexpr int kATile = NX * kBK * 2;        // bytes: NX x rows of 64 bf16
  static constexpr int kBTile = w_tile<PACKED>();
  static constexpr int kPStride = kSlab + 4;         // floats a result row
  static constexpr int kPart = NX * kPStride;        // floats, one slice group
  static_assert(kATile % 1024 == 0 && kBTile % 1024 == 0, "swizzled tiles 1024-aligned");
  // one warpgroup's stage: x, w, scale and zero_scaled rows
  __host__ __device__ static int tx(int GR) { return kATile + kBTile + 2 * s_tile(GR); }
  __host__ __device__ static int stage(int GR) { return round1024(tx(GR)); }
  // 1024 for alignment, 1024 for the ones, then the WK rings (which hold
  // the slice results after the loop) and 8 KB past them: xsum's A operand
  // reads 64 rows (8 KB) from each x tile, the last one's past the rings
  __host__ __device__ static int smem(int GR) {
    const int ring = WK * kStages * stage(GR) + 8192, part = WK * kPart * 4;
    return 2048 + (ring > part ? ring : part);
  }
};

template <int NX, int WK, bool PACKED>
__global__ void __launch_bounds__(128 * WK)
w4_matmul_decode(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                 const __grid_constant__ CUtensorMap tms, const __grid_constant__ CUtensorMap tmz,
                 __nv_bfloat16* __restrict__ out, int M, int K, int N, int gs, int GR) {
  using C = DecCfg<NX, WK, PACKED>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[WK][C::kStages];
  __shared__ __align__(16) float xs_s[WK][2][64];  // rounded xsums of a group, by parity
  uint8_t* ones = align1024(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int KB = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const Split sp = w4_split(K, N, gs);  // sp.S == KB * WK (the host launched it so)
  const int n0 = blockIdx.y * kSlab, m0 = blockIdx.z * NX;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the slice group, broadcast from lane 0 so that the compiler sees the
  // warpgroup's loop bounds as uniform: wgmma in a path it cannot prove
  // uniform is serialized (ptxas C7520)
  const int wk = __shfl_sync(LLMK_FULL_MASK, warp / 4, 0), wn = warp % 4;
  const int g = lane >> 2, tq = lane & 3;
  const bool producer = threadIdx.x % 128 == 0;
  const int stage = C::stage(GR), sb = s_tile(GR);
  // each warpgroup runs its own slice through its own ring: no barrier
  // couples the two until the fold
  uint8_t* ring = ones + 1024 + wk * C::kStages * stage;
  uint64_t* bar = bars[wk];
  const int kb = slice_edge(sp, rank * WK + wk), ke = slice_edge(sp, rank * WK + wk + 1);
  const int tiles = (ke - kb + kBK - 1) / kBK;

  // the warpgroup's first thread loads its tile t: x [NX, 64] at (k, m0),
  // w [64 k, 128] at (n0, k or k / 2), the scale and zero_scaled rows [GR,
  // 128] of the groups from k's; rows past M, K or G and columns past N
  // arrive as zeros
  // (predicated, not branched: see tma_load_if; `on` is false for every
  // thread but the warpgroup's first and for tiles past the slice)
  auto load = [&](int t, bool on) {
    uint8_t* st = ring + (t % C::kStages) * stage;
    uint64_t* b = &bar[t % C::kStages];
    const int k = kb + t * kBK;
    on = on && producer && t < tiles;
    mbar_expect_if(on, b, C::tx(GR));
    tma_load_if(on, st, &tmx, k, m0, b);
    tma_load_if(on, st + C::kATile, &tmw, n0, PACKED ? k / 2 : k, b);
    tma_load_if(on, st + C::kATile + C::kBTile, &tms, n0, k / gs, b);
    tma_load_if(on, st + C::kATile + C::kBTile + sb, &tmz, n0, k / gs, b);
  };
  if (producer) {
    for (int s = 0; s < C::kStages; ++s) mbar_init(&bar[s]);
    mbar_init_fence();
  }
  for (int s = 0; s < C::kStages; ++s) load(s, true);
  fill_ones(ones);
  __syncthreads();

  // acc[T]: the slice's result so far, part[Q][T]: the chain of a group of
  // parity Q, for wgmma tile T (A rows: the slab's 64-column halves as
  // mapped in hopper.cuh; B columns: the block's NX rows of x); xd[Q]: its
  // xsum chain (A rows 16 wn + g and + 8 are x rows). The pipelined loop
  // (kPipe) alternates the parities, the other loop takes parity 0 only.
  float acc[2][NX / 2], part[2][2][NX / 2], xd[2][4];
#pragma unroll
  for (int T = 0; T < 2; ++T)
#pragma unroll
    for (int i = 0; i < NX / 2; ++i) acc[T][i] = part[0][T][i] = part[1][T][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) xd[0][i] = xd[1][i] = 0.f;
  int buf = 0;
  uint32_t af[2][kBK / 16][2][4];  // two tiles' fragments: the current and the next
  auto frags = [&](uint32_t(&f)[kBK / 16][2][4], int t) {
    const uint8_t* b = ring + (t % C::kStages) * stage + C::kATile;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      w4_frags<0, PACKED>(f[kk][0], b, kk, wn, g, tq);
      w4_frags<1, PACKED>(f[kk][1], b, kk, wn, g, tq);
    }
  };
  auto next_frags = [&](auto p, int t) {
    constexpr int P = decltype(p)::value;
    if (t + 1 < tiles) {
      mbar_wait(&bar[(t + 1) % C::kStages], ((t + 1) / C::kStages) & 1);
      frags(af[1 - P], t + 1);
    }
  };
  // pins keep the compiler from reading the chains before the wait that
  // completes them; they touch no chain with a wgmma in flight
  auto pin_chain = [&](auto q) {
    constexpr int Q = decltype(q)::value;
    pin(part[Q][0]), pin(part[Q][1]), pin(xd[Q]);
  };
  // step kk of tile t (fragments af[P]) into the chains of parity Q; a
  // group's first step starts them (more: 0), so no instruction but wgmma
  // ever writes them
  auto step = [&](auto p, auto q, int t, int kk, int more) {
    constexpr int P = decltype(p)::value, Q = decltype(q)::value;
    const uint64_t d = desc_b(ring + (t % C::kStages) * stage + kk * 32);
    wgmma_rs<NX>(part[Q][0], af[P][kk][0], d, more);
    wgmma_rs<NX>(part[Q][1], af[P][kk][1], d, more);
    wgmma_ss8(xd[Q], d, desc_b(ones), more);
  };
  // the group of parity Q that ends at step j of tile t (k0 its first
  // row): its xsums to every thread of the warpgroup, then the group step.
  // Its chains are complete (waited for); ptxas serializes every wgmma of a
  // function that reads or writes an accumulator of a wgmma still in
  // flight (C7520)
  auto group_end = [&](auto q, int t, int k0, int j) {
    constexpr int Q = decltype(q)::value;
    const float* sc = reinterpret_cast<const float*>(ring + (t % C::kStages) * stage +
                                                     C::kATile + C::kBTile);
    const int gr = (k0 + 16 * j) / gs - k0 / gs;
    float* xb = xs_s[wk][buf];
    const int r = 16 * wn + g;  // rows past NX are never read
    const float x0 = round_bf16(xd[Q][0]), x8 = round_bf16(xd[Q][2]);
    if (tq == 0) xb[r] = x0, xb[r + 8] = x8;
    named_sync(1 + wk, 128);
    const float4 s4 = *reinterpret_cast<const float4*>(sc + gr * kSlab + wn * 32 + g * 4);
    const float4 z4 = *reinterpret_cast<const float4*>(sc + sb / 4 + gr * kSlab + wn * 32 +
                                                       g * 4);
    const float sv[4] = {s4.x, s4.y, s4.z, s4.w}, zv[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
    for (int i = 0; i < NX / 8; ++i) {
      const float2 x2 = *reinterpret_cast<const float2*>(xb + 8 * i + 2 * tq);
#pragma unroll
      for (int T = 0; T < 2; ++T)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 2 * T + (e >> 1);
          acc[T][4 * i + e] = group_step(acc[T][4 * i + e], part[Q][T][4 * i + e], sv[c],
                                         e & 1 ? x2.y : x2.x, zv[c]);
        }
    }
    buf ^= 1;
  };
  using I0 = std::integral_constant<int, 0>;
  using I1 = std::integral_constant<int, 1>;

  // tile t (any gs): its wgmma steps on af[P]; then, while they run, tile t
  // - 1's are waited for, its stage freed and tile t + 1's fragments
  // converted into af[1 - P]; the chains are waited for only where a group
  // ends, so the steps of a group's tiles run back to back
  auto run = [&](auto p, int t) {
    constexpr int P = decltype(p)::value;
    const int k0 = kb + t * kBK, steps = min(kBK, ke - k0) / 16;
    const int ends = group_ends(k0, steps, gs);
    wg_fence();
    if (steps == kBK / 16 && (ends & 7) == 0) {
      // a whole tile (every tile when 64 divides gs) issues its steps with no
      // branch between them
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) step(p, I0(), t, kk, (k0 + 16 * kk) % gs != 0);
    } else {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        if (kk < steps) step(p, I0(), t, kk, (k0 + 16 * kk) % gs != 0);
        if (kk < kBK / 16 - 1 && ((ends >> kk) & 1)) {
          wg_commit();
          wg_wait();
          pin_chain(I0());
          group_end(I0(), t, k0, kk);
          wg_fence();
        }
      }
    }
    wg_commit();
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // tile t - 1's done
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) pin(af[1 - P][kk][0]), pin(af[1 - P][kk][1]);
    named_sync(1 + wk, 128);  // tile t - 1's stage is free
    load(t - 1 + C::kStages, t > 0);
    next_frags(p, t);
    if (ends >> (kBK / 16 - 1)) {  // a group ends with the tile
      wg_wait();
      pin_chain(I0());
      group_end(I0(), t, k0, kBK / 16 - 1);
    }
  };

  // groups of one or two whole tiles (gs 64 or 128), two chain parities
  // (kPipe): tile t's steps go into the chains of its group's parity Q
  // (FIRST: the group's first tile, whose first step starts them); while
  // they run, tile t - 1's are waited for and, where they ended a group
  // (END), that group of parity 1 - Q is stepped, so no group's step waits
  // for the chains of the next. The calls are unrolled: no branch between a
  // wgmma in flight and the chains' reads
  auto tile_pipe = [&](auto p, auto q, auto end, auto first, int t) {
    constexpr int P = decltype(p)::value, Q = decltype(q)::value;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      step(p, q, t, kk, !(decltype(first)::value && kk == 0));
    wg_commit();
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // tile t - 1's done
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) pin(af[1 - P][kk][0]), pin(af[1 - P][kk][1]);
    if constexpr (decltype(end)::value) {
      pin_chain(std::integral_constant<int, 1 - Q>());
      group_end(std::integral_constant<int, 1 - Q>(), t - 1, kb + (t - 1) * kBK, 0);
    }
    named_sync(1 + wk, 128);  // tile t - 1's stage is free
    load(t - 1 + C::kStages, t > 0);
    next_frags(p, t);
  };
  using F = std::false_type;
  using T1 = std::true_type;

  if (tiles) {
    mbar_wait(&bar[0], 0);
    frags(af[0], 0);
  }
  if (C::kPipe && gs == 2 * kBK) {
    const int ng = tiles / 2;
    tile_pipe(I0(), I0(), F(), T1(), 0);
    tile_pipe(I1(), I0(), F(), F(), 1);
    int gi = 1;
    for (; gi + 1 < ng; gi += 2) {
      tile_pipe(I0(), I1(), T1(), T1(), 2 * gi);
      tile_pipe(I1(), I1(), F(), F(), 2 * gi + 1);
      tile_pipe(I0(), I0(), T1(), T1(), 2 * gi + 2);
      tile_pipe(I1(), I0(), F(), F(), 2 * gi + 3);
    }
    if (gi < ng) {  // one group left, of parity 1
      tile_pipe(I0(), I1(), T1(), T1(), 2 * gi);
      tile_pipe(I1(), I1(), F(), F(), 2 * gi + 1);
      wg_wait();
      pin_chain(I1());
      group_end(I1(), tiles - 1, kb + (tiles - 1) * kBK, 0);
    } else {
      wg_wait();
      pin_chain(I0());
      group_end(I0(), tiles - 1, kb + (tiles - 1) * kBK, 0);
    }
  } else if (C::kPipe && gs == kBK) {
    tile_pipe(I0(), I0(), F(), T1(), 0);
    int t = 1;
    for (; t + 1 < tiles; t += 2) {
      tile_pipe(I1(), I1(), T1(), T1(), t);
      tile_pipe(I0(), I0(), T1(), T1(), t + 1);
    }
    if (t < tiles) {
      tile_pipe(I1(), I1(), T1(), T1(), t);
      wg_wait();
      pin_chain(I1());
      group_end(I1(), t, kb + t * kBK, 0);
    } else {
      wg_wait();
      pin_chain(I0());
      group_end(I0(), tiles - 1, kb + (tiles - 1) * kBK, 0);
    }
  } else {
    for (int t = 0; t < tiles; t += 2) {
      run(I0(), t);
      if (t + 1 < tiles) run(I1(), t + 1);
    }
    wg_wait();  // (a slice ends a group: nothing is in flight here)
  }
  __syncthreads();  // the rings are free: they hold the slice results now

  // this thread's results: tile T, element 4i + e is x row 8i + 2tq + (e &
  // 1) and the slab's column 32 wn + 4g + 2T + (e >> 1), so a row's four
  // columns 32 wn + 4g .. + 3 go out in one 16-byte store
  float* res = reinterpret_cast<float*>(ones + 1024);
  float* mine = res + wk * C::kPart + wn * 32 + g * 4;
#pragma unroll
  for (int i = 0; i < NX / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(mine + (8 * i + 2 * tq + h) * C::kPStride) =
          make_float4(acc[0][4 * i + h], acc[0][4 * i + h + 2], acc[1][4 * i + h],
                      acc[1][4 * i + h + 2]);
  cluster.sync();  // every block's results are in place

  // this block sums columns [rank, rank + 1) * kSlab / KB of the slab over
  // all S slices, in slice order, and rounds once; slice s is slice group s
  // % WK of block s / WK
  const int rows = min(NX, M - m0), cols = kSlab / KB, quads = cols / 4;
  for (int q = threadIdx.x; q < rows * quads; q += C::kThreads) {
    const int m = q / quads, c = rank * cols + (q % quads) * 4, n = n0 + c;
    if (n >= N) continue;
    const int off = m * C::kPStride + c;
    constexpr int kMaxS = kSliceGroups * kMaxCluster;
    float4 v[kMaxS];
#pragma unroll
    for (int s = 0; s < kMaxS; ++s)
      if (s < sp.S)
        v[s] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(res, s / WK) +
                                                (s % WK) * C::kPart + off);
    float4 tot = v[0];
#pragma unroll
    for (int s = 1; s < kMaxS; ++s)
      if (s < sp.S)
        tot.x = tot.x + v[s].x, tot.y = tot.y + v[s].y, tot.z = tot.z + v[s].z,
        tot.w = tot.w + v[s].w;
    *reinterpret_cast<uint2*>(out + (size_t)(m0 + m) * N + n) =
        make_uint2(pack_bf16(tot.x, tot.y), pack_bf16(tot.z, tot.w));
  }
  cluster.sync();  // no block leaves while another still reads its results
}

// the tensor maps of one call: x [M, K] bf16 in boxes of xrows x 64, the
// weight [K or K / 2, N] in boxes of 64 k x 128, scale and zero_scaled [G,
// N] f32 in boxes of GR x 128 (unswizzled)
struct Maps {
  CUtensorMap x, w, s, z;
};

template <bool PACKED>
int make_maps(Maps& m, const void* x, const void* w, const void* scale, const void* zs, int M,
              int K, int N, int gs, int GR, int xrows) {
  const int G = K / gs;
  if (int e = make_map(&m.x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, xrows, kBK)) return e;
  if (int e = make_map(&m.w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, PACKED ? K / 2 : K, N,
                       PACKED ? kBK / 2 : kBK, kSlab))
    return e;
  if (int e = make_map(&m.s, scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, G, N, GR, kSlab,
                       CU_TENSOR_MAP_SWIZZLE_NONE))
    return e;
  return make_map(&m.z, zs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, G, N, GR, kSlab,
                  CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int NX, int WK, bool PACKED>
int launch_decode(const void* x, const void* w, const void* scale, const void* zs, void* out,
                  int M, int K, int N, int gs, int S, cudaStream_t stream) {
  using C = DecCfg<NX, WK, PACKED>;
  constexpr auto kernel = w4_matmul_decode<NX, WK, PACKED>;
  static bool smem_set = false;  // per instantiation; one card per process
  if (int e = set_smem(kernel, C::smem(kMaxGR), smem_set)) return e;
  const int GR = w4_group_rows(gs);
  Maps m;
  if (int e = make_maps<PACKED>(m, x, w, scale, zs, M, K, N, gs, GR, NX)) return e;
  const int KB = S / WK;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KB, (N + kSlab - 1) / kSlab, (M + NX - 1) / NX);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::smem(GR);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = KB;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, m.x, m.w, m.s, m.z,
                                           (__nv_bfloat16*)out, M, K, N, gs, GR);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int NX, bool PACKED>
int launch_nx(const void* x, const void* w, const void* scale, const void* zs, void* out, int M,
              int K, int N, int gs, int S, cudaStream_t stream) {
  if (S == 1) return launch_decode<NX, 1, PACKED>(x, w, scale, zs, out, M, K, N, gs, S, stream);
  return launch_decode<NX, kSliceGroups, PACKED>(x, w, scale, zs, out, M, K, N, gs, S, stream);
}

// -- prefill body: M > 64 -----------------------------------------------------

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

template <bool PACKED>
struct PreCfg {
  static constexpr int kRows = 128;                  // x rows a block: the wgmma width
  static constexpr int kConsumers = 256;             // warpgroup T: wgmma tile T of the slab
  static constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
  // registers a thread (setmaxnreg): the consumers take what the producer
  // gives up, within the SM's 64 Ki
  static constexpr int kConsumerRegs = 232, kProducerRegs = 40;
  static_assert(kConsumers * kConsumerRegs + 128 * kProducerRegs <= 65536, "registers");
  static constexpr int kStages = 5;
  static constexpr int kATile = kRows * kBK * 2;     // bytes: 128 x rows of 64 bf16
  static constexpr int kBTile = w_tile<PACKED>();
  static constexpr int kOStride = kSlab + 8;         // bf16 a staged output row
  static constexpr int kTot = kConsumers * kRows / 2 * 4;  // bytes: the finished slices' sums
  __host__ __device__ static int tx(int GR) { return kATile + kBTile + 2 * s_tile(GR); }
  __host__ __device__ static int stage(int GR) { return round1024(tx(GR)); }
  // 1024 for alignment, 1024 for the ones, the ring, the slice sums
  __host__ __device__ static int smem(int GR) { return 2048 + kStages * stage(GR) + kTot; }
  static_assert(kRows * kOStride * 2 <= kStages * (kATile + kBTile), "the output tile fits");
};

// Two consumer warpgroups and a producer warpgroup (whose registers the
// consumers take: setmaxnreg). The producer brings the tiles in order into
// a ring of kStages, each stage refilled once both warpgroups have released
// it (an "empty" mbarrier of 256 arrivals). Each warpgroup sums the xsums of
// all 128 rows itself (two m64n8k16 a step), so the two meet at no barrier
// inside the loop and one's group step can run under the other's wgmma
// (making them take turns at their groups' steps, ping-pong on two more
// mbarriers, measured slower: PERF.md section 6).
template <bool PACKED>
__global__ void __launch_bounds__(PreCfg<PACKED>::kThreads, 1)
w4_matmul_prefill(const __grid_constant__ CUtensorMap tmx,
                  const __grid_constant__ CUtensorMap tmw,
                  const __grid_constant__ CUtensorMap tms,
                  const __grid_constant__ CUtensorMap tmz, __nv_bfloat16* __restrict__ out,
                  int M, int K, int N, int gs, int GR) {
  using C = PreCfg<PACKED>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[C::kStages], empty[C::kStages];
  __shared__ __align__(16) float xs_s[2][2][C::kRows];  // [warpgroup][parity][row]
  uint8_t* ones = align1024(smem_raw);
  uint8_t* ring = ones + 1024;
  const int stage = C::stage(GR), sb = s_tile(GR);
  float* tot = reinterpret_cast<float*>(ring + C::kStages * stage);
  const Split sp = w4_split(K, N, gs);
  // grid (row block, slab): blocks that share a weight slab run side by
  // side, so the slab is read from device memory about once
  const int m0 = blockIdx.x * C::kRows, n0 = blockIdx.y * kSlab;
  const int warp = __shfl_sync(LLMK_FULL_MASK, (int)threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  int tiles = 0;
  for (int s = 0; s < sp.S; ++s)
    tiles += (slice_edge(sp, s + 1) - slice_edge(sp, s) + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) mbar_init(&full[s]), mbar_init_n(&empty[s], 256);
    mbar_init_fence();
  }
  fill_ones(ones);
  __syncthreads();

  if (warp >= C::kConsumers / 32) {  // the producer warpgroup: lane 0 of its first warp loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    if (warp == C::kConsumers / 32 && lane == 0) {
      TileCursor ld;
      ld.start(sp);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % C::kStages;
        if (t >= C::kStages) mbar_wait(&empty[s], (t / C::kStages - 1) & 1);
        uint8_t* st = ring + s * stage;
        mbar_expect(&full[s], C::tx(GR));
        tma_load(st, &tmx, ld.k0, m0, &full[s]);
        tma_load(st + C::kATile, &tmw, n0, PACKED ? ld.k0 / 2 : ld.k0, &full[s]);
        tma_load(st + C::kATile + C::kBTile, &tms, n0, ld.k0 / gs, &full[s]);
        tma_load(st + C::kATile + C::kBTile + sb, &tmz, n0, ld.k0 / gs, &full[s]);
        ld.next(sp);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));

  const int T = warp / 4, wn = warp % 4;
  const int g = lane >> 2, tq = lane & 3;

  // acc: the current slice's result so far, part: the current group's
  // chain (element 4i + e: x row 8i + 2tq + (e & 1), column 32 wn + 4g + 2T
  // + (e >> 1) of the slab); xd[h]: the group's xsum chain of x rows 64 h +
  // 16 wn + g and + 8; tot[i * 256 + thread]: the finished slices summed in
  // order
  float acc[C::kRows / 2], part[C::kRows / 2], xd[2][4];
#pragma unroll
  for (int i = 0; i < C::kRows / 2; ++i) acc[i] = part[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) xd[0][i] = xd[1][i] = 0.f;
  int buf = 0;
  uint32_t af[2][kBK / 16][4];
  auto frags = [&](uint32_t(&f)[kBK / 16][4], int t) {
    const uint8_t* b = ring + (t % C::kStages) * stage + C::kATile;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if (T == 0)
        w4_frags<0, PACKED>(f[kk], b, kk, wn, g, tq);
      else
        w4_frags<1, PACKED>(f[kk], b, kk, wn, g, tq);
    }
  };
  auto pin_chains = [&]() { pin(part), pin(xd[0]), pin(xd[1]); };
  // the group that ends at step j of tile t (k0 its first row), as the
  // decode body's, with no wgmma in flight; the xsums pass through this
  // warpgroup's own rows of shared memory
  auto group_end = [&](int t, int k0, int j) {
    const float* sc =
        reinterpret_cast<const float*>(ring + (t % C::kStages) * stage + C::kATile + C::kBTile);
    const int gr = (k0 + 16 * j) / gs - k0 / gs;
    float* xb = xs_s[T][buf];
    const int r = 16 * wn + g;
    const float x0 = round_bf16(xd[0][0]), x8 = round_bf16(xd[0][2]);
    const float x64 = round_bf16(xd[1][0]), x72 = round_bf16(xd[1][2]);
    if (tq == 0) xb[r] = x0, xb[r + 8] = x8, xb[r + 64] = x64, xb[r + 72] = x72;
    named_sync(1 + T, 128);
    const int c = gr * kSlab + wn * 32 + g * 4 + 2 * T;
    const float2 s2 = *reinterpret_cast<const float2*>(sc + c);
    const float2 z2 = *reinterpret_cast<const float2*>(sc + sb / 4 + c);
#pragma unroll
    for (int i = 0; i < C::kRows / 8; ++i) {
      const float2 x2 = *reinterpret_cast<const float2*>(xb + 8 * i + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[4 * i + e] = group_step(acc[4 * i + e], part[4 * i + e], e >> 1 ? s2.y : s2.x,
                                    e & 1 ? x2.y : x2.x, e >> 1 ? z2.y : z2.x);
    }
    buf ^= 1;
  };
  TileCursor cur;
  cur.start(sp);
  // tile t, as the decode body's: its wgmma steps on af[P]; while they run,
  // tile t - 1's are waited for, its stage released and tile t + 1's
  // fragments converted into af[1 - P]; the chains are waited for where a
  // group ends, then the slice fold where a slice does
  auto run = [&](auto parity, int t) {
    constexpr int P = decltype(parity)::value;
    const uint8_t* st = ring + (t % C::kStages) * stage;
    const int k0 = cur.k0, steps = min(kBK, cur.ke - k0) / 16;
    const int ends = group_ends(k0, steps, gs);
    // a group's first step starts its chains, as in the decode body
    auto step = [&](int kk) {
      const uint64_t d = desc_b(st + kk * 32);
      const int more = (k0 + 16 * kk) % gs != 0;
      wgmma_rs<C::kRows>(part, af[P][kk], d, more);
      wgmma_ss8(xd[0], d, desc_b(ones), more);
      wgmma_ss8(xd[1], desc_b(st + 64 * 128 + kk * 32), desc_b(ones), more);
    };
    wg_fence();
    if (steps == kBK / 16 && (ends & 7) == 0) {  // no branch between a whole tile's steps
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) step(kk);
    } else {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        if (kk < steps) step(kk);
        if (kk < kBK / 16 - 1 && ((ends >> kk) & 1)) {
          wg_commit();
          wg_wait();
          pin_chains();
          group_end(t, k0, kk);
          wg_fence();
        }
      }
    }
    wg_commit();
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // tile t - 1's done
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) pin(af[1 - P][kk]);
    if (t > 0) mbar_arrive(&empty[(t - 1) % C::kStages]);  // tile t - 1's stage
    if (t + 1 < tiles) {
      mbar_wait(&full[(t + 1) % C::kStages], ((t + 1) / C::kStages) & 1);
      frags(af[1 - P], t + 1);
    }
    if (ends >> (kBK / 16 - 1)) {  // a group ends with the tile
      wg_wait();
      pin_chains();
      group_end(t, k0, kBK / 16 - 1);
    }
    if (cur.last()) {  // the slice's result is whole: fold it in, slice order
#pragma unroll
      for (int i = 0; i < C::kRows / 2; ++i) {
        float& o = tot[i * C::kConsumers + threadIdx.x];
        o = cur.s == 0 ? acc[i] : o + acc[i];
        acc[i] = 0.f;
      }
    }
    cur.next(sp);
  };
  mbar_wait(&full[0], 0);
  frags(af[0], 0);
  for (int t = 0; t < tiles; t += 2) {
    run(std::integral_constant<int, 0>(), t);
    if (t + 1 < tiles) run(std::integral_constant<int, 1>(), t + 1);
  }
  wg_wait();                      // (a slice ends a group: nothing is in flight here)
  named_sync(3, C::kConsumers);   // both warpgroups are done with the ring

  // the one rounding, staged in shared memory (the ring is free), then
  // 16-byte stores of whole rows
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(ring);
  const int c = wn * 32 + 4 * g + 2 * T;
#pragma unroll
  for (int i = 0; i < C::kRows / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(o + (8 * i + 2 * tq + h) * C::kOStride + c) =
          pack_bf16(tot[(4 * i + h) * C::kConsumers + threadIdx.x],
                    tot[(4 * i + h + 2) * C::kConsumers + threadIdx.x]);
  named_sync(3, C::kConsumers);
  for (int q = threadIdx.x; q < C::kRows * kSlab / 8; q += C::kConsumers) {
    const int r = q / (kSlab / 8), ch = (q % (kSlab / 8)) * 8;
    if (m0 + r < M && n0 + ch < N)
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * N + n0 + ch) =
          *reinterpret_cast<const uint4*>(o + r * C::kOStride + ch);
  }
}

template <bool PACKED>
int launch_prefill(const void* x, const void* w, const void* scale, const void* zs, void* out,
                   int M, int K, int N, int gs, cudaStream_t stream) {
  using C = PreCfg<PACKED>;
  static bool smem_set = false;
  if (int e = set_smem(w4_matmul_prefill<PACKED>, C::smem(kMaxGR), smem_set)) return e;
  const int GR = w4_group_rows(gs);
  Maps m;
  if (int e = make_maps<PACKED>(m, x, w, scale, zs, M, K, N, gs, GR, C::kRows)) return e;
  const dim3 grid((M + C::kRows - 1) / C::kRows, (N + kSlab - 1) / kSlab);
  w4_matmul_prefill<PACKED><<<grid, C::kThreads, C::smem(GR), stream>>>(
      m.x, m.w, m.s, m.z, (__nv_bfloat16*)out, M, K, N, gs, GR);
  return (int)cudaGetLastError();
}

// prefill blocks (128 x 128) below which M > 64 rows run on the decode body
// instead, 64 rows a block: its K split keeps the card busy where the
// prefill body's grid is short (rows 256 of a Qwen3-8B projection: 16 to
// 192 blocks). The bodies give the same bits, so the choice is free.
constexpr int kMinPrefillBlocks = 256;

template <bool PACKED>
int launch_bf16(const void* x, const void* w, const void* scale, const void* zs, void* out,
                int M, int K, int N, int gs, cudaStream_t stream) {
  const int S = w4_split(K, N, gs).S;
  if (M <= 8) return launch_nx<8, PACKED>(x, w, scale, zs, out, M, K, N, gs, S, stream);
  if (M <= 16) return launch_nx<16, PACKED>(x, w, scale, zs, out, M, K, N, gs, S, stream);
  if (M <= 32) return launch_nx<32, PACKED>(x, w, scale, zs, out, M, K, N, gs, S, stream);
  const int prefill_blocks = (M + 127) / 128 * ((N + kSlab - 1) / kSlab);
  if (M <= 64 || prefill_blocks < kMinPrefillBlocks)
    return launch_nx<64, PACKED>(x, w, scale, zs, out, M, K, N, gs, S, stream);
  return launch_prefill<PACKED>(x, w, scale, zs, out, M, K, N, gs, stream);
}

// -- float32 body -----------------------------------------------------------------

constexpr int kSimtBM = 32, kSimtBN = 64, kSimtThreads = 128;
constexpr int kKC = 128;               // K rows a staged chunk, at most
constexpr int kWS = kSimtBN + 16;      // weight row stride in shared memory (bytes)

template <bool PACKED>
__global__ void __launch_bounds__(kSimtThreads)
w4_matmul_simt(const float* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ zs,
               float* __restrict__ out, int M, int K, int N, int gs, int G) {
  constexpr int kXS = kKC + 4;                 // x row stride (f32): 16-byte rows
  constexpr int kWR = PACKED ? kKC / 2 : kKC;
  __shared__ __align__(16) float xs[kSimtBM * kXS];
  __shared__ __align__(16) int8_t ws[kWR * kWS];
  __shared__ float xsum_s[kSimtBM];
  const int n0 = blockIdx.x * kSimtBN, m0 = blockIdx.y * kSimtBM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // columns 4tx.., rows 4ty..
  const int gsp = PACKED ? gs / 2 : gs;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int g = 0; g < G; ++g) {
    float pt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pt[i][0] = pt[i][1] = pt[i][2] = pt[i][3] = 0.f;
    float xsum = 0.f;  // thread r < kSimtBM: row r's sum over the group, in increasing k
    for (int c0 = 0; c0 < gs; c0 += kKC) {
      const int kc = min(kKC, gs - c0);
      const int xp = kc / 4;
      for (int q = threadIdx.x; q < kSimtBM * xp; q += kSimtThreads) {
        const int r = q / xp, p = q % xp;
        const bool in = m0 + r < M;
        cp_async<16>(xs + r * kXS + p * 4,
                     x + (size_t)(in ? m0 + r : 0) * K + (size_t)g * gs + c0 + p * 4, in);
      }
      // the chunk's weight rows of 64 bytes (columns past N: zeros)
      const size_t row0 = (size_t)g * gsp + (PACKED ? c0 / 2 : c0);
      const int rows = PACKED ? kc / 2 : kc;
      for (int q = threadIdx.x; q < rows * (kSimtBN / 16); q += kSimtThreads) {
        const int r = q / (kSimtBN / 16), p = q % (kSimtBN / 16);
        const bool in = n0 + p * 16 < N;
        cp_async<16>(ws + r * kWS + p * 16, w + (row0 + r) * N + (in ? n0 + p * 16 : 0), in);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (threadIdx.x < kSimtBM)
        for (int k = 0; k < kc; ++k) xsum += xs[threadIdx.x * kXS + k];
      for (int k = 0; k < kc; ++k) {
        float a[4], bw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[(ty * 4 + i) * kXS + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (PACKED) {
            const uint32_t byte = (uint8_t)ws[(k >> 1) * kWS + tx * 4 + j];
            bw[j] = (float)((int)(byte << (28 - 4 * (k & 1))) >> 28);
          } else {
            bw[j] = (float)ws[k * kWS + tx * 4 + j];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) pt[i][j] = fmaf(a[i], bw[j], pt[i][j]);
      }
      __syncthreads();
    }
    if (threadIdx.x < kSimtBM) xsum_s[threadIdx.x] = xsum;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      const bool in = col < N;
      const float sc = in ? scale[(size_t)g * N + col] : 0.f;
      const float z = in ? zs[(size_t)g * N + col] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i][j] = group_step(acc[i][j], pt[i][j], sc, xsum_s[ty * 4 + i], z);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) out[(size_t)row * N + col] = acc[i][j];
    }
  }
}

template <bool PACKED>
int launch_simt(const void* x, const void* w, const void* scale, const void* zs, void* out,
                int M, int K, int N, int gs, cudaStream_t stream) {
  const dim3 grid((N + kSimtBN - 1) / kSimtBN, (M + kSimtBM - 1) / kSimtBM);
  w4_matmul_simt<PACKED><<<grid, kSimtThreads, 0, stream>>>(
      (const float*)x, (const int8_t*)w, (const float*)scale, (const float*)zs, (float*)out, M,
      K, N, gs, K / gs);
  return (int)cudaGetLastError();
}

}  // namespace

// The number of K slices (of whole groups) of the bf16 bodies for K x N in
// groups of gs rows (ops/quant.py w4_splits mirrors it; slice s starts at
// row gs * (s * G / S)).
extern "C" int llmk_w4_splits(int K, int N, int gs) { return w4_split(K, N, gs).S; }

// x [M, K] (dtype LLMK_F32 or LLMK_BF16); w int8 [G, gs / 2, N] (packed) or
// [G, gs, N]; scale and zero_scaled f32 [G, N]; out [M, N] in x's dtype.
// All contiguous and 16-byte aligned; M >= 1, gs a multiple of 16 dividing
// K, N a multiple of 16. One launch, no scratch. Returns the launch's CUDA
// error, else cudaGetLastError().
extern "C" int llmk_w4_matmul(const void* x, const void* w, const void* scale, const void* zs,
                              void* out, int M, int K, int N, int gs, int packed, int dtype,
                              void* stream) {
  if (M < 1 || gs < 16 || gs % 16 || K % gs || N < 16 || N % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == LLMK_BF16)
    return packed ? launch_bf16<true>(x, w, scale, zs, out, M, K, N, gs, st)
                  : launch_bf16<false>(x, w, scale, zs, out, M, K, N, gs, st);
  if (dtype == LLMK_F32)
    return packed ? launch_simt<true>(x, w, scale, zs, out, M, K, N, gs, st)
                  : launch_simt<false>(x, w, scale, zs, out, M, K, N, gs, st);
  return (int)cudaErrorInvalidValue;
}
