// Weight-only int8 matrix product (W8A16) for Hopper (sm_90a).
//
// The port's own kernel: the JAX package computes this product in
// llms_on_kubernetes_tpu/ops/quant.py:311 qeinsum and leaves it to XLA,
// which fuses the int8 -> bf16 convert into the matrix unit's operand load,
// so the bf16 weight never reaches device memory. In PyTorch,
// matmul(x, w.to(bf16)) writes and re-reads a bf16 copy of every weight on
// every call; this kernel converts the int8 tile on its way to the tensor
// cores instead. Semantics are those of the plain version,
// ops/quant.py::w8_matmul_plain:
//
//   out[m, n] = round_x(round_x(sum_k x[m, k] * w[k, n]) * round_x(scale[n]))
//
// with f32 sums, x bf16 or f32 [M, K], w int8 [K, N] row-major (the JAX
// [in, out] layout, N contiguous), scale f32 [N], and round_x rounding to
// x's dtype (the identity for f32): the two roundings of qeinsum, whose
// einsum returns x's dtype before the multiply by scale.astype(x.dtype).
//
// What bounds it on the H100: at decode (M = 8 or 64 rows) the weight's
// bytes, K * N at 1 byte each (a llama-3-8b layer moves 218 MB, 65 us at
// 3.35 TB/s); at prefill (M in the thousands) the bf16 tensor-core rate,
// 2 M K N operations at 989 TFLOP/s, which only wgmma reaches.
//
// The K split (w8_split, mirrored by ops/quant.py::w8_splits). K is cut
// into S contiguous slices, each a whole number of units (64 rows when 64
// divides K, else 16); S and the edges follow from K and N alone, never
// from M. Every bf16 output is
//   1. each slice's f32 chain, one wgmma step of 16 k at a time in
//      increasing k, starting from zero;
//   2. the slice chains summed in slice order, ((p0 + p1) + p2) + ..., f32;
//   3. the two roundings above.
// Both bf16 bodies below compute exactly this, from the same fragments on
// the same instruction, so a row's result is the same at any M and at any
// place in the call (held bit for bit on the card: chip_smoke.py phase 2
// and tests/test_torch_cuda.py), and a request's logits do not depend on how
// many rows shared its prefill.
//
// int8 -> bf16 without I2F (s8_pair): with l a byte's low 7 bits and h its
// sign bit, the bf16 bit patterns 0x4300 | l and 0x4300 | h << 7 are 128 + l
// and 128 + 128 h, and their difference l - 128 h is the byte's value,
// exact in bf16: one byte_perm, two lop3 and one fma.bf16x2 a pair.
//
// The bf16 bodies compute out^T = w^T x^T on wgmma: the converted weight
// is the A operand, in registers, and x the B operand, in shared memory. A
// warp reads its 16 weight bytes of a 16-deep step with four 32-bit shared
// loads and converts them in registers (step_words, step_frags: column
// 4c + j of the warp's 32 is A row c of wgmma tile j / 2, or c + 8 for odd
// j), so both bodies feed the same fragments to the same instruction, and
// every weight byte is converted once a block. Thread 0 brings each 64-deep
// tile, x [rows, 64] and w [64, 128], into a ring of STAGES by TMA (128-byte
// swizzle, completion on an mbarrier).
//
// - w8_matmul_decode (M <= 64): a block holds NX rows of x (M rounded up
//   to 8, 16, 32 or 64: the wgmma width) and a slab of 128 columns; its WK
//   warpgroups are slice groups, and warpgroup g of cluster block r runs
//   slice r * WK + g over the slab, as two 64-column wgmma tiles. The
//   blocks of one slab form a thread-block cluster (KB = S / WK of them, at
//   most 8, so the small-N projections still fill the 132 SMs); the slice
//   chains go to shared memory, and after a cluster barrier each block sums
//   its share of the slab's outputs over all S slices in slice order,
//   reading the other blocks' chains through distributed shared memory. No
//   workspace, no counter and no float atomics, so a captured CUDA graph
//   holds nothing but the operands.
// - w8_matmul_prefill (M > 64): a block holds 128 rows of x and 128
//   columns; warpgroup T computes wgmma tile T (64 columns) at width 128
//   and runs every slice in order: one register set holds the current
//   slice's chain, a second the running sum. The next tile's fragments are
//   converted while the current tile's wgmma steps run.
//
// The float32 body: the CUDA cores, 32 rows by 64 columns a block, each
// thread 4 by 4 outputs, one fmaf a product, one chain over K (never
// split). The float32 checks (1e-4 against the plain version, the
// debug-tiny reference on the card) need full f32 products, which TF32
// tensor cores would not give.
#include <cooperative_groups.h>

#include <type_traits>

#include "hopper.cuh"

using namespace llmk;
namespace cg = cooperative_groups;

namespace {

// -- the K split (hopper.cuh make_split): 64-row units when 64 divides K,
// else 16 ---------------------------------------------------------------------

__host__ __device__ inline Split w8_split(int K, int N) {
  return make_split(K, N, K % 64 == 0 ? 64 : 16);
}

// -- shared pieces of the bf16 bodies ----------------------------------------

// A fragments of every step of a staged tile for both wgmma tiles (the
// decode body's warpgroups compute both)
__device__ __forceinline__ void tile_frags(uint32_t (&af)[kBK / 16][2][4], const uint8_t* b,
                                           int wn, int g, int tq) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    uint32_t wd[4];
    step_words(wd, b, kk, wn, g, tq);
    step_frags<0>(af[kk][0], wd);
    step_frags<1>(af[kk][1], wd);
  }
}

// one staged tile's wgmma steps (the first `steps` of four) on both of the
// warpgroup's 64-column tiles, waited for
template <int NX>
__device__ __forceinline__ void tile_mma(float (&acc)[2][NX / 2],
                                         uint32_t (&af)[kBK / 16][2][4], const uint8_t* a,
                                         int steps) {
  auto step = [&](int kk) {
    const uint64_t d = desc_b(a + kk * 32);
    wgmma_rs<NX>(acc[0], af[kk][0], d);
    wgmma_rs<NX>(acc[1], af[kk][1], d);
  };
  pin(acc[0]), pin(acc[1]);
  wg_fence();
  // a whole tile (every tile when 64 divides K) issues its steps with no
  // branch between them: a branch around each wgmma measured slower
  if (steps == kBK / 16) {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) step(kk);
  } else {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      if (kk < steps) step(kk);
  }
  wg_commit();
  wg_wait();
  pin(acc[0]), pin(acc[1]);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) pin(af[kk][0]), pin(af[kk][1]);
}

// -- decode body: M <= 64 -----------------------------------------------------

template <int NX, int WK>
struct DecCfg {
  static constexpr int kThreads = 128 * WK;          // WK slice groups (warpgroups)
  // fewer stages as x's tile grows, so that three blocks fit on an SM
  static constexpr int kStages = NX <= 16 ? 4 : NX <= 32 ? 3 : 2;
  static_assert(NX <= 64, "the decode body holds at most 64 rows");
  static constexpr int kATile = NX * kBK * 2;        // bytes: NX x rows of 64 bf16
  static constexpr int kBTile = kBK * kSlab;         // bytes: 64 int8 rows of 128
  static constexpr int kStage = WK * (kATile + kBTile);
  static constexpr int kPStride = kSlab + 4;         // floats a chain row
  static constexpr int kPart = NX * kPStride;        // floats, one slice group
  static constexpr int kSmem =
      (kStages * kStage > WK * kPart * 4 ? kStages * kStage : WK * kPart * 4) + 1024;
  static_assert(kATile % 1024 == 0 && kBTile % 1024 == 0, "swizzled tiles 1024-aligned");
};

template <int NX, int WK>
__global__ void __launch_bounds__(128 * WK)
w8_matmul_decode(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                 const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int M, int K,
                 int N) {
  using C = DecCfg<NX, WK>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[C::kStages];
  uint8_t* smem = align1024(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int KB = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const Split sp = w8_split(K, N);  // sp.S == KB * WK (the host launched it so)
  const int n0 = blockIdx.y * kSlab, m0 = blockIdx.z * NX;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wk = warp / 4, wn = warp % 4;  // slice group, warp of its warpgroup
  const int g = lane >> 2, tq = lane & 3;

  int kb[WK], ke[WK], tiles = 0;
#pragma unroll
  for (int i = 0; i < WK; ++i) {
    kb[i] = slice_edge(sp, rank * WK + i);
    ke[i] = slice_edge(sp, rank * WK + i + 1);
    tiles = max(tiles, (ke[i] - kb[i] + kBK - 1) / kBK);
  }
  const int my_kb = wk ? kb[WK - 1] : kb[0], my_ke = wk ? ke[WK - 1] : ke[0];

  // thread 0 loads tile t of every slice group of the block: x [NX, 64] at
  // (k, m0), w [64, 128] at (n0, k); rows past M or K and columns past N
  // arrive as zeros (a tile of a short slice may run into the next one:
  // its steps are skipped)
  auto load = [&](int t) {
    uint8_t* st = smem + (t % C::kStages) * C::kStage;
    uint64_t* bar = &bars[t % C::kStages];
    mbar_expect(bar, C::kStage);
#pragma unroll
    for (int i = 0; i < WK; ++i) {
      tma_load(st + i * C::kATile, &tmx, kb[i] + t * kBK, m0, bar);
      tma_load(st + WK * C::kATile + i * C::kBTile, &tmw, n0, kb[i] + t * kBK, bar);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) mbar_init(&bars[s]);
    mbar_init_fence();
    for (int s = 0; s < C::kStages - 1 && s < tiles; ++s) load(s);
  }
  __syncthreads();

  // acc[T]: wgmma tile T's chain (A rows: the slab's 64-column halves as
  // mapped above; B columns: the block's NX rows of x)
  float acc[2][NX / 2];
#pragma unroll
  for (int T = 0; T < 2; ++T)
#pragma unroll
    for (int i = 0; i < NX / 2; ++i) acc[T][i] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    if (t) __syncthreads();  // every warp is done with tile t - 1: its stage is free
    if (threadIdx.x == 0 && t + C::kStages - 1 < tiles) load(t + C::kStages - 1);
    mbar_wait(&bars[t % C::kStages], (t / C::kStages) & 1);
    const uint8_t* stage = smem + (t % C::kStages) * C::kStage;
    const uint8_t* a = stage + wk * C::kATile;
    const uint8_t* b = stage + WK * C::kATile + wk * C::kBTile;
    // 16-deep steps of this warpgroup's slice in this tile
    const int steps = max(0, min(kBK, my_ke - (my_kb + t * kBK))) / 16;
    uint32_t af[kBK / 16][2][4];
    tile_frags(af, b, wn, g, tq);
    tile_mma<NX>(acc, af, a, steps);
  }
  __syncthreads();  // the ring is free: it holds the slice chains now

  // this thread's chain values: tile T, element 4i + e is x row 8i + 2tq +
  // (e & 1) and the slab's column 32 wn + 4g + 2T + (e >> 1), so a row's
  // four columns 32 wn + 4g .. + 3 go out in one 16-byte store
  float* part = reinterpret_cast<float*>(smem);
  float* mine = part + wk * C::kPart + wn * 32 + g * 4;
#pragma unroll
  for (int i = 0; i < NX / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(mine + (8 * i + 2 * tq + h) * C::kPStride) =
          make_float4(acc[0][4 * i + h], acc[0][4 * i + h + 2], acc[1][4 * i + h],
                      acc[1][4 * i + h + 2]);
  cluster.sync();  // every block's chains are in place

  // this block sums columns [rank, rank + 1) * kSlab / KB of the slab over
  // all S slices, in slice order; slice s is slice group s % WK of block
  // s / WK
  const int rows = min(NX, M - m0), cols = kSlab / KB, quads = cols / 4;
  for (int q = threadIdx.x; q < rows * quads; q += C::kThreads) {
    const int m = q / quads, c = rank * cols + (q % quads) * 4, n = n0 + c;
    if (n >= N) continue;
    const int off = m * C::kPStride + c;
    // every slice's chain first (the loads overlap), then the sums in order
    constexpr int kMaxS = kSliceGroups * kMaxCluster;
    float4 v[kMaxS];
#pragma unroll
    for (int s = 0; s < kMaxS; ++s)
      if (s < sp.S)
        v[s] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, s / WK) +
                                                (s % WK) * C::kPart + off);
    float4 tot = v[0];
#pragma unroll
    for (int s = 1; s < kMaxS; ++s)
      if (s < sp.S)
        tot.x = tot.x + v[s].x, tot.y = tot.y + v[s].y, tot.z = tot.z + v[s].z,
        tot.w = tot.w + v[s].w;
    const float4 s4 = *reinterpret_cast<const float4*>(scale + n);
    const float r0 = round_bf16(tot.x) * round_bf16(s4.x);
    const float r1 = round_bf16(tot.y) * round_bf16(s4.y);
    const float r2 = round_bf16(tot.z) * round_bf16(s4.z);
    const float r3 = round_bf16(tot.w) * round_bf16(s4.w);
    *reinterpret_cast<uint2*>(out + (size_t)(m0 + m) * N + n) =
        make_uint2(pack_bf16(r0, r1), pack_bf16(r2, r3));
  }
  cluster.sync();  // no block leaves while another still reads its chains
}

template <int NX, int WK>
int launch_decode(const void* x, const void* w, const void* scale, void* out, int M, int K,
                  int N, int S, cudaStream_t stream) {
  using C = DecCfg<NX, WK>;
  constexpr auto kernel = w8_matmul_decode<NX, WK>;
  static bool smem_set = false;  // per instantiation; one card per process
  if (int e = set_smem(kernel, C::kSmem, smem_set)) return e;
  CUtensorMap tmx, tmw;
  if (int e = make_map(&tmx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, NX, kBK)) return e;
  if (int e = make_map(&tmw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, kBK, kSlab)) return e;
  const int KB = S / WK;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KB, (N + kSlab - 1) / kSlab, (M + NX - 1) / NX);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = KB;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, tmx, tmw, (const float*)scale,
                                           (__nv_bfloat16*)out, M, K, N);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int NX>
int launch_nx(const void* x, const void* w, const void* scale, void* out, int M, int K, int N,
              int S, cudaStream_t stream) {
  if (S == 1) return launch_decode<NX, 1>(x, w, scale, out, M, K, N, S, stream);
  return launch_decode<NX, kSliceGroups>(x, w, scale, out, M, K, N, S, stream);
}

// -- prefill body: M > 64 -----------------------------------------------------

struct PreCfg {
  static constexpr int kRows = 128;                  // x rows a block: the wgmma width
  static constexpr int kThreads = 256;               // warpgroup T: wgmma tile T of the slab
  static constexpr int kStages = 4;
  static constexpr int kATile = kRows * kBK * 2;     // bytes: 128 x rows of 64 bf16
  static constexpr int kBTile = kBK * kSlab;         // bytes: 64 int8 rows of 128
  static constexpr int kStage = kATile + kBTile;
  static constexpr int kOStride = kSlab + 8;         // bf16 a staged output row
  static constexpr int kSmem = kStages * kStage + 1024;
  static_assert(kRows * kOStride * 2 <= kStages * kStage, "the output tile fits the ring");
};
// warpgroup T's A fragments of every step of a staged tile (the prefill
// body's warpgroups compute one wgmma tile each)
template <int T>
__device__ __forceinline__ void pre_frags(uint32_t (&af)[kBK / 16][4], const uint8_t* b, int wn,
                                          int g, int tq) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    uint32_t wd[4];
    step_words(wd, b, kk, wn, g, tq);
    step_frags<T>(af[kk], wd);
  }
}

__global__ void __launch_bounds__(PreCfg::kThreads, 1)
w8_matmul_prefill(const __grid_constant__ CUtensorMap tmx,
                  const __grid_constant__ CUtensorMap tmw, const float* __restrict__ scale,
                  __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  using C = PreCfg;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[C::kStages];
  uint8_t* smem = align1024(smem_raw);
  const Split sp = w8_split(K, N);
  // grid (row block, slab): blocks that share a weight slab run side by
  // side, so the slab is read from device memory about once
  const int m0 = blockIdx.x * C::kRows, n0 = blockIdx.y * kSlab;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int T = warp / 4, wn = warp % 4;
  const int g = lane >> 2, tq = lane & 3;
  int tiles = 0;
  for (int s = 0; s < sp.S; ++s)
    tiles += (slice_edge(sp, s + 1) - slice_edge(sp, s) + kBK - 1) / kBK;

  TileCursor ld;  // thread 0's: the next tile to load
  auto load = [&](int t) {
    uint8_t* st = smem + (t % C::kStages) * C::kStage;
    uint64_t* bar = &bars[t % C::kStages];
    mbar_expect(bar, C::kStage);
    tma_load(st, &tmx, ld.k0, m0, bar);
    tma_load(st + C::kATile, &tmw, n0, ld.k0, bar);
    ld.next(sp);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) mbar_init(&bars[s]);
    mbar_init_fence();
    ld.start(sp);
    for (int s = 0; s < C::kStages && s < tiles; ++s) load(s);
  }
  __syncthreads();

  // acc: the current slice's chain, tot: the slices before it summed in
  // order (element 4i + e: x row 8i + 2tq + (e & 1), column 32 wn + 4g + 2T
  // + (e >> 1) of the slab)
  float acc[C::kRows / 2], tot[C::kRows / 2];
#pragma unroll
  for (int i = 0; i < C::kRows / 2; ++i) acc[i] = tot[i] = 0.f;
  uint32_t af[2][kBK / 16][4];
  auto frags = [&](uint32_t(&f)[kBK / 16][4], int t) {
    const uint8_t* b = smem + (t % C::kStages) * C::kStage + C::kATile;
    if (T == 0)
      pre_frags<0>(f, b, wn, g, tq);
    else
      pre_frags<1>(f, b, wn, g, tq);
  };
  TileCursor cur;
  cur.start(sp);
  // tile t: its wgmma steps on af[P], then tile t + 1's fragments into
  // af[1 - P] while they run, then the fold when the slice ends
  auto step = [&](auto parity, int t) {
    constexpr int P = decltype(parity)::value;
    const uint8_t* a = smem + (t % C::kStages) * C::kStage;
    const int steps = min(kBK, cur.ke - cur.k0) / 16;
    pin(acc);
    wg_fence();
    if (steps == kBK / 16) {  // no branch between a whole tile's steps
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs<C::kRows>(acc, af[P][kk], desc_b(a + kk * 32));
    } else {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        if (kk < steps) wgmma_rs<C::kRows>(acc, af[P][kk], desc_b(a + kk * 32));
    }
    wg_commit();
    if (t + 1 < tiles) {
      mbar_wait(&bars[(t + 1) % C::kStages], ((t + 1) / C::kStages) & 1);
      frags(af[1 - P], t + 1);
    }
    wg_wait();
    pin(acc);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) pin(af[P][kk]);
    if (cur.last()) {  // the slice's chain is whole: fold it in, slice order
#pragma unroll
      for (int i = 0; i < C::kRows / 2; ++i) {
        tot[i] = cur.s == 0 ? acc[i] : tot[i] + acc[i];
        acc[i] = 0.f;
      }
    }
    cur.next(sp);
    __syncthreads();  // both warpgroups are done with tile t: its stage is free
    if (threadIdx.x == 0 && t + C::kStages < tiles) load(t + C::kStages);
  };
  mbar_wait(&bars[0], 0);
  frags(af[0], 0);
  for (int t = 0; t < tiles; t += 2) {
    step(std::integral_constant<int, 0>(), t);
    if (t + 1 < tiles) step(std::integral_constant<int, 1>(), t + 1);
  }

  // the two roundings, staged in shared memory (the ring is free), then
  // 16-byte stores of whole rows
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(smem);
  const int c = wn * 32 + 4 * g + 2 * T;
  const float sc0 = n0 + c < N ? round_bf16(scale[n0 + c]) : 0.f;
  const float sc1 = n0 + c < N ? round_bf16(scale[n0 + c + 1]) : 0.f;
#pragma unroll
  for (int i = 0; i < C::kRows / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(o + (8 * i + 2 * tq + h) * C::kOStride + c) =
          pack_bf16(round_bf16(tot[4 * i + h]) * sc0, round_bf16(tot[4 * i + h + 2]) * sc1);
  __syncthreads();
  for (int q = threadIdx.x; q < C::kRows * kSlab / 8; q += C::kThreads) {
    const int r = q / (kSlab / 8), ch = (q % (kSlab / 8)) * 8;
    if (m0 + r < M && n0 + ch < N)
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * N + n0 + ch) =
          *reinterpret_cast<const uint4*>(o + r * C::kOStride + ch);
  }
}

int launch_prefill(const void* x, const void* w, const void* scale, void* out, int M, int K,
                   int N, cudaStream_t stream) {
  using C = PreCfg;
  static bool smem_set = false;
  if (int e = set_smem(w8_matmul_prefill, C::kSmem, smem_set)) return e;
  CUtensorMap tmx, tmw;
  if (int e = make_map(&tmx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, C::kRows, kBK))
    return e;
  if (int e = make_map(&tmw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, kBK, kSlab)) return e;
  const dim3 grid((M + C::kRows - 1) / C::kRows, (N + kSlab - 1) / kSlab);
  w8_matmul_prefill<<<grid, C::kThreads, C::kSmem, stream>>>(
      tmx, tmw, (const float*)scale, (__nv_bfloat16*)out, M, K, N);
  return (int)cudaGetLastError();
}

// -- f32 CUDA-core body -------------------------------------------------------

constexpr int kSimtBM = 32, kSimtBN = 64, kSimtBK = 16, kSimtThreads = 128;

__global__ void __launch_bounds__(kSimtThreads)
w8_matmul_simt(const float* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, float* __restrict__ out, int M, int K, int N) {
  __shared__ float sx[kSimtBM][kSimtBK + 1];
  __shared__ float sw[kSimtBK][kSimtBN];
  const int m0 = blockIdx.x * kSimtBM, n0 = blockIdx.y * kSimtBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // columns 4tx.., rows 4ty..
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kSimtBK) {
    {  // x: 4 floats a thread; rows past M are zeros
      const int r = threadIdx.x / 4, c = (threadIdx.x % 4) * 4, row = m0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < M) v = *reinterpret_cast<const float4*>(x + (size_t)row * K + k0 + c);
      sx[r][c] = v.x, sx[r][c + 1] = v.y, sx[r][c + 2] = v.z, sx[r][c + 3] = v.w;
    }
    {  // w: 8 bytes a thread; columns past N are zeros
      const int r = threadIdx.x / 8, c = (threadIdx.x % 8) * 8, col = n0 + c;
      uint2 v = make_uint2(0u, 0u);
      if (col < N) v = *reinterpret_cast<const uint2*>(w + (size_t)(k0 + r) * N + col);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        sw[r][c + i] = (float)(int8_t)((i < 4 ? v.x : v.y) >> (8 * (i % 4)));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSimtBK; ++kk) {
      float a[4], bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sx[ty * 4 + i][kk], bw[i] = sw[kk][tx * 4 + i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
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
      if (col < N) out[(size_t)row * N + col] = acc[i][j] * scale[col];
    }
  }
}

}  // namespace

// The number of K slices of the bf16 bodies for K x N (ops/quant.py
// w8_splits mirrors it; its slice s starts at row unit * (s * units / S)).
extern "C" int llmk_w8_splits(int K, int N) { return w8_split(K, N).S; }

// x [M, K] (dtype: LLMK_F32 or LLMK_BF16), w int8 [K, N], scale f32 [N],
// out [M, N] in x's dtype; all contiguous and 16-byte aligned, M >= 1, K and N
// multiples of 16. Returns the launch's CUDA error, else cudaGetLastError().
extern "C" int llmk_w8_matmul(const void* x, const void* w, const void* scale, void* out,
                              int M, int K, int N, int dtype, void* stream) {
  if (M < 1 || K < 16 || N < 16 || K % 16 || N % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == LLMK_F32) {
    const dim3 grid((M + kSimtBM - 1) / kSimtBM, (N + kSimtBN - 1) / kSimtBN);
    w8_matmul_simt<<<grid, kSimtThreads, 0, s>>>((const float*)x, (const int8_t*)w,
                                                 (const float*)scale, (float*)out, M, K, N);
    return (int)cudaGetLastError();
  }
  if (dtype == LLMK_BF16) {
    const int S = w8_split(K, N).S;
    if (M <= 8) return launch_nx<8>(x, w, scale, out, M, K, N, S, s);
    if (M <= 16) return launch_nx<16>(x, w, scale, out, M, K, N, S, s);
    if (M <= 32) return launch_nx<32>(x, w, scale, out, M, K, N, S, s);
    if (M <= 64) return launch_nx<64>(x, w, scale, out, M, K, N, S, s);
    return launch_prefill(x, w, scale, out, M, K, N, s);
  }
  return (int)cudaErrorInvalidValue;
}
