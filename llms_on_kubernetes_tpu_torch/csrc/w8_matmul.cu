// Weight-only int8 matrix product (W8A16) for Hopper (sm_90a).
//
// The port's own kernel: the JAX package computes this product in
// llms_on_kubernetes_tpu/ops/quant.py:311 qeinsum and leaves it to XLA,
// which fuses the int8 -> bf16 convert into the matrix unit's operand load,
// so the bf16 weight never reaches device memory. In PyTorch,
// matmul(x, w.to(bf16)) writes and re-reads a bf16 copy of every weight on
// every call; this kernel converts the int8 tile on its way from shared
// memory to the tensor cores instead. Semantics are those of the plain
// version, ops/quant.py::w8_matmul_plain:
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
// 2 M K N operations at 989 TFLOP/s. The design streams the weight once per
// block of rows in 16-byte cp.async copies, several tiles in flight, and
// does the products on mma.sync; it is simple and right first, and is not
// yet at either bound (PERF.md kernel table): wgmma, TMA and split-K for
// the small-N shapes are later work (ROADMAP.md queue 2).
//
// Two bodies:
//
// - bf16: tensor cores. A warp owns 16 * MT rows by 32 columns: four
//   mma.sync.m16n8k16 column tiles, bf16 in, f32 accumulators. x tiles are
//   staged by 16-byte cp.async into shared rows padded by 16 bytes (ldmatrix
//   reads them without bank conflicts); w tiles are staged as int8 by
//   16-byte cp.async into rows padded by 16 bytes, a ring of STAGES tiles.
//   ldmatrix moves 16-bit elements only, so B fragments are built in
//   registers: mma column c of column tile j is the warp's column 4c + j,
//   so one 32-bit shared load gives a lane its column in all four tiles;
//   each int8 byte becomes f32 and then bf16, both exact (|w| <= 127). The
//   same mapping puts a lane's eight output columns side by side: one
//   16-byte store a row. Two shapes of block: for M <= 64, one warp of 16
//   rows by 32 columns and 128-deep K tiles in a 4-deep ring (many blocks,
//   many bytes in flight: decode moves the weight and little else); above
//   it, four warps of 64 rows by 32 columns (128 by 64 a block), 32-deep K
//   tiles in a 3-deep ring (each B fragment serves four row tiles).
// - float32: the CUDA cores, 32 rows by 64 columns a block, each thread
//   4 by 4 outputs, one fmaf a product. The float32 checks (1e-4 against
//   the plain version, the debug-tiny reference on the card) need full f32
//   products, which TF32 tensor cores would not give.
//
// Batch invariance: every output is one chain of f32 accumulations over K
// in increasing order, 16 deep a step on the tensor cores and one product a
// step on the CUDA cores, never split; the block shape only chooses which
// outputs a warp owns. A row's result is therefore the same at any M and at
// any place in the call (held bit for bit on the card: chip_smoke.py phase 2
// and tests/test_torch_cuda.py), so a request's logits do not depend on how
// many rows shared its prefill.
#include "common.cuh"

using namespace llmk;

namespace {

// -- bf16 tensor-core body ----------------------------------------------------

constexpr int kNT = 4;  // mma column tiles a warp: 32 columns

template <int MT, int WM, int WN, int BK, int STAGES>
struct TcCfg {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kBM = 16 * MT * WM;       // rows a block
  static constexpr int kBN = 8 * kNT * WN;       // columns a block
  static constexpr int kAStride = BK + 8;        // bf16 a staged x row
  static constexpr int kBStride = kBN + 16;      // bytes a staged w row
  static constexpr int kATile = kBM * kAStride;  // elements a stage
  static constexpr int kBTile = BK * kBStride;   // bytes a stage
  static constexpr int kAChunks = kBM * BK / 8;  // 16-byte copies a stage
  static constexpr int kBChunks = BK * kBN / 16;
  static_assert(BK % 16 == 0 && kAChunks % kThreads == 0 && kBChunks % kThreads == 0,
                "whole copies per thread");
  static_assert(sizeof(__nv_bfloat16) * STAGES * kATile + STAGES * kBTile <= 48 * 1024,
                "static shared memory");
};

// Stage K tile kt of the block's rows of x and columns of w; rows past M and
// columns past N are zero-filled (K and N are multiples of 16, so a 16-byte
// copy is wholly in or out).
template <typename C, int BK>
__device__ __forceinline__ void load_stage(__nv_bfloat16* a, int8_t* b,
                                           const __nv_bfloat16* __restrict__ x,
                                           const int8_t* __restrict__ w, int m0, int n0,
                                           int kt, int M, int K, int N) {
  const int k0 = kt * BK;
#pragma unroll
  for (int n = 0; n < C::kAChunks / C::kThreads; ++n) {
    const int idx = threadIdx.x + n * C::kThreads;
    const int r = idx / (BK / 8), c = idx % (BK / 8);
    const int row = m0 + r, col = k0 + c * 8;
    const bool in = row < M && col < K;
    cp_async<16>(a + r * C::kAStride + c * 8, x + (in ? (size_t)row * K + col : 0), in);
  }
#pragma unroll
  for (int n = 0; n < C::kBChunks / C::kThreads; ++n) {
    const int idx = threadIdx.x + n * C::kThreads;
    const int r = idx / (C::kBN / 16), c = idx % (C::kBN / 16);
    const int kr = k0 + r, col = n0 + c * 16;
    const bool in = kr < K && col < N;
    cp_async<16>(b + r * C::kBStride + c * 16, w + (in ? (size_t)kr * N + col : 0), in);
  }
}

// byte j of two words as one bf16 pair, lo in the low half: int8 -> f32 ->
// bf16, both exact
__device__ __forceinline__ uint32_t s8_pair(uint32_t lo, uint32_t hi, int j) {
  return pack_bf16((float)(int8_t)(lo >> (8 * j)), (float)(int8_t)(hi >> (8 * j)));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int MT, int WM, int WN, int BK, int STAGES>
__global__ void __launch_bounds__(32 * WM * WN)
w8_matmul_tc(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int M, int K,
             int N) {
  using C = TcCfg<MT, WM, WN, BK, STAGES>;
  __shared__ __align__(16) __nv_bfloat16 sA[STAGES * C::kATile];
  __shared__ __align__(16) int8_t sB[STAGES * C::kBTile];

  // grid (row block, column block): blocks that share a weight slab run
  // side by side, so the slab is read from device memory about once
  const int m0 = blockIdx.x * C::kBM, n0 = blockIdx.y * C::kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, tq = lane & 3;
  const int n_tiles = (K + BK - 1) / BK;

  float acc[MT][kNT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles)
      load_stage<C, BK>(sA + s * C::kATile, sB + s * C::kBTile, x, w, m0, n0, s, M, K, N);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
    const int pf = kt + STAGES - 1;
    if (pf < n_tiles)
      load_stage<C, BK>(sA + (pf % STAGES) * C::kATile, sB + (pf % STAGES) * C::kBTile, x, w,
                        m0, n0, pf, M, K, N);
    cp_async_commit();
    const __nv_bfloat16* a = sA + (kt % STAGES) * C::kATile;
    const int8_t* b = sB + (kt % STAGES) * C::kBTile;
    // 16-deep steps in this tile: the chain over K is the same at every M
    const int steps = min(BK, K - kt * BK) / 16;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (kk < steps) {
        // k rows 2tq, 2tq + 1, 2tq + 8, 2tq + 9 of this step, columns
        // 4g .. 4g + 3 of the warp's 32: byte j is column tile j's
        const int8_t* bp = b + (kk * 16 + 2 * tq) * C::kBStride + wn * 32 + g * 4;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(bp + C::kBStride);
        const uint32_t w2 = *reinterpret_cast<const uint32_t*>(bp + 8 * C::kBStride);
        const uint32_t w3 = *reinterpret_cast<const uint32_t*>(bp + 9 * C::kBStride);
        uint32_t b0[kNT], b1[kNT];
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          b0[j] = s8_pair(w0, w1, j);
          b1[j] = s8_pair(w2, w3, j);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t af[4];
          ldmatrix_x4(af, a + (wm * 16 * MT + i * 16 + (lane & 15)) * C::kAStride + kk * 16 +
                              (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < kNT; ++j) mma_bf16(acc[i][j], af, b0[j], b1[j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // this lane's columns col .. col + 7: mma columns 2tq (acc[.][j][0|2]) and
  // 2tq + 1 (acc[.][j][1|3]) of tile j are columns 8tq + j and 8tq + 4 + j
  const int col = n0 + wn * 32 + tq * 8;
  if (col >= N) return;
  float sc[8];
  const float4 s_lo = *reinterpret_cast<const float4*>(scale + col);
  const float4 s_hi = *reinterpret_cast<const float4*>(scale + col + 4);
  sc[0] = s_lo.x, sc[1] = s_lo.y, sc[2] = s_lo.z, sc[3] = s_lo.w;
  sc[4] = s_hi.x, sc[5] = s_hi.y, sc[6] = s_hi.z, sc[7] = s_hi.w;
#pragma unroll
  for (int i = 0; i < 8; ++i) sc[i] = round_bf16(sc[i]);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 16 * MT + i * 16 + g + half * 8;
      if (row >= M) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        v[j] = round_bf16(acc[i][j][2 * half]) * sc[j];
        v[4 + j] = round_bf16(acc[i][j][2 * half + 1]) * sc[4 + j];
      }
      *reinterpret_cast<uint4*>(out + (size_t)row * N + col) =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                     pack_bf16(v[6], v[7]));
    }
  }
}

template <int MT, int WM, int WN, int BK, int STAGES>
int launch_tc(const void* x, const void* w, const void* scale, void* out, int M, int K, int N,
              cudaStream_t stream) {
  using C = TcCfg<MT, WM, WN, BK, STAGES>;
  const dim3 grid((M + C::kBM - 1) / C::kBM, (N + C::kBN - 1) / C::kBN);
  w8_matmul_tc<MT, WM, WN, BK, STAGES><<<grid, C::kThreads, 0, stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w, (const float*)scale, (__nv_bfloat16*)out, M,
      K, N);
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

// x [M, K] (dtype: LLMK_F32 or LLMK_BF16), w int8 [K, N], scale f32 [N],
// out [M, N] in x's dtype; all contiguous and 16-byte aligned, M >= 1, K and N
// multiples of 16. Returns cudaGetLastError() after the launch.
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
    if (M <= 64) return launch_tc<1, 1, 1, 128, 4>(x, w, scale, out, M, K, N, s);
    return launch_tc<4, 2, 2, 32, 3>(x, w, scale, out, M, K, N, s);
  }
  return (int)cudaErrorInvalidValue;
}
