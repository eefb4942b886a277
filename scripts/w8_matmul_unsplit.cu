// The W8A16 kernel's bf16 bodies as they were before the K split, kept
// only as a timing variant: chip_smoke.py phase 2 builds this file beside
// llms_on_kubernetes_tpu_torch/csrc/w8_matmul.cu and times the two in turns
// at every timed shape. Nothing in the package calls it.
//
// Every output is one f32 chain over K in order (mma.sync.m16n8k16 steps,
// never split); int8 bytes become bf16 through f32 (I2F). Two block shapes:
// for M <= 64 one warp of 16 rows by 32 columns, 128-deep K tiles in a
// 4-deep ring (a grid of ceil(M / 16) x N / 32 one-warp blocks); above it,
// four warps of 64 rows by 32 columns (128 by 64 a block), 32-deep K tiles
// in a 3-deep ring.
#include "../llms_on_kubernetes_tpu_torch/csrc/common.cuh"

using namespace llmk;

namespace {

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

}  // namespace

// bf16 x [M, K], int8 w [K, N], f32 scale [N] -> bf16 out [M, N]; the
// shapes csrc/w8_matmul.cu's llmk_w8_matmul takes for bf16.
extern "C" int llmk_w8_matmul_unsplit(const void* x, const void* w, const void* scale,
                                      void* out, int M, int K, int N, void* stream) {
  if (M < 1 || K < 16 || N < 16 || K % 16 || N % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 64) return launch_tc<1, 1, 1, 128, 4>(x, w, scale, out, M, K, N, s);
  return launch_tc<4, 2, 2, 32, 3>(x, w, scale, out, M, K, N, s);
}
