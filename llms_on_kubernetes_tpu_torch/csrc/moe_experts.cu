// Routed expert FFN of a Mixture-of-Experts layer for Hopper (sm_90a).
//
// The port's own kernel: it replaces no Pallas kernel. The JAX package
// computes this product in llms_on_kubernetes_tpu/ops/moe.py:33 moe_block as
// one-hot dispatch and combine einsums around a batched expert matmul, left
// to XLA. That form does E / k times the FLOPs routing needs and holds a
// [N, k, E, C = N] one-hot (34.4 GB in bf16 at Qwen3-30B-A3B's widths and a
// 4,096-token bucket), so the port routes instead: ops/moe.py::moe_route
// puts each kept (token, choice) claim at a row of an expert-major buffer,
// rows [offset_e, offset_e + count_e) for expert e, and this kernel computes,
// for every such row r of expert e,
//
//   h[r] = round(round(SiLU(round(x[src[r]] W_gate[e]))) * round(x[src[r]] W_up[e]))
//   y[r] = round(h[r] W_down[e])
//
// with f32 sums and round() to bf16, the rounding of the plain version,
// ops/moe.py::moe_experts_plain. Two launches of one template: gate/up
// (GATED, A rows gathered through src, the SiLU product in the epilogue,
// h [R, F]) and down (A = h's rows in place, y [R, D]). Weights keep the JAX
// layouts: W_gate and W_up [E, D, F], W_down [E, F, D], each [K, N] row-major
// for its expert.
//
// Work list without a host read: the grid is static, sized for the worst
// case, (N / 64 column tiles) x (ceil(R / 64) + min(E, R) row tiles). Each
// block reads the per-expert counts from device memory, and warp 0 finds its
// tile (expert, first row, rows) by a running sum over them (tiles of 64 rows
// within each expert, experts in order); a block past the last tile exits.
// So the kernel is captured in a CUDA graph as it is and reads each touched
// expert's weights once per column tile, for the rows that chose it.
//
// Bounds: at decode (8-64 tokens x top-8) the kernel reads the weights of
// the experts the step touches (9.44 MB an expert at D 2,048, F 768 in
// bf16) and little else: bytes bound it. At prefill (thousands of rows an
// expert) the tensor-core operations do.
//
// Batch-invariant: the tile shape (64 x 64, four warps of 16 columns), the K
// order (32-deep stages in order, two mma k16 steps each) and the epilogue
// depend on D and F only, and mma.sync computes each output element alone,
// so a row's result is bit for bit the same wherever it falls in a tile and
// however many rows run with it (held on the card: chip_smoke.py phase "moe"
// and tests/test_torch_cuda.py). Within a tile, 16-row slabs past the tile's
// rows are skipped (a block-uniform branch), so a decode tile with one row
// issues a quarter of the products.
//
// A simple body that is right: mma.sync.m16n8k16 bf16 -> f32 with A read by
// ldmatrix and the weights by ldmatrix.trans from a 4-stage cp.async ring.
// No wgmma, no TMA, no persistent blocks (a later redesign; see PERF.md).
#include "common.cuh"

using namespace llmk;

namespace {

constexpr int kBM = 64;        // expert-major rows a tile
constexpr int kBN = 64;        // output columns a block: four warps of 16
constexpr int kKC = 32;        // contraction rows a stage
constexpr int kStages = 4;
constexpr int kThreads = 128;
constexpr int kAS = kKC + 8;   // A row stride (bf16): 80-byte rows
constexpr int kBS = kBN + 8;   // weight row stride (bf16): 144-byte rows
constexpr int kATile = kBM * kAS;
constexpr int kBTile = kKC * kBS;

template <bool GATED>
constexpr size_t smem_bytes() {
  return (size_t)kStages * (kATile + (GATED ? 2 : 1) * kBTile) * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// h = round(round(SiLU(g)) * u) for rounded g and u, SiLU as torch computes
// it in float: g / (1 + exp(-g))
__device__ __forceinline__ float silu_mul(float acc_g, float acc_u) {
  const float g = round_bf16(acc_g), u = round_bf16(acc_u);
  const float s = round_bf16(g / (1.0f + expf(-g)));
  return s * u;
}

template <bool GATED>
__global__ void __launch_bounds__(kThreads)
moe_expert_gemm(const __nv_bfloat16* __restrict__ a, const int* __restrict__ src,
                const int* __restrict__ counts, const __nv_bfloat16* __restrict__ w1,
                const __nv_bfloat16* __restrict__ w2, __nv_bfloat16* __restrict__ out, int E,
                int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB1 = sA + kStages * kATile;
  __nv_bfloat16* sB2 = sB1 + kStages * kBTile;  // GATED only
  __shared__ int s_tile[3];                      // expert, first row, rows
  __shared__ int s_arow[kBM];                    // A row of each tile row, -1 past rows
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = blockIdx.y, n0 = blockIdx.x * kBN;

  // -- this block's tile: tiles of kBM rows within each expert, in order --
  if (warp == 0) {
    if (lane == 0) s_tile[2] = 0;
    __syncwarp();
    int tbase = 0, rbase = 0;
    for (int c0 = 0; c0 < E; c0 += 32) {
      const int e = c0 + lane;
      const int cnt = e < E ? counts[e] : 0;
      const int nt = (cnt + kBM - 1) / kBM;
      int ti = nt, ri = cnt;  // inclusive running sums over the lanes
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int ta = __shfl_up_sync(LLMK_FULL_MASK, ti, o);
        const int ra = __shfl_up_sync(LLMK_FULL_MASK, ri, o);
        if (lane >= o) ti += ta, ri += ra;
      }
      const int first = tbase + ti - nt;
      if (t >= first && t < first + nt) {
        const int local = t - first;
        s_tile[0] = e;
        s_tile[1] = rbase + ri - cnt + local * kBM;
        s_tile[2] = min(kBM, cnt - local * kBM);
      }
      tbase += __shfl_sync(LLMK_FULL_MASK, ti, 31);
      rbase += __shfl_sync(LLMK_FULL_MASK, ri, 31);
      if (tbase > t) break;  // warp-uniform: the tile was in this chunk
    }
  }
  __syncthreads();
  const int rows = s_tile[2];
  if (rows <= 0) return;  // past the last tile
  const int e = s_tile[0], row0 = s_tile[1];
  if (threadIdx.x < kBM)
    s_arow[threadIdx.x] =
        threadIdx.x < rows ? (GATED ? src[row0 + threadIdx.x] : row0 + threadIdx.x) : -1;
  __syncthreads();

  const __nv_bfloat16* W1 = w1 + (size_t)e * K * N;
  const __nv_bfloat16* W2 = GATED ? w2 + (size_t)e * K * N : nullptr;
  auto load_stage = [&](int buf, int kc) {
    const int k0 = kc * kKC;
    __nv_bfloat16* dA = sA + buf * kATile;
    for (int q = threadIdx.x; q < kBM * (kKC / 8); q += kThreads) {
      const int r = q / (kKC / 8), p = q % (kKC / 8);
      const int ar = s_arow[r];
      cp_async<16>(dA + r * kAS + p * 8, a + (size_t)(ar >= 0 ? ar : 0) * K + k0 + p * 8,
                   ar >= 0);
    }
    for (int q = threadIdx.x; q < kKC * (kBN / 8); q += kThreads) {
      const int r = q / (kBN / 8), p = q % (kBN / 8);
      const int col = n0 + p * 8;
      const bool in = col < N;
      const size_t off = (size_t)(k0 + r) * N + (in ? col : 0);
      cp_async<16>(sB1 + buf * kBTile + r * kBS + p * 8, W1 + off, in);
      if constexpr (GATED) cp_async<16>(sB2 + buf * kBTile + r * kBS + p * 8, W2 + off, in);
    }
  };

  float acc1[4][2][4], acc2[GATED ? 4 : 1][2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc1[i][j][c] = 0.f;
#pragma unroll
  for (int i = 0; i < (GATED ? 4 : 1); ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc2[i][j][c] = 0.f;

  const int nk = K / kKC;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  const bool col_in = n0 + warp * 16 < N;  // N % 32 == 0: a warp's 16 columns are all in or out
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kc landed; every warp is done with stage kc - 1's buffer
    const int nxt = kc + kStages - 1;
    if (nxt < nk) load_stage(nxt % kStages, nxt);
    cp_async_commit();
    if (!col_in) continue;
    const int buf = kc % kStages;
    const __nv_bfloat16* tA = sA + buf * kATile;
    const __nv_bfloat16* tB1 = sB1 + buf * kBTile;
    const __nv_bfloat16* tB2 = sB2 + buf * kBTile;
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      const int boff = (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kBS + warp * 16 +
                       (lane >> 4) * 8;
      uint32_t b1[4], b2[4];
      ldmatrix_x4_trans(b1, tB1 + boff);
      if constexpr (GATED) ldmatrix_x4_trans(b2, tB2 + boff);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt * 16 >= rows) break;  // block-uniform
        uint32_t af[4];
        ldmatrix_x4(af, tA + (mt * 16 + (lane & 15)) * kAS + ks * 16 + (lane >> 4) * 8);
        mma_bf16(acc1[mt][0], af, b1[0], b1[1]);
        mma_bf16(acc1[mt][1], af, b1[2], b1[3]);
        if constexpr (GATED) {
          mma_bf16(acc2[mt][0], af, b2[0], b2[1]);
          mma_bf16(acc2[mt][1], af, b2[2], b2[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!col_in) return;

  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    if (mt * 16 >= rows) break;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + warp * 16 + j * 8 + 2 * tig;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mt * 16 + gid + half * 8;
        if (r >= rows) continue;
        float v0 = acc1[mt][j][2 * half], v1 = acc1[mt][j][2 * half + 1];
        if constexpr (GATED) {
          v0 = silu_mul(v0, acc2[mt][j][2 * half]);
          v1 = silu_mul(v1, acc2[mt][j][2 * half + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row0 + r) * N + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <bool GATED>
int launch(const void* a, const int* src, const int* counts, const void* w1, const void* w2,
           void* out, int R, int E, int K, int N, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(moe_expert_gemm<GATED>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem_bytes<GATED>());
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int tiles = (R + kBM - 1) / kBM + (E < R ? E : R);
  const dim3 grid((N + kBN - 1) / kBN, tiles);
  moe_expert_gemm<GATED><<<grid, kThreads, smem_bytes<GATED>(), stream>>>(
      (const __nv_bfloat16*)a, src, counts, (const __nv_bfloat16*)w1,
      (const __nv_bfloat16*)w2, (__nv_bfloat16*)out, E, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// x [N, D] bf16; src [R] int32 (the token of each expert-major row); counts
// [E] int32 (rows an expert, sum <= R, in expert order from row 0); w_gate,
// w_up [E, D, F] and w_down [E, F, D] bf16; h [R, F] and y [R, D] bf16
// outputs (rows past sum(counts) are not written). All contiguous, 16-byte
// aligned; D and F multiples of 32. Returns the first launch's CUDA error,
// else the second's.
extern "C" int llmk_moe_experts(const void* x, const void* src, const void* counts,
                                const void* w_gate, const void* w_up, const void* w_down,
                                void* h, void* y, int R, int E, int D, int F, void* stream) {
  if (R < 1 || E < 1 || D < 32 || D % 32 || F < 32 || F % 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* s = (const int*)src;
  const int* c = (const int*)counts;
  const int e = launch<true>(x, s, c, w_gate, w_up, h, R, E, D, F, st);
  if (e) return e;
  return launch<false>(h, nullptr, c, w_down, nullptr, y, R, E, F, D, st);
}
