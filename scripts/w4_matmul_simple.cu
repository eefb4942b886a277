// The W4A16 kernel's bodies as they were before the Hopper redesign, kept
// only as a timing variant: chip_smoke.py phase 2 and
// scripts/time_w4_matmul.py build this file beside
// llms_on_kubernetes_tpu_torch/csrc/w4_matmul.cu and time the two in turns
// at every timed shape. Nothing in the package calls it.
//
// Semantics are those of ops/quant.py::group_qeinsum_plain. The G groups
// are cut into S contiguous slices of whole groups (w4_simple_split, S a
// power of two from G and N alone); block (column tile, slice s, row tile)
// runs its slice's groups in order from a zero accumulator and writes the
// f32 result to part[s]; w4_fold, a second launch, sums the slices in slice
// order and rounds. bf16 body (w4_matmul_tc): mma.sync.m16n8k16 with x as
// the A operand, each nibble sign-extended by shifts and converted by I2F,
// BM rows (16 for M <= 16, else 64) by 64 columns a block, each group
// staged in chunks of at most 128 rows by cp.async, one stage. The float32
// body (w4_matmul_simt): the CUDA cores, 32 by 64 a block.
#include "../llms_on_kubernetes_tpu_torch/csrc/common.cuh"

using namespace llmk;

namespace {

constexpr int kBN = 64;         // columns a block
constexpr int kThreads = 128;   // four warps
constexpr int kKC = 128;        // K rows a staged chunk, at most
constexpr int kMinBlocks = 256; // blocks (column tiles x slices) to aim for
constexpr int kWS = kBN + 16;   // weight row stride in shared memory (bytes)

// slices of whole groups: a power of two from G and N only
__host__ __device__ inline int w4_simple_split(int G, int N) {
  const int tiles = (N + kBN - 1) / kBN;
  int s = 1;
  while (tiles * s < kMinBlocks && 2 * s <= G) s *= 2;
  return s;
}

// first group of slice s (s = S gives G)
__host__ __device__ __forceinline__ int group_edge(int G, int S, int s) { return s * G / S; }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// one packed byte -> the bf16 pair (low nibble, high nibble), sign-extended
__device__ __forceinline__ uint32_t nibble_pair(uint32_t b) {
  const int lo = (int)(b << 28) >> 28;
  const int hi = (int)(b << 24) >> 28;
  return pack_bf16((float)lo, (float)hi);
}

// acc + part * s - xs * z, each operation rounded on its own
__device__ __forceinline__ float group_step(float acc, float part, float s, float xs, float z) {
  return __fsub_rn(__fadd_rn(acc, __fmul_rn(part, s)), __fmul_rn(xs, z));
}

// stage one chunk of the weight: rows of 64 bytes (columns past N: zeros)
__device__ __forceinline__ void load_w_chunk(int8_t* ws, const int8_t* w, size_t row0, int rows,
                                             int n0, int N) {
  for (int q = threadIdx.x; q < rows * (kBN / 16); q += kThreads) {
    const int r = q / (kBN / 16), p = q % (kBN / 16);
    const bool in = n0 + p * 16 < N;
    cp_async<16>(ws + r * kWS + p * 16, w + (row0 + r) * N + (in ? n0 + p * 16 : 0), in);
  }
}

// -- bf16 body ------------------------------------------------------------------

template <int BM, bool PACKED>
__global__ void __launch_bounds__(kThreads)
w4_matmul_tc(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ scale, const float* __restrict__ zs,
             float* __restrict__ part, int M, int K, int N, int gs, int G, int S) {
  constexpr int kXS = kKC + 8;                 // x row stride (bf16): 16-byte rows, no conflicts
  constexpr int kWR = PACKED ? kKC / 2 : kKC;  // weight rows a chunk
  constexpr int MT = BM / 16;
  __shared__ __align__(16) __nv_bfloat16 xs[BM * kXS];
  __shared__ __align__(16) int8_t ws[kWR * kWS];
  __shared__ float xsum_s[BM];
  const int n0 = blockIdx.x * kBN, s = blockIdx.y, m0 = blockIdx.z * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int gsp = PACKED ? gs / 2 : gs;
  float acc[MT][2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  const int g0 = group_edge(G, S, s), g1 = group_edge(G, S, s + 1);
  for (int g = g0; g < g1; ++g) {
    float pt[MT][2][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) pt[i][j][0] = pt[i][j][1] = pt[i][j][2] = pt[i][j][3] = 0.f;
    float xsum = 0.f;  // thread r < BM: row r's sum over the group, in increasing k
    for (int c0 = 0; c0 < gs; c0 += kKC) {
      const int kc = min(kKC, gs - c0);
      const int xp = kc / 8;  // 16-byte pieces of an x row
      for (int q = threadIdx.x; q < BM * xp; q += kThreads) {
        const int r = q / xp, p = q % xp;
        const bool in = m0 + r < M;
        cp_async<16>(xs + r * kXS + p * 8,
                     x + (size_t)(in ? m0 + r : 0) * K + (size_t)g * gs + c0 + p * 8, in);
      }
      load_w_chunk(ws, w, (size_t)g * gsp + (PACKED ? c0 / 2 : c0), PACKED ? kc / 2 : kc, n0,
                   N);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (threadIdx.x < BM)
        for (int k = 0; k < kc; ++k) xsum += __bfloat162float(xs[threadIdx.x * kXS + k]);
      for (int ks = 0; ks < kc / 16; ++ks) {
        uint32_t b[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = warp * 16 + j * 8 + gid;
          if constexpr (PACKED) {
            b[j][0] = nibble_pair((uint8_t)ws[(ks * 8 + tig) * kWS + col]);
            b[j][1] = nibble_pair((uint8_t)ws[(ks * 8 + 4 + tig) * kWS + col]);
          } else {
            const int8_t* wc = ws + (ks * 16 + 2 * tig) * kWS + col;
            b[j][0] = pack_bf16((float)wc[0], (float)wc[kWS]);
            b[j][1] = pack_bf16((float)wc[8 * kWS], (float)wc[9 * kWS]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const __nv_bfloat16* xr = xs + (mt * 16 + gid) * kXS + ks * 16 + 2 * tig;
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(xr);
          a[1] = *reinterpret_cast<const uint32_t*>(xr + 8 * kXS);
          a[2] = *reinterpret_cast<const uint32_t*>(xr + 8);
          a[3] = *reinterpret_cast<const uint32_t*>(xr + 8 * kXS + 8);
          mma_bf16(pt[mt][0], a, b[0][0], b[0][1]);
          mma_bf16(pt[mt][1], a, b[1][0], b[1][1]);
        }
      }
      __syncthreads();  // the chunk's stage is free
    }
    if (threadIdx.x < BM) xsum_s[threadIdx.x] = round_bf16(xsum);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + warp * 16 + j * 8 + 2 * tig;
      const bool in = col < N;
      const float s0 = in ? scale[(size_t)g * N + col] : 0.f;
      const float s1 = in ? scale[(size_t)g * N + col + 1] : 0.f;
      const float z0 = in ? zs[(size_t)g * N + col] : 0.f;
      const float z1 = in ? zs[(size_t)g * N + col + 1] : 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float xa = xsum_s[mt * 16 + gid], xb = xsum_s[mt * 16 + gid + 8];
        acc[mt][j][0] = group_step(acc[mt][j][0], pt[mt][j][0], s0, xa, z0);
        acc[mt][j][1] = group_step(acc[mt][j][1], pt[mt][j][1], s1, xa, z1);
        acc[mt][j][2] = group_step(acc[mt][j][2], pt[mt][j][2], s0, xb, z0);
        acc[mt][j][3] = group_step(acc[mt][j][3], pt[mt][j][3], s1, xb, z1);
      }
    }
    __syncthreads();  // xsum_s is rewritten by the next group
  }
  float* ps = part + (size_t)s * M * N;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = n0 + warp * 16 + j * 8 + 2 * tig;
    if (col >= N) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r0 = m0 + mt * 16 + gid;
      if (r0 < M)
        *reinterpret_cast<float2*>(ps + (size_t)r0 * N + col) =
            make_float2(acc[mt][j][0], acc[mt][j][1]);
      if (r0 + 8 < M)
        *reinterpret_cast<float2*>(ps + (size_t)(r0 + 8) * N + col) =
            make_float2(acc[mt][j][2], acc[mt][j][3]);
    }
  }
}

// -- float32 body -----------------------------------------------------------------

constexpr int kSimtBM = 32;

template <bool PACKED>
__global__ void __launch_bounds__(kThreads)
w4_matmul_simt(const float* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ zs,
               float* __restrict__ part, int M, int K, int N, int gs, int G, int S) {
  constexpr int kXS = kKC + 4;                 // x row stride (f32): 16-byte rows
  constexpr int kWR = PACKED ? kKC / 2 : kKC;
  __shared__ __align__(16) float xs[kSimtBM * kXS];
  __shared__ __align__(16) int8_t ws[kWR * kWS];
  __shared__ float xsum_s[kSimtBM];
  const int n0 = blockIdx.x * kBN, s = blockIdx.y, m0 = blockIdx.z * kSimtBM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // columns 4tx.., rows 4ty..
  const int gsp = PACKED ? gs / 2 : gs;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int g0 = group_edge(G, S, s), g1 = group_edge(G, S, s + 1);
  for (int g = g0; g < g1; ++g) {
    float pt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pt[i][0] = pt[i][1] = pt[i][2] = pt[i][3] = 0.f;
    float xsum = 0.f;
    for (int c0 = 0; c0 < gs; c0 += kKC) {
      const int kc = min(kKC, gs - c0);
      const int xp = kc / 4;
      for (int q = threadIdx.x; q < kSimtBM * xp; q += kThreads) {
        const int r = q / xp, p = q % xp;
        const bool in = m0 + r < M;
        cp_async<16>(xs + r * kXS + p * 4,
                     x + (size_t)(in ? m0 + r : 0) * K + (size_t)g * gs + c0 + p * 4, in);
      }
      load_w_chunk(ws, w, (size_t)g * gsp + (PACKED ? c0 / 2 : c0), PACKED ? kc / 2 : kc, n0,
                   N);
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
  float* ps = part + (size_t)s * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) ps[(size_t)row * N + col] = acc[i][j];
    }
  }
}

// -- the fold: slices summed in slice order, then one rounding -------------------

template <typename T>
__global__ void w4_fold(const float* __restrict__ part, T* __restrict__ out, size_t MN, int S) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    float t = part[i];
    for (int s = 1; s < S; ++s) t = __fadd_rn(t, part[(size_t)s * MN + i]);
    out[i] = from_float<T>(t);
  }
}

template <typename T>
int launch_fold(const float* part, void* out, int M, int N, int S, cudaStream_t stream) {
  const size_t MN = (size_t)M * N;
  const size_t want = (MN + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  w4_fold<T><<<blocks, 256, 0, stream>>>(part, (T*)out, MN, S);
  return (int)cudaGetLastError();
}

template <int BM, bool PACKED>
int launch_tc(const void* x, const void* w, const void* scale, const void* zs, float* part,
              int M, int K, int N, int gs, int S, cudaStream_t stream) {
  const int G = K / gs;
  const dim3 grid((N + kBN - 1) / kBN, S, (M + BM - 1) / BM);
  w4_matmul_tc<BM, PACKED><<<grid, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w, (const float*)scale, (const float*)zs, part, M,
      K, N, gs, G, S);
  return (int)cudaGetLastError();
}

template <bool PACKED>
int launch_simt(const void* x, const void* w, const void* scale, const void* zs, float* part,
                int M, int K, int N, int gs, int S, cudaStream_t stream) {
  const int G = K / gs;
  const dim3 grid((N + kBN - 1) / kBN, S, (M + kSimtBM - 1) / kSimtBM);
  w4_matmul_simt<PACKED><<<grid, kThreads, 0, stream>>>(
      (const float*)x, (const int8_t*)w, (const float*)scale, (const float*)zs, part, M, K, N,
      gs, G, S);
  return (int)cudaGetLastError();
}

}  // namespace

// The number of K slices for K x N in groups of gs rows: part holds S
// f32 [M, N] results.
extern "C" int llmk_w4_simple_splits(int K, int N, int gs) {
  return w4_simple_split(K / gs, N);
}

// x [M, K] (LLMK_F32 or LLMK_BF16); w int8 [G, gs / 2, N] (packed) or [G,
// gs, N]; scale and zero_scaled f32 [G, N]; part f32 [S, M, N] the slices'
// scratch; out [M, N] in x's dtype. Returns the first launch's CUDA error,
// else cudaGetLastError() of the fold.
extern "C" int llmk_w4_matmul_simple(const void* x, const void* w, const void* scale,
                                     const void* zs, void* part, void* out, int M, int K,
                                     int N, int gs, int packed, int dtype, void* stream) {
  if (M < 1 || gs < 16 || gs % 16 || K % gs || N < 16 || N % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int S = w4_simple_split(K / gs, N);
  float* p = (float*)part;
  int e;
  if (dtype == LLMK_BF16) {
    if (M <= 16)
      e = packed ? launch_tc<16, true>(x, w, scale, zs, p, M, K, N, gs, S, st)
                 : launch_tc<16, false>(x, w, scale, zs, p, M, K, N, gs, S, st);
    else
      e = packed ? launch_tc<64, true>(x, w, scale, zs, p, M, K, N, gs, S, st)
                 : launch_tc<64, false>(x, w, scale, zs, p, M, K, N, gs, S, st);
    if (e) return e;
    return launch_fold<__nv_bfloat16>(p, out, M, N, S, st);
  }
  if (dtype == LLMK_F32) {
    e = packed ? launch_simt<true>(x, w, scale, zs, p, M, K, N, gs, S, st)
               : launch_simt<false>(x, w, scale, zs, p, M, K, N, gs, S, st);
    if (e) return e;
    return launch_fold<float>(p, out, M, N, S, st);
  }
  return (int)cudaErrorInvalidValue;
}
