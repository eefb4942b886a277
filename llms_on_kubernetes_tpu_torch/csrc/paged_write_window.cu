// Windowed in-place KV append for Hopper (sm_90a): up to W rows per slot
// into the paged pool, one source for both pool kinds.
//
// Replaces two TPU kernels of llms_on_kubernetes_tpu/ops/pallas_paged.py:
//   float pool: pallas_paged_write_window       (body _paged_kernel_write_window)
//   int8 pool:  pallas_paged_write_window_int8  (bodies
//               _paged_kernel_write_window_int8 and _quantize_row)
//
// Semantics are those of the plain versions in ops/paged_write.py: slot b's
// rows t < widths[b] of k_new/v_new [B, W, n_kv, d] go to positions
// base[b] + t, page page_table[b, pos / page], row pos % page, of the
// head-major pool [n_kv, P, page, d] (a float pool takes the rows as they
// are: the wrapper casts them to the pool dtype; an int8 pool takes each
// (row, KV head) quantized as engine/cache.quantize_kv quantizes it, data
// and its f32 scale [n_kv, P, page]). Rows past widths[b] are not written,
// nor is a row whose position falls outside the page table, and no other
// pool byte changes. The chunk path of the decoder writes a prompt chunk
// this way (base = history, widths = the chunk's length).
//
// What bounds it on the H100: it moves bytes and does next to no
// arithmetic, so the bound is device memory (3.35 TB/s): each new row read
// once and each pool row written once.
//
// Design: the TPU kernel appended token by token, each a read-modify-write
// of the 8-row block the token lands in, chained in token order, because
// Mosaic's DMA copies whole (8, d) tiles. Here every (slot, token, KV head)
// row is an independent direct store, and nothing is read back from the
// pool. Float pool: one thread per 16-byte vector of a row moves that
// vector of K and of V. int8 pool: one warp per (row, KV head, side)
// quantizes the row with quantize.cuh's quantize_row -- the function the
// fused decode append (paged_decode.cuh) uses, so both store the same
// bytes -- and stores the int8 row and its scale. A row past its slot's
// width returns at once.
#include <stdint.h>

#include "common.cuh"
#include "quantize.cuh"

using namespace llmk;

namespace {

constexpr int kThreads = 128;

// The pool position of row t of slot b, or -1 when the row is not written.
__device__ __forceinline__ long long window_row(const int* __restrict__ page_table,
                                                const int* __restrict__ base,
                                                const int* __restrict__ widths, int b, int t,
                                                int kvh, int pool_pages, int page, int pps) {
  if (t >= widths[b]) return -1;
  const int pos = base[b] + t;
  if (pos < 0 || pos / page >= pps) return -1;
  return ((long long)kvh * pool_pages + page_table[(size_t)b * pps + pos / page]) * page +
         pos % page;
}

// Float pool (KV = float or bf16; k_new/v_new already in KV): one thread
// per 16-byte vector of one (slot, token, KV head) row, K and V.
template <typename KV, int D>
__global__ void __launch_bounds__(kThreads)
write_window_kernel(KV* __restrict__ k_pool, KV* __restrict__ v_pool,
                    const int* __restrict__ page_table, const int* __restrict__ base,
                    const int* __restrict__ widths, const KV* __restrict__ k_new,
                    const KV* __restrict__ v_new, int W, int n_kv, int pool_pages, int page,
                    int pps, long long n_vecs) {
  constexpr int kRowBytes = D * (int)sizeof(KV);
  static_assert(kRowBytes % 16 == 0, "a float pool row must be whole 16-byte vectors");
  constexpr int kVecs = kRowBytes / 16;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n_vecs) return;
  const int c = (int)(idx % kVecs);
  const long long row = idx / kVecs;  // ((b * W) + t) * n_kv + kvh
  const int kvh = (int)(row % n_kv);
  const int t = (int)((row / n_kv) % W);
  const int b = (int)(row / ((long long)n_kv * W));
  const long long dst = window_row(page_table, base, widths, b, t, kvh, pool_pages, page, pps);
  if (dst < 0) return;
  const uint4 kv = reinterpret_cast<const uint4*>(k_new + row * D)[c];
  const uint4 vv = reinterpret_cast<const uint4*>(v_new + row * D)[c];
  reinterpret_cast<uint4*>(k_pool + dst * D)[c] = kv;
  reinterpret_cast<uint4*>(v_pool + dst * D)[c] = vv;
}

// int8 pool (k_new/v_new in T = float or bf16): one warp per (slot, token,
// KV head, side) quantizes the row and stores its bytes and scale.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
write_window_int8_kernel(int8_t* __restrict__ k_pool, float* __restrict__ k_scale,
                         int8_t* __restrict__ v_pool, float* __restrict__ v_scale,
                         const int* __restrict__ page_table, const int* __restrict__ base,
                         const int* __restrict__ widths, const T* __restrict__ k_new,
                         const T* __restrict__ v_new, int W, int n_kv, int pool_pages, int page,
                         int pps, long long n_rows) {
  const long long gw = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  const int side = (int)(gw & 1);  // 0: K, 1: V
  const long long row = gw >> 1;   // ((b * W) + t) * n_kv + kvh
  if (row >= n_rows) return;       // whole warps: the shuffles stay full
  const int kvh = (int)(row % n_kv);
  const int t = (int)((row / n_kv) % W);
  const int b = (int)(row / ((long long)n_kv * W));
  const long long dst = window_row(page_table, base, widths, b, t, kvh, pool_pages, page, pps);
  if (dst < 0) return;
  int8_t q[(D + 31) / 32];
  const float s = quantize_row<T, D>((side ? v_new : k_new) + row * D, lane, q);
  int8_t* pool = side ? v_pool : k_pool;
#pragma unroll
  for (int c = 0; c < (D + 31) / 32; ++c) {
    const int i = lane + 32 * c;
    if (i < D) pool[dst * D + i] = q[c];
  }
  if (lane == 0) (side ? v_scale : k_scale)[dst] = s;
}

template <typename KV>
int launch_float(void* k_pool, void* v_pool, const int* page_table, const int* base,
                 const int* widths, const void* k_new, const void* v_new, int B, int W,
                 int n_kv, int pool_pages, int page, int pps, int d, cudaStream_t stream) {
  LLMK_DISPATCH_D(d, {
    const long long n_vecs = (long long)B * W * n_kv * (D * (int)sizeof(KV) / 16);
    const long long blocks = (n_vecs + kThreads - 1) / kThreads;
    write_window_kernel<KV, D><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (KV*)k_pool, (KV*)v_pool, page_table, base, widths, (const KV*)k_new,
        (const KV*)v_new, W, n_kv, pool_pages, page, pps, n_vecs);
  });
  return (int)cudaGetLastError();
}

template <typename T>
int launch_int8(void* k_pool, void* k_scale, void* v_pool, void* v_scale, const int* page_table,
                const int* base, const int* widths, const void* k_new, const void* v_new, int B,
                int W, int n_kv, int pool_pages, int page, int pps, int d, cudaStream_t stream) {
  LLMK_DISPATCH_D(d, {
    const long long n_rows = (long long)B * W * n_kv;
    const long long blocks = (2 * n_rows * 32 + kThreads - 1) / kThreads;
    write_window_int8_kernel<T, D><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (int8_t*)k_pool, (float*)k_scale, (int8_t*)v_pool, (float*)v_scale, page_table, base,
        widths, (const T*)k_new, (const T*)v_new, W, n_kv, pool_pages, page, pps, n_rows);
  });
  return (int)cudaGetLastError();
}

}  // namespace

// k_pool/v_pool [n_kv, pool_pages, page, d] in pool_dtype (LLMK_F32,
// LLMK_BF16 or LLMK_I8); k_scale/v_scale [n_kv, pool_pages, page] float32
// for an int8 pool (unused otherwise); page_table [B, pps] int32 (global
// page ids); base/widths [B] int32; k_new/v_new [B, W, n_kv, d] in
// new_dtype: the pool's own for a float pool, LLMK_F32 or LLMK_BF16 for an
// int8 pool. All contiguous, pools and rows 16-byte aligned. B * W > 0.
// Returns cudaGetLastError() after the launch.
extern "C" int llmk_paged_write_window(void* k_pool, void* k_scale, void* v_pool, void* v_scale,
                                       const void* page_table, const void* base,
                                       const void* widths, const void* k_new, const void* v_new,
                                       int B, int W, int n_kv, int pool_pages, int page, int pps,
                                       int d, int pool_dtype, int new_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* pt = (const int*)page_table;
  const int* bs = (const int*)base;
  const int* ws = (const int*)widths;
  if (B <= 0 || W <= 0 || n_kv <= 0 || page <= 0 || pps <= 0) return (int)cudaErrorInvalidValue;
  if (pool_dtype == LLMK_I8) {
    if (new_dtype == LLMK_F32)
      return launch_int8<float>(k_pool, k_scale, v_pool, v_scale, pt, bs, ws, k_new, v_new, B,
                                W, n_kv, pool_pages, page, pps, d, s);
    if (new_dtype == LLMK_BF16)
      return launch_int8<__nv_bfloat16>(k_pool, k_scale, v_pool, v_scale, pt, bs, ws, k_new,
                                        v_new, B, W, n_kv, pool_pages, page, pps, d, s);
    return (int)cudaErrorInvalidValue;
  }
  if (new_dtype != pool_dtype) return (int)cudaErrorInvalidValue;
  if (pool_dtype == LLMK_F32)
    return launch_float<float>(k_pool, v_pool, pt, bs, ws, k_new, v_new, B, W, n_kv,
                               pool_pages, page, pps, d, s);
  if (pool_dtype == LLMK_BF16)
    return launch_float<__nv_bfloat16>(k_pool, v_pool, pt, bs, ws, k_new, v_new, B, W, n_kv,
                                       pool_pages, page, pps, d, s);
  return (int)cudaErrorInvalidValue;
}
