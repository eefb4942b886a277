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
// pool byte changes; nothing is read back from the pool. The chunk path of
// the decoder writes a prompt chunk this way (base = history, widths = the
// chunk's length).
//
// What bounds it on the H100: it moves bytes and does little arithmetic,
// so the bound is device memory (3.35 TB/s): each written row read once
// and written once. At the chunk path's sizes (0.8-25 MB) that is 0.3-7.5
// us, the order of a launch, so at one slot what counts is the chain of
// dependent steps a block waits through, and at four slots the rate.
//
// Design: the TPU kernel appended token by token, each a read-modify-write
// of the 8-row block the token lands in, because Mosaic's DMA copies whole
// (8, d) tiles. Here one block takes one (span, KV head, slot): a span is
// the run of window rows that land on one pool page, at most kSpanRows
// (R = 16) of them -- a page of more than R rows (a multiple of R) takes
// several spans. Positions are cut into aligned pieces of rp = min(page,
// R) rows; span s of slot b is piece floor(base / rp) + s, clipped to the
// rows t < min(widths[b], W) and to positions in [0, pps * page), so its
// rows are ONE contiguous run of the pool and a slot has at most
// ceil((W - 1) / rp) + 1 spans: the grid is fixed on the host from W and
// the page alone, with no sync. ops/paged_write._window_spans is these
// formulas in plain Python, and the CPU tests hold them. The chain is two
// round trips to device memory: thread 0 reads base[b] and widths[b] and
// publishes the span in shared memory (a block whose span holds no
// written row returns at once); then every thread loads its 16-byte
// vectors of the rows, K and V, while thread 0 reads the span's page id, and
// after one barrier the threads store. Index math is 32-bit; only the pool
// offset is 64-bit.
//   float pool: 128 threads move the span's vectors (two each at bf16
//     d 128), loads before stores; the destination run is contiguous, so
//     the stores coalesce.
//   int8 pool: a row is spread over the L = d * elt / 16 lanes of an
//     aligned group of a warp (16 at bf16 d 128), each quantizing its
//     vector in registers with quantize.cuh's quantize_vec (the chain of
//     quantize_row, which the fused decode append uses, so both store the
//     same bytes; amax by shuffles within the group) and storing its int8
//     values directly; the group's first lane stores the row's scale.
// Measured on the H100 (PERF.md, PR 5): 16-row spans beat 64-row ones
// (more blocks share the loads and the quantization at one slot), 128
// float threads beat a thread a vector at four slots, and 1-D bulk
// asynchronous copies (the TMA engine: one copy a 256-byte row into shared
// memory, one bulk store a side) were 1.2-3.6 us slower at one slot than
// plain 16-byte loads on the same grid.
#include <stdint.h>

#include "common.cuh"
#include "quantize.cuh"

using namespace llmk;

namespace {

constexpr int kSpanRows = 16;      // R: rows a span holds at most (ops/paged_write.SPAN_ROWS)
constexpr int kFloatThreads = 128;  // threads of a float block

// The rows of span s of one slot: window rows [t0, t0 + r) at positions
// [pos0, pos0 + r), all on one page; r <= 0 when the span writes nothing.
struct Span {
  int t0, r, pos0;
};

__device__ __forceinline__ Span window_span(int base, int width, int W, int s, int page,
                                            int pps) {
  const int rp = min(page, kSpanRows);
  const int k = (base >= 0 ? base / rp : -((rp - 1 - base) / rp)) + s;  // floor(base / rp) + s
  const int lo = max(max(base, k * rp), 0);
  const int hi = min(min(base + min(width, W), (k + 1) * rp), pps * page);
  return {lo - base, hi - lo, lo};
}

// This block's span (blockIdx: span, KV head, slot): thread 0 reads base
// and width and publishes the span through shared memory `sh`.
__device__ __forceinline__ Span block_span(const int* __restrict__ base,
                                           const int* __restrict__ widths, int W, int page,
                                           int pps, int* sh) {
  if (threadIdx.x == 0) {
    const int b = blockIdx.z;
    const Span sp = window_span(base[b], widths[b], W, blockIdx.x, page, pps);
    sh[0] = sp.t0, sh[1] = sp.r, sh[2] = sp.pos0;
  }
  __syncthreads();
  return {sh[0], sh[1], sh[2]};
}

// The pool row of the span's first position: thread 0 reads the page id
// (every thread calls this after issuing its row loads) and publishes it
// at a barrier.
__device__ __forceinline__ long long block_pool_row(const int* __restrict__ page_table,
                                                    int pps, int pool_pages, int page,
                                                    const Span& sp, int* sh) {
  if (threadIdx.x == 0) sh[3] = page_table[blockIdx.z * pps + sp.pos0 / page];
  __syncthreads();
  return ((long long)blockIdx.y * pool_pages + sh[3]) * page + sp.pos0 % page;
}

// the span's source row i (of k_new or v_new [B, W, n_kv, D]) as 16-byte vectors
template <typename T, int D>
__device__ __forceinline__ const uint4* source_row(const T* __restrict__ src, int W, int n_kv,
                                                   const Span& sp, int i) {
  return reinterpret_cast<const uint4*>(src +
                                        ((blockIdx.z * W + sp.t0 + i) * n_kv + blockIdx.y) * D);
}

template <typename T, int D>
__host__ __device__ constexpr int row_vecs() {  // 16-byte vectors a source row
  static_assert(D * sizeof(T) % 16 == 0, "a row must be whole 16-byte vectors");
  return D * sizeof(T) / 16;
}

// Float pool (KV = float or bf16; k_new/v_new already in KV): vector v of
// the span (row v / kVecs) is thread v % kFloatThreads's; each thread
// issues all its loads before its stores.
template <typename KV, int D>
__global__ void __launch_bounds__(kFloatThreads)
write_window_kernel(KV* __restrict__ k_pool, KV* __restrict__ v_pool,
                    const int* __restrict__ page_table, const int* __restrict__ base,
                    const int* __restrict__ widths, const KV* __restrict__ k_new,
                    const KV* __restrict__ v_new, int W, int n_kv, int pool_pages, int page,
                    int pps) {
  constexpr int kVecs = row_vecs<KV, D>();
  constexpr int kPer = (kSpanRows * kVecs + kFloatThreads - 1) / kFloatThreads;
  __shared__ int sh[4];
  const Span sp = block_span(base, widths, W, page, pps, sh);
  if (sp.r <= 0) return;
  uint4 kv[kPer], vv[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int v = threadIdx.x + m * kFloatThreads;
    if (v / kVecs < sp.r) {
      kv[m] = source_row<KV, D>(k_new, W, n_kv, sp, v / kVecs)[v % kVecs];
      vv[m] = source_row<KV, D>(v_new, W, n_kv, sp, v / kVecs)[v % kVecs];
    }
  }
  const long long dst = block_pool_row(page_table, pps, pool_pages, page, sp, sh) * D;
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int v = threadIdx.x + m * kFloatThreads;
    if (v / kVecs < sp.r) {
      reinterpret_cast<uint4*>(k_pool + dst)[v] = kv[m];
      reinterpret_cast<uint4*>(v_pool + dst)[v] = vv[m];
    }
  }
}

// a 16-byte vector of source row elements, widened to f32
__device__ __forceinline__ void widen(const uint4& v, float (&x)[4]) {
  x[0] = __uint_as_float(v.x), x[1] = __uint_as_float(v.y);
  x[2] = __uint_as_float(v.z), x[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void widen(const uint4& v, float (&x)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    x[2 * c] = __uint_as_float(w[c] << 16);  // bf16 -> f32 is exact
    x[2 * c + 1] = __uint_as_float(w[c] & 0xffff0000u);
  }
}

// V int8 values as one 4- or 8-byte store
template <int V>
__device__ __forceinline__ void store_int8(int8_t* p, const int8_t (&q)[V]) {
  uint32_t w[V / 4];
#pragma unroll
  for (int c = 0; c < V / 4; ++c)
    w[c] = (uint32_t)(uint8_t)q[4 * c] | (uint32_t)(uint8_t)q[4 * c + 1] << 8 |
           (uint32_t)(uint8_t)q[4 * c + 2] << 16 | (uint32_t)(uint8_t)q[4 * c + 3] << 24;
  if constexpr (V == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint32_t*>(p) = w[0];
}

// int8 pool (k_new/v_new in T = float or bf16): row i of the span is
// spread over L = row_vecs lanes (an aligned group of a warp), lane c
// holding its vector c: elements [c * V, c * V + V).
template <typename T, int D>
__global__ void __launch_bounds__((kSpanRows * row_vecs<T, D>()))
write_window_int8_kernel(int8_t* __restrict__ k_pool, float* __restrict__ k_scale,
                         int8_t* __restrict__ v_pool, float* __restrict__ v_scale,
                         const int* __restrict__ page_table, const int* __restrict__ base,
                         const int* __restrict__ widths, const T* __restrict__ k_new,
                         const T* __restrict__ v_new, int W, int n_kv, int pool_pages, int page,
                         int pps) {
  constexpr int L = row_vecs<T, D>();  // lanes a row: a power of two, 1-32
  constexpr int V = 16 / sizeof(T);    // elements a lane
  __shared__ int sh[4];
  const int i = threadIdx.x / L, c = threadIdx.x % L;
  const Span sp = block_span(base, widths, W, page, pps, sh);
  if (sp.r <= 0) return;
  uint4 raw[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
  if (i < sp.r) {
    raw[0] = source_row<T, D>(k_new, W, n_kv, sp, i)[c];
    raw[1] = source_row<T, D>(v_new, W, n_kv, sp, i)[c];
  }
  const long long dst = block_pool_row(page_table, pps, pool_pages, page, sp, sh) + i;
#pragma unroll
  for (int side = 0; side < 2; ++side) {  // every lane quantizes: the shuffles stay full
    float x[V];
    widen(raw[side], x);
    int8_t q[V];
    const float s = quantize_vec<L, V>(x, q);
    if (i < sp.r) {
      store_int8<V>((side ? v_pool : k_pool) + dst * D + c * V, q);
      if (c == 0) (side ? v_scale : k_scale)[dst] = s;
    }
  }
}

// the grid: (spans a slot, KV heads, slots)
inline dim3 span_grid(int B, int W, int n_kv, int page) {
  const int rp = page < kSpanRows ? page : kSpanRows;
  return dim3((W + rp - 2) / rp + 1, n_kv, B);
}

template <typename KV>
int launch_float(void* k_pool, void* v_pool, const int* page_table, const int* base,
                 const int* widths, const void* k_new, const void* v_new, int B, int W,
                 int n_kv, int pool_pages, int page, int pps, int d, cudaStream_t stream) {
  LLMK_DISPATCH_D(d, {
    write_window_kernel<KV, D><<<span_grid(B, W, n_kv, page), kFloatThreads, 0, stream>>>(
        (KV*)k_pool, (KV*)v_pool, page_table, base, widths, (const KV*)k_new,
        (const KV*)v_new, W, n_kv, pool_pages, page, pps);
  });
  return (int)cudaGetLastError();
}

template <typename T>
int launch_int8(void* k_pool, void* k_scale, void* v_pool, void* v_scale, const int* page_table,
                const int* base, const int* widths, const void* k_new, const void* v_new, int B,
                int W, int n_kv, int pool_pages, int page, int pps, int d, cudaStream_t stream) {
  LLMK_DISPATCH_D(d, {
    write_window_int8_kernel<T, D><<<span_grid(B, W, n_kv, page),
                                     kSpanRows * row_vecs<T, D>(), 0, stream>>>(
        (int8_t*)k_pool, (float*)k_scale, (int8_t*)v_pool, (float*)v_scale, page_table, base,
        widths, (const T*)k_new, (const T*)v_new, W, n_kv, pool_pages, page, pps);
  });
  return (int)cudaGetLastError();
}

}  // namespace

// k_pool/v_pool [n_kv, pool_pages, page, d] in pool_dtype (LLMK_F32,
// LLMK_BF16 or LLMK_I8); k_scale/v_scale [n_kv, pool_pages, page] float32
// for an int8 pool (unused otherwise); page_table [B, pps] int32 (global
// page ids); base/widths [B] int32; k_new/v_new [B, W, n_kv, d] in
// new_dtype: the pool's own for a float pool, LLMK_F32 or LLMK_BF16 for an
// int8 pool. All contiguous, pools and rows 16-byte aligned, k_new and the
// page table under 2^31 elements, B <= 65535, and page <= 16 or a multiple
// of 16. B * W > 0. Returns cudaGetLastError() after the launch.
extern "C" int llmk_paged_write_window(void* k_pool, void* k_scale, void* v_pool, void* v_scale,
                                       const void* page_table, const void* base,
                                       const void* widths, const void* k_new, const void* v_new,
                                       int B, int W, int n_kv, int pool_pages, int page, int pps,
                                       int d, int pool_dtype, int new_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* pt = (const int*)page_table;
  const int* bs = (const int*)base;
  const int* ws = (const int*)widths;
  if (B <= 0 || B > 65535 || W <= 0 || n_kv <= 0 || n_kv > 65535 || page <= 0 || pps <= 0 ||
      (page > kSpanRows && page % kSpanRows))
    return (int)cudaErrorInvalidValue;
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
