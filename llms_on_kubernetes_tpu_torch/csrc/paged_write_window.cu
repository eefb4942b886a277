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
// (R = 16) of them -- a page of more than R rows takes several spans, any
// page size. Each page is cut into pieces by in-page offset, rows
// [16 j, min(16 j + 16, page)); span s of slot b is the piece of
// position base[b], plus s, clipped to the rows t < min(widths[b], W) and
// to positions in [0, pps * page), so its rows are ONE contiguous run of
// the pool, and a slot has at most window_span_count(W, page) spans: the
// grid is fixed on the host from W and the page alone, with no sync. (At
// a page of at most 16 rows or a multiple of 16 the pieces are the aligned
// runs of min(page, 16) positions this kernel used before it took any
// page.) ops/paged_write._window_spans is these formulas in plain Python,
// and the CPU tests hold them. The chain is two
// round trips to device memory: thread 0 reads base[b] and widths[b] and
// publishes the span in shared memory (a block whose span holds no
// written row returns at once); then every thread loads its 16-byte
// vectors of the rows, K and V, while thread 0 reads the span's page id, and
// after one barrier the threads store. Index math is 32-bit; only the pool
// offset is 64-bit.
//   float pool: 128 threads move the span's vectors (two each at bf16
//     d 128), loads before stores; the destination run is contiguous, so
//     the stores coalesce.
//   int8 pool: a row is spread over an aligned group of a warp, 16-byte
//     vectors a lane (16 lanes at bf16 d 128; at d 96 its 12 vectors take
//     16 lanes, 4 idle; f32 at d 256 is 32 lanes of 2 vectors), each lane
//     quantizing its vectors in registers with quantize.cuh's quantize_vec (the chain of
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

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}

// Positions are cut into pieces by their offset IN THE PAGE: piece j of
// page p is rows [16 j, min(16 j + 16, page)) of it, ceil(page / 16) pieces
// a page, numbered page by page. Span s of a slot is piece
// piece(base) + s clipped to the window, so it never crosses a page, at
// any page size. At a page of at most 16 rows or a multiple of 16 the
// pieces are the aligned runs of rp = min(page, 16) positions, and the
// span is found with one division instead of two: thread 0 computes it
// while every other thread of the block waits, and the second division
// cost kernel 7 0.8 us at four slots on the H100 (PERF.md, kernel table).
__device__ __forceinline__ Span window_span(int base, int width, int W, int s, int page,
                                            int pps) {
  const int end = base + min(width, W);
  if (page <= kSpanRows || page % kSpanRows == 0) {
    const int rp = min(page, kSpanRows);
    const int k = floor_div(base, rp) + s;
    const int lo = max(max(base, k * rp), 0);
    const int hi = min(min(end, (k + 1) * rp), pps * page);
    return {lo - base, hi - lo, lo};
  }
  const int per = (page + kSpanRows - 1) / kSpanRows;  // pieces a page
  const int pg0 = floor_div(base, page);
  const int k = pg0 * per + (base - pg0 * page) / kSpanRows + s;
  const int pg = floor_div(k, per), j = k - pg * per;
  const int lo = max(max(base, pg * page + j * kSpanRows), 0);
  const int hi = min(min(end, pg * page + min((j + 1) * kSpanRows, page)), pps * page);
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

// a 16-byte vector of source row elements (T = float: 4, bf16: 8), widened
// to f32 into x[0 .. 16 / sizeof(T))
template <typename T>
__device__ __forceinline__ void widen(const uint4& v, float* x) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if constexpr (sizeof(T) == 4) {
      x[c] = __uint_as_float(w[c]);
    } else {
      x[2 * c] = __uint_as_float(w[c] << 16);  // bf16 -> f32 is exact
      x[2 * c + 1] = __uint_as_float(w[c] & 0xffff0000u);
    }
  }
}

// V int8 values q[0 .. V) as one 4- or 8-byte store
template <int V>
__device__ __forceinline__ void store_int8(int8_t* p, const int8_t* q) {
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

// How an int8-pool block spreads a source row of D elements of T over
// lanes: kVecs 16-byte vectors a row go to an aligned group of kLanes lanes
// (a power of two, at most a warp, so quantize_vec's butterfly closes), a
// lane holding vectors c, c + kLanes, ... (kPer of them). bf16 at head_dim
// 96 has 12 vectors: a group of 16 lanes, 4 of them padding, which load
// nothing, feed amax with zeros and store nothing; f32 at 256 has 64: 32
// lanes of 2.
template <typename T, int D>
struct RowLanes {
  static constexpr int kVecs = row_vecs<T, D>();
  static constexpr int kLanes = kVecs >= 32 ? 32 : pow2_ceil(kVecs);
  static constexpr int kPer = (kVecs + kLanes - 1) / kLanes;
  static constexpr int kThreads = kSpanRows * kLanes;
};

// int8 pool (k_new/v_new in T = float or bf16): row i of the span is
// spread over a group of RowLanes::kLanes lanes, lane c holding vectors
// c + p * kLanes (elements [v * V, v * V + V) of vector v).
template <typename T, int D>
__global__ void __launch_bounds__(RowLanes<T, D>::kThreads)
write_window_int8_kernel(int8_t* __restrict__ k_pool, float* __restrict__ k_scale,
                         int8_t* __restrict__ v_pool, float* __restrict__ v_scale,
                         const int* __restrict__ page_table, const int* __restrict__ base,
                         const int* __restrict__ widths, const T* __restrict__ k_new,
                         const T* __restrict__ v_new, int W, int n_kv, int pool_pages, int page,
                         int pps) {
  using RL = RowLanes<T, D>;
  constexpr int L = RL::kLanes, P = RL::kPer;
  constexpr int V = 16 / sizeof(T);    // elements a vector
  __shared__ int sh[4];
  const int i = threadIdx.x / L, c = threadIdx.x % L;
  const Span sp = block_span(base, widths, W, page, pps, sh);
  if (sp.r <= 0) return;
  uint4 raw[2][P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int v = c + p * L;
    const bool in = i < sp.r && v < RL::kVecs;
    raw[0][p] = in ? source_row<T, D>(k_new, W, n_kv, sp, i)[v] : make_uint4(0, 0, 0, 0);
    raw[1][p] = in ? source_row<T, D>(v_new, W, n_kv, sp, i)[v] : make_uint4(0, 0, 0, 0);
  }
  const long long dst = block_pool_row(page_table, pps, pool_pages, page, sp, sh) + i;
#pragma unroll
  for (int side = 0; side < 2; ++side) {  // every lane quantizes: the shuffles stay full
    float x[P * V];
#pragma unroll
    for (int p = 0; p < P; ++p) widen<T>(raw[side][p], x + p * V);
    int8_t q[P * V];
    const float s = quantize_vec<L, P * V>(x, q);
    if (i < sp.r) {
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (c + p * L < RL::kVecs)
          store_int8<V>((side ? v_pool : k_pool) + dst * D + (c + p * L) * V, q + p * V);
      if (c == 0) (side ? v_scale : k_scale)[dst] = s;
    }
  }
}

// The most pieces (window_span) W consecutive positions can touch, fixed
// by W and the page alone: W - 1 = q * page + r positions past the first
// cross q whole pages (q * per piece starts) and r more rows, which hold
// the most starts when they begin at the start of a page's last piece, of
// rem = page - 16 (per - 1) rows: one start there, then one each 16 rows
// past it. Tight (some base reaches it); at a page of at most 16 rows or a
// multiple of 16 it is ceil((W - 1) / min(page, 16)) + 1.
// ops/paged_write.window_span_count is the same formula.
inline int window_span_count(int W, int page) {
  const int per = (page + kSpanRows - 1) / kSpanRows;
  const int rem = page - (per - 1) * kSpanRows;
  const int q = (W - 1) / page, r = (W - 1) % page;
  int n = 1 + q * per;
  if (r > 0) n += 1 + (r - 1 >= rem ? 1 + (r - 1 - rem) / kSpanRows : 0);
  return n;
}

// the grid: (spans a slot, KV heads, slots)
inline dim3 span_grid(int B, int W, int n_kv, int page) {
  return dim3(window_span_count(W, page), n_kv, B);
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
                                     RowLanes<T, D>::kThreads, 0, stream>>>(
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
// page table under 2^31 elements, B <= 65535, any page size. B * W > 0.
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
  if (B <= 0 || B > 65535 || W <= 0 || n_kv <= 0 || n_kv > 65535 || page <= 0 || pps <= 0)
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
