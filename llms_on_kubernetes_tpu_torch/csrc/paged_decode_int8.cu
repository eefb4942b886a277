// Paged decode attention over an int8 pool with per-token f32 scales, for
// Hopper (sm_90a). The kernel is paged_decode.cuh's, with KV = int8_t.
//
// Replaces two TPU kernels of llms_on_kubernetes_tpu/ops/pallas_paged.py:
//   write=0: pallas_paged_attention_int8        (body _paged_kernel_int8)
//   write=1: pallas_paged_attention_write_int8  (bodies _paged_kernel_write_int8
//            and _quantize_row)
// See paged_decode.cuh for the semantics, the bound and the design. The
// bytes an append stores equal engine/cache.quantize_kv's only with IEEE
// division: kernels/__init__.py builds without fast math.
#include "paged_decode.cuh"

using namespace llmk;

// q [B, n_q, d] float32 or bf16; k_data/v_data [n_kv, pool_pages, page, d]
// int8; k_scale/v_scale [n_kv, pool_pages, page] float32; page_table
// [B, pps] int32 (global page ids); lengths [B] int32 (keys including the
// current token); out [B, n_q, d] in q's dtype; k_new/v_new [B, n_kv, d] in
// q's dtype, quantized and stored (data and scale) only when write != 0.
// Workspace as llmk_paged_decode's: part float32 of at least
// B * n_q * n_split * (d + 2), counters int32 of at least B * n_kv, 0
// between calls; n_split = ceil(pps * page / 256). All contiguous, pools
// 16-byte aligned. window <= 0 means none, cap <= 0 means no softcap.
// Returns cudaGetLastError() after the launch.
extern "C" int llmk_paged_decode_int8(const void* q, void* k_data, void* k_scale,
                                      void* v_data, void* v_scale, const void* page_table,
                                      const void* lengths, const void* k_new,
                                      const void* v_new, void* part, void* counters,
                                      void* out, int B, int n_q, int n_kv, int pool_pages,
                                      int page, int pps, int n_split, int d, float scale,
                                      int window, float cap, int write, int dtype,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == LLMK_F32)
    return paged_decode_launch<float, int8_t>(
        q, k_data, k_scale, v_data, v_scale, page_table, lengths, k_new, v_new, part,
        counters, out, B, n_q, n_kv, pool_pages, page, pps, n_split, d, scale, window, cap,
        write, s);
  if (dtype == LLMK_BF16)
    return paged_decode_launch<__nv_bfloat16, int8_t>(
        q, k_data, k_scale, v_data, v_scale, page_table, lengths, k_new, v_new, part,
        counters, out, B, n_q, n_kv, pool_pages, page, pps, n_split, d, scale, window, cap,
        write, s);
  return (int)cudaErrorInvalidValue;
}
