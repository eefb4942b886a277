// Paged decode attention over a float pool (the pool holds q's dtype), for
// Hopper (sm_90a). The kernel is paged_decode.cuh's, with KV = T.
//
// Replaces two TPU kernels of llms_on_kubernetes_tpu/ops/pallas_paged.py:
//   write=0: pallas_paged_attention        (body _paged_kernel)
//   write=1: pallas_paged_attention_write  (body _paged_kernel_write)
// See paged_decode.cuh for the semantics, the bound and the design.
#include "paged_decode.cuh"

using namespace llmk;

// q [B, n_q, d]; k_pool/v_pool [n_kv, pool_pages, page, d]; page_table
// [B, pps] int32 (global page ids); lengths [B] int32 (keys including the
// current token); out [B, n_q, d]; k_new/v_new [B, n_kv, d] in the pool
// dtype, read only when write != 0. Scratch: part_m/part_l [B, n_q, n_split]
// and part_acc [B, n_q, n_split, d] float32, n_split = ceil(pps * page /
// 256). All contiguous and 16-byte aligned, q/pool/out one dtype.
// window <= 0 means none, cap <= 0 means no softcap.
// Returns cudaGetLastError() after the launches.
extern "C" int llmk_paged_decode(const void* q, void* k_pool, void* v_pool,
                                 const void* page_table, const void* lengths,
                                 const void* k_new, const void* v_new, void* part_m,
                                 void* part_l, void* part_acc, void* out, int B, int n_q,
                                 int n_kv, int pool_pages, int page, int pps, int n_split,
                                 int d, float scale, int window, float cap, int write,
                                 int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == LLMK_F32)
    return paged_decode_launch<float, float>(
        q, k_pool, nullptr, v_pool, nullptr, page_table, lengths, k_new, v_new, part_m,
        part_l, part_acc, out, B, n_q, n_kv, pool_pages, page, pps, n_split, d, scale,
        window, cap, write, s);
  if (dtype == LLMK_BF16)
    return paged_decode_launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pool, nullptr, v_pool, nullptr, page_table, lengths, k_new, v_new, part_m,
        part_l, part_acc, out, B, n_q, n_kv, pool_pages, page, pps, n_split, d, scale,
        window, cap, write, s);
  return (int)cudaErrorInvalidValue;
}
