// Routed expert FFN of a Mixture-of-Experts layer for Hopper (sm_90a),
// int8 expert weights (a grouped W8A16).
//
// The port's own kernel: it replaces no Pallas kernel. The JAX package
// serves int8 expert stacks (quantize_params quantizes the [L, E, D, F] /
// [L, E, F, D] stacks per (layer, expert, output column),
// llms_on_kubernetes_tpu/ops/quant.py:412-441) and computes the product in
// llms_on_kubernetes_tpu/ops/moe.py:81-82 as qeinsum (ops/quant.py:311)
// around its one-hot dispatch, left to XLA, which fuses the int8 -> bf16
// convert into the matrix unit's operand load. The port routes, as the
// bf16 expert kernel does (moe_experts.cu), and this kernel computes, for
// every expert-major row r of expert e, with f32 sums, round() to bf16 and
// each f32 scale rounded to bf16 as qeinsum rounds it,
//
//   g[r] = round(round(x[src[r]] Wg[e]) * round(sg[e]))
//   u[r] = round(round(x[src[r]] Wu[e]) * round(su[e]))
//   h[r] = round(round(SiLU(g[r])) * u[r])
//   y[r] = round(round(h[r] Wd[e]) * round(sd[e]))
//
// the rounding of the plain version, ops/moe.py::moe_experts_plain on
// QTensor stacks (ops/quant.py::w8_matmul_plain per product). The body is
// moe_stream.cuh's with int8 weight tiles: half the bytes of a bf16 tile,
// converted to bf16 in registers on their way to wgmma (int8 converts to
// bf16 exactly, so the products are the plain version's), the scales in
// the epilogue; the K split, the walk over tiles and the order of sums are
// the bf16 kernel's, so a row comes out with the same bits at any R.
// Dequantizing the stacks instead would write a bf16 copy of every expert
// (Mixtral-8x7B's alone would not fit the card).
//
// What bounds it on the H100: at decode (8 tokens x top-2 of Mixtral-8x7B)
// the int8 bytes of the experts the step touches (176 MB an expert at D
// 4,096, F 14,336), half the bf16 kernel's; at prefill the bf16
// tensor-core rate, with the conversion's integer work beside wgmma. One
// chain of small wgmma steps a consumer held the shared body to 2.2x the
// byte bound at decode, so the int8 tiles of 8 to 32 rows take their own
// body where the K split allows (moe_stream.cuh moe_spread): two slices
// side by side in each consumer warpgroup, 128 k rows a stage, and where
// the launch makes few items, an item's slices spread over a cluster and
// folded in order through distributed shared memory. Every int8 tile is
// read by ldmatrix.trans.
#include "moe_stream.cuh"

// the int8 decode body's cluster size for a launch over K rows with N
// outputs (gated: the gate/up launch) and E experts on a card of `sms` SMs
// (ops/moe.py::moe_spread_blocks mirrors it)
extern "C" int llmk_moe_spread(int K, int N, int gated, int E, int sms) {
  return spread_blocks(K, N, gated != 0, E, sms);
}

// x [Nx, D] bf16; src [R] int32; counts [E] int32 (as llmk_moe_experts);
// w_gate, w_up [E, D, F] and w_down [E, F, D] int8; s_gate, s_up [E, F] and
// s_down [E, D] f32 (each weight's per-column scale); h [R, F] and y [R, D]
// bf16 outputs (rows past sum(counts) are not written). All contiguous,
// 16-byte aligned; D and F multiples of 32; E at most 512.
// Returns the first launch's CUDA error, else the second's.
extern "C" int llmk_moe_experts_w8(const void* x, const void* src, const void* counts,
                                   const void* w_gate, const void* w_up, const void* w_down,
                                   const void* s_gate, const void* s_up, const void* s_down,
                                   void* h, void* y, int R, int Nx, int E, int D, int F,
                                   void* stream) {
  return moe_experts<true>(x, src, counts, w_gate, w_up, w_down, (const float*)s_gate,
                           (const float*)s_up, (const float*)s_down, h, y, R, Nx, E, D, F,
                           stream);
}
