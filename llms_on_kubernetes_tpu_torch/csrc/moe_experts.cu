// Routed expert FFN of a Mixture-of-Experts layer for Hopper (sm_90a),
// bf16 weights.
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
// ops/moe.py::moe_experts_plain. The body, its order of sums and its walk
// are moe_stream.cuh's (shared with the int8 kernel, moe_experts_w8.cu).
//
// What bounds it on the H100: at decode (8-64 tokens x top-8) the bytes of
// the experts the step touches (9.44 MB an expert at D 2,048, F 768 in
// bf16); at prefill (hundreds of rows an expert) the bf16 tensor-core rate,
// which only wgmma reaches, with every operand tile streamed from L2.
#include "moe_stream.cuh"

// The number of K slices of a launch over K rows streaming Nw weight
// columns an expert (ops/moe.py moe_splits mirrors it; slice s starts at
// row unit * (s * (K / unit) / S)).
extern "C" int llmk_moe_splits(int K, int Nw) { return moe_split(K, Nw).S; }

// Rows a tile for R expert-major rows over Nx tokens and E experts
// (ops/moe.py moe_rows mirrors it).
extern "C" int llmk_moe_rows(int R, int Nx, int E) { return tile_rows(R, Nx, E); }

// x [Nx, D] bf16; src [R] int32 (the token of each expert-major row; rows
// past sum(counts) are not read); counts [E] int32 (rows an expert, sum <=
// R, in expert order from row 0); w_gate, w_up [E, D, F] and w_down [E, F,
// D] bf16; h [R, F] and y [R, D] bf16 outputs (rows past sum(counts) are
// not written). All contiguous, 16-byte aligned; D and F multiples of 32;
// E at most 512.
// Returns the first launch's CUDA error, else the second's.
extern "C" int llmk_moe_experts(const void* x, const void* src, const void* counts,
                                const void* w_gate, const void* w_up, const void* w_down,
                                void* h, void* y, int R, int Nx, int E, int D, int F,
                                void* stream) {
  return moe_experts<false>(x, src, counts, w_gate, w_up, w_down, nullptr, nullptr, nullptr, h,
                            y, R, Nx, E, D, F, stream);
}
