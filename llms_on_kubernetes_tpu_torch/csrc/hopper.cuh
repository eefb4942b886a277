// Hopper (sm_90a) pieces shared by the weight-only matrix products
// (w8_matmul.cu, W8A16; w4_matmul.cu, grouped W4A16) and the MoE expert
// kernel (moe_experts.cu, whose bf16 weights take ldmatrix.trans instead
// of a conversion into the same A fragments): the K split and its
// slice walk, TMA tiles into shared memory with completion on an mbarrier,
// wgmma with the weight as the register A operand and x as the
// shared-memory B operand (out^T = w^T x^T), and the integer -> bf16
// conversions that feed A without I2F.
//
// Both kernels compute out^T tiles of 64 weight columns (A rows) by NX rows
// of x (wgmma's N: 8, 16, 32, 64 or 128), one 16-deep step at a time. A
// warp of a warpgroup reads its bytes of a staged 64-deep weight tile of
// 128 columns with 32-bit shared loads: column 32 wn + 4 c + j of warp wn's
// 32 is A row c of wgmma tile j / 2, or c + 8 for odd j, so one word holds
// a step's bytes for both 64-column tiles.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace llmk {

// -- the K split --------------------------------------------------------------

constexpr int kSlab = 128;       // columns a decode block
constexpr int kMinBlocks = 128;  // decode blocks to aim for (132 SMs)
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kSliceGroups = 2;  // slice groups a decode block (WK)
constexpr int kMaxSlice = 1024;  // K rows a slice stays within where S allows
constexpr int kBK = 64;          // K rows a staged tile, every bf16 body

struct Split {
  int S;      // slices
  int unit;   // K rows a unit: every slice edge is a multiple of it
  int units;  // K / unit
};

// S is a power of two: enough decode blocks (slabs x S / kSliceGroups) for
// the card and slices of at most kMaxSlice rows, within kSliceGroups x
// kMaxCluster slices and at least one unit a slice
__host__ __device__ inline Split make_split(int K, int N, int unit) {
  Split sp;
  sp.unit = unit;
  sp.units = K / unit;
  const int slabs = (N + kSlab - 1) / kSlab;
  int kb = 1;
  while (slabs * kb < kMinBlocks && kb < kMaxCluster) kb *= 2;
  int s = kSliceGroups * kb;
  while (s < kSliceGroups * kMaxCluster && s * kMaxSlice < K) s *= 2;
  while (s > sp.units) s /= 2;
  sp.S = s;
  return sp;
}

// first K row of slice s (s = S gives K)
__host__ __device__ __forceinline__ int slice_edge(const Split& sp, int s) {
  return sp.unit * (s * sp.units / sp.S);
}

// a walk over the slices' tiles in order: tile [k0, min(k0 + kBK, ke)) of
// slice s
struct TileCursor {
  int s, k0, ke;
  __device__ __forceinline__ void start(const Split& sp) {
    s = 0, k0 = 0, ke = slice_edge(sp, 1);
  }
  __device__ __forceinline__ bool last() const { return k0 + kBK >= ke; }
  __device__ __forceinline__ void next(const Split& sp) {
    k0 += kBK;
    if (k0 >= ke) {
      ++s;
      k0 = ke;
      ke = slice_edge(sp, s + 1);
    }
  }
};

// -- integer -> bf16 in registers ----------------------------------------------

// bytes J of two words as one bf16 pair, lo in the low half, exactly: with l
// a byte's low 7 bits and h its sign bit, the bf16 bit patterns 0x4300 | l
// and 0x4300 | h << 7 are 128 + l and 128 + 128 h, and their difference l -
// 128 h is the byte's value (byte_perm puts the two bytes at bits 0 and 16)
template <int J>
__device__ __forceinline__ uint32_t s8_pair(uint32_t lo, uint32_t hi) {
  constexpr uint32_t kSel = J | (J << 4) | ((4 + J) << 8) | ((4 + J) << 12);
  const uint32_t p = __byte_perm(lo, hi, kSel);
  const uint32_t v = (p & 0x007F007Fu) | 0x43004300u;  // 128 + l
  const uint32_t s = (p & 0x00800080u) | 0x43004300u;  // 128 + 128 h
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(s), "r"(0xBF80BF80u), "r"(v));
  return r;  // v - s
}

// the two nibbles of byte J of w as one bf16 pair (low nibble in the low
// half), exactly; h = w >> 4. With u a two's-complement nibble of value v,
// u ^ 8 = v + 8, so the bf16 bit pattern 0x4300 | (u ^ 8) is 136 + v: one
// byte_perm, one lop3 and one fma.bf16x2 (minus 136) a pair
template <int J>
__device__ __forceinline__ uint32_t nibble_pair(uint32_t w, uint32_t h) {
  constexpr uint32_t kSel = J | (J << 4) | ((4 + J) << 8) | ((4 + J) << 12);
  const uint32_t p = (__byte_perm(w, h, kSel) & 0x000F000Fu) ^ 0x43084308u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(p), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;  // p - 136
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes, bool& done) {
  if (!done) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    done = true;
  }
  return 0;
}

// -- TMA: 2D tiles into shared memory, completion on an mbarrier --------------

// a tensor map over a row-major [rows, cols] array of elt-byte elements,
// boxes of box_rows x box_cols, 128-byte swizzle by default (the box's rows
// are 128 bytes: 16-byte chunk c of row r lands at chunk c ^ (r % 8));
// elements past the array read as zeros. The driver entry point comes
// through the runtime, so the library links against nothing but cudart.
inline int make_map(CUtensorMap* tm, const void* base, CUtensorMapDataType type, int elt,
                    int rows, int cols, int box_rows, int box_cols,
                    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorNotSupported;
    encode = (PFN_cuTensorMapEncodeTiled_v12000)fn;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elt};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(tm, type, 2, const_cast<void*>(base), dims, strides, box, estr,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// a barrier that completes a phase after n arrivals
__device__ __forceinline__ void mbar_init_n(uint64_t* bar, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(n)
               : "memory");
}

// the named barrier `id` over `threads` threads of the block
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the one arrival of this phase, expecting `bytes` of TMA writes
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// the box at (column c0, row c1) of tm into dst (1024-byte aligned for a
// swizzled map, 128-byte for an unswizzled one)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* tm, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// mbar_expect and tma_load where `on` is true, as predicated instructions:
// no branch, so a thread that issues them from inside a stretch of wgmma
// in flight puts no divergent path there (ptxas serializes the wgmma of a
// function with one: C7520)
__device__ __forceinline__ void mbar_expect_if(bool on, uint64_t* bar, int bytes) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(smem_addr(bar)),
      "r"(bytes), "r"((int)on)
      : "memory");
}

__device__ __forceinline__ void tma_load_if(bool on, void* dst, const CUtensorMap* tm, int c0,
                                            int c1, uint64_t* bar) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %5, 0;\n"
      " @p cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n}\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(smem_addr(bar)), "r"((int)on)
      : "memory");
}

// byte offset of (row r, byte b) in a tile of 128-byte rows, 128-byte swizzle
__device__ __forceinline__ int swz(int r, int b) {
  return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// -- wgmma: out^T tiles, the weight as register A, x as shared-memory B ----------

// d = a b + (scale_d ? d : 0)
template <int NX>
__device__ __forceinline__ void wgmma_rs(float (&d)[NX / 2], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d = 1);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[4], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %9, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d = a b + (scale_d ? d : 0) with both operands in shared memory, a 64 x
// 16 and b 16 x 8 (K-major descriptors)
__device__ __forceinline__ void wgmma_ss8(float (&d)[4], uint64_t da, uint64_t db,
                                          int scale_d = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// descriptor of a K-major operand: rows of 128 bytes (64 bf16), 128-byte
// swizzle, 8-row groups 1024 bytes apart, from a 1024-aligned tile (plus
// 32 bytes a 16-deep step)
__device__ __forceinline__ uint64_t desc_b(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// registers an asynchronous wgmma reads or writes: the compiler must keep
// them where they are until wg_wait (a use after it pins them)
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// the four words a lane needs for 16-deep step kk of a staged int8 w tile
// [64, 128] (128-byte swizzle): k rows 2tq, 2tq + 1, 2tq + 8, 2tq + 9,
// columns 4g .. 4g + 3 of the warp's 32; byte j of each is A row g (j even)
// or g + 8 (j odd) of wgmma tile j / 2
__device__ __forceinline__ void step_words(uint32_t (&wd)[4], const uint8_t* b, int kk, int wn,
                                           int g, int tq) {
  const int r = kk * 16 + 2 * tq, c = wn * 32 + g * 4;
  wd[0] = *reinterpret_cast<const uint32_t*>(b + swz(r, c));
  wd[1] = *reinterpret_cast<const uint32_t*>(b + swz(r + 1, c));
  wd[2] = *reinterpret_cast<const uint32_t*>(b + swz(r + 8, c));
  wd[3] = *reinterpret_cast<const uint32_t*>(b + swz(r + 9, c));
}

// A fragments of wgmma tile T for one step from its int8 words
template <int T>
__device__ __forceinline__ void step_frags(uint32_t (&f)[4], const uint32_t (&wd)[4]) {
  f[0] = s8_pair<2 * T>(wd[0], wd[1]), f[1] = s8_pair<2 * T + 1>(wd[0], wd[1]);
  f[2] = s8_pair<2 * T>(wd[2], wd[3]), f[3] = s8_pair<2 * T + 1>(wd[2], wd[3]);
}

}  // namespace llmk
