// Hopper (sm_90a) building blocks of the TMA + wgmma kernels in
// flash_fwd.cu and flash_bwd.cu: mbarriers, TMA tensor loads and the tensor
// maps they read, wgmma shared-memory descriptors (128-byte swizzle), the
// products, and the register fences around them.
//
// Tiles: TMA writes a [rows][64] bf16 box as rows of 128 bytes under the
// 128-byte swizzle; a tile of D columns is D/64 such blocks one after the
// other, each ``rows`` rows (f32: [rows][32] boxes, ``bshd_map_f32``). A
// K-major operand (the 16-column step of a product runs along a row) steps
// through a block 32 bytes at a time and to the next block after 4 steps;
// an MN-major B operand (the step runs down the rows) steps 16 rows at a
// time, its two 64-column halves (N = 128) ``rows`` rows apart.
//
// wgmma fragments: warp w of a warpgroup holds rows 16w + g and 16w + g + 8
// (g = lane / 4) of the 64; accumulator register 4j + 2r + e is column
// 8j + 2t + e (t = lane % 4) of row g + 8r, and the register A operand of
// a 16-deep step kk is the accumulator registers 8kk .. 8kk + 7 packed in
// pairs (``pack_a``): the accumulator of one product is the A operand of
// the next, register for register.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int WG_THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pair);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// Arrives on ``bar`` and adds ``bytes`` to the transaction count its
// current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Returns once the phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 4-d tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Returns once at most ``pending`` committed wgmma groups of this thread
// are still running (groups complete in the order they were committed).
template <int pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(pending)
               : "memory");
}

// Keeps the compiler from touching accumulator registers across a pending
// wgmma: each register is read and written here, in order with the asm.
template <int N>
__device__ __forceinline__ void fence_registers(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_registers(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(r[i][x]) :: "memory");
}

#define THP_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define THP_F16(i) THP_F4(i), THP_F4(i + 4), THP_F4(i + 8), THP_F4(i + 12)
#define THP_R32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31"
#define THP_R64                                                              \
  THP_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63"

// D (64 x 128) (+)= A (64 x 16) B^T (B 128 x 16): both operands K-major in
// shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " THP_R64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : THP_F16(0), THP_F16(16), THP_F16(32), THP_F16(48)
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 64) (+)= A (64 x 16) B^T (B 64 x 16), as above.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " THP_R32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : THP_F16(0), THP_F16(16)
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 128) += A (64 x 16, registers) B (16 x 128, MN-major in shared
// memory).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " THP_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : THP_F16(0), THP_F16(16), THP_F16(32), THP_F16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 64) += A (64 x 16, registers) B (16 x 64), as above.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " THP_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : THP_F16(0), THP_F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef THP_R64
#undef THP_R32
#undef THP_F16
#undef THP_F4

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Descriptor offset (16-byte units) of the 16 columns kk*16.. of a K-major
// tile of ``rows`` rows stored as 64-column swizzle blocks.
template <int rows>
__device__ __forceinline__ uint64_t k_major_step(int kk) {
  return static_cast<uint64_t>(((kk / 4) * rows * 128 + (kk % 4) * 32) >> 4);
}

// C (64 x N) = A B^T over the D columns of both (issued, committed, not
// waited): ``a_desc`` the descriptor of the warpgroup's 64 rows of a
// K-major tile of A_ROWS rows, ``b_tile`` a K-major tile of B_ROWS = N rows.
template <int D, int A_ROWS, int B_ROWS, int N2>
__device__ __forceinline__ void issue_ss(float (&c)[N2], uint64_t a_desc,
                                         uint32_t b_tile) {
  static_assert(2 * N2 == B_ROWS, "one product spans the whole B tile");
  const uint64_t b_desc = sw128_desc(b_tile, 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(c, a_desc + k_major_step<A_ROWS>(kk),
             b_desc + k_major_step<B_ROWS>(kk), kk > 0);
  wgmma_commit();
}

// C (64 x N) += A (64 x ROWS, registers, ``pack_a``) B, B the MN-major
// tile of ROWS rows at ``b_tile`` (issued, committed, not waited): 8-row
// groups 1024 bytes apart, the second 64-column block ROWS rows after the
// first.
template <int ROWS, int N>
__device__ __forceinline__ void issue_rs(float (&c)[N],
                                         uint32_t (&a)[ROWS / 16][4],
                                         uint32_t b_tile) {
  const uint64_t b_desc = sw128_desc(b_tile, ROWS * 128, 1024);
  fence_registers(c);
  fence_registers(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < ROWS / 16; ++kk)
    wgmma_rs(c, a[kk], b_desc + ((kk * 16 * 128) >> 4));
  wgmma_commit();
}

// An accumulator (64 x N, f32) rounded to bf16 as the register A operand
// of a product whose depth is its N columns.
template <int N2>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N2 / 8][4],
                                       const float (&c)[N2]) {
#pragma unroll
  for (int kk = 0; kk < N2 / 8; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      a[kk][x] = pack_bf16(c[8 * kk + 2 * x], c[8 * kk + 2 * x + 1]);
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t status = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &entry, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t status = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &entry, cudaEnableDefault, &found);
#endif
    if (status == cudaSuccess && found == cudaDriverEntryPointSuccess)
      encode = reinterpret_cast<EncodeTiled>(entry);
  }
  return encode;
}

// The tensor map of a [B, S, heads, D] tensor of ``bytes``-byte elements:
// boxes of ``cols`` columns x 1 head x ``rows`` positions x 1 batch under
// ``swizzle``, zeros past S.
bool bshd_tensor_map(CUtensorMap* map, CUtensorMapDataType type, int bytes,
                     const void* data, int B, int S, int heads, int D,
                     int cols, int rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * bytes,
                                 (cuuint64_t)heads * D * bytes,
                                 (cuuint64_t)S * heads * D * bytes};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(data), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// bf16 [B, S, heads, D]: boxes of 64 columns (128-byte rows), 128-byte
// swizzle.
bool bshd_map(CUtensorMap* map, const void* data, int B, int S, int heads,
              int D, int rows) {
  return bshd_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, data, B, S,
                         heads, D, 64, rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

// f32 [B, S, heads, D]: boxes of 32 columns (128-byte rows) under the
// 128-byte swizzle; d_head 16 has one box of 64-byte rows under the 64-byte
// swizzle.
bool bshd_map_f32(CUtensorMap* map, const void* data, int B, int S,
                  int heads, int D, int rows) {
  return bshd_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, data, B, S,
                         heads, D, D < 32 ? D : 32, rows,
                         D < 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                : CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace
