// TF32 building blocks of the f32 kernels in flash_fwd.cu and flash_bwd.cu:
// f32 tiles as TMA writes them under the 128-byte swizzle (64-byte at
// d_head 16), their fragments, the hi/lo split that makes three TF32
// products one f32-accurate product, and those products (mma.sync m16n8k8
// TF32, f32 accumulation).
//
// A split: every f32 x becomes hi (x rounded to TF32, cvt.rna) and lo =
// x - hi, exact in f32; a TF32 operand reads lo's top 19 bits, truncating
// it, and a_lo b_hi + a_hi b_lo + a_hi b_hi gives a b to about 2^-22 of
// each product (the dropped a_lo b_lo). Streamed operands are split once per
// stage, in place (``split_stage``: hi where x was, lo in a plane beside
// it); an operand read from registers is split there (``split_tf32``).
//
// Fragment layout of m16n8k8 (g = lane / 4, t = lane % 4): A holds rows g,
// g+8 x columns t, t+4; B holds k rows t, t+4 of column g; C holds rows g,
// g+8 x columns 2t, 2t+1. An 8 x 4 f32 block is an 8 x 8 b16 matrix to
// ldmatrix, and lane l receives row l / 4, column l % 4: the A and B
// fragments of operands read along their rows, as they are.
#pragma once

#include "hopper.cuh"

namespace {

// k-steps of 8 columns whose score passes sum from zero before joining the
// scores (f32 adds cost issue slots; the tensor cores' truncating sums lose
// accuracy as they grow)
constexpr int SCORE_KSTEPS = 2;

// Byte offset of element (row, col) of an f32 tile of ``rows`` rows as TMA
// writes it: D/32 blocks of rows x 128 bytes, 16-byte chunk c of row r at
// c ^ (r % 8); d_head 16: rows of 64 bytes, chunk c at c ^ (r / 2 % 4).
template <int D, int rows>
__device__ __forceinline__ uint32_t f32_offset(int row, int col) {
  if constexpr (D >= 32)
    return (col >> 5) * (rows * 128) + row * 128 +
           ((((col >> 2) ^ row) & 7) << 4) + ((col & 3) << 2);
  else
    return row * 64 + ((((col >> 2) ^ (row >> 1)) & 3) << 4) +
           ((col & 3) << 2);
}

// Byte offsets of (row0 + 8 R, col0 + 8 c + 32 C) in an f32 tile of
// ``rows`` rows: table[c % 4] + R * 8 rows + C * rows * 128. The swizzle
// depends on the row only modulo 8 (d_head 16: on row / 2 modulo 4) and on
// the column's 16-byte chunk within its 32 columns, so four per-lane
// offsets cover a warp's every load of an unrolled loop over a tile and the
// rest is an immediate (ptxas kept a register for each load's address, and
// spilled).
template <int D, int rows>
struct F32Addr {
  static constexpr int C = D / 8 < 4 ? D / 8 : 4;
  static constexpr uint32_t ROW8 = 8 * (D >= 32 ? 128 : 64);
  uint32_t table[C];
  __device__ __forceinline__ F32Addr(int row0, int col0) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      table[c] = f32_offset<D, rows>(row0, col0 + 8 * c);
  }
  __device__ __forceinline__ uint32_t at(int R, int c) const {
    return table[c % C] + R * ROW8 + (c / 4) * rows * 128;
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t lds_f32(uint32_t addr) {
  uint32_t x;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(x) : "r"(addr));
  return x;
}

__device__ __forceinline__ float to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}

// x = hi + lo: hi is x rounded to TF32 and lo = x - hi, exact in f32; the
// product reads lo's top 19 bits, truncating it.
template <int N>
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[N],
                                           uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float h = to_tf32(__uint_as_float(x[i]));
    hi[i] = __float_as_uint(h);
    lo[i] = __float_as_uint(__uint_as_float(x[i]) - h);
  }
}

// Splits the FLOATS f32 values at ``x`` in place, hi where x was and lo
// FLOATS values further on, as split_tf32 does: thread t of n, 16 bytes at
// a time. The fence orders the stores before the async proxy's (the TMA
// load that later refills the stage).
template <int FLOATS>
__device__ __forceinline__ void split_stage(float* x, int t, int n) {
  float4* hi = reinterpret_cast<float4*>(x);
  float4* lo = reinterpret_cast<float4*>(x + FLOATS);
#pragma unroll 1
  for (int i = t; i < FLOATS / 4; i += n) {
    const float4 v = hi[i];
    const float4 h = make_float4(to_tf32(v.x), to_tf32(v.y), to_tf32(v.z),
                                 to_tf32(v.w));
    hi[i] = h;
    lo[i] = make_float4(v.x - h.x, v.y - h.y, v.z - h.z, v.w - h.w);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Volatile, as the loads are: the products stay in the order written, so
// ptxas does not hoist a whole unrolled tile's loads above them.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// part[i] (+)= a[i] b[i] to f32 accuracy for CH independent products, in
// three passes: a_lo b_hi and a_hi b_lo first, then a_hi b_hi (the dropped
// a_lo b_lo is about 2^-22 of a product), each pass over all CH products
// so that no product waits on the one before. Without ``ACCUMULATE`` the
// passes start from zero. The tensor cores align a sum to its largest term
// and truncate, so the callers keep these sums short (two k-steps of a
// score, one stage of a gradient) and add them into their running sums in
// f32, rounding to nearest: a running sum kept in the accumulator drifted
// past the f32 bound over a long row.
template <int CH, bool ACCUMULATE = false>
__device__ __forceinline__ void mma_3xtf32(float (&part)[CH][4],
                                           const uint32_t (&a_hi)[CH][4],
                                           const uint32_t (&a_lo)[CH][4],
                                           const uint32_t (&b_hi)[CH][2],
                                           const uint32_t (&b_lo)[CH][2]) {
  if (!ACCUMULATE) {
#pragma unroll
    for (int i = 0; i < CH; ++i)
      part[i][0] = part[i][1] = part[i][2] = part[i][3] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < CH; ++i) mma_tf32(part[i], a_lo[i], b_hi[i]);
#pragma unroll
  for (int i = 0; i < CH; ++i) mma_tf32(part[i], a_hi[i], b_lo[i]);
#pragma unroll
  for (int i = 0; i < CH; ++i) mma_tf32(part[i], a_hi[i], b_hi[i]);
}

// acc_i (16 x D) += X_i B_i for the NP products of a warp: X_i (16 x
// STREAM) in the registers of a score accumulator, split here; B_i the
// STREAM x D split stage tile at ``b_tile[i]``, its lo LO bytes on, the
// contraction index permuted as above. A group of NG column tiles of every
// product at a time, over the whole stage; the group's sum over the stage's
// rows starts from zero and joins ``acc`` by f32 adds.
template <int D, int STREAM, uint32_t LO, int NP>
__device__ __forceinline__ void accumulate_3xtf32(
    float (*const (&acc)[NP])[4], const float (*const (&x)[NP])[4],
    const uint32_t (&b_tile)[NP], int g, int t4) {
  // products a group: 4, or 2 where dK and dV at d_head 128 hold 128
  // accumulator registers already
  constexpr int CH_MAX = D == 128 && NP == 2 ? 2 : 4;
  constexpr int NG = CH_MAX / NP < D / 8 ? CH_MAX / NP : D / 8;
  constexpr int CH = NP * NG;
  // b_e of the B fragment: row 8j + 2 t4 + e, column 8n + g
  const F32Addr<D, STREAM> b_addr[2] = {F32Addr<D, STREAM>(2 * t4, g),
                                        F32Addr<D, STREAM>(2 * t4 + 1, g)};
#pragma unroll
  for (int grp = 0; grp < D / 8 / NG; ++grp) {
    float part[CH][4];
#pragma unroll
    for (int j = 0; j < STREAM / 8; ++j) {
      uint32_t a_hi[CH][4], a_lo[CH][4], b_hi[CH][2], b_lo[CH][2];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const uint32_t a[4] = {__float_as_uint(x[i][j][0]),
                               __float_as_uint(x[i][j][2]),
                               __float_as_uint(x[i][j][1]),
                               __float_as_uint(x[i][j][3])};
        split_tf32(a, a_hi[i * NG], a_lo[i * NG]);
#pragma unroll
        for (int q = 0; q < NG; ++q) {
          if (q > 0) {
#pragma unroll
            for (int y = 0; y < 4; ++y)
              a_hi[i * NG + q][y] = a_hi[i * NG][y],
              a_lo[i * NG + q][y] = a_lo[i * NG][y];
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t at = b_tile[i] + b_addr[e].at(j, grp * NG + q);
            b_hi[i * NG + q][e] = lds_f32(at);
            b_lo[i * NG + q][e] = lds_f32(at + LO);
          }
        }
      }
      if (j == 0)
        mma_3xtf32<CH>(part, a_hi, a_lo, b_hi, b_lo);
      else
        mma_3xtf32<CH, true>(part, a_hi, a_lo, b_hi, b_lo);
    }
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int q = 0; q < NG; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][grp * NG + q][e] += part[i * NG + q][e];
  }
}

}  // namespace
