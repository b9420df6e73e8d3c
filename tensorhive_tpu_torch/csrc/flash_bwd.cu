// Flash attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces: tensorhive_tpu/ops/flash_attention.py, _dq_kernel_resident and
// _dq_kernel (dQ; K/V resident or streamed) and _dkv_kernel_resident and
// _dkv_kernel (dK/dV; Q/dO resident or streamed), all reached from
// _flash_bwd_bhsd. Their resident/streaming split was a 4 MiB VMEM budget;
// here one dQ kernel and one dK/dV kernel serve every sequence length.
//
// Computes, for q/do [B, S, H, D], k/v [B, S, Hkv, D] (GQA: query head h
// reads KV head h / (H / Hkv), with no expanded copy), the saved row
// log-sum-exp lse [B*H, S] f32 and delta = rowsum(dO * O) [B*H, S] f32:
//   P  = exp(scale * Q K^T - lse)           (masked scores give P = 0)
//   dS = P * (dO V^T - delta)
//   dQ = scale * dS K,  dK = scale * dS^T Q (summed over the GQA group),
//   dV = P^T dO         (summed over the GQA group)
// dq comes out in q's layout and type, dk/dv in k's.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): the two
// passes do 5 products of 2*S^2*D per head (QK^T and dO V^T twice, dS K,
// dS^T Q, P^T dO), halved by causality: 5*S^2*H*D FLOPs against about
// 4*S*(H+Hkv)*D*itemsize bytes. At S=4096, H=32, Hkv=8, D=128 that is
// 344 GFLOP against 168 MB, so operations bound it: ~0.35 ms at the bf16
// tensor-core rate, ~5.1 ms for f32 at the 67 TFLOP/s of exact f32.
//
// Design (simple and right first; wgmma/TMA and a fused single pass are
// later work). The TPU kernels' two-pass split is kept: it needs no atomics
// and sums every gradient in a fixed order, so results are deterministic.
// * dQ kernel: one CTA per (batch*head, 64-row q tile). Q, dO and the rows'
//   lse/delta load once; the CTA loops over 64-row K/V tiles up to the
//   causal diagonal, recomputes P from lse, and accumulates dQ in f32
//   registers.
// * dK/dV kernel: one CTA per (batch*kv_head, 64-row kv tile). K and V load
//   once; the CTA loops over the `group` query heads that share this KV
//   head and, for each, over the q tiles from the diagonal down, reading
//   that query head's own lse/delta rows. dK and dV accumulate in f32
//   registers; nothing is shared between CTAs.
// * bf16: every product on the tensor cores (mma.sync m16n8k16, bf16
//   operands, f32 accumulation), as flash_fwd.cu does. P is rounded to bf16
//   before P^T dO and dS before dS K and dS^T Q — the JAX kernels'
//   .astype(do.dtype) / .astype(q.dtype) / .astype(k.dtype). Score
//   fragments that a product consumes as its A operand are repacked from
//   the accumulator registers; B operands that need the transpose come
//   through ldmatrix.trans.
// * f32: CUDA-core FMAs in exact f32 (no TF32), 256 threads as a 16x16
//   grid; each thread owns 4 rows x 4 columns of a 64x64 score tile and 4
//   rows of the gradient accumulators; P and dS pass through shared memory
//   to the second product.
// * The scale always multiplies the f32 scores. _fold_scale_into_q folds a
//   power-of-two scale into q instead; scaling by a power of two commutes
//   with every rounding of the sum, so both give the same bits.
// * Masks: key j is visible to query i iff j <= i (causal, seq_q == seq_k)
//   and both are < S. A masked score gives P = 0 exactly, never
//   exp(NEG_INF - lse) computed. Rows past S are loaded as zeros, never
//   written, and contribute nothing: a ragged S (4095) needs no fallback.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 64;      // dQ: q rows per CTA
constexpr int BLOCK_K = 64;      // dQ: keys per tile; dK/dV: keys per CTA
constexpr int BLOCK_QB = 32;     // bf16 dK/dV: q rows per inner tile
constexpr int THREADS = 256;     // f32 kernels
constexpr int MMA_THREADS = 128; // bf16 kernels: 4 warps x 16 rows
constexpr int ROWS = 4;          // f32: rows per thread
constexpr int COLS = 4;          // f32: score columns per thread

using bf16 = __nv_bfloat16;

// -- f32: exact f32 products on the CUDA cores --------------------------------

template <int D>
constexpr size_t dq_f32_smem() {
  return sizeof(float) * (4 * 64 * (D + 1) + 64 * 65);
}

template <int D>
constexpr size_t dkv_f32_smem() {
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * 64 * 65 + 2 * 64);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int S, int H, int Hkv, int causal, float scale) {
  constexpr int DP = D + 1;           // padded rows: no bank conflicts
  constexpr int PP = BLOCK_K + 1;
  constexpr int OUT = D / 16;         // gradient columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                  // [BLOCK_Q][DP]
  float* do_s = q_s + BLOCK_Q * DP;   // [BLOCK_Q][DP]
  float* k_s = do_s + BLOCK_Q * DP;   // [BLOCK_K][DP]
  float* v_s = k_s + BLOCK_K * DP;    // [BLOCK_K][DP]
  float* ds_s = v_s + BLOCK_K * DP;   // [BLOCK_Q][PP]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hkv);
  const int q0 = blockIdx.x * BLOCK_Q;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long q_stride = (long)H * D;
  const long kv_stride = (long)Hkv * D;
  const float* q_base = q + ((long)b * S * H + h) * D;
  const float* do_base = dout + ((long)b * S * H + h) * D;
  const float* k_base = k + ((long)b * S * Hkv + kvh) * D;
  const float* v_base = v + ((long)b * S * Hkv + kvh) * D;
  float* dq_base = dq + ((long)b * S * H + h) * D;

  for (int i = tid; i < BLOCK_Q * D; i += THREADS) {
    const int r = i / D, c = i % D, s = q0 + r;
    const bool ok = s < S;
    q_s[r * DP + c] = ok ? q_base[s * q_stride + c] : 0.f;
    do_s[r * DP + c] = ok ? do_base[s * q_stride + c] : 0.f;
  }
  float row_lse[ROWS], row_delta[ROWS], acc[ROWS][OUT];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int s = q0 + ty * ROWS + r;
    row_lse[r] = s < S ? lse[(long)bh * S + s] : 0.f;
    row_delta[r] = s < S ? delta[(long)bh * S + s] : 0.f;
#pragma unroll
    for (int j = 0; j < OUT; ++j) acc[r][j] = 0.f;
  }

  const int q_last = min(q0 + BLOCK_Q, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int tiles = (kv_end + BLOCK_K - 1) / BLOCK_K;

  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * BLOCK_K;
    __syncthreads();  // the previous tile's k_s/v_s/ds_s are consumed
    for (int i = tid; i < BLOCK_K * D; i += THREADS) {
      const int r = i / D, c = i % D, s = k0 + r;
      const bool ok = s < S;
      k_s[r * DP + c] = ok ? k_base[s * kv_stride + c] : 0.f;
      v_s[r * DP + c] = ok ? v_base[s * kv_stride + c] : 0.f;
    }
    __syncthreads();

    float sc[ROWS][COLS], dp[ROWS][COLS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < COLS; ++c) sc[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[ROWS], dov[ROWS], kv[COLS], vv[COLS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        qv[r] = q_s[(ty * ROWS + r) * DP + d];
        dov[r] = do_s[(ty * ROWS + r) * DP + d];
      }
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        kv[c] = k_s[(tx + 16 * c) * DP + d];
        vv[c] = v_s[(tx + 16 * c) * DP + d];
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          sc[r][c] = fmaf(qv[r], kv[c], sc[r][c]);
          dp[r][c] = fmaf(dov[r], vv[c], dp[r][c]);
        }
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = ty * ROWS + r;
      const int qpos = q0 + row;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int kpos = k0 + tx + 16 * c;
        const bool visible = kpos < S && (!causal || kpos <= qpos);
        const float p = visible ? expf(sc[r][c] * scale - row_lse[r]) : 0.f;
        ds_s[row * PP + tx + 16 * c] = p * (dp[r][c] - row_delta[r]);
      }
    }
    __syncthreads();  // ds_s is complete

#pragma unroll 4
    for (int kk = 0; kk < BLOCK_K; ++kk) {
      float dsv[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) dsv[r] = ds_s[(ty * ROWS + r) * PP + kk];
#pragma unroll
      for (int j = 0; j < OUT; ++j) {
        const float kval = k_s[kk * DP + tx + 16 * j];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r][j] = fmaf(dsv[r], kval, acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int s = q0 + ty * ROWS + r;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < OUT; ++j)
      dq_base[s * q_stride + tx + 16 * j] = scale * acc[r][j];
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int S, int H, int Hkv,
                     int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = 64 + 1;
  constexpr int OUT = D / 16;
  constexpr int BQ = 64;              // q rows per inner tile
  extern __shared__ float smem[];
  float* k_s = smem;                  // [BLOCK_K][DP]
  float* v_s = k_s + BLOCK_K * DP;    // [BLOCK_K][DP]
  float* q_s = v_s + BLOCK_K * DP;    // [BQ][DP]
  float* do_s = q_s + BQ * DP;        // [BQ][DP]
  float* p_s = do_s + BQ * DP;        // [BLOCK_K][PP], keys x q
  float* ds_s = p_s + BLOCK_K * PP;   // [BLOCK_K][PP]
  float* lse_s = ds_s + BLOCK_K * PP; // [BQ]
  float* delta_s = lse_s + BQ;        // [BQ]

  const int bkv = blockIdx.y;
  const int b = bkv / Hkv;
  const int kvh = bkv % Hkv;
  const int group = H / Hkv;
  const int k0 = blockIdx.x * BLOCK_K;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long q_stride = (long)H * D;
  const long kv_stride = (long)Hkv * D;
  const float* k_base = k + ((long)b * S * Hkv + kvh) * D;
  const float* v_base = v + ((long)b * S * Hkv + kvh) * D;

  for (int i = tid; i < BLOCK_K * D; i += THREADS) {
    const int r = i / D, c = i % D, s = k0 + r;
    const bool ok = s < S;
    k_s[r * DP + c] = ok ? k_base[s * kv_stride + c] : 0.f;
    v_s[r * DP + c] = ok ? v_base[s * kv_stride + c] : 0.f;
  }
  float dk_acc[ROWS][OUT], dv_acc[ROWS][OUT];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < OUT; ++j) dk_acc[r][j] = dv_acc[r][j] = 0.f;

  const int first = causal ? k0 / BQ : 0;
  const int tiles = (S + BQ - 1) / BQ;

  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const long bh = (long)b * H + h;
    const float* q_base = q + ((long)b * S * H + h) * D;
    const float* do_base = dout + ((long)b * S * H + h) * D;
    for (int t = first; t < tiles; ++t) {
      const int q0 = t * BQ;
      __syncthreads();  // the previous tile's q_s/do_s/p_s/ds_s are consumed
      for (int i = tid; i < BQ * D; i += THREADS) {
        const int r = i / D, c = i % D, s = q0 + r;
        const bool ok = s < S;
        q_s[r * DP + c] = ok ? q_base[s * q_stride + c] : 0.f;
        do_s[r * DP + c] = ok ? do_base[s * q_stride + c] : 0.f;
      }
      for (int i = tid; i < BQ; i += THREADS) {
        const int s = q0 + i;
        lse_s[i] = s < S ? lse[bh * S + s] : 0.f;
        delta_s[i] = s < S ? delta[bh * S + s] : 0.f;
      }
      __syncthreads();

      float sc[ROWS][COLS], dp[ROWS][COLS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < COLS; ++c) sc[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[ROWS], vv[ROWS], qv[COLS], dov[COLS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          kv[r] = k_s[(ty * ROWS + r) * DP + d];
          vv[r] = v_s[(ty * ROWS + r) * DP + d];
        }
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          qv[c] = q_s[(tx + 16 * c) * DP + d];
          dov[c] = do_s[(tx + 16 * c) * DP + d];
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            sc[r][c] = fmaf(kv[r], qv[c], sc[r][c]);
            dp[r][c] = fmaf(vv[r], dov[c], dp[r][c]);
          }
      }

#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int row = ty * ROWS + r;
        const int kpos = k0 + row;
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const int col = tx + 16 * c;
          const int qpos = q0 + col;
          const bool visible =
              qpos < S && kpos < S && (!causal || kpos <= qpos);
          const float p =
              visible ? expf(sc[r][c] * scale - lse_s[col]) : 0.f;
          p_s[row * PP + col] = p;
          ds_s[row * PP + col] = p * (dp[r][c] - delta_s[col]);
        }
      }
      __syncthreads();  // p_s and ds_s are complete

#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float pv[ROWS], dsv[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          pv[r] = p_s[(ty * ROWS + r) * PP + qq];
          dsv[r] = ds_s[(ty * ROWS + r) * PP + qq];
        }
#pragma unroll
        for (int j = 0; j < OUT; ++j) {
          const float dov = do_s[qq * DP + tx + 16 * j];
          const float qval = q_s[qq * DP + tx + 16 * j];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            dv_acc[r][j] = fmaf(pv[r], dov, dv_acc[r][j]);
            dk_acc[r][j] = fmaf(dsv[r], qval, dk_acc[r][j]);
          }
        }
      }
    }
  }

  float* dk_base = dk + ((long)b * S * Hkv + kvh) * D;
  float* dv_base = dv + ((long)b * S * Hkv + kvh) * D;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int s = k0 + ty * ROWS + r;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < OUT; ++j) {
      dk_base[s * kv_stride + tx + 16 * j] = scale * dk_acc[r][j];
      dv_base[s * kv_stride + tx + 16 * j] = dv_acc[r][j];
    }
  }
}

// -- bf16: every product on the tensor cores (mma.sync m16n8k16, f32 acc) ---
//
// Four warps per CTA, each owning 16 rows of the CTA's tile (q rows in the
// dQ kernel, keys in the dK/dV kernel). Fragment layout of m16n8k16 (g =
// lane / 4, t = lane % 4): A holds rows g, g+8 x columns 2t..2t+1 and
// 2t+8..2t+9; B holds k rows 2t..2t+1, 2t+8..2t+9 of column g; C holds rows
// g, g+8 x columns 2t..2t+1.

template <int D>
constexpr size_t dq_bf16_smem() {
  return sizeof(bf16) * (2 * BLOCK_Q + 2 * BLOCK_K) * (D + 8);
}

template <int D>
constexpr size_t dkv_bf16_smem() {
  return sizeof(bf16) * (2 * BLOCK_K + 2 * BLOCK_QB) * (D + 8) +
         sizeof(float) * 2 * BLOCK_QB;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t load32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pair);
}

// A fragment (rows row0+g, row0+g+8; k columns col0 + 2t.., + 8) of a
// row-major bf16 tile with leading dimension ld
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* tile, int ld,
                                       int row0, int col0, int g, int t) {
  const bf16* row_g = tile + (row0 + g) * ld + col0 + 2 * t;
  const bf16* row_g8 = row_g + 8 * ld;
  a[0] = load32(row_g);
  a[1] = load32(row_g8);
  a[2] = load32(row_g + 8);
  a[3] = load32(row_g8 + 8);
}

// B fragment of rows [k0, k0 + 16) x columns [n0, n0 + 8) of a row-major bf16
// tile whose rows are the k dimension (ldmatrix.trans)
__device__ __forceinline__ void load_b_trans(uint32_t& b0, uint32_t& b1,
                                             const bf16* tile, int ld, int k0,
                                             int n0, int lane) {
  const uint32_t address = static_cast<uint32_t>(
      __cvta_generic_to_shared(tile + (k0 + lane % 16) * ld + n0));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(address));
}

// 16-byte rows of a [rows][D] slice of a [.., S, heads, D] tensor into a
// [rows][ld] shared tile; rows past S are zeros
template <int D>
__device__ __forceinline__ void load_tile(bf16* tile, int ld,
                                          const bf16* base, long stride,
                                          int s0, int rows, int S, int tid) {
  constexpr int CHUNKS = D / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < rows * CHUNKS; i += MMA_THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8, s = s0 + r;
    *reinterpret_cast<uint4*>(tile + r * ld + c) =
        s < S ? *reinterpret_cast<const uint4*>(base + s * stride + c) : zero;
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     int S, int H, int Hkv, int causal, float scale) {
  constexpr int LD = D + 8;           // 16-byte rows, conflict-free fragments
  constexpr int KSTEPS = D / 16;      // k-steps over d
  constexpr int NT_S = BLOCK_K / 8;   // score n-tiles (8 keys each)
  constexpr int NT_O = D / 8;         // dQ n-tiles (8 columns each)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + BLOCK_Q * LD;
  bf16* k_s = do_s + BLOCK_Q * LD;
  bf16* v_s = k_s + BLOCK_K * LD;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hkv);
  const int q0 = blockIdx.x * BLOCK_Q;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = warp * 16;
  const long q_stride = (long)H * D;
  const long kv_stride = (long)Hkv * D;
  const bf16* k_base = k + ((long)b * S * Hkv + kvh) * D;
  const bf16* v_base = v + ((long)b * S * Hkv + kvh) * D;

  load_tile<D>(q_s, LD, q + ((long)b * S * H + h) * D, q_stride, q0, BLOCK_Q,
               S, tid);
  load_tile<D>(do_s, LD, dout + ((long)b * S * H + h) * D, q_stride, q0,
               BLOCK_Q, S, tid);
  const int qpos[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const bool ok = qpos[half] < S;
    row_lse[half] = ok ? lse[(long)bh * S + qpos[half]] : 0.f;
    row_delta[half] = ok ? delta[(long)bh * S + qpos[half]] : 0.f;
  }

  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int q_last = min(q0 + BLOCK_Q, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int tiles = (kv_end + BLOCK_K - 1) / BLOCK_K;

  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * BLOCK_K;
    __syncthreads();  // every warp is done with the previous K/V tiles
    load_tile<D>(k_s, LD, k_base, kv_stride, k0, BLOCK_K, S, tid);
    load_tile<D>(v_s, LD, v_base, kv_stride, k0, BLOCK_K, S, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: lane holds rows (g, g+8) x keys
    // (8j + 2t, 8j + 2t + 1)
    float sc[NT_S][4], dp[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t aq[4], ado[4];
      load_a(aq, q_s, LD, r0, kk * 16, g, t);
      load_a(ado, do_s, LD, r0, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        const bf16* key = k_s + (j * 8 + g) * LD + kk * 16 + 2 * t;
        const bf16* val = v_s + (j * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(sc[j], aq, load32(key), load32(key + 8));
        mma_bf16(dp[j], ado, load32(val), load32(val + 8));
      }
    }

    // P = exp(scale * S - lse), dS = P * (dP - delta), kept in sc
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + j * 8 + 2 * t + e;
          const bool visible = kpos < S && (!causal || kpos <= qpos[half]);
          const int idx = 2 * half + e;
          const float p =
              visible ? expf(sc[j][idx] * scale - row_lse[half]) : 0.f;
          sc[j][idx] = p * (dp[j][idx] - row_delta[half]);
        }

    // dQ += dS K: dS (bf16) from the registers as A, K through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BLOCK_K / 16; ++kk) {
      const uint32_t da[4] = {
          pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
          pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        uint32_t b0, b1;
        load_b_trans(b0, b1, k_s, LD, kk * 16, n * 8, lane);
        mma_bf16(acc[n], da, b0, b1);
      }
    }
  }

  bf16* dq_base = dq + ((long)b * S * H + h) * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (qpos[half] >= S) continue;
    bf16* out = dq_base + qpos[half] * q_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) = __floats2bfloat162_rn(
          scale * acc[n][2 * half], scale * acc[n][2 * half + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int S, int H, int Hkv,
                      int causal, float scale) {
  constexpr int LD = D + 8;
  constexpr int KSTEPS = D / 16;
  constexpr int NT_S = BLOCK_QB / 8;  // score n-tiles (8 q rows each)
  constexpr int NT_O = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [BLOCK_K][LD]
  bf16* v_s = k_s + BLOCK_K * LD;                 // [BLOCK_K][LD]
  bf16* q_s = v_s + BLOCK_K * LD;                 // [BLOCK_QB][LD]
  bf16* do_s = q_s + BLOCK_QB * LD;               // [BLOCK_QB][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + BLOCK_QB * LD);
  float* delta_s = lse_s + BLOCK_QB;

  const int bkv = blockIdx.y;
  const int b = bkv / Hkv;
  const int kvh = bkv % Hkv;
  const int group = H / Hkv;
  const int k0 = blockIdx.x * BLOCK_K;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = warp * 16;
  const long q_stride = (long)H * D;
  const long kv_stride = (long)Hkv * D;

  load_tile<D>(k_s, LD, k + ((long)b * S * Hkv + kvh) * D, kv_stride, k0,
               BLOCK_K, S, tid);
  load_tile<D>(v_s, LD, v + ((long)b * S * Hkv + kvh) * D, kv_stride, k0,
               BLOCK_K, S, tid);
  const int kpos[2] = {k0 + r0 + g, k0 + r0 + g + 8};

  float dk_acc[NT_O][4], dv_acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int first = causal ? k0 / BLOCK_QB : 0;
  const int tiles = (S + BLOCK_QB - 1) / BLOCK_QB;

  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const long bh = (long)b * H + h;
    const bf16* q_base = q + ((long)b * S * H + h) * D;
    const bf16* do_base = dout + ((long)b * S * H + h) * D;
    for (int tile = first; tile < tiles; ++tile) {
      const int q0 = tile * BLOCK_QB;
      __syncthreads();  // every warp is done with the previous Q/dO tiles
      load_tile<D>(q_s, LD, q_base, q_stride, q0, BLOCK_QB, S, tid);
      load_tile<D>(do_s, LD, do_base, q_stride, q0, BLOCK_QB, S, tid);
      if (tid < BLOCK_QB) {
        const int s = q0 + tid;
        lse_s[tid] = s < S ? lse[bh * S + s] : 0.f;
        delta_s[tid] = s < S ? delta[bh * S + s] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: lane holds keys (g, g+8) x q rows
      // (8j + 2t, 8j + 2t + 1)
      float sc[NT_S][4], dp[NT_S][4];
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t ak[4], av[4];
        load_a(ak, k_s, LD, r0, kk * 16, g, t);
        load_a(av, v_s, LD, r0, kk * 16, g, t);
#pragma unroll
        for (int j = 0; j < NT_S; ++j) {
          const bf16* qrow = q_s + (j * 8 + g) * LD + kk * 16 + 2 * t;
          const bf16* dorow = do_s + (j * 8 + g) * LD + kk * 16 + 2 * t;
          mma_bf16(sc[j], ak, load32(qrow), load32(qrow + 8));
          mma_bf16(dp[j], av, load32(dorow), load32(dorow + 8));
        }
      }

      // P^T into sc, dS^T into dp; each q column reads its own head's
      // lse/delta
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = j * 8 + 2 * t + e;
            const int qpos = q0 + col;
            const bool visible = qpos < S && kpos[half] < S &&
                                 (!causal || kpos[half] <= qpos);
            const int idx = 2 * half + e;
            const float p =
                visible ? expf(sc[j][idx] * scale - lse_s[col]) : 0.f;
            sc[j][idx] = p;
            dp[j][idx] = p * (dp[j][idx] - delta_s[col]);
          }

      // dV += P^T dO and dK += dS^T Q: P^T, dS^T (bf16) from the registers
      // as A, dO and Q through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < BLOCK_QB / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
            pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
            pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
            pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
        const uint32_t da[4] = {
            pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
            pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
            pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
            pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < NT_O; ++n) {
          uint32_t b0, b1;
          load_b_trans(b0, b1, do_s, LD, kk * 16, n * 8, lane);
          mma_bf16(dv_acc[n], pa, b0, b1);
          load_b_trans(b0, b1, q_s, LD, kk * 16, n * 8, lane);
          mma_bf16(dk_acc[n], da, b0, b1);
        }
      }
    }
  }

  bf16* dk_base = dk + ((long)b * S * Hkv + kvh) * D;
  bf16* dv_base = dv + ((long)b * S * Hkv + kvh) * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (kpos[half] >= S) continue;
    bf16* dk_row = dk_base + kpos[half] * kv_stride + 2 * t;
    bf16* dv_row = dv_base + kpos[half] * kv_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk_row + n * 8) =
          __floats2bfloat162_rn(scale * dk_acc[n][2 * half],
                                scale * dk_acc[n][2 * half + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv_row + n * 8) =
          __floats2bfloat162_rn(dv_acc[n][2 * half], dv_acc[n][2 * half + 1]);
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, S, H, Hkv, causal;
  float scale;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
int launch_f32(const Args& a) {
  const size_t dq_smem = dq_f32_smem<D>();
  const size_t dkv_smem = dkv_f32_smem<D>();
  cudaError_t status = allow_smem(flash_dq_f32_kernel<D>, dq_smem);
  if (status == cudaSuccess)
    status = allow_smem(flash_dkv_f32_kernel<D>, dkv_smem);
  if (status != cudaSuccess) return (int)status;
  const dim3 dq_grid((a.S + BLOCK_Q - 1) / BLOCK_Q, a.B * a.H);
  flash_dq_f32_kernel<D><<<dq_grid, THREADS, dq_smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dq), a.S, a.H, a.Hkv, a.causal,
      a.scale);
  status = cudaGetLastError();
  if (status != cudaSuccess) return (int)status;
  const dim3 dkv_grid((a.S + BLOCK_K - 1) / BLOCK_K, a.B * a.Hkv);
  flash_dkv_f32_kernel<D><<<dkv_grid, THREADS, dkv_smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.S, a.H, a.Hkv, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const Args& a) {
  const size_t dq_smem = dq_bf16_smem<D>();
  const size_t dkv_smem = dkv_bf16_smem<D>();
  cudaError_t status = allow_smem(flash_dq_bf16_kernel<D>, dq_smem);
  if (status == cudaSuccess)
    status = allow_smem(flash_dkv_bf16_kernel<D>, dkv_smem);
  if (status != cudaSuccess) return (int)status;
  const dim3 dq_grid((a.S + BLOCK_Q - 1) / BLOCK_Q, a.B * a.H);
  flash_dq_bf16_kernel<D><<<dq_grid, MMA_THREADS, dq_smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, static_cast<bf16*>(a.dq), a.S, a.H, a.Hkv, a.causal, a.scale);
  status = cudaGetLastError();
  if (status != cudaSuccess) return (int)status;
  const dim3 dkv_grid((a.S + BLOCK_K - 1) / BLOCK_K, a.B * a.Hkv);
  flash_dkv_bf16_kernel<D><<<dkv_grid, MMA_THREADS, dkv_smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.S, a.H,
      a.Hkv, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(int dtype, const Args& a) {
  if (dtype == 0) return launch_f32<D>(a);
  if (dtype == 1) return launch_bf16<D>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Launches the dQ kernel, then the dK/dV
// kernel, on `stream`. Returns cudaGetLastError() after the launches (0 =
// launched).
extern "C" int thp_flash_bwd(int dtype, const void* q, const void* k,
                             const void* v, const void* dout, const void* lse,
                             const void* delta, void* dq, void* dk, void* dv,
                             int B, int S, int H, int Hkv, int D, int causal,
                             float scale, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, dk, dv, B, S, H, Hkv,
               causal, scale, static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 16: return launch<16>(dtype, a);
    case 32: return launch<32>(dtype, a);
    case 64: return launch<64>(dtype, a);
    case 128: return launch<128>(dtype, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
