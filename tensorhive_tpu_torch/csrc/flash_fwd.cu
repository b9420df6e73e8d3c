// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: tensorhive_tpu/ops/flash_attention.py, _fwd_kernel_resident
// (K/V of one head resident in VMEM) and _fwd_kernel (the streaming grid),
// both reached from _flash_fwd_bhsd. Their split was a 4 MiB VMEM budget;
// here one kernel serves every sequence length (thp_flash_fwd). Also
// _fwd_kernel_resident_bh, the resident forward over a block of G heads per
// grid program (MHA only), as the head-blocked kernels (thp_flash_fwd_bh):
// one CTA per (q tile, G consecutive b*h rows) writes all G heads' O and
// LSE. On the TPU the block amortized per-program sequencing and DMA set-up
// and fed the MXU a batched contraction; a CTA has no such fixed cost to
// amortize and its tensor cores take one head's tile at a time, so the CTA
// runs its G heads' tiles in turn through the same shared memory and the
// same per-tile code as the per-head kernel. A head's O and LSE are then
// bitwise those of the per-head kernel; the grid is G times smaller.
//
// Computes, per (batch, head), O = softmax(scale * Q K^T [+ causal mask]) V
// and the row log-sum-exp LSE = m + log(l), for q [B, S, H, D] and k/v
// [B, S, Hkv, D] (GQA: query head h reads KV head h / (H / Hkv), with no
// expanded copy). O is [B, S, H, D] in the input type, LSE [B*H, 1, S] f32.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): one causal
// layer does 2*S^2*H*D FLOPs on 2*S*(H+Hkv)*D*itemsize bytes — at S=4096,
// H=32, Hkv=8, D=128 that is 137 GFLOP against 84 MB, so operations bound
// it: ~0.14 ms at the bf16 tensor-core rate, ~2.0 ms for f32 inputs at the
// 67 TFLOP/s of exact f32 outside the tensor cores.
//
// Design (simple and right first; wgmma/TMA are later work):
// * One CTA per (batch*head, 64-row q tile) loops over 64-row K/V tiles
//   staged in shared memory.
// * bf16: QK^T and PV on the tensor cores (mma.sync m16n8k16, bf16
//   operands, f32 accumulation), Q, S/P and O in registers, softmax
//   statistics in f32, probabilities rounded to bf16 for PV as the TPU
//   kernel rounds them (flash_fwd_bf16_kernel).
// * f32: CUDA-core FMAs in exact f32 (no TF32), 256 threads; thread (ty,
//   tx) of a 16x16 grid owns score rows 4*ty..4*ty+3 and columns tx+16*c,
//   and the same rows of the O accumulator in registers for columns
//   tx+16*j. Row max/sum reduce over the 16 lanes of a half-warp.
// * Online softmax over K tiles in order. Causal: the loop stops at the
//   tile holding the last visible key of the q tile, so tiles above the
//   diagonal are never loaded. The mask is bottom-right aligned with
//   seq_q == seq_k (key j visible to query i iff j <= i), the convention
//   of reference_attention's tril(.., seq_k - seq_q).
// * Masked scores give probability exactly 0 (never exp(NEG_INF-NEG_INF)
//   = 1), keys past S are masked, q rows past S are neither read nor
//   written: a ragged last tile (S = 4095) needs no fallback.
// * The scale multiplies the f32 scores (d_head 128 gives 128^-0.5, not a
//   power of two). That is the JAX _fold_scale_into_q rule either way: a
//   power-of-two scale folded into q scales every product and every partial
//   sum exactly, so it gives these scores bit for bit, and any other scale
//   is the rule's residual on the f32 scores. A zero row sum divides by 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int THREADS = 256;
constexpr int ROWS = BLOCK_Q / 16;   // score/output rows per thread
constexpr int COLS = BLOCK_K / 16;   // score columns per thread
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BLOCK_Q * (D + 1) + BLOCK_K * (D + 1) +
                          BLOCK_K * D + BLOCK_Q * (BLOCK_K + 1));
}

// -- f32: exact f32 products on the CUDA cores --------------------------------
// One (b*h row, 64-row q tile) of the f32 forward, run by the whole CTA in
// shared memory ``smem``. Both the per-head kernel (K1/K2) and the
// head-blocked kernel (K3) run their tiles through this one body, so a head
// gets the same arithmetic, in the same order, from either.
template <int D>
__device__ __forceinline__ void fwd_f32_tile(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int S, int H, int Hkv, int causal, float scale,
    int bh, int q0, float* smem) {
  constexpr int DP = D + 1;           // padded rows: no bank conflicts
  constexpr int PP = BLOCK_K + 1;
  constexpr int OUT = D / 16;         // output columns per thread
  float* q_s = smem;                  // [BLOCK_Q][DP]
  float* k_s = q_s + BLOCK_Q * DP;    // [BLOCK_K][DP]
  float* v_s = k_s + BLOCK_K * DP;    // [BLOCK_K][D]
  float* p_s = v_s + BLOCK_K * D;     // [BLOCK_Q][PP]

  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long q_stride = (long)H * D;
  const long kv_stride = (long)Hkv * D;
  const float* q_base = q + ((long)b * S * H + h) * D;
  const float* k_base = k + ((long)b * S * Hkv + kvh) * D;
  const float* v_base = v + ((long)b * S * Hkv + kvh) * D;
  float* o_base = o + ((long)b * S * H + h) * D;

  for (int i = tid; i < BLOCK_Q * D; i += THREADS) {
    const int r = i / D, c = i % D, s = q0 + r;
    q_s[r * DP + c] = s < S ? q_base[s * q_stride + c] : 0.f;
  }

  float acc[ROWS][OUT];
  float m[ROWS], l[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < OUT; ++j) acc[r][j] = 0.f;
  }

  const int q_last = min(q0 + BLOCK_Q, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int tiles = (kv_end + BLOCK_K - 1) / BLOCK_K;

  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * BLOCK_K;
    __syncthreads();  // the previous tile's k_s/v_s/p_s are consumed
    for (int i = tid; i < BLOCK_K * D; i += THREADS) {
      const int r = i / D, c = i % D, s = k0 + r;
      const bool ok = s < S;
      k_s[r * DP + c] = ok ? k_base[s * kv_stride + c] : 0.f;
      v_s[r * D + c] = ok ? v_base[s * kv_stride + c] : 0.f;
    }
    __syncthreads();

    float sc[ROWS][COLS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < COLS; ++c) sc[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[ROWS], kv[COLS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) qv[r] = q_s[(ty * ROWS + r) * DP + d];
#pragma unroll
      for (int c = 0; c < COLS; ++c) kv[c] = k_s[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < COLS; ++c) sc[r][c] = fmaf(qv[r], kv[c], sc[r][c]);
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = ty * ROWS + r;
      const int qpos = q0 + row;
      bool visible[COLS];
      float block_max = NEG_INF;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int kpos = k0 + tx + 16 * c;
        visible[c] = kpos < S && (!causal || kpos <= qpos);
        sc[r][c] = visible[c] ? sc[r][c] * scale : NEG_INF;
        block_max = fmaxf(block_max, sc[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        block_max = fmaxf(block_max,
                          __shfl_xor_sync(0xffffffffu, block_max, off));
      const float m_new = fmaxf(m[r], block_max);
      const float correction = expf(m[r] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const float p = visible[c] ? expf(sc[r][c] - m_new) : 0.f;
        p_s[row * PP + tx + 16 * c] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[r] = l[r] * correction + row_sum;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < OUT; ++j) acc[r][j] *= correction;
    }
    __syncthreads();  // p_s is complete

#pragma unroll 4
    for (int kk = 0; kk < BLOCK_K; ++kk) {
      float pv[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) pv[r] = p_s[(ty * ROWS + r) * PP + kk];
#pragma unroll
      for (int j = 0; j < OUT; ++j) {
        const float vv = v_s[kk * D + tx + 16 * j];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r][j] = fmaf(pv[r], vv, acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int s = q0 + ty * ROWS + r;
    if (s >= S) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int j = 0; j < OUT; ++j)
      o_base[s * q_stride + tx + 16 * j] = acc[r][j] / denom;
    if (tx == 0) lse[(long)bh * S + s] = m[r] + logf(denom);
  }
}

// K1/K2: one CTA per (q tile, b*h row).
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int Hkv,
                     int causal, float scale) {
  extern __shared__ float smem[];
  fwd_f32_tile<D>(q, k, v, o, lse, S, H, Hkv, causal, scale, blockIdx.y,
                  blockIdx.x * BLOCK_Q, smem);
}

// K3: one CTA per (q tile, block of G consecutive b*h rows); the CTA runs
// the G heads' tiles one after the other in the same shared memory. Row i
// of the block is b*h row blockIdx.y * G + i, i.e. batch (row / H) and head
// (row % H): a block may straddle two batch elements when H % G != 0.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bh_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int S, int H, int causal,
                        float scale, int G) {
  extern __shared__ float smem[];
  for (int i = 0; i < G; ++i) {
    __syncthreads();  // the previous head is done with every tile
    fwd_f32_tile<D>(q, k, v, o, lse, S, H, H, causal, scale,
                    blockIdx.y * G + i, blockIdx.x * BLOCK_Q, smem);
  }
}

// -- bf16: QK^T and PV on the tensor cores (mma.sync m16n8k16, f32 acc) ----
//
// Four warps per CTA, each owning 16 of the 64 query rows (FlashAttention-2
// style). The warp's Q fragments stay in registers for the whole sweep; K
// and V tiles are staged in shared memory as bf16 with 16-byte loads. S =
// QK^T accumulates in registers; each lane holds rows g and g+8 (g = lane /
// 4) of its columns, so the row max/sum reduce over the 4 lanes of a
// group. The probabilities are rounded to bf16 (the JAX kernel's
// probs.astype(v.dtype)) and fed straight from the S registers as the A
// operand of PV; V's B operand comes through ldmatrix.trans. The O
// accumulator stays in registers and is rescaled per row in place; the row
// sums use the f32 probabilities.
constexpr int MMA_THREADS = 128;

template <int D>
constexpr size_t bf16_smem_bytes() {
  return sizeof(__nv_bfloat16) * (BLOCK_Q + 2 * BLOCK_K) * (D + 8);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t load32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pair);
}

// One (b*h row, 64-row q tile) of the bf16 forward (see fwd_f32_tile).
template <int D>
__device__ __forceinline__ void fwd_bf16_tile(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int S, int H, int Hkv, int causal, float scale,
    int bh, int q0, unsigned char* smem_raw) {
  constexpr int LD = D + 8;           // bf16 tile rows: 16-byte multiple,
                                      // conflict-free fragment reads
  constexpr int CHUNKS = D / 8;       // 16-byte chunks per row
  constexpr int KSTEPS = D / 16;      // QK^T k-steps over d
  constexpr int NT_S = BLOCK_K / 8;   // S n-tiles (8 keys each)
  constexpr int NT_O = D / 8;         // O n-tiles (8 columns each)
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + BLOCK_Q * LD;
  __nv_bfloat16* v_s = k_s + BLOCK_K * LD;

  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;             // fragment row group
  const int t = lane % 4;             // thread in group
  const int r0 = warp * 16;           // the warp's first row in the tile
  const long q_stride = (long)H * D;
  const long kv_stride = (long)Hkv * D;
  const __nv_bfloat16* q_base = q + ((long)b * S * H + h) * D;
  const __nv_bfloat16* k_base = k + ((long)b * S * Hkv + kvh) * D;
  const __nv_bfloat16* v_base = v + ((long)b * S * Hkv + kvh) * D;
  __nv_bfloat16* o_base = o + ((long)b * S * H + h) * D;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < BLOCK_Q * CHUNKS; i += MMA_THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8, s = q0 + r;
    *reinterpret_cast<uint4*>(q_s + r * LD + c) =
        s < S ? *reinterpret_cast<const uint4*>(q_base + s * q_stride + c)
              : zero;
  }
  __syncthreads();
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const __nv_bfloat16* row_g = q_s + (r0 + g) * LD + kk * 16 + 2 * t;
    const __nv_bfloat16* row_g8 = row_g + 8 * LD;
    qf[kk][0] = load32(row_g);
    qf[kk][1] = load32(row_g8);
    qf[kk][2] = load32(row_g + 8);
    qf[kk][3] = load32(row_g8 + 8);
  }

  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};   // rows g and g + 8
  float l[2] = {0.f, 0.f};           // this lane's share of the row sums
  const int qpos[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  const int q_last = min(q0 + BLOCK_Q, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int tiles = (kv_end + BLOCK_K - 1) / BLOCK_K;

  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * BLOCK_K;
    __syncthreads();  // every warp is done with the previous K/V tiles
    for (int i = tid; i < BLOCK_K * CHUNKS; i += MMA_THREADS) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8, s = k0 + r;
      const bool ok = s < S;
      *reinterpret_cast<uint4*>(k_s + r * LD + c) =
          ok ? *reinterpret_cast<const uint4*>(k_base + s * kv_stride + c)
             : zero;
      *reinterpret_cast<uint4*>(v_s + r * LD + c) =
          ok ? *reinterpret_cast<const uint4*>(v_base + s * kv_stride + c)
             : zero;
    }
    __syncthreads();

    // S = Q K^T: lane holds rows (g, g+8) x keys (8j + 2t, 8j + 2t + 1)
    float sc[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const __nv_bfloat16* key = k_s + (j * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        mma_bf16(sc[j], qf[kk], load32(key + kk * 16),
                 load32(key + kk * 16 + 8));
    }

    // online softmax in f32; masked scores give probability exactly 0
    float correction[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float block_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + j * 8 + 2 * t + e;
          const bool visible = kpos < S && (!causal || kpos <= qpos[half]);
          float& score = sc[j][2 * half + e];
          score = visible ? score * scale : NEG_INF;
          block_max = fmaxf(block_max, score);
        }
      block_max = fmaxf(block_max, __shfl_xor_sync(0xffffffffu, block_max, 1));
      block_max = fmaxf(block_max, __shfl_xor_sync(0xffffffffu, block_max, 2));
      const float m_new = fmaxf(m[half], block_max);
      correction[half] = expf(m[half] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& score = sc[j][2 * half + e];
          score = score > 0.5f * NEG_INF ? expf(score - m_new) : 0.f;
          row_sum += score;
        }
      l[half] = l[half] * correction[half] + row_sum;
      m[half] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      acc[n][0] *= correction[0];
      acc[n][1] *= correction[0];
      acc[n][2] *= correction[1];
      acc[n][3] *= correction[1];
    }

    // O += P V: P from the S registers (A operand), V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BLOCK_K / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
          pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const __nv_bfloat16* v_rows = v_s + (kk * 16 + lane % 16) * LD;
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        uint32_t b0, b1;
        const uint32_t address = static_cast<uint32_t>(
            __cvta_generic_to_shared(v_rows + n * 8));
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
            : "=r"(b0), "=r"(b1)
            : "r"(address));
        mma_bf16(acc[n], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float total = l[half];
    total += __shfl_xor_sync(0xffffffffu, total, 1);
    total += __shfl_xor_sync(0xffffffffu, total, 2);
    const float denom = total == 0.f ? 1.f : total;
    if (qpos[half] >= S) continue;
    __nv_bfloat16* out = o_base + qpos[half] * q_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) = __floats2bfloat162_rn(
          acc[n][2 * half] / denom, acc[n][2 * half + 1] / denom);
    if (t == 0) lse[(long)bh * S + qpos[half]] = m[half] + logf(denom);
  }
}

// K1/K2: one CTA per (q tile, b*h row).
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int S, int H, int Hkv, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  fwd_bf16_tile<D>(q, k, v, o, lse, S, H, Hkv, causal, scale, blockIdx.y,
                   blockIdx.x * BLOCK_Q, smem_raw);
}

// K3: one CTA per (q tile, block of G consecutive b*h rows), as
// flash_fwd_bh_f32_kernel.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_bh_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int S, int H, int causal,
                         float scale, int G) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  for (int i = 0; i < G; ++i) {
    __syncthreads();  // the previous head is done with every tile
    fwd_bf16_tile<D>(q, k, v, o, lse, S, H, H, causal, scale,
                     blockIdx.y * G + i, blockIdx.x * BLOCK_Q, smem_raw);
  }
}

// G == 0 launches the per-head kernel (K1/K2) over B*H rows; G >= 1 the
// head-blocked kernel (K3, MHA: Hkv == H) over B*H / G blocks.
template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int S, int H, int Hkv, int causal,
                float scale, int G, cudaStream_t stream) {
  const size_t smem = bf16_smem_bytes<D>();
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  const int tiles = (S + BLOCK_Q - 1) / BLOCK_Q;
  cudaError_t status;
  if (G == 0) {
    status = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
    if (status != cudaSuccess) return (int)status;
    flash_fwd_bf16_kernel<D><<<dim3(tiles, B * H), MMA_THREADS, smem,
                               stream>>>(qp, kp, vp, op, lp, S, H, Hkv,
                                         causal, scale);
  } else {
    status = cudaFuncSetAttribute(flash_fwd_bh_bf16_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
    if (status != cudaSuccess) return (int)status;
    flash_fwd_bh_bf16_kernel<D><<<dim3(tiles, B * H / G), MMA_THREADS, smem,
                                  stream>>>(qp, kp, vp, op, lp, S, H, causal,
                                            scale, G);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int S, int H, int Hkv, int causal,
               float scale, int G, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(o);
  auto* lp = static_cast<float*>(lse);
  const int tiles = (S + BLOCK_Q - 1) / BLOCK_Q;
  cudaError_t status;
  if (G == 0) {
    status = cudaFuncSetAttribute(flash_fwd_f32_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
    if (status != cudaSuccess) return (int)status;
    flash_fwd_f32_kernel<D><<<dim3(tiles, B * H), THREADS, smem, stream>>>(
        qp, kp, vp, op, lp, S, H, Hkv, causal, scale);
  } else {
    status = cudaFuncSetAttribute(flash_fwd_bh_f32_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
    if (status != cudaSuccess) return (int)status;
    flash_fwd_bh_f32_kernel<D><<<dim3(tiles, B * H / G), THREADS, smem,
                                 stream>>>(qp, kp, vp, op, lp, S, H, causal,
                                           scale, G);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           void* lse, int B, int S, int H, int Hkv, int causal, float scale,
           int G, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, lse, B, S, H, Hkv, causal, scale, G,
                         stream);
  if (dtype == 1)
    return launch_bf16<D>(q, k, v, o, lse, B, S, H, Hkv, causal, scale, G,
                          stream);
  return (int)cudaErrorInvalidValue;
}

int dispatch(int dtype, const void* q, const void* k, const void* v, void* o,
             void* lse, int B, int S, int H, int Hkv, int D, int causal,
             float scale, int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(dtype, q, k, v, o, lse, B, S, H, Hkv, causal, scale, G, s);
    case 32: return launch<32>(dtype, q, k, v, o, lse, B, S, H, Hkv, causal, scale, G, s);
    case 64: return launch<64>(dtype, q, k, v, o, lse, B, S, H, Hkv, causal, scale, G, s);
    case 128: return launch<128>(dtype, q, k, v, o, lse, B, S, H, Hkv, causal, scale, G, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K1/K2. dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int thp_flash_fwd(int dtype, const void* q, const void* k,
                             const void* v, void* o, void* lse, int B, int S,
                             int H, int Hkv, int D, int causal, float scale,
                             void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  return dispatch(dtype, q, k, v, o, lse, B, S, H, Hkv, D, causal, scale, 0,
                  stream);
}

// K3: MHA (k/v carry H heads), G consecutive b*h rows per CTA; G must
// divide B*H. Same dtype codes and return value as thp_flash_fwd.
extern "C" int thp_flash_fwd_bh(int dtype, const void* q, const void* k,
                                const void* v, void* o, void* lse, int B,
                                int S, int H, int D, int causal, float scale,
                                int G, void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || (B * H) % G != 0 ||
      B * H / G > 65535)
    return (int)cudaErrorInvalidValue;
  return dispatch(dtype, q, k, v, o, lse, B, S, H, H, D, causal, scale, G,
                  stream);
}
