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
// and fed the MXU a batched contraction; a CTA's tensor cores take one
// head's tile at a time, so the CTA runs its G heads' tiles in turn through
// the same shared memory and the same per-tile code as the per-head kernel
// (what it amortizes is its own set-up: the bf16 TMA body keeps its load
// ring running across the heads). A head's O and LSE are then bitwise those
// of the per-head kernel; the grid is G times smaller.
//
// Computes, per (batch, head), O = softmax(scale * Q K^T [+ causal mask]) V
// and the row log-sum-exp LSE = m + log(l), for q [B, S, H, D] and k/v
// [B, S, Hkv, D] (GQA: query head h reads KV head h / (H / Hkv), with no
// expanded copy). O is [B, S, H, D] in the input type, LSE [B*H, 1, S] f32.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): one causal
// layer does 2*S^2*H*D FLOPs on 2*S*(H+Hkv)*D*itemsize bytes — at S=4095,
// H=32, Hkv=8, D=128 (K1, the 7b prefill) that is 137 GFLOP against 84 MB,
// so operations bound it: ~0.14 ms at the bf16 tensor-core rate, ~2.0 ms
// for f32 inputs at the 67 TFLOP/s of exact f32 outside the tensor cores.
// K3 at the encoder shape (B 64, S 1024, H 8, D 64, non-causal) is 137
// GFLOP on 67 MB, operations again (0.139 ms); at d_head 64 the softmax
// weighs as much as the products: one exponential per score at the 16 per
// clock of an SM's special-function units also takes ~0.14 ms.
//
// bf16, d_head 64 and 128 (every main path: t2t-base/big and the encoder
// at 64, the 1b/7b presets at 128) — the Hopper design. The mma.sync body
// (kept below for d 16/32) runs Ampere tiles of 64x64 on 4 warps that copy
// every K/V tile through registers between two __syncthreads, with no load
// in flight while the tensor cores work: 12% of the bf16 peak at the K1
// shape on an H100.
// Here (flash_fwd_bf16_kernel, flash_fwd_bh_bf16_kernel, fwd_bf16_cta):
// * A CTA of three warpgroups owns a 128-row q tile. Warpgroup 2 is the
//   producer: one thread issues TMA loads (cp.async.bulk.tensor) of Q once
//   per head and of K and V, tile by tile, into a ring of shared-memory
//   stages (2 at d 128, 3 at d 64; 128 keys each), so loads run ahead of
//   the math. K and V of a stage each have a full and an empty mbarrier: a
//   consumer releases K as soon as S is in and V only after P V, so the
//   next K load does not wait for the last product (with one empty barrier
//   per stage, 2 stages at d 128 starved the pipeline below). Warpgroups 0
//   and 1 consume, 64 q rows each; setmaxnreg moves registers from the
//   producer to them. The tensor maps are the port's layouts as they are, q/o
//   [B, S, H, D] and k/v [B, S, Hkv, D], boxes of (64 columns, 1 head, 128
//   rows, 1 batch) with the 128-byte swizzle wgmma reads; GQA loads KV head
//   h / (H / Hkv) with no expanded copy, and TMA fills rows past S with
//   zeros, so a ragged last tile needs no masked loads.
// * S = Q K^T is wgmma m64n128k16 with both operands from shared memory,
//   f32 accumulators. The online softmax stays in registers in f32, row
//   max/sum over the 4 lanes that share a row, exponentials as exp2 with
//   log2(e) folded into the score scale. P is rounded to bf16 in registers
//   (the JAX kernel's probs.astype(v.dtype)) and is the register A operand
//   of O += P V (wgmma m64nDk16, V the MN-major B operand from shared
//   memory): the accumulator layout of the first product is the operand
//   layout of the second, so P never touches shared memory.
// * Each consumer pipelines its own tiles: it issues S of tile t and P V
//   of tile t - 1 together, runs the softmax of tile t while P V is on the
//   tensor cores, and rescales O once P V is done.
// * Causal: a CTA loads key tiles up to the diagonal of its last row and
//   never above it; a warpgroup whose rows end earlier releases the last
//   tile unread. The q-tile order is reversed so the longest CTAs of each
//   b*h row start first.
// * K3 runs the same body over its G heads in turn: the producer carries
//   the ring across the head boundary (the next head's K/V stream in while
//   this head finishes), and a head's O and LSE are bitwise K1's.
// d_head 16 and 32 (the tiny preset, and the card tests' grid) keep the
// mma.sync body (fwd_bf16_tile): wgmma's 128-byte swizzle spans 64 bf16
// columns, and a narrower head would need its own swizzle modes for work
// no main path does.
//
// f32: CUDA-core FMAs in exact f32 (no TF32), 256 threads, one CTA per
// (batch*head, 64-row q tile); thread (ty, tx) of a 16x16 grid owns score
// rows 4*ty..4*ty+3 and columns tx+16*c, and the same rows of the O
// accumulator in registers for columns tx+16*j. Row max/sum reduce over the
// 16 lanes of a half-warp.
//
// Every body: online softmax over K tiles in order; the causal mask is
// bottom-right aligned with seq_q == seq_k (key j visible to query i iff
// j <= i), the convention of reference_attention's tril(.., seq_k - seq_q).
// Masked scores give probability exactly 0 (never exp(NEG_INF-NEG_INF) =
// 1), keys past S are masked, q rows past S are not written. The row sums
// use the f32 probabilities. The scale multiplies the f32 scores (d_head
// 128 gives 128^-0.5, not a power of two). That is the JAX
// _fold_scale_into_q rule either way: a power-of-two scale folded into q
// scales every product and every partial sum exactly, so it gives these
// scores bit for bit, and any other scale is the rule's residual on the f32
// scores. A zero row sum divides by 1.
#include "hopper.cuh"

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

// -- bf16, d_head 16 and 32: mma.sync m16n8k16, f32 acc ----------------------
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

// One (b*h row, 64-row q tile) of the bf16 forward (see fwd_f32_tile).
template <int D>
__device__ __forceinline__ void fwd_bf16_tile(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int S, int H, int Hkv, int causal, float scale,
    int bh, int q0, unsigned char* smem_raw) {
  static_assert(D == 16 || D == 32, "d_head 64 and 128 run fwd_bf16_cta");
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

// d 16/32, K1/K2: one CTA per (q tile, b*h row).
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int S, int H, int Hkv,
                          int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  fwd_bf16_tile<D>(q, k, v, o, lse, S, H, Hkv, causal, scale, blockIdx.y,
                   blockIdx.x * BLOCK_Q, smem_raw);
}

// d 16/32, K3: one CTA per (q tile, block of G consecutive b*h rows), as
// flash_fwd_bh_f32_kernel.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_bh_mma_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             __nv_bfloat16* __restrict__ o,
                             float* __restrict__ lse, int S, int H,
                             int causal, float scale, int G) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  for (int i = 0; i < G; ++i) {
    __syncthreads();  // the previous head is done with every tile
    fwd_bf16_tile<D>(q, k, v, o, lse, S, H, H, causal, scale,
                     blockIdx.y * G + i, blockIdx.x * BLOCK_Q, smem_raw);
  }
}

template <int D>
int launch_bf16_mma(const void* q, const void* k, const void* v, void* o,
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
    status = cudaFuncSetAttribute(flash_fwd_mma_bf16_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
    if (status != cudaSuccess) return (int)status;
    flash_fwd_mma_bf16_kernel<D><<<dim3(tiles, B * H), MMA_THREADS, smem,
                                   stream>>>(qp, kp, vp, op, lp, S, H, Hkv,
                                             causal, scale);
  } else {
    status = cudaFuncSetAttribute(flash_fwd_bh_mma_bf16_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
    if (status != cudaSuccess) return (int)status;
    flash_fwd_bh_mma_bf16_kernel<D><<<dim3(tiles, B * H / G), MMA_THREADS,
                                      smem, stream>>>(qp, kp, vp, op, lp, S,
                                                      H, causal, scale, G);
  }
  return (int)cudaGetLastError();
}

// -- bf16, d_head 64 and 128: TMA, an mbarrier ring and wgmma ---------------
//
// Shared memory (1024-byte aligned for the 128-byte swizzle): the Q tile,
// then STAGES K tiles, then STAGES V tiles, each stored as D/64 blocks of
// (rows x 64 columns), 128 bytes a row, as TMA writes them; then the
// mbarriers. The fragment layouts, descriptors and products are
// hopper.cuh's, shared with the backward.
constexpr int TMA_Q = 128;                  // q rows per CTA, 64 a consumer
constexpr int TMA_K = 128;                  // keys per K/V stage
constexpr int TMA_THREADS = 3 * WG_THREADS; // consumers 0, 1; producer 2
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;          // 2 * 224 + 56 = 3 * 168

template <int D>
struct TmaTile {
  static_assert(D == 64 || D == 128, "the TMA body serves d_head 64 and 128");
  static constexpr int BLOCKS = D / 64;     // 64-column swizzle blocks
  static constexpr int STAGES = D == 128 ? 2 : 3;
  static constexpr uint32_t Q_BYTES = TMA_Q * D * 2;
  static constexpr uint32_t KV_BYTES = TMA_K * D * 2;
  static constexpr uint32_t BARRIERS = Q_BYTES + 2 * STAGES * KV_BYTES;
  // q_full, q_empty, then k_full, v_full, k_empty and v_empty per stage;
  // 1024 bytes of slack to align the base
  static constexpr int SMEM = 1024 + BARRIERS + 8 * (2 + 4 * STAGES);
};

// One online-softmax step over a key tile from k0, in f32: the scores in
// ``s`` become probabilities (masked ones exactly 0), the row maxima ``m``
// (in scaled log2 units) and this lane's row sums ``l`` move on, and
// ``correction`` is the factor the O rows must be rescaled by. ``edge``:
// the tile holds masked keys (past S, or above the diagonal of a row).
__device__ __forceinline__ void softmax_tile(
    float (&s)[64], int k0, const int (&qpos)[2], int S, int causal,
    bool edge, int t4, float scale_log2, float (&m)[2], float (&l)[2],
    float (&correction)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float block_max = NEG_INF;
    if (edge) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * j + 2 * t4 + e;
          float& x = s[4 * j + 2 * r + e];
          x = kpos < S && (!causal || kpos <= qpos[r]) ? x * scale_log2
                                                       : NEG_INF;
          block_max = fmaxf(block_max, x);
        }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * r + e];
          x *= scale_log2;
          block_max = fmaxf(block_max, x);
        }
    }
    block_max = fmaxf(block_max, __shfl_xor_sync(0xffffffffu, block_max, 1));
    block_max = fmaxf(block_max, __shfl_xor_sync(0xffffffffu, block_max, 2));
    const float m_new = fmaxf(m[r], block_max);
    correction[r] = exp2_approx(m[r] - m_new);
    float row_sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * r + e];
        x = edge && x <= 0.5f * NEG_INF ? 0.f : exp2_approx(x - m_new);
        row_sum += x;
      }
    l[r] = l[r] * correction[r] + row_sum;
    m[r] = m_new;
  }
}

template <int N>
__device__ __forceinline__ void rescale_rows(float (&acc)[N],
                                             const float (&correction)[2]) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    acc[4 * n] *= correction[0];
    acc[4 * n + 1] *= correction[0];
    acc[4 * n + 2] *= correction[1];
    acc[4 * n + 3] *= correction[1];
  }
}

// One CTA of the bf16 forward: the 128-row q tile of this block's grid
// column for ``items`` consecutive b*h rows from ``bh0`` (K1/K2: one;
// K3: G), in turn. ``scale_log2`` is the score scale times log2(e).
template <int D>
__device__ __forceinline__ void fwd_bf16_cta(
    const CUtensorMap& q_map, const CUtensorMap& k_map,
    const CUtensorMap& v_map, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int S, int H, int Hkv, int causal,
    float scale_log2, int bh0, int items) {
  using T = TmaTile<D>;
  constexpr int STAGES = T::STAGES;
  extern __shared__ __align__(1024) unsigned char tma_smem[];
  const uint32_t base = (smem_u32(tma_smem) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + T::Q_BYTES;
  const uint32_t v_s = k_s + STAGES * T::KV_BYTES;
  const uint32_t q_full = base + T::BARRIERS;
  const uint32_t q_empty = q_full + 8;
  const uint32_t k_full = q_full + 16;           // + 8 * stage
  const uint32_t v_full = k_full + 8 * STAGES;
  const uint32_t k_empty = v_full + 8 * STAGES;
  const uint32_t v_empty = k_empty + 8 * STAGES;

  // heaviest causal q tiles first
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * TMA_Q;
  const int cta_last = min(q0 + TMA_Q, S) - 1;
  const int kv_tiles = ((causal ? cta_last + 1 : S) + TMA_K - 1) / TMA_K;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 2);
      mbar_init(v_empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 2) {
    // -- producer: one thread keeps the ring full -----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 2 * WG_THREADS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < items; ++i) {
        const int bh = bh0 + i;
        const int b = bh / H;
        const int h = bh % H;
        const int kvh = h / (H / Hkv);
        mbar_wait(q_empty, (i & 1) ^ 1);  // both consumers are past Q
        mbar_expect_tx(q_full, T::Q_BYTES);
        for (int blk = 0; blk < T::BLOCKS; ++blk)
          tma_load(q_s + blk * TMA_Q * 128, q_map, q_full, blk * 64, h, q0, b);
        for (int t = 0; t < kv_tiles; ++t) {
          // K and V stages are released apart: a consumer is done with K
          // once S is in, with V only after P V, a tile later
          const uint32_t kf = k_full + 8 * stage;
          const uint32_t vf = v_full + 8 * stage;
          const uint32_t kd = k_s + stage * T::KV_BYTES;
          const uint32_t vd = v_s + stage * T::KV_BYTES;
          mbar_wait(k_empty + 8 * stage, phase ^ 1);  // both released it
          mbar_expect_tx(kf, T::KV_BYTES);
          for (int blk = 0; blk < T::BLOCKS; ++blk)
            tma_load(kd + blk * TMA_K * 128, k_map, kf, blk * 64, kvh,
                     t * TMA_K, b);
          mbar_wait(v_empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(vf, T::KV_BYTES);
          for (int blk = 0; blk < T::BLOCKS; ++blk)
            tma_load(vd + blk * TMA_K * 128, v_map, vf, blk * 64, kvh,
                     t * TMA_K, b);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // -- consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63 ----------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int t4 = lane % 4;
    const int row0 = q0 + wg * 64;
    const int qpos[2] = {row0 + warp * 16 + lane / 4,
                         row0 + warp * 16 + lane / 4 + 8};
    // key tiles this warpgroup reads: causal rows stop at their diagonal
    const int my_tiles =
        row0 >= S ? 1
                  : (causal ? (min(row0 + 64, S) - 1) / TMA_K + 1 : kv_tiles);
    const uint64_t q_desc = sw128_desc(q_s + wg * 64 * 128, 16, 1024);
    int stage = 0;
    uint32_t phase = 0;
    for (int i = 0; i < items; ++i) {
      const int bh = bh0 + i;
      float acc[D / 2];
#pragma unroll
      for (int n = 0; n < D / 2; ++n) acc[n] = 0.f;
      float m[2] = {NEG_INF, NEG_INF};  // in scaled log2 units
      float l[2] = {0.f, 0.f};          // this lane's share of the row sums
      float s[64];
      float correction[2];
      uint32_t p[TMA_K / 16][4];
      const auto edge = [&](int k0) {
        return k0 + TMA_K > S || (causal && k0 + TMA_K - 1 > row0);
      };

      // Software pipeline over the key tiles: S of tile t is computed
      // while P V of tile t - 1 runs, and its softmax overlaps that
      // product; O is rescaled once P V is done.
      mbar_wait(q_full, i & 1);
      mbar_wait(k_full + 8 * stage, phase);
      issue_ss<D, TMA_Q, TMA_K>(s, q_desc, k_s + stage * T::KV_BYTES);
      wgmma_wait<0>();
      fence_registers(s);
      if (tid == 0) {
        mbar_arrive(k_empty + 8 * stage);
        if (my_tiles == 1) mbar_arrive(q_empty);
      }
      softmax_tile(s, 0, qpos, S, causal, edge(0), t4, scale_log2, m, l,
                   correction);
      pack_a(p, s);
      int prev_stage = stage;
      uint32_t prev_phase = phase;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
      for (int t = 1; t < my_tiles; ++t) {
        mbar_wait(k_full + 8 * stage, phase);
        issue_ss<D, TMA_Q, TMA_K>(s, q_desc, k_s + stage * T::KV_BYTES);
        mbar_wait(v_full + 8 * prev_stage, prev_phase);
        issue_rs<TMA_K>(acc, p, v_s + prev_stage * T::KV_BYTES);
        wgmma_wait<1>();                // S is in, P V still running
        fence_registers(s);
        if (tid == 0) {
          mbar_arrive(k_empty + 8 * stage);
          if (t == my_tiles - 1) mbar_arrive(q_empty);
        }
        softmax_tile(s, t * TMA_K, qpos, S, causal, edge(t * TMA_K), t4,
                     scale_log2, m, l, correction);
        wgmma_wait<0>();
        fence_registers(acc);
        if (tid == 0) mbar_arrive(v_empty + 8 * prev_stage);
        rescale_rows(acc, correction);
        pack_a(p, s);
        prev_stage = stage;
        prev_phase = phase;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      mbar_wait(v_full + 8 * prev_stage, prev_phase);
      issue_rs<TMA_K>(acc, p, v_s + prev_stage * T::KV_BYTES);
      wgmma_wait<0>();
      fence_registers(acc);
      if (tid == 0) mbar_arrive(v_empty + 8 * prev_stage);
      // tiles above every row of this warpgroup: released once landed
      for (int t = my_tiles; t < kv_tiles; ++t) {
        mbar_wait(k_full + 8 * stage, phase);
        mbar_wait(v_full + 8 * stage, phase);
        if (tid == 0) {
          mbar_arrive(k_empty + 8 * stage);
          mbar_arrive(v_empty + 8 * stage);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }

      const int b = bh / H;
      const int h = bh % H;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float total = l[r];
        total += __shfl_xor_sync(0xffffffffu, total, 1);
        total += __shfl_xor_sync(0xffffffffu, total, 2);
        const float denom = total == 0.f ? 1.f : total;
        if (qpos[r] >= S) continue;
        __nv_bfloat16* out =
            o + (((long)b * S + qpos[r]) * H + h) * D + 2 * t4;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(out + n * 8) =
              __floats2bfloat162_rn(acc[4 * n + 2 * r] / denom,
                                    acc[4 * n + 2 * r + 1] / denom);
        if (t4 == 0) lse[(long)bh * S + qpos[r]] = m[r] * LN2 + logf(denom);
      }
    }
  }
}

// K1/K2: one CTA per (q tile, b*h row).
template <int D>
__global__ void __launch_bounds__(TMA_THREADS, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int S, int H, int Hkv, int causal, float scale_log2) {
  fwd_bf16_cta<D>(q_map, k_map, v_map, o, lse, S, H, Hkv, causal, scale_log2,
                  blockIdx.y, 1);
}

// K3: one CTA per (q tile, block of G consecutive b*h rows), MHA.
template <int D>
__global__ void __launch_bounds__(TMA_THREADS, 1)
flash_fwd_bh_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int S, int H, int causal,
                         float scale_log2, int G) {
  fwd_bf16_cta<D>(q_map, k_map, v_map, o, lse, S, H, H, causal, scale_log2,
                  blockIdx.y * G, G);
}

template <int D>
int launch_bf16_tma(const void* q, const void* k, const void* v, void* o,
                    void* lse, int B, int S, int H, int Hkv, int causal,
                    float scale, int G, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!bshd_map(&q_map, q, B, S, H, D, TMA_Q) ||
      !bshd_map(&k_map, k, B, S, Hkv, D, TMA_K) ||
      !bshd_map(&v_map, v, B, S, Hkv, D, TMA_K))
    return (int)cudaErrorInvalidValue;
  const int smem = TmaTile<D>::SMEM;
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  const int tiles = (S + TMA_Q - 1) / TMA_Q;
  const float scale_log2 = scale * LOG2E;
  cudaError_t status;
  if (G == 0) {
    status = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
    if (status != cudaSuccess) return (int)status;
    flash_fwd_bf16_kernel<D><<<dim3(tiles, B * H), TMA_THREADS, smem,
                               stream>>>(q_map, k_map, v_map, op, lp, S, H,
                                         Hkv, causal, scale_log2);
  } else {
    status = cudaFuncSetAttribute(flash_fwd_bh_bf16_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
    if (status != cudaSuccess) return (int)status;
    flash_fwd_bh_bf16_kernel<D><<<dim3(tiles, B * H / G), TMA_THREADS, smem,
                                  stream>>>(q_map, k_map, v_map, op, lp, S, H,
                                            causal, scale_log2, G);
  }
  return (int)cudaGetLastError();
}

// G == 0 launches the per-head kernel (K1/K2) over B*H rows; G >= 1 the
// head-blocked kernel (K3, MHA: Hkv == H) over B*H / G blocks.
template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int S, int H, int Hkv, int causal,
                float scale, int G, cudaStream_t stream) {
  if constexpr (D >= 64)
    return launch_bf16_tma<D>(q, k, v, o, lse, B, S, H, Hkv, causal, scale, G,
                              stream);
  else
    return launch_bf16_mma<D>(q, k, v, o, lse, B, S, H, Hkv, causal, scale, G,
                              stream);
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
