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
// dq comes out in q's layout and type, dk/dv in k's. D is any multiple of
// 16 from 16 to 256: each body is built for a padded width of 16, 32, 64,
// 128 or 256 (widths.cuh's ``padded_width``), its tensor maps declare the
// real D (TMA fills the columns past it with zeros: they add nothing to
// the scores and give zero gradient columns) and the stores skip the
// padding. Grid rows past 65535 b*h (b*hkv) rows launch again.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): the function
// needs 5 products of 2*S^2*D per head (Q K^T, dO V^T, dS K, dS^T Q,
// P^T dO), halved by causality: 5*S^2*H*D FLOPs against about
// 4*S*(H+Hkv)*D*itemsize bytes. At S=4096, H=32, Hkv=8, D=128 that is
// 344 GFLOP against 168 MB, so operations bound it: ~0.35 ms at the bf16
// tensor-core rate, ~2.1 ms for f32 at 165 TFLOP/s — an f32-accurate product
// on the tensor cores takes three TF32 products (495 / 3 TFLOP/s), less
// time than the 67 TFLOP/s of exact f32 on the CUDA cores. The two passes
// below do 7 products, not 5: each computes Q K^T and dO V^T itself; the
// f32 kernels take dO V^T at the f64 tensor-core rate (67 TFLOP/s).
//
// Two passes, as the TPU kernels split it: the dQ kernel sums over keys,
// the dK/dV kernel over q rows and the GQA group, each CTA owning its
// output rows. No atomics, every sum in a fixed order: two launches on one
// input give the same bits. (A fused single pass does the 5 products but
// sums dQ across CTAs with atomics.)
//
// bf16, padded d_head 64, 128 and 256 (every main path) — the Hopper
// design, the forward's machinery (hopper.cuh): a CTA of three warpgroups. Warpgroup 2
// is the producer: one thread loads the CTA's 128 resident rows once and
// streams the other operands, tile by tile, into a ring of 4 shared-memory
// stages by TMA (cp.async.bulk.tensor; the port's layouts as they are, boxes
// of 64 columns with the 128-byte swizzle wgmma reads, zeros past S), with
// full and empty mbarriers per stage. Warpgroups 0 and 1 consume, 64
// resident rows each; setmaxnreg moves registers from the producer to them.
// A streamed tile is 128 rows at d 64, 64 at d 128 and 32 at d 256, so that
// a consumer's accumulators stay in registers (no spills). At d 256 the
// dK and dV accumulators (64 x 256 f32 each, per warpgroup) would take 256
// registers a thread: the dK/dV kernel's CTAs each own 128 of the columns
// (grid z), computing the scores over all 256 (4 of their 6 products
// recompute what the other half's CTA computes).
// * dQ kernel (flash_dq_bf16_kernel): one CTA per (b*h, 128-row q tile),
//   reversed tile order so the longest causal CTAs start first. Q and dO
//   load once; K and V stream up to the diagonal of the CTA's last row.
//   S = Q K^T and dP = dO V^T are wgmma with both operands in shared
//   memory; P and dS are formed in f32 registers (the rows' LSE and delta
//   loaded once, by plain loads: a ragged S gives their rows no 16-byte
//   stride for a tensor map); dS, rounded to bf16, is the register A
//   operand of dQ += dS K, whose B operand is the K stage read MN-major —
//   the tile the first product read K-major. A consumer computes P while
//   dP runs; V's stage is released once dP is in, K's once dS K is done.
// * dK/dV kernel (flash_dkv_bf16_kernel): one CTA per (b*hkv, 128-key
//   tile). K and V load once; Q and dO stream, q tile by q tile from the
//   key tile's diagonal (causal), for each of the `group` query heads in
//   turn, the ring running across the head boundary. The producer warp
//   also writes each tile's LSE (in log2 units) and delta into the stage.
//   The scores are computed transposed, S^T = K Q^T and dP^T = V dO^T, so
//   the accumulator rows are keys: P^T and dS^T, rounded to bf16, are the
//   register A operands of dV += P^T dO and dK += dS^T Q, with dO and Q the
//   MN-major B operands straight from their stages. LSE and delta are per
//   column. dK and dV sum over the group in registers. A consumer computes
//   P^T while dP^T runs, then issues dV and dK together.
// * Inside a consumer, each tile's products finish before the next tile's
//   start; the two consumer warpgroups keep the tensor cores fed. Measured
//   on the H100: overlapping tile t's dQ product with tile t + 1's S and dP
//   gained at most 2% (and ptxas serializes every wgmma when such a
//   product is issued in a conditional path); issuing dV before dS^T is
//   formed was slower (serialized: the registers of both do not fit).
// * P = 2^(s * scale * log2(e) - lse * log2(e)) (ex2.approx); a masked score
//   gives P = 0 exactly, and so does a q row past S (its LSE is +inf).
//   Keys past S (dQ) are masked; rows of the resident tile past S are never
//   stored and feed no other row.
// d_head 16 and 32 (the tiny preset, and the card tests' grid) keep the
// mma.sync body: wgmma's 128-byte swizzle spans 64 bf16 columns.
// * dQ kernel: one CTA per (batch*head, 64-row q tile). Q, dO and the rows'
//   lse/delta load once; the CTA loops over 64-row K/V tiles up to the
//   causal diagonal, recomputes P from lse, and accumulates dQ in f32
//   registers.
// * dK/dV kernel: one CTA per (batch*kv_head, 64-row kv tile). K and V load
//   once; the CTA loops over the `group` query heads that share this KV
//   head and, for each, over the q tiles from the diagonal down, reading
//   that query head's own lse/delta rows. dK and dV accumulate in f32
//   registers; nothing is shared between CTAs.
// * Every product on the tensor cores (mma.sync m16n8k16, bf16 operands,
//   f32 accumulation), 4 warps copying tiles through registers. Score
//   fragments that a product consumes as its A operand are repacked from
//   the accumulator registers; B operands that need the transpose come
//   through ldmatrix.trans.
// Both bf16 bodies round P to bf16 before P^T dO and dS before dS K and
// dS^T Q — the JAX kernels' .astype(do.dtype) / .astype(q.dtype) /
// .astype(k.dtype).
// f32, every d_head: the same two passes on the tensor cores with mma.sync.
// Q K^T and the three gradient products are m16n8k8 in TF32, each to f32
// accuracy in three passes of a split x = hi + lo (hi the TF32 rounding of
// x: a_hi b_hi + a_hi b_lo + a_lo b_hi). dO V^T is m16n8k4 in f64 (the f32
// operands widened exactly, the sum in f64) and dP - delta is rounded to
// f32 once: where dP is close to delta (a causal row that sees two keys, a
// saturated softmax) dS keeps only the low bits of dP, and a dP with f32
// error relative to its terms — any f32 or TF32 sum — misses the plain f32
// version's own accuracy on those rows. tf32 wgmma would take both
// shared-memory operands K-major only, and three of each kernel's four
// products read one MN-major. The CTA is the TMA body's three warpgroups;
// the streamed stages are split once into hi/lo planes, and P and dS stay
// in registers (see the f32 section below).
// The scale always multiplies the f32 scores. _fold_scale_into_q folds a
// power-of-two scale into q instead; scaling by a power of two commutes
// with every rounding of the sum (and with the log2(e) factor), so both give
// the same bits.
// Masks: key j is visible to query i iff j <= i (causal, seq_q == seq_k)
// and both are < S. A masked score gives P = 0 exactly, never
// exp(NEG_INF - lse) computed. Rows past S are loaded as zeros, never
// written, and contribute nothing: a ragged S (4095) needs no fallback.
#include "tf32.cuh"

namespace {

constexpr int BLOCK_Q = 64;      // dQ: q rows per CTA
constexpr int BLOCK_K = 64;      // dQ: keys per tile; dK/dV: keys per CTA
constexpr int BLOCK_QB = 32;     // mma.sync dK/dV: q rows per inner tile
constexpr int MMA_THREADS = 128; // mma.sync kernels: 4 warps x 16 rows

using bf16 = __nv_bfloat16;

// -- bf16, d_head 16 and 32: mma.sync m16n8k16, f32 acc ---------------------
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
flash_dq_mma_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int S, int H, int Hkv,
                         int causal, float scale, int row_base) {
  static_assert(D == 16 || D == 32, "d_head 64 and 128 run the TMA body");
  constexpr int LD = D + 8;           // 16-byte rows, conflict-free fragments
  constexpr int KSTEPS = D / 16;      // k-steps over d
  constexpr int NT_S = BLOCK_K / 8;   // score n-tiles (8 keys each)
  constexpr int NT_O = D / 8;         // dQ n-tiles (8 columns each)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + BLOCK_Q * LD;
  bf16* k_s = do_s + BLOCK_Q * LD;
  bf16* v_s = k_s + BLOCK_K * LD;

  const int bh = row_base + blockIdx.y;
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
flash_dkv_mma_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int S, int H, int Hkv, int causal, float scale,
                          int row_base) {
  static_assert(D == 16 || D == 32, "d_head 64 and 128 run the TMA body");
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

  const int bkv = row_base + blockIdx.y;
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

// -- bf16, d_head 64 and 128: TMA, an mbarrier ring and wgmma ---------------
//
// Shared memory (1024-byte aligned for the 128-byte swizzle): the two
// resident tiles (128 rows each), then STAGES tiles of each streamed
// operand, each stored as D/64 blocks of (rows x 64 columns), 128 bytes a
// row, as TMA writes them; the dK/dV kernel adds each stage's LSE and delta
// (STREAM floats each); then the mbarriers. An empty barrier counts one
// arrival per consumer warp: a warp arrives once the products that read the
// stage, and its own reads of it, are done.
constexpr int RESIDENT = 128;                // resident rows, 64 a consumer
constexpr int BWD_THREADS = 3 * WG_THREADS;  // consumers 0, 1; producer 2
constexpr int CONSUMER_WARPS = 8;
constexpr int BWD_PRODUCER_REGS = 40;
constexpr int BWD_CONSUMER_REGS = 232;       // 2 * 232 + 40 = 3 * 168

template <int D>
struct BwdTile {
  static_assert(D == 64 || D == 128 || D == 256,
                "the TMA body serves padded d_head 64, 128 and 256");
  static constexpr int BLOCKS = D / 64;      // 64-column swizzle blocks
  static constexpr int STREAM = D == 256 ? 32 : D == 128 ? 64 : 128;
  static constexpr int STAGES = D == 256 ? 3 : 4;
  // dK/dV columns a CTA owns (its accumulators: OUT / 2 registers each)
  static constexpr int OUT = D == 256 ? 128 : D;
  static constexpr uint32_t RES_BYTES = RESIDENT * D * 2;
  static constexpr uint32_t STREAM_BYTES = STREAM * D * 2;
  static constexpr uint32_t TILES = 2 * RES_BYTES + 2 * STAGES * STREAM_BYTES;
  static constexpr uint32_t STATS = 2 * STAGES * STREAM * 4;
  // 1024 bytes of slack to align the base. dQ: q_full, then k_full,
  // v_full, k_empty, v_empty per stage; dK/dV: kv_full, then full and
  // empty per stage
  static constexpr int DQ_SMEM = 1024 + TILES + 8 * (1 + 4 * STAGES);
  static constexpr int DKV_SMEM = 1024 + TILES + STATS + 8 * (1 + 2 * STAGES);
  static_assert(DQ_SMEM <= 232448 && DKV_SMEM <= 232448, "shared memory");
};

template <int STAGES>
__device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == STAGES) {
    stage = 0;
    phase ^= 1;
  }
}

// P of a key tile from k0 in place of the scores ``s`` (rows are q rows):
// 2^(s * scale_log2 - lse) with ``lse`` in log2 units, masked scores
// exactly 0. ``edge``: the tile holds keys past S or above the diagonal of
// a row.
template <int N2>
__device__ __forceinline__ void dq_probabilities(
    float (&s)[N2], int k0, const int (&qpos)[2], int S, int causal,
    bool edge, int t4, float scale_log2, const float (&lse)[2]) {
#pragma unroll
  for (int j = 0; j < N2 / 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * r + e];
        const float p = exp2_approx(fmaf(x, scale_log2, -lse[r]));
        const int kpos = k0 + 8 * j + 2 * t4 + e;
        x = !edge || (kpos < S && (!causal || kpos <= qpos[r])) ? p : 0.f;
      }
}

// dS = P (dP - delta) in place of dP (rows are q rows).
template <int N2>
__device__ __forceinline__ void dq_ds(float (&dp)[N2], const float (&p)[N2],
                                      const float (&delta)[2]) {
#pragma unroll
  for (int j = 0; j < N2 / 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e;
        dp[i] = p[i] * (dp[i] - delta[r]);
      }
}

// P^T of a q tile from q0 in place of the scores ``st`` (rows are keys,
// columns q rows), each column with its own LSE (log2 units, +inf past S)
// from shared memory. ``edge``: a key of the rows lies above the diagonal
// of a column.
template <int N2>
__device__ __forceinline__ void dkv_probabilities(
    float (&st)[N2], int q0, const int (&kpos)[2], bool edge, int t4,
    float scale_log2, const float* lse) {
#pragma unroll
  for (int j = 0; j < N2 / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * t4 + e;
      const float l = lse[col];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& x = st[4 * j + 2 * r + e];
        const float p = exp2_approx(fmaf(x, scale_log2, -l));
        x = !edge || kpos[r] <= q0 + col ? p : 0.f;
      }
    }
}

// dS^T = P^T (dP^T - delta) in place of dP^T, delta per column.
template <int N2>
__device__ __forceinline__ void dkv_ds(float (&dpt)[N2], const float (&pt)[N2],
                                       int t4, const float* delta) {
#pragma unroll
  for (int j = 0; j < N2 / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float d = delta[8 * j + 2 * t4 + e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r + e;
        dpt[i] = pt[i] * (dpt[i] - d);
      }
    }
}

// dQ: one CTA per (128-row q tile, b*h row). ``scale_log2`` is the score
// scale times log2(e).
template <int D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_dq_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     int S, int H, int Hkv, int d, int causal, float scale,
                     float scale_log2, int row_base) {
  using T = BwdTile<D>;
  constexpr int SB = T::STREAM;                  // keys a stage
  constexpr int STAGES = T::STAGES;
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  const uint32_t base = (smem_u32(bwd_smem) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t do_s = q_s + T::RES_BYTES;
  const uint32_t k_s = do_s + T::RES_BYTES;
  const uint32_t v_s = k_s + STAGES * T::STREAM_BYTES;
  const uint32_t q_full = base + T::TILES;
  const uint32_t k_full = q_full + 8;            // + 8 * stage
  const uint32_t v_full = k_full + 8 * STAGES;
  const uint32_t k_empty = v_full + 8 * STAGES;
  const uint32_t v_empty = k_empty + 8 * STAGES;

  const int bh = row_base + blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hkv);
  // heaviest causal q tiles first
  const int q0 =
      (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * RESIDENT;
  const int kv_tiles =
      ((causal ? min(q0 + RESIDENT, S) : S) + SB - 1) / SB;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, CONSUMER_WARPS);
      mbar_init(v_empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  const int lane = threadIdx.x % 32;
  if (wg == 2) {
    // -- producer: one thread keeps the ring full -------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(BWD_PRODUCER_REGS));
    if (threadIdx.x == 2 * WG_THREADS) {
      mbar_expect_tx(q_full, 2 * T::RES_BYTES);
      for (int blk = 0; blk < T::BLOCKS; ++blk) {
        tma_load(q_s + blk * RESIDENT * 128, q_map, q_full, blk * 64, h, q0,
                 b);
        tma_load(do_s + blk * RESIDENT * 128, do_map, q_full, blk * 64, h,
                 q0, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < kv_tiles; ++t) {
        const uint32_t kf = k_full + 8 * stage;
        const uint32_t vf = v_full + 8 * stage;
        const uint32_t kd = k_s + stage * T::STREAM_BYTES;
        const uint32_t vd = v_s + stage * T::STREAM_BYTES;
        mbar_wait(k_empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(kf, T::STREAM_BYTES);
        for (int blk = 0; blk < T::BLOCKS; ++blk)
          tma_load(kd + blk * SB * 128, k_map, kf, blk * 64, kvh, t * SB, b);
        mbar_wait(v_empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(vf, T::STREAM_BYTES);
        for (int blk = 0; blk < T::BLOCKS; ++blk)
          tma_load(vd + blk * SB * 128, v_map, vf, blk * 64, kvh, t * SB, b);
        advance<STAGES>(stage, phase);
      }
    }
  } else {
    // -- consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63 ------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(BWD_CONSUMER_REGS));
    const int warp = (threadIdx.x % WG_THREADS) / 32;
    const int t4 = lane % 4;
    const int row0 = q0 + wg * 64;
    const int qpos[2] = {row0 + warp * 16 + lane / 4,
                         row0 + warp * 16 + lane / 4 + 8};
    float row_lse[2], row_delta[2];            // LSE in log2 units
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = qpos[r] < S;
      row_lse[r] = ok ? lse[(long)bh * S + qpos[r]] * LOG2E : CUDART_INF_F;
      row_delta[r] = ok ? delta[(long)bh * S + qpos[r]] : 0.f;
    }
    // key tiles this warpgroup reads: causal rows stop at their diagonal
    const int my_tiles =
        row0 >= S ? 0
                  : (causal ? (min(row0 + 64, S) - 1) / SB + 1 : kv_tiles);
    const uint64_t q_desc = sw128_desc(q_s + wg * 64 * 128, 16, 1024);
    const uint64_t do_desc = sw128_desc(do_s + wg * 64 * 128, 16, 1024);
    float acc[D / 2];
#pragma unroll
    for (int n = 0; n < D / 2; ++n) acc[n] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(q_full, 0);
    for (int t = 0; t < my_tiles; ++t) {
      const int k0 = t * SB;
      const bool edge = k0 + SB > S || (causal && k0 + SB - 1 > row0);
      float s[SB / 2], dp[SB / 2];
      mbar_wait(k_full + 8 * stage, phase);
      issue_ss<D, RESIDENT, SB>(s, q_desc, k_s + stage * T::STREAM_BYTES);
      mbar_wait(v_full + 8 * stage, phase);
      issue_ss<D, RESIDENT, SB>(dp, do_desc, v_s + stage * T::STREAM_BYTES);
      wgmma_wait<1>();
      fence_registers(s);
      dq_probabilities(s, k0, qpos, S, causal, edge, t4, scale_log2, row_lse);
      wgmma_wait<0>();
      fence_registers(dp);
      if (lane == 0) mbar_arrive(v_empty + 8 * stage);
      dq_ds(dp, s, row_delta);
      uint32_t ds[SB / 16][4];
      pack_a(ds, dp);
      issue_rs<SB>(acc, ds, k_s + stage * T::STREAM_BYTES);
      wgmma_wait<0>();
      fence_registers(acc);
      if (lane == 0) mbar_arrive(k_empty + 8 * stage);
      advance<STAGES>(stage, phase);
    }
    // tiles above every row of this warpgroup: released once landed
    for (int t = my_tiles; t < kv_tiles; ++t) {
      mbar_wait(k_full + 8 * stage, phase);
      mbar_wait(v_full + 8 * stage, phase);
      if (lane == 0) {
        mbar_arrive(k_empty + 8 * stage);
        mbar_arrive(v_empty + 8 * stage);
      }
      advance<STAGES>(stage, phase);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qpos[r] >= S) continue;
      bf16* out = dq + (((long)b * S + qpos[r]) * H + h) * d + 2 * t4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        if (n < D / 16 || 8 * n < d)           // the padding is not stored
          *reinterpret_cast<__nv_bfloat162*>(out + n * 8) =
              __floats2bfloat162_rn(scale * acc[4 * n + 2 * r],
                                    scale * acc[4 * n + 2 * r + 1]);
    }
  }
}

// dK/dV: one CTA per (128-key tile, b*hkv row, OUT-column part).
template <int D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_dkv_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap do_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int S, int H, int Hkv, int d,
                      int causal, float scale, float scale_log2,
                      int row_base) {
  using T = BwdTile<D>;
  constexpr int SB = T::STREAM;                  // q rows a stage
  constexpr int OUT = T::OUT;
  constexpr int STAGES = T::STAGES;
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  const uint32_t offset = ((smem_u32(bwd_smem) + 1023u) & ~1023u) -
                          smem_u32(bwd_smem);
  const uint32_t base = smem_u32(bwd_smem) + offset;
  const uint32_t k_s = base;
  const uint32_t v_s = k_s + T::RES_BYTES;
  const uint32_t q_s = v_s + T::RES_BYTES;
  const uint32_t do_s = q_s + STAGES * T::STREAM_BYTES;
  float* lse_s = reinterpret_cast<float*>(bwd_smem + offset + T::TILES);
  float* delta_s = lse_s + STAGES * SB;          // [STAGES][SB] each
  const uint32_t kv_full = base + T::TILES + T::STATS;
  const uint32_t full = kv_full + 8;             // + 8 * stage
  const uint32_t empty = full + 8 * STAGES;

  const int bkv = row_base + blockIdx.y;
  const int b = bkv / Hkv;
  const int kvh = bkv % Hkv;
  const int group = H / Hkv;
  const int k0 = blockIdx.x * RESIDENT;          // heaviest causal first
  const int first = causal ? k0 / SB : 0;
  const int tiles = (S + SB - 1) / SB;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      // the TMA thread's expect_tx, then every producer lane once its
      // LSE/delta stores are in
      mbar_init(full + 8 * s, 1 + 32);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  const int lane = threadIdx.x % 32;
  if (wg == 2) {
    // -- producer: warp 0; lane 0 issues the TMA loads --------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(BWD_PRODUCER_REGS));
    if (threadIdx.x < 2 * WG_THREADS + 32) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * T::RES_BYTES);
        for (int blk = 0; blk < T::BLOCKS; ++blk) {
          tma_load(k_s + blk * RESIDENT * 128, k_map, kv_full, blk * 64, kvh,
                   k0, b);
          tma_load(v_s + blk * RESIDENT * 128, v_map, kv_full, blk * 64, kvh,
                   k0, b);
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int gi = 0; gi < group; ++gi) {
        const int h = kvh * group + gi;
        const long row = ((long)b * H + h) * S;
        for (int t = first; t < tiles; ++t) {
          const int q0 = t * SB;
          const uint32_t f = full + 8 * stage;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          if (lane == 0) {
            mbar_expect_tx(f, 2 * T::STREAM_BYTES);
            const uint32_t qd = q_s + stage * T::STREAM_BYTES;
            const uint32_t dod = do_s + stage * T::STREAM_BYTES;
            for (int blk = 0; blk < T::BLOCKS; ++blk) {
              tma_load(qd + blk * SB * 128, q_map, f, blk * 64, h, q0, b);
              tma_load(dod + blk * SB * 128, do_map, f, blk * 64, h, q0, b);
            }
          }
          for (int i = lane; i < SB; i += 32) {
            const bool ok = q0 + i < S;
            lse_s[stage * SB + i] =
                ok ? lse[row + q0 + i] * LOG2E : CUDART_INF_F;
            delta_s[stage * SB + i] = ok ? delta[row + q0 + i] : 0.f;
          }
          mbar_arrive(f);
          advance<STAGES>(stage, phase);
        }
      }
    }
  } else {
    // -- consumers: warpgroup wg owns keys k0 + 64 wg .. + 63 --------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(BWD_CONSUMER_REGS));
    const int warp = (threadIdx.x % WG_THREADS) / 32;
    const int t4 = lane % 4;
    const int kw0 = k0 + wg * 64;
    const int kpos[2] = {kw0 + warp * 16 + lane / 4,
                         kw0 + warp * 16 + lane / 4 + 8};
    // the first q tile with a row that sees one of this warpgroup's keys
    const int mine = kw0 >= S ? tiles : (causal ? kw0 / SB : 0);
    const uint64_t k_desc = sw128_desc(k_s + wg * 64 * 128, 16, 1024);
    const uint64_t v_desc = sw128_desc(v_s + wg * 64 * 128, 16, 1024);
    // this CTA's dK/dV columns: the 64-column blocks from col0 of a stage
    const int col0 = OUT == D ? 0 : blockIdx.z * OUT;
    const uint32_t col_bytes = col0 / 64 * SB * 128;
    float dk_acc[OUT / 2], dv_acc[OUT / 2];
#pragma unroll
    for (int n = 0; n < OUT / 2; ++n) dk_acc[n] = dv_acc[n] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(kv_full, 0);
    for (int gi = 0; gi < group; ++gi) {
      for (int t = first; t < tiles; ++t) {
        mbar_wait(full + 8 * stage, phase);
        if (t >= mine) {
          const int q0 = t * SB;
          const uint32_t qt = q_s + stage * T::STREAM_BYTES;
          const uint32_t dot = do_s + stage * T::STREAM_BYTES;
          float st[SB / 2], dpt[SB / 2];
          issue_ss<D, RESIDENT, SB>(st, k_desc, qt);
          issue_ss<D, RESIDENT, SB>(dpt, v_desc, dot);
          wgmma_wait<1>();
          fence_registers(st);
          dkv_probabilities(st, q0, kpos, causal && q0 < kw0 + 64, t4,
                            scale_log2, lse_s + stage * SB);
          wgmma_wait<0>();
          fence_registers(dpt);
          dkv_ds(dpt, st, t4, delta_s + stage * SB);
          uint32_t pt[SB / 16][4], dst[SB / 16][4];
          pack_a(pt, st);
          pack_a(dst, dpt);
          issue_rs<SB>(dv_acc, pt, dot + col_bytes);
          issue_rs<SB>(dk_acc, dst, qt + col_bytes);
          wgmma_wait<0>();
          fence_registers(dv_acc);
          fence_registers(dk_acc);
        }
        if (lane == 0) mbar_arrive(empty + 8 * stage);
        advance<STAGES>(stage, phase);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kpos[r] >= S) continue;
      const long at =
          (((long)b * S + kpos[r]) * Hkv + kvh) * d + col0 + 2 * t4;
#pragma unroll
      for (int n = 0; n < OUT / 8; ++n) {
        if (col0 + 8 * n >= d) continue;       // the padding is not stored
        *reinterpret_cast<__nv_bfloat162*>(dk + at + n * 8) =
            __floats2bfloat162_rn(scale * dk_acc[4 * n + 2 * r],
                                  scale * dk_acc[4 * n + 2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + n * 8) =
            __floats2bfloat162_rn(dv_acc[4 * n + 2 * r],
                                  dv_acc[4 * n + 2 * r + 1]);
      }
    }
  }
}

// -- f32: three-pass TF32 products on the tensor cores -----------------------
//
// A CTA of three warpgroups, as in the bf16 kernels: warpgroups 0 and 1 are
// 8 consumer warps, 16 resident rows each; warpgroup 2 feeds them, and
// setmaxnreg moves registers from it to the consumers (232 each: the dK/dV
// accumulators alone are 128 at d_head 128). Its warp 0, lane 0, loads the
// resident tile once and streams the other two operands, STREAM rows a
// stage, into a ring of STAGES stages by TMA (f32 boxes of 32 columns,
// 128-byte rows under the 128-byte swizzle; d_head 16: 64-byte rows under
// the 64-byte swizzle), with full, split and empty mbarriers per stage. Its
// warps 1-3 split each landed stage once, in place: every f32 x becomes hi
// (x rounded to TF32) and its lo (x - hi, exact in f32; a TF32 operand
// reads its top 19 bits) goes to a plane beside it, so that hi + lo gives
// x back. The consumers take the streamed operands' fragments as they are,
// hi and lo, and split only their resident operand in registers: with
// every warp splitting every element it read, the products waited on the
// splits.
// Q K^T and the gradient products are mma.sync m16n8k8 in TF32 with f32
// accumulation, three passes per product (``mma_3xtf32``; the split, the
// tile offsets and the products are tf32.cuh's, shared with the f32
// forward); dO V^T is
// mma.sync m16n8k4 in f64 (``mma_f64``), its B operand hi + lo of the
// stage. Fragment layout (g = lane / 4, t = lane % 4): A holds rows g, g+8
// x columns t, t+4 (m16n8k4: column t); B holds k rows t, t+4 (t) of column
// g; C holds rows g, g+8 x columns 2t, 2t+1, in f32 or f64.
// * Operands read along their rows (Q, dO, K, V in the score products) come
//   through ldmatrix: an 8 x 4 f32 block is an 8 x 8 b16 matrix, and lane
//   l receives row l / 4, column l % 4 — the A and B fragments as they are.
//   The swizzle puts the 8 rows of a block in 8 different bank groups.
// * D is the padded width (the products run over its zero columns too: a
//   loop bound at the real d_head made the d 128 dK/dV kernel spill). At
//   d_head 256 two resident tiles of 128 rows would take 256 KiB, so the
//   CTA is one consumer warpgroup (64 resident rows) and the producer
//   warpgroup, 256 threads whose registers need no setmaxnreg, with one
//   stage of 16 streamed rows; and the dK/dV accumulators (16 x 256 f32
//   each, per warp) would take 256 registers a thread, so its CTAs each own
//   128 of the columns (grid z), as in the bf16 kernel.
// * The second products contract over the score columns. The accumulator
//   holds columns 2t, 2t+1 where the A fragment wants t, t+4, so the
//   contraction index is permuted instead of the registers: A column t is
//   key (q row) 8j + 2t and t+4 is 8j + 2t + 1, and the B fragment reads
//   rows 8j + 2t and 8j + 2t + 1 of the stage (plain shared loads, column
//   g): P and dS never leave the registers. Under the swizzle those rows
//   and 8 columns fall in 32 different banks for d_head >= 32 (2-way
//   conflicts at d_head 16).

template <int D>
struct F32Bwd {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128 || D == 256,
                "padded d_head 16, 32, 64, 128 or 256");
  static constexpr int WARPS = D == 256 ? 4 : CONSUMER_WARPS;  // consumers
  static constexpr int THREADS = 32 * WARPS + WG_THREADS;
  static constexpr int SPLITTERS = 3;             // warps 1-3 of the last wg
  static constexpr int ROWS = 16 * WARPS;         // resident rows a CTA
  static constexpr int STREAM = D >= 128 ? 16 : 32;  // streamed rows a stage
  static constexpr int STAGES = D == 256 ? 1 : D == 128 ? 3 : 4;
  static constexpr int OUT = D == 256 ? 128 : D;  // dK/dV columns a CTA
  static constexpr int BOX = D < 32 ? D : 32;        // columns a TMA box
  static constexpr uint32_t RES_BYTES = ROWS * D * 4;
  // a stage: the two streamed operands (hi after the split), then their lo
  static constexpr uint32_t TILE_BYTES = STREAM * D * 4;
  static constexpr uint32_t LO = 2 * TILE_BYTES;
  static constexpr uint32_t STAGE_BYTES = 4 * TILE_BYTES;
  static constexpr uint32_t TILES = 2 * RES_BYTES + STAGES * STAGE_BYTES;
  static constexpr uint32_t STATS = 2 * STAGES * STREAM * 4;
  // 1024 bytes of slack to align the base; the resident barrier, then full,
  // split and empty per stage
  static constexpr int BARRIERS = 8 * (1 + 3 * STAGES);
  static constexpr int DQ_SMEM = 1024 + TILES + BARRIERS;
  static constexpr int DKV_SMEM = 1024 + TILES + STATS + BARRIERS;
  static_assert(DKV_SMEM <= 232448, "shared memory");
};

// c += a b for a 16 x 8 x 4 product in f64: a0, a1 rows g, g+8 of column
// t; b row t of column g. Products of widened f32 values are exact in f64.
__device__ __forceinline__ void mma_f64(double (&c)[4], double a0, double a1,
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// The two score products of a warp over the D columns, their rows the 16
// resident rows from ``row0`` (tiles of ROWS rows), their columns the
// STREAM rows of a split stage tile (its lo ``LO`` bytes on):
//   s  = A1 B1^T in three TF32 passes, A1 split here; the passes of KG
//        k-steps sum from zero, then join s;
//   dp = A2 B2^T in f64, A2 widened as it is and B2 as hi + lo (= x).
// The k-step groups stay a loop: unrolled, ptxas hoisted their loads and
// spilled.
template <int D, int ROWS, int STREAM, uint32_t LO>
__device__ __forceinline__ void scores(
    float (&s)[STREAM / 8][4], double (&dp)[STREAM / 8][4], uint32_t a1_tile,
    uint32_t a2_tile, int row0, uint32_t b1_tile, uint32_t b2_tile,
    int lane) {
  constexpr int KG = SCORE_KSTEPS < D / 8 ? SCORE_KSTEPS : D / 8;
  const int m = lane >> 3;
#pragma unroll
  for (int j = 0; j < STREAM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f, dp[j][e] = 0.0;
  // ldmatrix.x4 rows: A's four 8 x 4 blocks a0..a3; B's b0, b1 of column
  // tiles 2p and 2p + 1
  const int a_row = row0 + ((m & 1) << 3) + (lane & 7);
  const int a_col = (m >> 1) << 2;
  const int b_row = ((m >> 1) << 3) + (lane & 7);
  const int b_col = (m & 1) << 2;
#pragma unroll 1
  for (int k0 = 0; k0 < D / 8; k0 += KG) {
    float part[STREAM / 16][2][4];
#pragma unroll
    for (int h = 0; h < KG; ++h) {
      const int kk = k0 + h;
      const uint32_t a_at = f32_offset<D, ROWS>(a_row, 8 * kk + a_col);
      uint32_t a1[4], a2[4];
      ldsm_x4(a1, a1_tile + a_at);
      ldsm_x4(a2, a2_tile + a_at);
      uint32_t a_hi[2][4], a_lo[2][4];
      split_tf32(a1, a_hi[0], a_lo[0]);
#pragma unroll
      for (int x = 0; x < 4; ++x)
        a_hi[1][x] = a_hi[0][x], a_lo[1][x] = a_lo[0][x];
      double w[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) w[x] = __uint_as_float(a2[x]);
#pragma unroll
      for (int p = 0; p < STREAM / 16; ++p) {
        const uint32_t at =
            f32_offset<D, STREAM>(16 * p + b_row, 8 * kk + b_col);
        uint32_t h1[4], l1[4], h2[4], l2[4];
        ldsm_x4(h1, b1_tile + at);
        ldsm_x4(l1, b1_tile + LO + at);
        ldsm_x4(h2, b2_tile + at);
        ldsm_x4(l2, b2_tile + LO + at);
        const uint32_t b_hi[2][2] = {{h1[0], h1[1]}, {h1[2], h1[3]}};
        const uint32_t b_lo[2][2] = {{l1[0], l1[1]}, {l1[2], l1[3]}};
        if (h == 0)
          mma_3xtf32<2>(part[p], a_hi, a_lo, b_hi, b_lo);
        else
          mma_3xtf32<2, true>(part[p], a_hi, a_lo, b_hi, b_lo);
        double x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[e] = __uint_as_float(h2[e]) + __uint_as_float(l2[e]);
        mma_f64(dp[2 * p], w[0], w[1], x[0]);          // k columns t
        mma_f64(dp[2 * p], w[2], w[3], x[1]);          // and t + 4
        mma_f64(dp[2 * p + 1], w[0], w[1], x[2]);
        mma_f64(dp[2 * p + 1], w[2], w[3], x[3]);
      }
    }
#pragma unroll
    for (int p = 0; p < STREAM / 16; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[2 * p][e] += part[p][0][e];
        s[2 * p + 1][e] += part[p][1][e];
      }
  }
}

// P = exp(s scale - lse) by the plain version's own arithmetic (a product
// and a difference each rounded to f32, then expf), not ex2.approx with a
// log2(e) factor: some rows of the gradients (a causal row that sees two
// keys) cancel to a small part of their terms, and there every difference
// in P shows.
__device__ __forceinline__ float probability(float s, float scale,
                                             float lse) {
  return expf(__fsub_rn(__fmul_rn(s, scale), lse));
}

// dQ: one CTA per (ROWS-row q tile, b*h row), the heaviest causal tiles
// first. Q and dO load once; K and V stream up to the diagonal of the
// CTA's last row.
template <int D>
__global__ void __launch_bounds__(F32Bwd<D>::THREADS, 1)
flash_dq_f32_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int S, int H, int Hkv, int d, int causal, float scale,
                    int row_base) {
  using T = F32Bwd<D>;
  constexpr int SB = T::STREAM;                  // keys a stage
  constexpr int STAGES = T::STAGES;
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  unsigned char* const smem =
      bwd_smem + (((smem_u32(bwd_smem) + 1023u) & ~1023u) -
                  smem_u32(bwd_smem));
  const uint32_t base = smem_u32(smem);
  const uint32_t q_s = base;
  const uint32_t do_s = q_s + T::RES_BYTES;
  const uint32_t ring = do_s + T::RES_BYTES;     // + stage * STAGE_BYTES
  const uint32_t q_full = base + T::TILES;
  const uint32_t full = q_full + 8;              // + 8 * stage
  const uint32_t split = full + 8 * STAGES;
  const uint32_t empty = split + 8 * STAGES;

  const int bh = row_base + blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hkv);
  const int q0 =
      (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * T::ROWS;
  const int tiles = ((causal ? min(q0 + T::ROWS, S) : S) + SB - 1) / SB;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(split + 8 * s, T::SPLITTERS);
      mbar_init(empty + 8 * s, T::WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= T::WARPS) {
    // -- the last warpgroup: TMA loads (warp 0, lane 0), splits (warps 1-3)
    if constexpr (T::WARPS == CONSUMER_WARPS)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                   :: "n"(BWD_PRODUCER_REGS));
    int stage = 0;
    uint32_t phase = 0;
    if (threadIdx.x == 32 * T::WARPS) {
      mbar_expect_tx(q_full, 2 * T::RES_BYTES);
      for (int c = 0; c < D; c += T::BOX) {
        const uint32_t at = c / T::BOX * T::ROWS * 128;
        tma_load(q_s + at, q_map, q_full, c, h, q0, b);
        tma_load(do_s + at, do_map, q_full, c, h, q0, b);
      }
      for (int t = 0; t < tiles; ++t) {
        const uint32_t f = full + 8 * stage;
        const uint32_t kt = ring + stage * T::STAGE_BYTES;
        mbar_wait(empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(f, 2 * T::TILE_BYTES);
        for (int c = 0; c < D; c += T::BOX) {
          const uint32_t at = c / T::BOX * SB * 128;
          tma_load(kt + at, k_map, f, c, kvh, t * SB, b);
          tma_load(kt + T::TILE_BYTES + at, v_map, f, c, kvh, t * SB, b);
        }
        advance<STAGES>(stage, phase);
      }
    } else if (warp > T::WARPS) {
      const int t0 = threadIdx.x - 32 * (T::WARPS + 1);
      for (int t = 0; t < tiles; ++t) {
        mbar_wait(full + 8 * stage, phase);
        split_stage<2 * SB * D>(reinterpret_cast<float*>(
            smem + 2 * T::RES_BYTES + stage * T::STAGE_BYTES), t0,
            32 * T::SPLITTERS);
        __syncwarp();
        if (lane == 0) mbar_arrive(split + 8 * stage);
        advance<STAGES>(stage, phase);
      }
    }
  } else {
    // -- consumers: warp w owns q rows q0 + 16 w .. + 15 --------------------
    if constexpr (T::WARPS == CONSUMER_WARPS)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                   :: "n"(BWD_CONSUMER_REGS));
    const int g = lane / 4;
    const int t4 = lane % 4;
    const int row0 = 16 * warp;
    const int first_row = q0 + row0;
    const int qpos[2] = {first_row + g, first_row + g + 8};
    float row_lse[2];
    double row_delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = qpos[r] < S;
      row_lse[r] = ok ? lse[(long)bh * S + qpos[r]] : CUDART_INF_F;
      row_delta[r] = ok ? delta[(long)bh * S + qpos[r]] : 0.f;
    }
    // key tiles this warp reads: causal rows stop at their diagonal
    const int my_tiles =
        first_row >= S
            ? 0
            : (causal ? (min(first_row + 16, S) - 1) / SB + 1 : tiles);
    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(q_full, 0);
    for (int t = 0; t < tiles; ++t) {
      mbar_wait(split + 8 * stage, phase);
      if (t < my_tiles) {
        const int k0 = t * SB;
        const uint32_t kt = ring + stage * T::STAGE_BYTES;
        float s[SB / 8][4], ds[SB / 8][4];
        double dp[SB / 8][4];
        scores<D, T::ROWS, SB, T::LO>(s, dp, q_s, do_s, row0, kt,
                                      kt + T::TILE_BYTES, lane);
        // P = exp(s scale - lse), masked scores exactly 0; dS = P (dP -
        // delta), the difference rounded to f32 once
        const bool edge = k0 + SB > S || (causal && k0 + SB - 1 > first_row);
#pragma unroll
        for (int j = 0; j < SB / 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 2 * r + e;
              const int kpos = k0 + 8 * j + 2 * t4 + e;
              float p = probability(s[j][i], scale, row_lse[r]);
              if (edge && !(kpos < S && (!causal || kpos <= qpos[r])))
                p = 0.f;
              ds[j][i] = p * __double2float_rn(dp[j][i] - row_delta[r]);
            }
        float (*const out[1])[4] = {acc};           // dQ += dS K
        const float (*const in[1])[4] = {ds};
        const uint32_t stages[1] = {kt};
        accumulate_3xtf32<D, SB, T::LO, 1>(out, in, stages, g, t4);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);
      advance<STAGES>(stage, phase);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qpos[r] >= S) continue;
      float* out = dq + (((long)b * S + qpos[r]) * H + h) * d + 2 * t4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        if (n < D / 16 || 8 * n < d)           // the padding is not stored
          *reinterpret_cast<float2*>(out + 8 * n) =
              make_float2(scale * acc[n][2 * r], scale * acc[n][2 * r + 1]);
    }
  }
}

// dK/dV: one CTA per (ROWS-key tile, b*hkv row, OUT-column part). K and V
// load once; Q and dO stream, q tile by q tile from the key tile's
// diagonal (causal), for each of the ``group`` query heads in turn, the
// ring running across the head boundary. The loading warp also writes each tile's LSE (+inf past S)
// and delta into the stage. The scores are computed transposed (rows are
// keys), so P^T and dS^T are the A operands of dV += P^T dO and dK +=
// dS^T Q.
template <int D>
__global__ void __launch_bounds__(F32Bwd<D>::THREADS, 1)
flash_dkv_f32_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int S, int H, int Hkv, int d,
                     int causal, float scale, int row_base) {
  using T = F32Bwd<D>;
  constexpr int SB = T::STREAM;                  // q rows a stage
  constexpr int OUT = T::OUT;
  constexpr int STAGES = T::STAGES;
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  unsigned char* const smem =
      bwd_smem + (((smem_u32(bwd_smem) + 1023u) & ~1023u) -
                  smem_u32(bwd_smem));
  const uint32_t base = smem_u32(smem);
  const uint32_t k_s = base;
  const uint32_t v_s = k_s + T::RES_BYTES;
  const uint32_t ring = v_s + T::RES_BYTES;      // + stage * STAGE_BYTES
  float* lse_s = reinterpret_cast<float*>(smem + T::TILES);
  float* delta_s = lse_s + STAGES * SB;          // [STAGES][SB] each
  const uint32_t kv_full = base + T::TILES + T::STATS;
  const uint32_t full = kv_full + 8;             // + 8 * stage
  const uint32_t split = full + 8 * STAGES;
  const uint32_t empty = split + 8 * STAGES;

  const int bkv = row_base + blockIdx.y;
  const int b = bkv / Hkv;
  const int kvh = bkv % Hkv;
  const int group = H / Hkv;
  const int k0 = blockIdx.x * T::ROWS;           // heaviest causal first
  const int first = causal ? k0 / SB : 0;
  const int tiles = (S + SB - 1) / SB;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      // lane 0's expect_tx, then every lane of the loading warp once its
      // LSE/delta stores are in
      mbar_init(full + 8 * s, 1 + 32);
      mbar_init(split + 8 * s, T::SPLITTERS);
      mbar_init(empty + 8 * s, T::WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= T::WARPS) {
    // -- the last warpgroup: TMA loads and LSE/delta (warp 0), splits ------
    if constexpr (T::WARPS == CONSUMER_WARPS)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                   :: "n"(BWD_PRODUCER_REGS));
    int stage = 0;
    uint32_t phase = 0;
    if (warp == T::WARPS) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * T::RES_BYTES);
        for (int c = 0; c < D; c += T::BOX) {
          const uint32_t at = c / T::BOX * T::ROWS * 128;
          tma_load(k_s + at, k_map, kv_full, c, kvh, k0, b);
          tma_load(v_s + at, v_map, kv_full, c, kvh, k0, b);
        }
      }
      for (int gi = 0; gi < group; ++gi) {
        const int h = kvh * group + gi;
        const long row = ((long)b * H + h) * S;
        for (int t = first; t < tiles; ++t) {
          const int q0 = t * SB;
          const uint32_t f = full + 8 * stage;
          const uint32_t qt = ring + stage * T::STAGE_BYTES;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          if (lane == 0) {
            mbar_expect_tx(f, 2 * T::TILE_BYTES);
            for (int c = 0; c < D; c += T::BOX) {
              const uint32_t at = c / T::BOX * SB * 128;
              tma_load(qt + at, q_map, f, c, h, q0, b);
              tma_load(qt + T::TILE_BYTES + at, do_map, f, c, h, q0, b);
            }
          }
          for (int i = lane; i < SB; i += 32) {
            const bool ok = q0 + i < S;
            lse_s[stage * SB + i] = ok ? lse[row + q0 + i] : CUDART_INF_F;
            delta_s[stage * SB + i] = ok ? delta[row + q0 + i] : 0.f;
          }
          mbar_arrive(f);
          advance<STAGES>(stage, phase);
        }
      }
    } else {
      const int t0 = threadIdx.x - 32 * (T::WARPS + 1);
      for (int n = 0; n < group * (tiles - first); ++n) {
        mbar_wait(full + 8 * stage, phase);
        split_stage<2 * SB * D>(reinterpret_cast<float*>(
            smem + 2 * T::RES_BYTES + stage * T::STAGE_BYTES), t0,
            32 * T::SPLITTERS);
        __syncwarp();
        if (lane == 0) mbar_arrive(split + 8 * stage);
        advance<STAGES>(stage, phase);
      }
    }
  } else {
    // -- consumers: warp w owns keys k0 + 16 w .. + 15 ----------------------
    if constexpr (T::WARPS == CONSUMER_WARPS)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                   :: "n"(BWD_CONSUMER_REGS));
    const int g = lane / 4;
    const int t4 = lane % 4;
    const int row0 = 16 * warp;
    const int first_key = k0 + row0;
    const int kpos[2] = {first_key + g, first_key + g + 8};
    // the first q tile with a row that sees one of this warp's keys
    const int mine = first_key >= S ? tiles : (causal ? first_key / SB : 0);
    // this CTA's dK/dV columns: the 32-column blocks from col0 of a stage
    const int col0 = OUT == D ? 0 : blockIdx.z * OUT;
    const uint32_t col_bytes = col0 / 32 * SB * 128;
    float dk_acc[OUT / 8][4], dv_acc[OUT / 8][4];
#pragma unroll
    for (int n = 0; n < OUT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(kv_full, 0);
    for (int gi = 0; gi < group; ++gi) {
      for (int t = first; t < tiles; ++t) {
        mbar_wait(split + 8 * stage, phase);
        if (t >= mine) {
          const int q0 = t * SB;
          const uint32_t qt = ring + stage * T::STAGE_BYTES;
          const uint32_t dot = qt + T::TILE_BYTES;
          const float* tile_lse = lse_s + stage * SB;
          const float* tile_delta = delta_s + stage * SB;
          float st[SB / 8][4], dst[SB / 8][4];
          double dpt[SB / 8][4];
          scores<D, T::ROWS, SB, T::LO>(st, dpt, k_s, v_s, row0, qt, dot,
                                        lane);
          // P^T into st, dS^T into dst; a key above a q row's diagonal gives
          // P = 0 exactly, and so does a q row past S (its LSE is +inf)
          const bool edge = causal && q0 < first_key + 15;
#pragma unroll
          for (int j = 0; j < SB / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * j + 2 * t4 + e;
              const float l = tile_lse[col];
              const double d = tile_delta[col];
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int i = 2 * r + e;
                float p = probability(st[j][i], scale, l);
                if (edge && kpos[r] > q0 + col) p = 0.f;
                st[j][i] = p;
                dst[j][i] = p * __double2float_rn(dpt[j][i] - d);
              }
            }
          // dV += P^T dO and dK += dS^T Q over this CTA's columns (a
          // stage's column blocks from col_bytes on are an OUT-column tile)
          float (*const out[2])[4] = {dv_acc, dk_acc};
          const float (*const in[2])[4] = {st, dst};
          const uint32_t stages[2] = {dot + col_bytes, qt + col_bytes};
          accumulate_3xtf32<OUT, SB, T::LO, 2>(out, in, stages, g, t4);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * stage);
        advance<STAGES>(stage, phase);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kpos[r] >= S) continue;
      const long at =
          (((long)b * S + kpos[r]) * Hkv + kvh) * d + col0 + 2 * t4;
#pragma unroll
      for (int n = 0; n < OUT / 8; ++n) {
        if (col0 + 8 * n >= d) continue;       // the padding is not stored
        *reinterpret_cast<float2*>(dk + at + 8 * n) = make_float2(
            scale * dk_acc[n][2 * r], scale * dk_acc[n][2 * r + 1]);
        *reinterpret_cast<float2*>(dv + at + 8 * n) =
            make_float2(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
      }
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
  int B, S, H, Hkv, d, causal;
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
  using T = F32Bwd<D>;
  // dQ: q and dO resident, k and v streamed; dK/dV the other way round
  CUtensorMap q_res, do_res, k_str, v_str, q_str, do_str, k_res, v_res;
  if (!bshd_map_f32(&q_res, a.q, a.B, a.S, a.H, a.d, T::ROWS) ||
      !bshd_map_f32(&do_res, a.dout, a.B, a.S, a.H, a.d, T::ROWS) ||
      !bshd_map_f32(&k_str, a.k, a.B, a.S, a.Hkv, a.d, T::STREAM) ||
      !bshd_map_f32(&v_str, a.v, a.B, a.S, a.Hkv, a.d, T::STREAM) ||
      !bshd_map_f32(&q_str, a.q, a.B, a.S, a.H, a.d, T::STREAM) ||
      !bshd_map_f32(&do_str, a.dout, a.B, a.S, a.H, a.d, T::STREAM) ||
      !bshd_map_f32(&k_res, a.k, a.B, a.S, a.Hkv, a.d, T::ROWS) ||
      !bshd_map_f32(&v_res, a.v, a.B, a.S, a.Hkv, a.d, T::ROWS))
    return (int)cudaErrorInvalidValue;
  cudaError_t status = allow_smem(flash_dq_f32_kernel<D>, T::DQ_SMEM);
  if (status == cudaSuccess)
    status = allow_smem(flash_dkv_f32_kernel<D>, T::DKV_SMEM);
  if (status != cudaSuccess) return (int)status;
  const int tiles = (a.S + T::ROWS - 1) / T::ROWS;
  const int error = over_rows(a.B * a.H, [&](int row0, int rows) {
    flash_dq_f32_kernel<D><<<dim3(tiles, rows), T::THREADS, T::DQ_SMEM,
                             a.stream>>>(
        q_res, do_res, k_str, v_str, a.lse, a.delta,
        static_cast<float*>(a.dq), a.S, a.H, a.Hkv, a.d, a.causal, a.scale,
        row0);
  });
  if (error != 0) return error;
  return over_rows(a.B * a.Hkv, [&](int row0, int rows) {
    flash_dkv_f32_kernel<D><<<dim3(tiles, rows, D / T::OUT), T::THREADS,
                              T::DKV_SMEM, a.stream>>>(
        q_str, do_str, k_res, v_res, a.lse, a.delta,
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.S, a.H,
        a.Hkv, a.d, a.causal, a.scale, row0);
  });
}

template <int D>
int launch_bf16_mma(const Args& a) {
  const size_t dq_smem = dq_bf16_smem<D>();
  const size_t dkv_smem = dkv_bf16_smem<D>();
  cudaError_t status = allow_smem(flash_dq_mma_bf16_kernel<D>, dq_smem);
  if (status == cudaSuccess)
    status = allow_smem(flash_dkv_mma_bf16_kernel<D>, dkv_smem);
  if (status != cudaSuccess) return (int)status;
  const int dq_tiles = (a.S + BLOCK_Q - 1) / BLOCK_Q;
  const int error = over_rows(a.B * a.H, [&](int row0, int rows) {
    flash_dq_mma_bf16_kernel<D><<<dim3(dq_tiles, rows), MMA_THREADS, dq_smem,
                                  a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        a.lse, a.delta, static_cast<bf16*>(a.dq), a.S, a.H, a.Hkv, a.causal,
        a.scale, row0);
  });
  if (error != 0) return error;
  const int dkv_tiles = (a.S + BLOCK_K - 1) / BLOCK_K;
  return over_rows(a.B * a.Hkv, [&](int row0, int rows) {
    flash_dkv_mma_bf16_kernel<D><<<dim3(dkv_tiles, rows), MMA_THREADS,
                                   dkv_smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
        a.S, a.H, a.Hkv, a.causal, a.scale, row0);
  });
}

template <int D>
int launch_bf16_tma(const Args& a) {
  using T = BwdTile<D>;
  constexpr int SB = T::STREAM;
  // dQ: q and dO resident, k and v streamed; dK/dV the other way round
  CUtensorMap q_res, do_res, k_str, v_str, q_str, do_str, k_res, v_res;
  if (!bshd_map(&q_res, a.q, a.B, a.S, a.H, a.d, RESIDENT) ||
      !bshd_map(&do_res, a.dout, a.B, a.S, a.H, a.d, RESIDENT) ||
      !bshd_map(&k_str, a.k, a.B, a.S, a.Hkv, a.d, SB) ||
      !bshd_map(&v_str, a.v, a.B, a.S, a.Hkv, a.d, SB) ||
      !bshd_map(&q_str, a.q, a.B, a.S, a.H, a.d, SB) ||
      !bshd_map(&do_str, a.dout, a.B, a.S, a.H, a.d, SB) ||
      !bshd_map(&k_res, a.k, a.B, a.S, a.Hkv, a.d, RESIDENT) ||
      !bshd_map(&v_res, a.v, a.B, a.S, a.Hkv, a.d, RESIDENT))
    return (int)cudaErrorInvalidValue;
  cudaError_t status = allow_smem(flash_dq_bf16_kernel<D>, T::DQ_SMEM);
  if (status == cudaSuccess)
    status = allow_smem(flash_dkv_bf16_kernel<D>, T::DKV_SMEM);
  if (status != cudaSuccess) return (int)status;
  const float scale_log2 = a.scale * LOG2E;
  const int tiles = (a.S + RESIDENT - 1) / RESIDENT;
  const int error = over_rows(a.B * a.H, [&](int row0, int rows) {
    flash_dq_bf16_kernel<D><<<dim3(tiles, rows), BWD_THREADS, T::DQ_SMEM,
                              a.stream>>>(
        q_res, do_res, k_str, v_str, a.lse, a.delta, static_cast<bf16*>(a.dq),
        a.S, a.H, a.Hkv, a.d, a.causal, a.scale, scale_log2, row0);
  });
  if (error != 0) return error;
  return over_rows(a.B * a.Hkv, [&](int row0, int rows) {
    flash_dkv_bf16_kernel<D><<<dim3(tiles, rows, D / T::OUT), BWD_THREADS,
                               T::DKV_SMEM, a.stream>>>(
        q_str, do_str, k_res, v_res, a.lse, a.delta, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.S, a.H, a.Hkv, a.d, a.causal, a.scale,
        scale_log2, row0);
  });
}

template <int D>
int launch_bf16(const Args& a) {
  if constexpr (D >= 64)
    return launch_bf16_tma<D>(a);
  else
    return launch_bf16_mma<D>(a);
}

template <int D>
int launch(int dtype, const Args& a) {
  if (dtype == 0) return launch_f32<D>(a);
  if (dtype == 1) return launch_bf16<D>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d_head D a multiple of 16 from 16 to
// 256, run by the body of its padded width. Launches the dQ kernel, then
// the dK/dV kernel, on `stream`. Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int thp_flash_bwd(int dtype, const void* q, const void* k,
                             const void* v, const void* dout, const void* lse,
                             const void* delta, void* dq, void* dk, void* dv,
                             int B, int S, int H, int Hkv, int D, int causal,
                             float scale, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, dk, dv, B, S, H, Hkv, D,
               causal, scale, static_cast<cudaStream_t>(stream)};
  switch (padded_width(D)) {
    case 16: return launch<16>(dtype, a);
    case 32: return launch<32>(dtype, a);
    case 64: return launch<64>(dtype, a);
    case 128: return launch<128>(dtype, a);
    case 256: return launch<256>(dtype, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
