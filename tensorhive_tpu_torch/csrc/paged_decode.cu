// Paged-attention decode for Hopper (sm_90a), plain C interface.
//
// Replaces: tensorhive_tpu/ops/paged_attention.py, _decode_kernel with
// quant=False (bf16/f32 pages, K8) and quant=True (int8 pages with one f32
// scale per (page, kv_head), K9), reached from paged_attention.
//
// Computes, for every slot s, one query token against that slot's KV pages
// read through its page-table row: out[s, h] = softmax_j(scale * q[s,h] .
// k[j]) v[j] over logical positions j <= positions[s], with q/out [S, H, D],
// pages [P, page_size, Hkv, D], page_table [S, max_pages] int32, positions
// [S] int32 and (int8 only) scales [P, Hkv] f32. GQA: query head h reads
// KV head h / (H / Hkv), with no expanded copy.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. A decode step reads every live
// K/V row of every slot once (plus the scale rows of int8 pages) and does
// 4 FLOPs per query head per element, ~1-16 FLOPs a byte: far below the
// ~295 FLOPs a byte where the tensor cores would be the limit. At the 7b
// serving shape (8 slots, H 32, Hkv 8, d 128, 10,978 live rows) that is
// 45.0 MB for bf16 pages (13.4 us), 22.5 MB for int8 (6.8 us), 90 MB for
// f32 (26.9 us).
//
// Design (flash-decoding). The first port ran one CTA per (slot, kv_head):
// 64 CTAs on 132 SMs at the serving shape, the long slot's CTAs walking
// 4096 rows alone, each row a 5-step shuffle chain per query head, so time
// followed latency and instructions, not bytes. Here:
// * Many CTAs per slot. A CTA takes one CHUNK of 256 tokens of one (slot,
//   kv_head) for all GROUP query heads of that kv head, which share every
//   K/V load. The grid is (chunks, Hkv, S) with chunks = ceil(max_pages *
//   page_size / CHUNK): it never depends on positions (they live on the
//   device and are read only here), so a call can be captured in a CUDA
//   graph and replayed after positions and page tables change. A CTA whose
//   chunk starts past its slot's position leaves at once; it fetches its
//   page-table entries beside the position, so a live CTA waits for one
//   round trip before its first page load.
// * Asynchronous page loads. 16-byte cp.async copies (a page row of one kv
//   head is D contiguous elements at a stride of Hkv * D; every layer's
//   cache is another pointer, so plain copies need no tensor map) into
//   rings in shared memory, with the int8 scales of the chunk's pages in
//   the first group. Rows past the position, and rows of a page id outside
//   [0, P), are zero-filled, never read. Rows are stored with a 16-byte XOR
//   swizzle, so ldmatrix and a thread per token read them free of bank
//   conflicts.
// * Products without per-row shuffle chains.
//   - bf16 query (bf16 pages; int8 pages under a bf16 query, the serving
//     default): tensor cores through mma.sync.m16n8k16. Warp w streams the
//     16-token sub-tiles w, w + 4, ... of the chunk through a ring of its
//     own (no CTA barrier per tile). The GROUP (<= 8) query rows padded to
//     16 are the A operand of S = Q K^T, and S's accumulator is, register
//     for register, the A operand (P) of O += P V; K and V come from shared
//     memory by ldmatrix (V transposed). int8 rows are read by ldmatrix as
//     pairs of bytes and widened to bf16 in registers, exactly: the k
//     columns of Q and the output columns are permuted to match the order
//     in which the lanes receive the bytes. The page's k scale multiplies
//     the f32 score after the product and its v scale is folded into P
//     before P is rounded to bf16; JAX keeps P in f32 against f32-
//     dequantized V for int8 pages, and this rounding (2^-9 relative) is
//     inside the bf16 output's own rounding and the 1e-2 per-row bound it
//     is held to. For bf16 pages, P in bf16 is what JAX does
//     (probs.astype(v_dtype)). Each warp keeps its own online softmax; the
//     four merge once at the end of the chunk.
//   - f32 query (f32 pages; int8 pages under an f32 query), held to 1e-5
//     absolute, which TF32 cannot meet: CUDA cores in f32, with the same
//     per-warp streaming (32-token sub-tiles, 8 for f32 rows of 512 bytes).
//     Lane = (token, part of the row) for the scores, q read as a
//     broadcast; the parts combine in 0-2 shuffles, then one max and one sum
//     of log2(sub-tile) shuffles per query head and sub-tile, not per row.
//     P goes through shared memory; then each lane accumulates 4 output
//     columns of every query head. int8 rows widen to f32 in registers.
//   Softmax statistics are f32 and in log2 units (scale * log2 e folded).
// * Merge by the log-sum-exp rule. A slot whose position lies in its first
//   chunk is written by that chunk's CTA. Otherwise each live chunk leaves
//   (m, l, acc[GROUP][D]) in f32 in a buffer the wrapper allocates, then
//   takes a ticket (atomicAdd on a counter per (slot, kv_head) the wrapper
//   owns); the CTA that takes the last merges the live chunks in chunk
//   order (bitwise reproducible), writes the output and resets the counter
//   to 0, so every call and every graph replay starts clean. A zero row sum
//   divides by 1; a parked slot (position 0, a row of trash pages) reads
//   token 0 of the trash page and gives finite garbage.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;     // 4 warps
constexpr int CHUNK = 256;       // tokens of one (slot, kv_head) per CTA
constexpr int MAX_GROUP = 8;     // query heads per kv head
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;
  const float* v_scales;
  const int* page_table;
  const int* positions;
  void* out;
  float* part_acc;   // [S, Hkv, chunks, GROUP, D]
  float* part_ml;    // [S, Hkv, chunks, GROUP, 2]: m (log2 units), l
  int* tickets;      // [S, Hkv], zero between calls
  int H, Hkv, P, page_size, max_pages, chunks;
  float scale_log2;  // d_head^-0.5 * log2 e
};

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int align128(int x) { return (x + 127) & ~127; }

// 16-byte XOR swizzle of a tile of rows of CH 16-byte chunks: chunk c of row
// r sits at c ^ ((r / RPL) & XM), so 8 rows read at one chunk (ldmatrix, a
// thread per row) or 8 chunks of one row fall in 8 distinct 16-byte units
// of a 128-byte line
template <int CH>
__device__ __forceinline__ int swizzle(int r, int c) {
  constexpr int RPL = cmax(1, 8 / CH), XM = cmin(CH, 8) - 1;
  return c ^ ((r / RPL) & XM);
}

template <typename QT, typename PT, int D, int GROUP>
struct Traits {
  static constexpr bool MMA = std::is_same<QT, __nv_bfloat16>::value;
  static constexpr bool QUANT = std::is_same<PT, int8_t>::value;
  static constexpr int PCH = D * (int)sizeof(PT) / 16;   // 16-B chunks/row
  // Warp w streams the SUB-token sub-tiles w, w + 4, ... of the chunk
  // through a ring of RS stages of its own: no CTA barrier per tile. The
  // f32-query body takes up to 32 tokens (a lane each), 8 of 512-byte f32
  // rows, to keep the ring near 16 KB a warp, so 3 CTAs fit an SM.
  static constexpr int SUB =
      MMA ? 16 : cmin(32, cmax(8, 8192 / (2 * D * (int)sizeof(PT))));
  static constexpr int SUB_BYTES = 2 * SUB * D * (int)sizeof(PT);  // K + V
  static constexpr int RS = cmax(2, cmin(CHUNK / SUB / 4, 16384 / SUB_BYTES));
  // f32 query: lane = 4 output columns (a slice) x every NTGW-th token
  static constexpr int NTGW = MMA ? 1 : cmax(1, 32 / (D / 4));
  // shared memory, bytes
  static constexpr int TABLE_N = CHUNK + 2;         // pages a chunk touches
  static constexpr int OFF_TABLE = 0;
  static constexpr int OFF_KSC = align128(OFF_TABLE + 4 * TABLE_N);
  static constexpr int OFF_VSC = align128(OFF_KSC + 4 * TABLE_N);
  static constexpr int OFF_STAT = align128(OFF_VSC + 4 * TABLE_N);
  static constexpr int OFF_Q = OFF_STAT + 4 * 8 * MAX_GROUP;  // f32 query
  static constexpr int OFF_P = OFF_Q + (MMA ? 0 : 4 * GROUP * D);
  static constexpr int OFF_RING = align128(OFF_P + (MMA ? 0 : 4 * 4 * GROUP * SUB));
  // the warps' accumulators at the end of the chunk, [4][NTGW][GROUP][D]
  // f32, over the ring (free by then)
  static constexpr int MERGE = 4 * 4 * NTGW * GROUP * D;
  static constexpr int SMEM = OFF_RING + cmax(4 * RS * SUB_BYTES, MERGE);
  static_assert(CHUNK % (4 * SUB) == 0 && D % 16 == 0 && D <= 128,
                "tile shape");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled (nothing read)
// unless ``valid``
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, "
               "%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d[0..1] (+)= A B for the query rows g (d[2..3], rows g + 8, are padding
// and discarded): A 16 x 16 bf16 {a0, 0, a2, 0}, B 16 x 8 bf16 {b0, b1}
__device__ __forceinline__ void mma_rows8(float (&d)[2], uint32_t a0,
                                          uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  float pad0 = 0.f, pad1 = 0.f;
  const uint32_t zero = 0;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(pad0), "+f"(pad1)
      : "r"(a0), "r"(zero), "r"(a2), "r"(zero), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pair);
}

// -inf (nothing visible yet) is measured from 0, so exp2 gives 0, not NaN
__device__ __forceinline__ float finite_or_zero(float m) {
  return m == -CUDART_INF_F ? 0.f : m;
}

__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  __nv_bfloat162* pair = reinterpret_cast<__nv_bfloat162*>(p);
  pair[0] = __floats2bfloat162_rn(x[0], x[1]);
  pair[1] = __floats2bfloat162_rn(x[2], x[3]);
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, "
               "[%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// Byte k of four int8 values as an f32, exactly and with no conversion
// instruction: the f32 with bits 0x4B0000XX, XX = x + 128, is 2^23 + 128 +
// x; less 2^23 + 128 it is x.
__device__ __forceinline__ float i8_f32(uint32_t word, int k) {
  return __uint_as_float(__byte_perm(word ^ 0x80808080u, 0x4B000000u,
                                     0x7440 | k)) - 8388736.f;
}

// Bytes ``lo`` and ``hi`` of four int8 values as two bf16, exactly: the
// top 16 bits of x in f32 (8 significant bits at most).
__device__ __forceinline__ uint32_t i8_pair(uint32_t word, int lo, int hi) {
  return __byte_perm(__float_as_uint(i8_f32(word, lo)),
                     __float_as_uint(i8_f32(word, hi)), 0x7632);
}

// The pool row (phys * page_size + token % page_size) of logical token
// ``tok`` of a chunk whose page-table entries from ``page0`` on are in
// ``table_s``, or -1 past the position or for a page id outside [0, P);
// ``page`` is the entry's index.
__device__ __forceinline__ int pool_row(const Params& p, const int* table_s,
                                        int tok, int last, int page0,
                                        int& page) {
  const int logical = tok / p.page_size;
  page = logical - page0;
  if (tok > last) return -1;
  const int phys = table_s[page];
  return phys >= 0 && phys < p.P
             ? phys * p.page_size + tok - logical * p.page_size : -1;
}

// The K and V rows of one SUB-token sub-tile into the ring stage at
// ``k_dst`` (V SUB * D elements after), 16-byte chunks swizzled; ``row`` is
// lane l's pool row of sub-tile row l % SUB (one lookup a lane, shared by
// shuffles). Every row index is taken before the first copy: the copies'
// memory clobbers would otherwise hold each lookup behind the copy before.
template <typename PT, int D, int SUB>
__device__ __forceinline__ void copy_sub(const Params& p, uint32_t k_dst,
                                         int row, int kvh) {
  constexpr int PCH = D * (int)sizeof(PT) / 16;
  constexpr int ITERS = (SUB * PCH + 31) / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t v_dst = k_dst + SUB * D * (int)sizeof(PT);
  const PT* k_pages = static_cast<const PT*>(p.k_pages);
  const PT* v_pages = static_cast<const PT*>(p.v_pages);
  int rows[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it)
    rows[it] = __shfl_sync(0xffffffffu, row,
                           cmin((lane + 32 * it) / PCH, SUB - 1));
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int idx = lane + 32 * it;
    if (idx < SUB * PCH) {
      const int r = idx / PCH, c = idx % PCH;
      const long off = rows[it] < 0
          ? 0 : ((long)rows[it] * p.Hkv + kvh) * D + c * (16 / (int)sizeof(PT));
      const int at = (r * PCH + swizzle<PCH>(r, c)) * 16;
      cp_async16(k_dst + at, k_pages + off, rows[it] >= 0);
      cp_async16(v_dst + at, v_pages + off, rows[it] >= 0);
    }
  }
}

// Warp w takes the sub-tiles w, w + 4, ... of a chunk of n_tok tokens: how
// many of them hold a token.
template <int SUB>
__device__ __forceinline__ int warp_sub_tiles(int n_tok) {
  const int warp = threadIdx.x / 32;
  return max(0, (n_tok - SUB * warp + 4 * SUB - 1) / (4 * SUB));
}

// Shared address of stage i % RS of this warp's ring.
template <typename TR>
__device__ __forceinline__ uint32_t ring_stage(unsigned char* smem, int i) {
  return smem_u32(smem + TR::OFF_RING) +
         ((threadIdx.x / 32) * TR::RS + i % TR::RS) * TR::SUB_BYTES;
}

// Starts the copy of this warp's i-th sub-tile (of ``mine``) into its
// ring: one commit group a call, empty past the last.
template <typename TR, typename PT, int D>
__device__ __forceinline__ void load_sub(const Params& p, unsigned char* smem,
                                          int i, int mine, int start,
                                          int last, int page0, int kvh) {
  if (i < mine) {
    const int* table_s = reinterpret_cast<const int*>(smem + TR::OFF_TABLE);
    const int tok = start + TR::SUB * (threadIdx.x / 32 + 4 * i) +
                    threadIdx.x % TR::SUB;
    int page;
    copy_sub<PT, D, TR::SUB>(p, ring_stage<TR>(smem, i),
                             pool_row(p, table_s, tok, last, page0, page), kvh);
  }
  cp_async_commit();
}

// The chunk [start, start + n_tok) of one (slot, kv_head), bf16 query, on
// the tensor cores. Leaves each warp's (m, l) in the stat area ([2][4]
// [GROUP]) and its unnormalized accumulator in [4][GROUP][D] at the ring.
template <typename QT, typename PT, int D, int GROUP>
__device__ __forceinline__ void chunk_mma(const Params& p, unsigned char* smem,
                                          int start, int n_tok, int last,
                                          int page0, int kvh, long head0) {
  using TR = Traits<QT, PT, D, GROUP>;
  constexpr int PCH = TR::PCH, RS = TR::RS, SUB = TR::SUB;
  constexpr bool QUANT = TR::QUANT;
  const int* table_s = reinterpret_cast<const int*>(smem + TR::OFF_TABLE);
  const float* ksc_s = reinterpret_cast<const float*>(smem + TR::OFF_KSC);
  const float* vsc_s = reinterpret_cast<const float*>(smem + TR::OFF_VSC);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int mine = warp_sub_tiles<SUB>(n_tok);
#pragma unroll
  for (int i = 0; i < RS - 1; ++i)
    load_sub<TR, PT, D>(p, smem, i, mine, start, last, page0, kvh);

  // Q as the A operand, rows g < GROUP (rows g + 8 are zero padding). For
  // int8 pages the 16 columns of a k step are ordered so that each lane's
  // four are contiguous (d = 16 kk + 4 t4 + 0..3), the order in which an
  // ldmatrix of int8 rows hands out K; the product does not depend on it.
  uint32_t qa[D / 16][2];
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + head0 * D;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int d0 = QUANT ? 16 * kk + 4 * t4 : 16 * kk + 2 * t4;
    const int d1 = QUANT ? d0 + 2 : d0 + 8;
    qa[kk][0] = g < GROUP ? *reinterpret_cast<const uint32_t*>(q + g * D + d0)
                          : 0u;
    qa[kk][1] = g < GROUP ? *reinterpret_cast<const uint32_t*>(q + g * D + d1)
                          : 0u;
  }
  if constexpr (QUANT) {
    // the page scales rode in every thread's first group
    cp_async_wait<RS - 2>();
    __syncthreads();
  }

  float m_run = -CUDART_INF_F, l_run = 0.f;
  float acc[D / 8][2];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = 0.f;
  for (int i = 0; i < mine; ++i) {
    __syncwarp();                      // the stage refilled here is read
    load_sub<TR, PT, D>(p, smem, i + RS - 1, mine, start, last, page0, kvh);
    cp_async_wait<RS - 1>();
    __syncwarp();
    const uint32_t k_base = ring_stage<TR>(smem, i);
    const uint32_t v_base = k_base + TR::SUB_BYTES / 2;
    // S = Q K^T for the sub-tile's two blocks of 8 tokens
    // (even and odd k steps into separate sums: two shorter chains)
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float s_odd[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    if constexpr (!QUANT) {
      const int kr = (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b[4];
        const int c = 2 * kk + ((lane >> 3) & 1);
        ldsm_x4(b, k_base + (kr * PCH + swizzle<PCH>(kr, c)) * 16);
        if (kk & 1) {
          mma_rows8(s_odd[0], qa[kk][0], qa[kk][1], b[0], b[1]);
          mma_rows8(s_odd[1], qa[kk][0], qa[kk][1], b[2], b[3]);
        } else {
          mma_rows8(s[0], qa[kk][0], qa[kk][1], b[0], b[1]);
          mma_rows8(s[1], qa[kk][0], qa[kk][1], b[2], b[3]);
        }
      }
    } else {
      // int8 rows as b16 pairs: a lane gets 4 contiguous values of a token
      const int kr = (lane & 7) + ((lane >> 3) & 1) * 8;
      if constexpr (D == 16) {
        uint32_t b[4];
        ldsm_x2(b, k_base + (kr * PCH + swizzle<PCH>(kr, 0)) * 16);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
          mma_rows8(s[nb], qa[0][0], qa[0][1], i8_pair(b[nb], 0, 1),
                    i8_pair(b[nb], 2, 3));
      } else {
#pragma unroll
        for (int kk = 0; kk < D / 16; kk += 2) {
          uint32_t b[4];
          const int c = kk + (lane >> 4);
          ldsm_x4(b, k_base + (kr * PCH + swizzle<PCH>(kr, c)) * 16);
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) {
            mma_rows8(s[nb], qa[kk][0], qa[kk][1], i8_pair(b[nb], 0, 1),
                      i8_pair(b[nb], 2, 3));
            mma_rows8(s_odd[nb], qa[kk + 1][0], qa[kk + 1][1],
                      i8_pair(b[2 + nb], 0, 1), i8_pair(b[2 + nb], 2, 3));
          }
        }
      }
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      s[nb][0] += s_odd[nb][0];
      s[nb][1] += s_odd[nb][1];
    }
    // online softmax over the 16 tokens (log2 units); the k scale after
    // the product, the v scale folded into P
    int page;                          // lane l's row: sub-tile row l % SUB
    const int row = pool_row(p, table_s, start + SUB * (warp + 4 * i) +
                                             lane % SUB, last, page0, page);
    float k_row = 1.f, v_row = 1.f;
    if constexpr (QUANT) {
      if (row >= 0) {
        k_row = ksc_s[page];
        v_row = vsc_s[page];
      }
    }
    float v_scale[2][2];
    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * nb + 2 * t4 + e;
        const bool valid = __shfl_sync(0xffffffffu, row, r) >= 0;
        float k_scale = 1.f;
        v_scale[nb][e] = 1.f;
        if constexpr (QUANT) {
          k_scale = __shfl_sync(0xffffffffu, k_row, r);
          v_scale[nb][e] = __shfl_sync(0xffffffffu, v_row, r);
        }
        s[nb][e] = valid ? s[nb][e] * p.scale_log2 * k_scale
                         : -CUDART_INF_F;
        tile_max = fmaxf(tile_max, s[nb][e]);
      }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m_run, tile_max);
    const float m_use = finite_or_zero(m_new);
    const float corr = exp2f(m_run - m_use);
    float pr[2][2];
    float sum = 0.f;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        pr[nb][e] = exp2f(s[nb][e] - m_use);
        sum += pr[nb][e];
      }
    l_run = l_run * corr + sum;
    m_run = m_new;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= corr;
      acc[j][1] *= corr;
    }
    // O += P V: S's accumulator is P's A operand, register for register
    const uint32_t a0 = pack_bf16(pr[0][0] * v_scale[0][0],
                                  pr[0][1] * v_scale[0][1]);
    const uint32_t a2 = pack_bf16(pr[1][0] * v_scale[1][0],
                                  pr[1][1] * v_scale[1][1]);
    const int vr = (lane & 7) + ((lane >> 3) & 1) * 8;
    if constexpr (!QUANT) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        uint32_t b[4];
        const int c = 2 * j + (lane >> 4);
        ldsm_x4_trans(b, v_base + (vr * PCH + swizzle<PCH>(vr, c)) * 16);
        mma_rows8(acc[2 * j], a0, a2, b[0], b[1]);
        mma_rows8(acc[2 * j + 1], a0, a2, b[2], b[3]);
      }
    } else {
      // transposed int8 rows as b16 pairs: a lane gets tokens 2 t4, 2 t4 + 1
      // of columns 2 g, 2 g + 1 of a 16-column chunk; the even columns feed
      // one block of 8 outputs, the odd ones the next
      if constexpr (D == 16) {
        uint32_t b[4];
        ldsm_x2_trans(b, v_base + (vr * PCH + swizzle<PCH>(vr, 0)) * 16);
        mma_rows8(acc[0], a0, a2, i8_pair(b[0], 0, 2), i8_pair(b[1], 0, 2));
        mma_rows8(acc[1], a0, a2, i8_pair(b[0], 1, 3), i8_pair(b[1], 1, 3));
      } else {
#pragma unroll
        for (int c2 = 0; c2 < PCH; c2 += 2) {
          uint32_t b[4];
          const int c = c2 + (lane >> 4);
          ldsm_x4_trans(b, v_base + (vr * PCH + swizzle<PCH>(vr, c)) * 16);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mma_rows8(acc[2 * (c2 + h)], a0, a2, i8_pair(b[2 * h], 0, 2),
                      i8_pair(b[2 * h + 1], 0, 2));
            mma_rows8(acc[2 * (c2 + h) + 1], a0, a2, i8_pair(b[2 * h], 1, 3),
                      i8_pair(b[2 * h + 1], 1, 3));
          }
        }
      }
    }
  }

  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  __syncthreads();                     // every warp is done with its ring
  float* acc_w = reinterpret_cast<float*>(smem + TR::OFF_RING);
  float* m_w = reinterpret_cast<float*>(smem + TR::OFF_STAT);
  float* l_w = m_w + 4 * MAX_GROUP;
  if (g < GROUP) {
    if (t4 == 0) {
      m_w[warp * GROUP + g] = m_run;
      l_w[warp * GROUP + g] = l_run;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = QUANT ? 16 * (j / 2) + 4 * t4 + 2 * e + (j & 1)
                            : 8 * j + 2 * t4 + e;
        acc_w[(warp * GROUP + g) * D + d] = acc[j][e];
      }
  }
  __syncthreads();
}

// The same chunk, f32 query, on the CUDA cores in f32, with the same
// per-warp streaming. Scores: lane = (token r = lane % SUB, part = lane /
// SUB), a part summing every (32 / SUB)-th 16-byte chunk of the row against
// q read as a broadcast; the parts combine in 0-2 shuffles, then one max
// and one sum of log2(SUB) shuffles per query head and sub-tile. P goes
// through shared memory; then lane = 4 output columns x every NTGW-th
// token. int8 rows are widened in registers. Leaves the warps' (m, l) in
// the stat area and their accumulators in [4][NTGW][GROUP][D] at the ring.
template <typename QT, typename PT, int D, int GROUP>
__device__ __forceinline__ void chunk_f32(const Params& p, unsigned char* smem,
                                          int start, int n_tok, int last,
                                          int page0, int kvh, long head0) {
  using TR = Traits<QT, PT, D, GROUP>;
  constexpr int PCH = TR::PCH, RS = TR::RS, SUB = TR::SUB, NTGW = TR::NTGW;
  constexpr int LPT = 32 / SUB, NSL = D / 4;
  constexpr bool QUANT = TR::QUANT;
  const int* table_s = reinterpret_cast<const int*>(smem + TR::OFF_TABLE);
  const float* ksc_s = reinterpret_cast<const float*>(smem + TR::OFF_KSC);
  const float* vsc_s = reinterpret_cast<const float*>(smem + TR::OFF_VSC);
  float* q_s = reinterpret_cast<float*>(smem + TR::OFF_Q);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* p_w = reinterpret_cast<float*>(smem + TR::OFF_P) + warp * GROUP * SUB;
  const int mine = warp_sub_tiles<SUB>(n_tok);
#pragma unroll
  for (int i = 0; i < RS - 1; ++i)
    load_sub<TR, PT, D>(p, smem, i, mine, start, last, page0, kvh);
  const float* q = static_cast<const float*>(p.q) + head0 * D;
  for (int i = tid; i < GROUP * D; i += THREADS) q_s[i] = q[i];
  if constexpr (QUANT) cp_async_wait<RS - 2>();  // the scales, in group 0
  __syncthreads();

  const int r = lane % SUB, part = lane / SUB;
  const int slice = lane % NSL, tg = lane / NSL;
  float m_run[GROUP], l_run[GROUP], acc[GROUP][4];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    m_run[g] = -CUDART_INF_F;
    l_run[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  }
  for (int i = 0; i < mine; ++i) {
    __syncwarp();                      // the stage and p_w are read
    load_sub<TR, PT, D>(p, smem, i + RS - 1, mine, start, last, page0, kvh);
    cp_async_wait<RS - 1>();
    __syncwarp();
    const unsigned char* k_sub =
        smem + TR::OFF_RING + (warp * RS + i % RS) * TR::SUB_BYTES;
    const unsigned char* v_sub = k_sub + TR::SUB_BYTES / 2;
    int page;
    const int row = pool_row(p, table_s, start + SUB * (warp + 4 * i) + r,
                             last, page0, page);
    float k_scale = 1.f, v_scale = 1.f;
    if constexpr (QUANT) {
      if (row >= 0) {
        k_scale = ksc_s[page];
        v_scale = vsc_s[page];
      }
    }
    float dot[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) dot[g] = 0.f;
#pragma unroll
    for (int c = part; c < PCH; c += LPT) {
      const unsigned char* at = k_sub + (r * PCH + swizzle<PCH>(r, c)) * 16;
      if constexpr (QUANT) {
        const uint4 raw = *reinterpret_cast<const uint4*>(at);
        const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int j = 0; j < 16; j += 4) {
          const uint32_t word = words[j / 4];
          const float k0 = i8_f32(word, 0), k1 = i8_f32(word, 1),
                      k2 = i8_f32(word, 2), k3 = i8_f32(word, 3);
#pragma unroll
          for (int g = 0; g < GROUP; ++g) {
            const float4 qv = *reinterpret_cast<const float4*>(
                q_s + g * D + 16 * c + j);
            dot[g] = fmaf(qv.x, k0, dot[g]);
            dot[g] = fmaf(qv.y, k1, dot[g]);
            dot[g] = fmaf(qv.z, k2, dot[g]);
            dot[g] = fmaf(qv.w, k3, dot[g]);
          }
        }
      } else {
        const float4 kv = *reinterpret_cast<const float4*>(at);
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
          const float4 qv = *reinterpret_cast<const float4*>(q_s + g * D +
                                                             4 * c);
          dot[g] = fmaf(qv.x, kv.x, dot[g]);
          dot[g] = fmaf(qv.y, kv.y, dot[g]);
          dot[g] = fmaf(qv.z, kv.z, dot[g]);
          dot[g] = fmaf(qv.w, kv.w, dot[g]);
        }
      }
    }
    // online softmax over the SUB tokens, per query head (log2 units)
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
#pragma unroll
      for (int off = SUB; off < 32; off *= 2)
        dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
      const float sc = row >= 0 ? dot[g] * p.scale_log2 * k_scale
                                : -CUDART_INF_F;
      float tile_max = sc;
#pragma unroll
      for (int off = 1; off < SUB; off *= 2)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      const float m_new = fmaxf(m_run[g], tile_max);
      const float m_use = finite_or_zero(m_new);
      const float corr = exp2f(m_run[g] - m_use);
      const float pr = exp2f(sc - m_use);
      float sum = pr;
#pragma unroll
      for (int off = 1; off < SUB; off *= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[g] = l_run[g] * corr + sum;
      m_run[g] = m_new;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] *= corr;
      if (part == 0) p_w[g * SUB + r] = pr * v_scale;
    }
    __syncwarp();
    // O += P V
#pragma unroll
    for (int t = tg; t < SUB; t += NTGW) {
      float v[4];
      if constexpr (QUANT) {
        const uint32_t word = *reinterpret_cast<const uint32_t*>(
            v_sub + (t * PCH + swizzle<PCH>(t, slice / 4)) * 16 +
            (slice % 4) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = i8_f32(word, e);
      } else {
        const float4 vv = *reinterpret_cast<const float4*>(
            v_sub + (t * PCH + swizzle<PCH>(t, slice)) * 16);
        v[0] = vv.x;
        v[1] = vv.y;
        v[2] = vv.z;
        v[3] = vv.w;
      }
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const float pr = p_w[g * SUB + t];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(pr, v[e], acc[g][e]);
      }
    }
  }

  __syncthreads();                     // every warp is done with its ring
  float* acc_w = reinterpret_cast<float*>(smem + TR::OFF_RING);
  float* m_w = reinterpret_cast<float*>(smem + TR::OFF_STAT);
  float* l_w = m_w + 4 * MAX_GROUP;
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    if (lane == 0) {
      m_w[warp * GROUP + g] = m_run[g];
      l_w[warp * GROUP + g] = l_run[g];
    }
    store4(acc_w + ((warp * NTGW + tg) * GROUP + g) * D + 4 * slice, acc[g]);
  }
  __syncthreads();
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename QT, typename PT, int D, int GROUP>
__global__ void __launch_bounds__(THREADS, 1)
paged_decode_split_kernel(const Params p) {
  using TR = Traits<QT, PT, D, GROUP>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int merges;
  int* table_s = reinterpret_cast<int*>(smem + TR::OFF_TABLE);
  const int chunk = blockIdx.x, kvh = blockIdx.y, slot = blockIdx.z;
  const int tid = threadIdx.x;
  const int page_size = p.page_size;
  const int start = chunk * CHUNK;
  const int page0 = start / page_size;
  const long pair = (long)slot * p.Hkv + kvh;
  const long head0 = (long)slot * p.H + (long)kvh * GROUP;
  QT* out = static_cast<QT*>(p.out) + head0 * D;

  // the chunk's page-table entries, fetched beside the position (a CTA
  // past its slot's position leaves without waiting for them)
  constexpr int PER = (TR::TABLE_N + THREADS - 1) / THREADS;
  const int n_tab = min((start + CHUNK - 1) / page_size - page0 + 1,
                        p.max_pages - page0);
  int entry[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * THREADS;
    entry[k] = i < n_tab ? p.page_table[(long)slot * p.max_pages + page0 + i]
                         : -1;
  }
  const int last = min(p.positions[slot], p.max_pages * page_size - 1);
  if (start > last) {
    if (chunk == 0)                    // nothing visible: a zero output
      for (int i = tid; i < GROUP * D; i += THREADS) store(out + i, 0.f);
    return;
  }
  const int n_tok = min(CHUNK, last + 1 - start);
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (tid + k * THREADS < n_tab) table_s[tid + k * THREADS] = entry[k];
  __syncthreads();
  if constexpr (TR::QUANT) {
    // the scales of the chunk's live pages ride in the first async group
    float* ksc_s = reinterpret_cast<float*>(smem + TR::OFF_KSC);
    float* vsc_s = reinterpret_cast<float*>(smem + TR::OFF_VSC);
    const int n_pages = (start + n_tok - 1) / page_size - page0 + 1;
    for (int i = tid; i < n_pages; i += THREADS) {
      const int phys = table_s[i];
      const bool ok = phys >= 0 && phys < p.P;
      const long at = ok ? (long)phys * p.Hkv + kvh : 0;
      cp_async4(smem_u32(ksc_s + i), p.k_scales + at, ok);
      cp_async4(smem_u32(vsc_s + i), p.v_scales + at, ok);
    }
  }
  if constexpr (TR::MMA)
    chunk_mma<QT, PT, D, GROUP>(p, smem, start, n_tok, last, page0, kvh,
                                head0);
  else
    chunk_f32<QT, PT, D, GROUP>(p, smem, start, n_tok, last, page0, kvh,
                                head0);

  // this chunk's (m, l, unnormalized acc): the output itself when it is
  // the slot's only chunk with a visible token, else a partial
  const float* scratch = reinterpret_cast<const float*>(smem + TR::OFF_RING);
  const float* stat = reinterpret_cast<const float*>(smem + TR::OFF_STAT);
  const int live = last / CHUNK + 1;
  const long part = pair * p.chunks + chunk;
  float* part_acc = p.part_acc + part * GROUP * D;
  float* part_ml = p.part_ml + part * GROUP * 2;
  for (int i = tid; i < GROUP * D; i += THREADS) {
    const int gg = i / D;
    float m, l, a = 0.f;
    // the 4 warps' states, merged (and, f32 query, their token groups)
    m = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < 4; ++w) m = fmaxf(m, stat[w * GROUP + gg]);
    const float m_use = finite_or_zero(m);
    l = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float weight = exp2f(stat[w * GROUP + gg] - m_use);
      l = fmaf(stat[4 * MAX_GROUP + w * GROUP + gg], weight, l);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < TR::NTGW; ++t)
        sum += scratch[(w * TR::NTGW + t) * GROUP * D + i];
      a = fmaf(sum, weight, a);
    }
    if (live == 1) {
      store(out + i, a / (l == 0.f ? 1.f : l));
    } else {
      part_acc[i] = a;
      if (i % D == 0) {
        part_ml[2 * gg] = m;
        part_ml[2 * gg + 1] = l;
      }
    }
  }
  if (live == 1) return;

  // the CTA that takes the last ticket of its (slot, kv_head) merges the
  // live chunks in chunk order and resets the ticket
  __threadfence();
  __syncthreads();
  if (tid == 0) merges = atomicAdd(p.tickets + pair, 1) == live - 1;
  __syncthreads();
  if (!merges) return;
  __threadfence();
  const float* acc_in = p.part_acc + pair * p.chunks * GROUP * D;
  const float* ml_in = p.part_ml + pair * p.chunks * GROUP * 2;
  for (int i = tid; i < GROUP * D / 4; i += THREADS) {
    const int gg = 4 * i / D;
    float m = -CUDART_INF_F, l = 0.f;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int c = 0; c < live; ++c) {
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(
          ml_in + (c * GROUP + gg) * 2));
      const float4 a = __ldcg(reinterpret_cast<const float4*>(
          acc_in + (long)c * GROUP * D + 4 * i));
      const float m_new = fmaxf(m, ml.x);
      const float m_use = finite_or_zero(m_new);
      const float keep = exp2f(m - m_use), weight = exp2f(ml.x - m_use);
      l = l * keep + ml.y * weight;
      o[0] = o[0] * keep + a.x * weight;
      o[1] = o[1] * keep + a.y * weight;
      o[2] = o[2] * keep + a.z * weight;
      o[3] = o[3] * keep + a.w * weight;
      m = m_new;
    }
    const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] *= inv;
    store4(out + 4 * i, o);
  }
  if (tid == 0) p.tickets[pair] = 0;
}

template <typename QT, typename PT, int D, int GROUP>
int launch(const Params& p, int S, cudaStream_t stream) {
  using TR = Traits<QT, PT, D, GROUP>;
  static unsigned long long sized = 0;   // devices given the attribute
  if (TR::SMEM > 48 * 1024) {
    int device = 0;
    cudaError_t status = cudaGetDevice(&device);
    if (status != cudaSuccess) return (int)status;
    if (device >= 64 || !(sized >> device & 1)) {
      status = cudaFuncSetAttribute(
          paged_decode_split_kernel<QT, PT, D, GROUP>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, TR::SMEM);
      if (status != cudaSuccess) return (int)status;
      if (device < 64) sized |= 1ull << device;
    }
  }
  const dim3 grid(p.chunks, p.Hkv, S);
  paged_decode_split_kernel<QT, PT, D, GROUP>
      <<<grid, THREADS, TR::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename QT, typename PT, int D>
int dispatch_group(const Params& p, int S, cudaStream_t stream) {
  switch (p.H / p.Hkv) {
    case 1: return launch<QT, PT, D, 1>(p, S, stream);
    case 2: return launch<QT, PT, D, 2>(p, S, stream);
    case 4: return launch<QT, PT, D, 4>(p, S, stream);
    case 8: return launch<QT, PT, D, 8>(p, S, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename QT, typename PT>
int dispatch_d(int D, const Params& p, int S, cudaStream_t stream) {
  switch (D) {
    case 16: return dispatch_group<QT, PT, 16>(p, S, stream);
    case 32: return dispatch_group<QT, PT, 32>(p, S, stream);
    case 64: return dispatch_group<QT, PT, 64>(p, S, stream);
    case 128: return dispatch_group<QT, PT, 128>(p, S, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Tokens of one slot per CTA; the wrapper sizes the partials by it.
extern "C" int thp_paged_decode_chunk_tokens() { return CHUNK; }

// q_dtype: 0 = float32, 1 = bfloat16 (also the output type).
// page_dtype: 0 = float32, 1 = bfloat16 (both == q_dtype), 2 = int8 (then
// k_scales/v_scales are required). D in {16, 32, 64, 128}; H / Hkv in
// {1, 2, 4, 8}; pages 16-byte aligned, P * page_size < 2^31. ``chunks`` must be
// ceil(max_pages * page_size / CHUNK); part_acc holds S * H * chunks * D
// f32, part_ml S * H * chunks * 2 f32, tickets S * Hkv int32, all zero
// before the first call (the kernel leaves them zero).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int thp_paged_decode(int q_dtype, int page_dtype, const void* q,
                                const void* k_pages, const void* v_pages,
                                const void* k_scales, const void* v_scales,
                                const void* page_table, const void* positions,
                                void* out, void* part_acc, void* part_ml,
                                void* tickets, int S, int H, int Hkv, int D,
                                int P, int page_size, int max_pages,
                                int chunks, float scale, void* stream) {
  if (S < 1 || S > 65535 || Hkv < 1 || Hkv > 65535 || H % Hkv != 0 ||
      H / Hkv > MAX_GROUP || P < 1 || page_size < 1 || max_pages < 1 ||
      (long)max_pages * page_size > (1L << 30) ||
      (long)P * page_size >= (1L << 31) ||
      chunks != (max_pages * page_size + CHUNK - 1) / CHUNK)
    return (int)cudaErrorInvalidValue;
  const bool quant = page_dtype == 2;
  if (quant != (k_scales != nullptr && v_scales != nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k_pages = k_pages;
  p.v_pages = v_pages;
  p.k_scales = static_cast<const float*>(k_scales);
  p.v_scales = static_cast<const float*>(v_scales);
  p.page_table = static_cast<const int*>(page_table);
  p.positions = static_cast<const int*>(positions);
  p.out = out;
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.tickets = static_cast<int*>(tickets);
  p.H = H;
  p.Hkv = Hkv;
  p.P = P;
  p.page_size = page_size;
  p.max_pages = max_pages;
  p.chunks = chunks;
  p.scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && page_dtype == 0) return dispatch_d<float, float>(D, p, S, s);
  if (q_dtype == 1 && page_dtype == 1)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(D, p, S, s);
  if (q_dtype == 0 && quant) return dispatch_d<float, int8_t>(D, p, S, s);
  if (q_dtype == 1 && quant) return dispatch_d<__nv_bfloat16, int8_t>(D, p, S, s);
  return (int)cudaErrorInvalidValue;
}
