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
// KV head h / (H / Hkv), with no expanded copy. D is any multiple of 16
// from 16 to 256 and the group H / Hkv any divisor of H (JAX's kernel takes
// any width and group): each body is built for a padded width of 16, 32, 64,
// 128 or 256 and a tile of query heads (CUDA-core body: the group's next
// power of two up to 8, 4 at width 256; tensor-core body: 8 or 16, its
// m16 tile holding 16 rows anyway, 8 at width 256), the copies zero-fill the
// columns past D, the stores skip them, and a CTA runs a group wider than
// its tile as tiles of query heads in turn (a group of 48 under a bf16
// query: three of 16) over the same chunk, whose second and later passes
// find its pages in L2.
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
//     default, up to width 128: at 256 its registers spilled and it runs
//     the f32 body below, P in f32): tensor cores through
//     mma.sync.m16n8k16. Warp w streams the
//     16-token sub-tiles w, w + 4, ... of the chunk through a ring of its
//     own (no CTA barrier per tile). A tile's query rows (up to 8 as rows
//     g, rows g + 8 zero; 9-16 on both halves) are the A operand of
//     S = Q K^T, and S's accumulator is, register
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
//   - f32 query (f32 pages; int8 pages under an f32 query; and int8 pages
//     under a bf16 query at width 256), held to 1e-5 absolute, which TF32
//     cannot meet: CUDA cores in f32, with the same
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

#include "widths.cuh"

namespace {

constexpr int THREADS = 128;     // 4 warps
constexpr int CHUNK = 256;       // tokens of one (slot, kv_head) per CTA
constexpr int MAX_GROUP = 16;    // query heads a tile
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
  float* part_acc;   // [S, Hkv, chunks, group, D (padded)]
  float* part_ml;    // [S, Hkv, chunks, group, 2]: m (log2 units), l
  int* tickets;      // [S, Hkv], zero between calls
  int H, Hkv, P, page_size, max_pages, chunks;
  int d;             // d_head (<= the padded D), the row length in memory
  int group;         // H / Hkv
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

// Whether a (query type, page type, padded width) runs the tensor-core body:
// a bf16 query, but not over int8 pages at width 256, whose registers
// spilled there (it runs the f32 body).
template <typename QT, typename PT, int D>
constexpr bool tensor_cores() {
  return std::is_same<QT, __nv_bfloat16>::value &&
         !(std::is_same<PT, int8_t>::value && D > 128);
}

// D: the padded width; GROUP: the query heads a tile (rows of the products)
template <typename QT, typename PT, int D, int GROUP>
struct Traits {
  static constexpr bool MMA = tensor_cores<QT, PT, D>();
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
  // f32 query: lane = slices of 4 output columns x every NTGW-th token
  static constexpr int NTGW = MMA ? 1 : cmax(1, 32 / (D / 4));
  // shared memory, bytes
  static constexpr int TABLE_N = CHUNK + 2;         // pages a chunk touches
  static constexpr int OFF_TABLE = 0;
  static constexpr int OFF_KSC = align128(OFF_TABLE + 4 * TABLE_N);
  static constexpr int OFF_VSC = align128(OFF_KSC + 4 * TABLE_N);
  static constexpr int OFF_STAT = align128(OFF_VSC + 4 * TABLE_N);
  // the query rows in shared memory: f32 query always; bf16 query past
  // width 64, where Q's fragments in registers (D / 8 a lane) cost the
  // third CTA an SM at width 128 and spilled at 256
  static constexpr bool Q_SMEM = !MMA || D > 64;
  static constexpr int OFF_Q = OFF_STAT + 4 * 8 * MAX_GROUP;
  static constexpr int OFF_P =
      OFF_Q + (MMA ? (Q_SMEM ? 2 * GROUP * D : 0) : 4 * GROUP * D);
  static constexpr int OFF_RING = align128(OFF_P + (MMA ? 0 : 4 * 4 * GROUP * SUB));
  // the warps' accumulators at the end of the chunk, [4][NTGW][GROUP][D]
  // f32, over the ring (free by then)
  static constexpr int MERGE = 4 * 4 * NTGW * GROUP * D;
  static constexpr int SMEM = OFF_RING + cmax(4 * RS * SUB_BYTES, MERGE);
  // CTAs an SM must hold: 3 (at most 168 registers a thread) where the
  // kernels of groups up to 8 (tensor cores) or 4 fit them without a spill;
  // at 2 a CTA, int8 pages under a bf16 query ran a fifth slower at the 7b
  // serving shape
  static constexpr int MIN_BLOCKS =
      D <= 128 && (MMA ? GROUP == 8 : GROUP <= 4) ? 3 : 1;
  static_assert(CHUNK % (4 * SUB) == 0 && D % 16 == 0 && D <= 256 &&
                GROUP <= MAX_GROUP && (!MMA || GROUP == 8 || GROUP == 16),
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

// d (+)= A B, A 16 x 16 bf16, B 16 x 8 bf16 {b0, b1}. R = 1: the query rows
// g only, A {a[0], 0, a[1], 0} (rows g + 8 are zero padding, their sums
// discarded), d rows g; R = 2: A {a[0], a[1], a[2], a[3]}, d rows g, g + 8
// (d[2r + e]: row g + 8r, column 2t + e).
template <int R>
__device__ __forceinline__ void mma_rows(float (&d)[2 * R],
                                         const uint32_t (&a)[2 * R],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (R == 1) {
    float pad0 = 0.f, pad1 = 0.f;
    const uint32_t zero = 0;
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
        "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(pad0), "+f"(pad1)
        : "r"(a[0]), "r"(zero), "r"(a[1]), "r"(zero), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
        "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pair);
}

// -inf (nothing visible yet) is measured from 0, so exp2 gives 0, not NaN
__device__ __forceinline__ float finite_or_zero(float m) {
  return m == -CUDART_INF_F ? 0.f : m;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
// ``k_dst`` (V SUB * D elements after), 16-byte chunks swizzled, the chunks
// past d_head zero-filled; ``row`` is lane l's pool row of sub-tile row
// l % SUB (one lookup a lane, shared by shuffles). Every row index is taken
// before the first copy: the copies' memory clobbers would otherwise hold
// each lookup behind the copy before.
template <typename PT, int D, int SUB>
__device__ __forceinline__ void copy_sub(const Params& p, uint32_t k_dst,
                                         int row, int kvh) {
  constexpr int PCH = D * (int)sizeof(PT) / 16;
  const int live_chunks = p.d * (int)sizeof(PT) / 16;
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
      const bool valid = rows[it] >= 0 && c < live_chunks;
      const long off = valid ? ((long)rows[it] * p.Hkv + kvh) * p.d +
                                   c * (16 / (int)sizeof(PT))
                             : 0;
      const int at = (r * PCH + swizzle<PCH>(r, c)) * 16;
      cp_async16(k_dst + at, k_pages + off, valid);
      cp_async16(v_dst + at, v_pages + off, valid);
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

// Tile row g + 8r's Q fragment of k step kk (R row halves): columns d0.. in
// a[r] and d1.. in a[R + r], from rows of ``stride`` elements at ``q``;
// zero past ``rows`` and past ``d``. For int8 pages the 16 columns of a k
// step are ordered so that each lane's four are contiguous (d = 16 kk +
// 4 t4 + 0..3), the order in which an ldmatrix of int8 rows hands out K;
// the product does not depend on it.
template <bool QUANT, int R>
__device__ __forceinline__ void q_fragment(uint32_t (&a)[2 * R],
                                           const __nv_bfloat16* q, int stride,
                                           int kk, int g, int t4, int rows,
                                           int d) {
  const int d0 = QUANT ? 16 * kk + 4 * t4 : 16 * kk + 2 * t4;
  const int d1 = QUANT ? d0 + 2 : d0 + 8;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = g + 8 * r;
    const bool ok = row < rows && 16 * kk < d;
    const __nv_bfloat16* q_row = q + row * stride;
    a[r] = ok ? *reinterpret_cast<const uint32_t*>(q_row + d0) : 0u;
    a[R + r] = ok ? *reinterpret_cast<const uint32_t*>(q_row + d1) : 0u;
  }
}

// The chunk [start, start + n_tok) of one (slot, kv_head), bf16 query, on
// the tensor cores, for the ``rows`` query heads of a tile from ``head0``
// (rows past them, and columns past d_head, are zero in Q). Leaves each
// warp's (m, l) in the stat area ([2][4][GROUP]) and its unnormalized
// accumulator in [4][GROUP][D] at the ring.
template <typename QT, typename PT, int D, int GROUP>
__device__ __forceinline__ void chunk_mma(const Params& p, unsigned char* smem,
                                          int start, int n_tok, int last,
                                          int page0, int kvh, long head0,
                                          int rows) {
  using TR = Traits<QT, PT, D, GROUP>;
  constexpr int PCH = TR::PCH, RS = TR::RS, SUB = TR::SUB;
  constexpr int R = GROUP / 8;         // m16 row halves the tile uses
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

  // Q as the A operand (R = 1: rows g + 8 are zero padding): its fragments
  // in registers, or past width 64 the tile's rows in shared memory (zeros
  // past ``rows`` and d_head) and the fragments read there each k step
  constexpr bool Q_SMEM = TR::Q_SMEM;
  uint32_t qa[Q_SMEM ? 1 : D / 16][2 * R];
  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + head0 * p.d;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + TR::OFF_Q);
  if constexpr (Q_SMEM) {
    for (int i = tid; i < GROUP * D / 2; i += THREADS) {
      const int row = 2 * i / D, col = 2 * i % D;
      reinterpret_cast<uint32_t*>(q_s)[i] =
          row < rows && col < p.d
              ? *reinterpret_cast<const uint32_t*>(q + row * p.d + col)
              : 0u;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      q_fragment<QUANT, R>(qa[kk], q, p.d, kk, g, t4, rows, p.d);
  }
  const auto q_operand = [&](int kk) -> const uint32_t (&)[2 * R] {
    if constexpr (Q_SMEM) {
      q_fragment<QUANT, R>(qa[0], q_s, D, kk, g, t4, GROUP, D);
      return qa[0];
    } else {
      return qa[kk];
    }
  };
  if constexpr (QUANT) cp_async_wait<RS - 2>();  // the scales, in group 0
  if constexpr (QUANT || Q_SMEM) __syncthreads();

  float m_run[R], l_run[R];
#pragma unroll
  for (int r = 0; r < R; ++r) m_run[r] = -CUDART_INF_F, l_run[r] = 0.f;
  float acc[D / 8][2 * R];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2 * R; ++e) acc[j][e] = 0.f;
  for (int i = 0; i < mine; ++i) {
    __syncwarp();                      // the stage refilled here is read
    load_sub<TR, PT, D>(p, smem, i + RS - 1, mine, start, last, page0, kvh);
    cp_async_wait<RS - 1>();
    __syncwarp();
    const uint32_t k_base = ring_stage<TR>(smem, i);
    const uint32_t v_base = k_base + TR::SUB_BYTES / 2;
    // S = Q K^T for the sub-tile's two blocks of 8 tokens
    // (even and odd k steps into separate sums: two shorter chains)
    float s[2][2 * R], s_odd[2][2 * R];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 2 * R; ++e) s[nb][e] = s_odd[nb][e] = 0.f;
    if constexpr (!QUANT) {
      const int kr = (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b[4];
        const int c = 2 * kk + ((lane >> 3) & 1);
        ldsm_x4(b, k_base + (kr * PCH + swizzle<PCH>(kr, c)) * 16);
        const uint32_t (&a)[2 * R] = q_operand(kk);
        if (kk & 1) {
          mma_rows<R>(s_odd[0], a, b[0], b[1]);
          mma_rows<R>(s_odd[1], a, b[2], b[3]);
        } else {
          mma_rows<R>(s[0], a, b[0], b[1]);
          mma_rows<R>(s[1], a, b[2], b[3]);
        }
      }
    } else {
      // int8 rows as b16 pairs: a lane gets 4 contiguous values of a token
      const int kr = (lane & 7) + ((lane >> 3) & 1) * 8;
      if constexpr (D == 16) {
        uint32_t b[4];
        ldsm_x2(b, k_base + (kr * PCH + swizzle<PCH>(kr, 0)) * 16);
        const uint32_t (&a)[2 * R] = q_operand(0);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
          mma_rows<R>(s[nb], a, i8_pair(b[nb], 0, 1), i8_pair(b[nb], 2, 3));
      } else {
#pragma unroll
        for (int kk = 0; kk < D / 16; kk += 2) {
          uint32_t b[4];
          const int c = kk + (lane >> 4);
          ldsm_x4(b, k_base + (kr * PCH + swizzle<PCH>(kr, c)) * 16);
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
            mma_rows<R>(s[nb], q_operand(kk), i8_pair(b[nb], 0, 1),
                        i8_pair(b[nb], 2, 3));
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
            mma_rows<R>(s_odd[nb], q_operand(kk + 1),
                        i8_pair(b[2 + nb], 0, 1), i8_pair(b[2 + nb], 2, 3));
        }
      }
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 2 * R; ++e) s[nb][e] += s_odd[nb][e];
    // online softmax over the 16 tokens (log2 units), per row half; the k
    // scale after the product, the v scale folded into P
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
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = 8 * nb + 2 * t4 + e;
        const bool valid = __shfl_sync(0xffffffffu, row, key) >= 0;
        float k_scale = 1.f;
        v_scale[nb][e] = 1.f;
        if constexpr (QUANT) {
          k_scale = __shfl_sync(0xffffffffu, k_row, key);
          v_scale[nb][e] = __shfl_sync(0xffffffffu, v_row, key);
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
          s[nb][2 * r + e] = valid ? s[nb][2 * r + e] * p.scale_log2 * k_scale
                                   : -CUDART_INF_F;
      }
    float pr[2][2 * R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float tile_max = -CUDART_INF_F;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) tile_max = fmaxf(tile_max, s[nb][2 * r + e]);
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
      const float m_new = fmaxf(m_run[r], tile_max);
      const float m_use = finite_or_zero(m_new);
      const float corr = exp2f(m_run[r] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          pr[nb][2 * r + e] = exp2f(s[nb][2 * r + e] - m_use);
          sum += pr[nb][2 * r + e];
        }
      l_run[r] = l_run[r] * corr + sum;
      m_run[r] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][2 * r] *= corr;
        acc[j][2 * r + 1] *= corr;
      }
    }
    // O += P V: S's accumulator is P's A operand, register for register
    uint32_t pa[2 * R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      pa[r] = pack_bf16(pr[0][2 * r] * v_scale[0][0],
                        pr[0][2 * r + 1] * v_scale[0][1]);
      pa[R + r] = pack_bf16(pr[1][2 * r] * v_scale[1][0],
                            pr[1][2 * r + 1] * v_scale[1][1]);
    }
    const int vr = (lane & 7) + ((lane >> 3) & 1) * 8;
    if constexpr (!QUANT) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        uint32_t b[4];
        const int c = 2 * j + (lane >> 4);
        ldsm_x4_trans(b, v_base + (vr * PCH + swizzle<PCH>(vr, c)) * 16);
        mma_rows<R>(acc[2 * j], pa, b[0], b[1]);
        mma_rows<R>(acc[2 * j + 1], pa, b[2], b[3]);
      }
    } else {
      // transposed int8 rows as b16 pairs: a lane gets tokens 2 t4, 2 t4 + 1
      // of columns 2 g, 2 g + 1 of a 16-column chunk; the even columns feed
      // one block of 8 outputs, the odd ones the next
      if constexpr (D == 16) {
        uint32_t b[4];
        ldsm_x2_trans(b, v_base + (vr * PCH + swizzle<PCH>(vr, 0)) * 16);
        mma_rows<R>(acc[0], pa, i8_pair(b[0], 0, 2), i8_pair(b[1], 0, 2));
        mma_rows<R>(acc[1], pa, i8_pair(b[0], 1, 3), i8_pair(b[1], 1, 3));
      } else {
#pragma unroll
        for (int c2 = 0; c2 < PCH; c2 += 2) {
          uint32_t b[4];
          const int c = c2 + (lane >> 4);
          ldsm_x4_trans(b, v_base + (vr * PCH + swizzle<PCH>(vr, c)) * 16);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mma_rows<R>(acc[2 * (c2 + h)], pa, i8_pair(b[2 * h], 0, 2),
                        i8_pair(b[2 * h + 1], 0, 2));
            mma_rows<R>(acc[2 * (c2 + h) + 1], pa, i8_pair(b[2 * h], 1, 3),
                        i8_pair(b[2 * h + 1], 1, 3));
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  __syncthreads();                     // every warp is done with its ring
  float* acc_w = reinterpret_cast<float*>(smem + TR::OFF_RING);
  float* m_w = reinterpret_cast<float*>(smem + TR::OFF_STAT);
  float* l_w = m_w + 4 * MAX_GROUP;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = g + 8 * r;         // < GROUP = 8 R
    if (row >= rows) continue;         // the tile's padding rows
    if (t4 == 0) {
      m_w[warp * GROUP + row] = m_run[r];
      l_w[warp * GROUP + row] = l_run[r];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = QUANT ? 16 * (j / 2) + 4 * t4 + 2 * e + (j & 1)
                            : 8 * j + 2 * t4 + e;
        acc_w[(warp * GROUP + row) * D + d] = acc[j][2 * r + e];
      }
  }
  __syncthreads();
}

// The same chunk, f32 query, on the CUDA cores in f32, with the same
// per-warp streaming, for the ``rows`` query heads of a tile from
// ``head0``. Scores: lane = (token r = lane % SUB, part = lane / SUB), a
// part summing every (32 / SUB)-th 16-byte chunk of the row against q read
// as a broadcast; the parts combine in 0-2 shuffles, then one max and one
// sum of log2(SUB) shuffles per query head and sub-tile. P goes through
// shared memory; then lane = SPL slices of 4 output columns x every
// NTGW-th token. int8 rows are widened in registers. Leaves the warps'
// (m, l) in the stat area and their accumulators in [4][NTGW][GROUP][D] at
// the ring.
template <typename QT, typename PT, int D, int GROUP>
__device__ __forceinline__ void chunk_f32(const Params& p, unsigned char* smem,
                                          int start, int n_tok, int last,
                                          int page0, int kvh, long head0,
                                          int rows) {
  using TR = Traits<QT, PT, D, GROUP>;
  constexpr int PCH = TR::PCH, RS = TR::RS, SUB = TR::SUB, NTGW = TR::NTGW;
  constexpr int SPL = D > 128 ? D / 128 : 1;   // slices of 4 columns a lane
  constexpr int LPT = 32 / SUB, NSL = D / 4 / SPL;
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
  const QT* q = static_cast<const QT*>(p.q) + head0 * p.d;
  for (int i = tid; i < GROUP * D; i += THREADS) {
    const int row = i / D, col = i % D;
    q_s[i] = row < rows && col < p.d ? to_f32(q[row * p.d + col]) : 0.f;
  }
  if constexpr (QUANT) cp_async_wait<RS - 2>();  // the scales, in group 0
  __syncthreads();

  const int r = lane % SUB, part = lane / SUB;
  const int slice = lane % NSL, tg = lane / NSL;
  float m_run[GROUP], l_run[GROUP], acc[GROUP][SPL][4];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    m_run[g] = -CUDART_INF_F;
    l_run[g] = 0.f;
#pragma unroll
    for (int k = 0; k < SPL; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][k][e] = 0.f;
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
      for (int k = 0; k < SPL; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][k][e] *= corr;
      if (part == 0) p_w[g * SUB + r] = pr * v_scale;
    }
    __syncwarp();
    // O += P V
#pragma unroll
    for (int t = tg; t < SUB; t += NTGW) {
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        const int sl = slice + k * NSL;
        float v[4];
        if constexpr (QUANT) {
          const uint32_t word = *reinterpret_cast<const uint32_t*>(
              v_sub + (t * PCH + swizzle<PCH>(t, sl / 4)) * 16 +
              (sl % 4) * 4);
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = i8_f32(word, e);
        } else {
          const float4 vv = *reinterpret_cast<const float4*>(
              v_sub + (t * PCH + swizzle<PCH>(t, sl)) * 16);
          v[0] = vv.x;
          v[1] = vv.y;
          v[2] = vv.z;
          v[3] = vv.w;
        }
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
          const float pr = p_w[g * SUB + t];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[g][k][e] = fmaf(pr, v[e], acc[g][k][e]);
        }
      }
    }
  }

  __syncthreads();                     // every warp is done with its ring
  float* acc_w = reinterpret_cast<float*>(smem + TR::OFF_RING);
  float* m_w = reinterpret_cast<float*>(smem + TR::OFF_STAT);
  float* l_w = m_w + 4 * MAX_GROUP;
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    if (g >= rows) continue;           // the tile's padding rows
    if (lane == 0) {
      m_w[warp * GROUP + g] = m_run[g];
      l_w[warp * GROUP + g] = l_run[g];
    }
#pragma unroll
    for (int k = 0; k < SPL; ++k)
      store4(acc_w + ((warp * NTGW + tg) * GROUP + g) * D +
                 4 * (slice + k * NSL),
             acc[g][k]);
  }
  __syncthreads();
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// TILED: the group is wider than GROUP and runs as tiles in turn. The
// kernel for a group that fits one tile has no tile loop: around it the
// loop held ~40 more registers a thread, and 3 CTAs no longer fit an SM
// (a fifth slower at the 7b serving shape).
template <typename QT, typename PT, int D, int GROUP, bool TILED>
__global__ void __launch_bounds__(THREADS,
                                  Traits<QT, PT, D, GROUP>::MIN_BLOCKS)
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
  const int d = p.d, group = p.group;
  const long pair = (long)slot * p.Hkv + kvh;
  // this (slot, kv_head)'s query heads, [group][d]: head kvh * group + g of
  // the slot's H = Hkv * group
  QT* out = static_cast<QT*>(p.out) + pair * group * d;

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
      for (int i = tid; i < group * d; i += THREADS) store(out + i, 0.f);
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

  // each tile of GROUP query heads in turn: this chunk's (m, l,
  // unnormalized acc) of its heads, the output itself when the chunk is
  // the slot's only one with a visible token, else a partial
  const float* scratch = reinterpret_cast<const float*>(smem + TR::OFF_RING);
  const float* stat = reinterpret_cast<const float*>(smem + TR::OFF_STAT);
  const int live = last / CHUNK + 1;
  const long part = pair * p.chunks + chunk;
  float* part_acc = p.part_acc + part * group * D;
  float* part_ml = p.part_ml + part * group * 2;
  for (int h0 = 0; h0 < group; h0 += GROUP) {
    const int rows = TILED ? min(GROUP, group - h0) : group;
    if (h0 > 0) __syncthreads();       // the last tile's state is read
    if constexpr (TR::MMA)
      chunk_mma<QT, PT, D, GROUP>(p, smem, start, n_tok, last, page0, kvh,
                                  pair * group + h0, rows);
    else
      chunk_f32<QT, PT, D, GROUP>(p, smem, start, n_tok, last, page0, kvh,
                                  pair * group + h0, rows);
    for (int i = tid; i < rows * D; i += THREADS) {
      const int gg = i / D, col = i % D, head = h0 + gg;
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
      if (col >= d) continue;          // d_head's padding
      if (live == 1) {
        store(out + head * d + col, a / (l == 0.f ? 1.f : l));
      } else {
        part_acc[head * D + col] = a;
        if (col == 0) {
          part_ml[2 * head] = m;
          part_ml[2 * head + 1] = l;
        }
      }
    }
    if (!TILED) break;
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
  const float* acc_in = p.part_acc + pair * p.chunks * group * D;
  const float* ml_in = p.part_ml + pair * p.chunks * group * 2;
  const int quads = d / 4;
  for (int i = tid; i < group * quads; i += THREADS) {
    const int head = i / quads, c4 = i % quads;
    float m = -CUDART_INF_F, l = 0.f;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int c = 0; c < live; ++c) {
      const long row = (long)c * group + head;
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(ml_in + row * 2));
      const float4 a = __ldcg(reinterpret_cast<const float4*>(
          acc_in + row * D + 4 * c4));
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
    store4(out + head * d + 4 * c4, o);
  }
  if (tid == 0) p.tickets[pair] = 0;
}

template <typename QT, typename PT, int D, int GROUP, bool TILED = false>
int launch(const Params& p, int S, cudaStream_t stream) {
  using TR = Traits<QT, PT, D, GROUP>;
  static unsigned long long sized = 0;   // devices given the attribute
  if (TR::SMEM > 48 * 1024) {
    int device = 0;
    cudaError_t status = cudaGetDevice(&device);
    if (status != cudaSuccess) return (int)status;
    if (device >= 64 || !(sized >> device & 1)) {
      status = cudaFuncSetAttribute(
          paged_decode_split_kernel<QT, PT, D, GROUP, TILED>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, TR::SMEM);
      if (status != cudaSuccess) return (int)status;
      if (device < 64) sized |= 1ull << device;
    }
  }
  const dim3 grid(p.chunks, p.Hkv, S);
  paged_decode_split_kernel<QT, PT, D, GROUP, TILED>
      <<<grid, THREADS, TR::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

// The tile of query heads a pass: a bf16 query's tensor-core tile holds 16
// rows, 8 of them used below 9 heads (and at width 256, where 16 rows of
// accumulators would not fit); an f32 query's lanes keep every head of the
// tile in registers, a tile the group's next power of two up to 8 (4 at
// width 256: wider tiles spilled). A wider group runs as tiles in turn.
template <typename QT, typename PT, int D>
int dispatch_group(const Params& p, int S, cudaStream_t stream) {
  const int group = p.group;
  if constexpr (tensor_cores<QT, PT, D>()) {
    if (group <= 8) return launch<QT, PT, D, 8>(p, S, stream);
    if constexpr (D == 256) {
      return launch<QT, PT, D, 8, true>(p, S, stream);
    } else {
      if (group <= 16) return launch<QT, PT, D, 16>(p, S, stream);
      return launch<QT, PT, D, 16, true>(p, S, stream);
    }
  } else {
    if (group == 1) return launch<QT, PT, D, 1>(p, S, stream);
    if (group == 2) return launch<QT, PT, D, 2>(p, S, stream);
    if (group <= 4) return launch<QT, PT, D, 4>(p, S, stream);
    if constexpr (D == 256) {
      return launch<QT, PT, D, 4, true>(p, S, stream);
    } else {
      if (group <= 8) return launch<QT, PT, D, 8>(p, S, stream);
      return launch<QT, PT, D, 8, true>(p, S, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename QT, typename PT>
int dispatch_d(int D, const Params& p, int S, cudaStream_t stream) {
  switch (padded_width(D)) {
    case 16: return dispatch_group<QT, PT, 16>(p, S, stream);
    case 32: return dispatch_group<QT, PT, 32>(p, S, stream);
    case 64: return dispatch_group<QT, PT, 64>(p, S, stream);
    case 128: return dispatch_group<QT, PT, 128>(p, S, stream);
    case 256: return dispatch_group<QT, PT, 256>(p, S, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Tokens of one slot per CTA; the wrapper sizes the partials by it.
extern "C" int thp_paged_decode_chunk_tokens() { return CHUNK; }

// The padded width of d_head ``D`` (the row length of the partials), 0 for
// a width the kernel does not take.
extern "C" int thp_paged_decode_width(int D) { return padded_width(D); }

// q_dtype: 0 = float32, 1 = bfloat16 (also the output type).
// page_dtype: 0 = float32, 1 = bfloat16 (both == q_dtype), 2 = int8 (then
// k_scales/v_scales are required). D a multiple of 16 from 16 to 256; H a
// multiple of Hkv; pages 16-byte aligned, P * page_size < 2^31. ``chunks``
// must be ceil(max_pages * page_size / CHUNK); part_acc holds S * H *
// chunks * thp_paged_decode_width(D) f32, part_ml S * H * chunks * 2 f32,
// tickets S * Hkv int32, all zero before the first call (the kernel leaves
// them zero). Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int thp_paged_decode(int q_dtype, int page_dtype, const void* q,
                                const void* k_pages, const void* v_pages,
                                const void* k_scales, const void* v_scales,
                                const void* page_table, const void* positions,
                                void* out, void* part_acc, void* part_ml,
                                void* tickets, int S, int H, int Hkv, int D,
                                int P, int page_size, int max_pages,
                                int chunks, float scale, void* stream) {
  if (S < 1 || S > 65535 || Hkv < 1 || Hkv > 65535 || H % Hkv != 0 ||
      padded_width(D) == 0 || P < 1 || page_size < 1 || max_pages < 1 ||
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
  p.d = D;
  p.group = H / Hkv;
  p.scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && page_dtype == 0) return dispatch_d<float, float>(D, p, S, s);
  if (q_dtype == 1 && page_dtype == 1)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(D, p, S, s);
  if (q_dtype == 0 && quant) return dispatch_d<float, int8_t>(D, p, S, s);
  if (q_dtype == 1 && quant) return dispatch_d<__nv_bfloat16, int8_t>(D, p, S, s);
  return (int)cudaErrorInvalidValue;
}
