// Paged-attention decode for Hopper (sm_90a), plain C interface.
//
// Replaces: tensorhive_tpu/ops/paged_attention.py, _decode_kernel with
// quant=False (bf16/f32 pages) and quant=True (int8 pages with one f32
// scale per (page, kv_head)), reached from paged_attention.
//
// Computes, for every slot s, one query token against that slot's KV pages
// read through its page-table row: out[s, h] = softmax_j(scale * q[s,h] .
// k[j]) v[j] over logical positions j <= positions[s], with q/out [S, H, D],
// pages [P, page_size, Hkv, D], page_table [S, max_pages] int32, positions
// [S] int32 and (int8 only) scales [P, Hkv] f32. GQA: query head h reads
// KV head h / (H / Hkv).
//
// Bound on an H100 SXM (3.35 TB/s): bytes. A decode step reads every live
// page of every slot once (payload, plus the two scale rows for int8) and
// does ~4 FLOPs per byte — far below the ~295 FLOPs/byte where the tensor
// cores would become the limit.
//
// Design (splitting one slot over several CTAs — flash-decoding — is later
// work):
// * One CTA of 512 threads per (slot, kv_head); its H/Hkv query heads
//   (1, 2, 4 or 8: a template parameter) share every K/V row load. The
//   slot's live page-table entries are staged in shared memory once.
// * The CTA is cut into sub-warps of D/4 lanes; a sub-warp owns one token
//   row at a time, each lane four of its columns, loaded straight from the
//   page with one vector load (no shared-memory staging, no barrier inside
//   the loop). Sub-warps stride over the tokens 0..position, UNROLL rows
//   per iteration so several row loads are in flight.
// * The CTA reads positions[s] and page_table[s, t / page_size] itself,
//   for tokens t <= position only: pages past the live window (trash or
//   unassigned entries) are never read. A parked slot (position 0, a row
//   of trash pages) reads token 0 of the trash page and produces finite
//   garbage; a page id outside [0, P) is skipped, never dereferenced.
// * int8 rows are dequantized with scale[phys, kv_head] of the page the
//   row came from. Every product and the softmax statistics are f32 (as the
//   TPU kernel's int8 variant computes them; bf16 inputs are exact in f32).
// * Each sub-warp keeps its own online softmax (max, sum, accumulator in
//   registers); one shared-memory merge at the end combines them. A zero
//   row sum divides by 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int VEC = 4;          // columns per lane
constexpr int UNROLL = 4;       // token rows per sub-warp per iteration
constexpr int MAX_GROUP = 8;    // query heads per kv head
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float* out) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D, int GROUP>
size_t smem_bytes(int max_pages) {
  constexpr int NSUB = THREADS / (D / VEC);
  return sizeof(float) * ((size_t)NSUB * GROUP * (D + 2) + 2 * GROUP) +
         sizeof(int) * (size_t)max_pages;
}

template <typename QT, typename PT, int D, int GROUP>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const QT* __restrict__ q, const PT* __restrict__ k_pages,
                    const PT* __restrict__ v_pages,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ page_table,
                    const int* __restrict__ positions, QT* __restrict__ out,
                    int H, int Hkv, int P, int page_size, int max_pages,
                    float scale) {
  constexpr int ROW_LANES = D / VEC;          // lanes per token row
  constexpr int NSUB = THREADS / ROW_LANES;   // sub-warps per CTA
  const int slot = blockIdx.x;
  const int kvh = blockIdx.y;
  constexpr int group = GROUP;             // query heads per kv head
  const int tid = threadIdx.x;
  const int sub = tid / ROW_LANES;
  const int lane = tid % ROW_LANES;
  const int col = lane * VEC;
  const long head0 = (long)slot * H + (long)kvh * group;
  const long row_stride = (long)Hkv * D;
  const bool quant = k_scales != nullptr;

  float qv[GROUP][VEC];
  float acc[GROUP][VEC];
  float m[GROUP], l[GROUP];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[g][c] = 0.f;
    load4(q + (head0 + g) * D + col, qv[g]);
  }

  extern __shared__ float smem[];
  int* table_s = reinterpret_cast<int*>(smem);  // this slot's live entries
  const int position = positions[slot];
  const int last = min(position, max_pages * page_size - 1);
  for (int j = tid; j <= last / page_size; j += THREADS)
    table_s[j] = page_table[(long)slot * max_pages + j];
  __syncthreads();
  // uniform trip count: every sub-warp runs every iteration, so the
  // segmented shuffles below always have all lanes of the warp present
  const int per_iter = NSUB * UNROLL;
  const int iters = last < 0 ? 0 : (last + per_iter) / per_iter;
  for (int it = 0; it < iters; ++it) {
    float kr[UNROLL][VEC], vr[UNROLL][VEC];
    float k_scale[UNROLL], v_scale[UNROLL];
    bool valid[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = (it * UNROLL + u) * NSUB + sub;
      int phys = -1;
      if (t <= last) phys = table_s[t / page_size];
      valid[u] = phys >= 0 && phys < P;
      k_scale[u] = v_scale[u] = 1.f;
      if (valid[u]) {
        const long offset = ((long)phys * page_size + t % page_size) *
                                row_stride + (long)kvh * D + col;
        load4(k_pages + offset, kr[u]);
        load4(v_pages + offset, vr[u]);
        if (quant) {
          k_scale[u] = k_scales[(long)phys * Hkv + kvh];
          v_scale[u] = v_scales[(long)phys * Hkv + kvh];
        }
      } else {
#pragma unroll
        for (int c = 0; c < VEC; ++c) kr[u][c] = vr[u][c] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      float s[UNROLL];
      float block_max = NEG_INF;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < VEC; ++c) dot = fmaf(qv[g][c], kr[u][c], dot);
#pragma unroll
        for (int off = ROW_LANES / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[u] = dot * k_scale[u] * scale;
        if (valid[u]) block_max = fmaxf(block_max, s[u]);
      }
      const float m_new = fmaxf(m[g], block_max);
      const float correction = expf(m[g] - m_new);
      l[g] *= correction;
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[g][c] *= correction;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float p = valid[u] ? expf(s[u] - m_new) : 0.f;
        l[g] += p;
        const float pv = p * v_scale[u];
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[g][c] = fmaf(pv, vr[u][c], acc[g][c]);
      }
      m[g] = m_new;
    }
  }

  // merge the sub-warps' online softmax states
  float* acc_s = smem + max_pages;              // [NSUB][group][D]
  float* m_s = acc_s + NSUB * group * D;        // [NSUB][group]
  float* l_s = m_s + NSUB * group;              // [NSUB][group]
  float* max_s = l_s + NSUB * group;            // [group]
  float* sum_s = max_s + group;                 // [group]
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc_s[(sub * group + g) * D + col + c] =
        acc[g][c];
    if (lane == 0) {
      m_s[sub * group + g] = m[g];
      l_s[sub * group + g] = l[g];
    }
  }
  __syncthreads();
  for (int g = tid; g < group; g += THREADS) {
    float total_max = NEG_INF;
    for (int s = 0; s < NSUB; ++s) total_max = fmaxf(total_max, m_s[s * group + g]);
    float total = 0.f;
    for (int s = 0; s < NSUB; ++s) {
      const float w = expf(m_s[s * group + g] - total_max);
      m_s[s * group + g] = w;                   // now the sub-warp's weight
      total += l_s[s * group + g] * w;
    }
    max_s[g] = total_max;
    sum_s[g] = total == 0.f ? 1.f : total;
  }
  __syncthreads();
  for (int i = tid; i < group * D; i += THREADS) {
    const int g = i / D, c = i % D;
    float o = 0.f;
    for (int s = 0; s < NSUB; ++s)
      o = fmaf(acc_s[(s * group + g) * D + c], m_s[s * group + g], o);
    store(out + head0 * D + i, o / sum_s[g]);
  }
}

template <typename QT, typename PT, int D, int GROUP>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales, const void* page_table,
           const void* positions, void* out, int S, int H, int Hkv, int P,
           int page_size, int max_pages, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D, GROUP>(max_pages);
  if (smem > 48 * 1024) {
    cudaError_t status = cudaFuncSetAttribute(
        paged_decode_kernel<QT, PT, D, GROUP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (status != cudaSuccess) return (int)status;
  }
  const dim3 grid(S, Hkv);
  paged_decode_kernel<QT, PT, D, GROUP><<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(k_pages),
      static_cast<const PT*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales),
      static_cast<const int*>(page_table), static_cast<const int*>(positions),
      static_cast<QT*>(out), H, Hkv, P, page_size, max_pages, scale);
  return (int)cudaGetLastError();
}

template <typename QT, typename PT, int D>
int dispatch_group(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scales, const void* v_scales,
                   const void* page_table, const void* positions, void* out,
                   int S, int H, int Hkv, int P, int page_size, int max_pages,
                   float scale, cudaStream_t stream) {
#define THP_CASE(G)                                                          \
  case G:                                                                    \
    return launch<QT, PT, D, G>(q, k_pages, v_pages, k_scales, v_scales,     \
                                page_table, positions, out, S, H, Hkv, P,    \
                                page_size, max_pages, scale, stream);
  switch (H / Hkv) {
    THP_CASE(1)
    THP_CASE(2)
    THP_CASE(4)
    THP_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef THP_CASE
}

template <typename QT, typename PT>
int dispatch_d(int D, const void* q, const void* k_pages, const void* v_pages,
               const void* k_scales, const void* v_scales,
               const void* page_table, const void* positions, void* out, int S,
               int H, int Hkv, int P, int page_size, int max_pages,
               float scale, cudaStream_t stream) {
#define THP_CASE(DIM)                                                      \
  case DIM:                                                                \
    return dispatch_group<QT, PT, DIM>(q, k_pages, v_pages, k_scales,      \
                                       v_scales, page_table, positions,    \
                                       out, S, H, Hkv, P, page_size,       \
                                       max_pages, scale, stream);
  switch (D) {
    THP_CASE(16)
    THP_CASE(32)
    THP_CASE(64)
    THP_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef THP_CASE
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (also the output type).
// page_dtype: 0 = float32, 1 = bfloat16 (both == q_dtype), 2 = int8 (then
// k_scales/v_scales are required). D in {16, 32, 64, 128}; H / Hkv in
// {1, 2, 4, 8}.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int thp_paged_decode(int q_dtype, int page_dtype, const void* q,
                                const void* k_pages, const void* v_pages,
                                const void* k_scales, const void* v_scales,
                                const void* page_table, const void* positions,
                                void* out, int S, int H, int Hkv, int D, int P,
                                int page_size, int max_pages, float scale,
                                void* stream) {
  if (S < 1 || Hkv < 1 || Hkv > 65535 || H % Hkv != 0 ||
      H / Hkv > MAX_GROUP || P < 1 || page_size < 1 || max_pages < 1)
    return (int)cudaErrorInvalidValue;
  const bool quant = page_dtype == 2;
  if (quant != (k_scales != nullptr && v_scales != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define THP_LAUNCH(QT, PT)                                                 \
  dispatch_d<QT, PT>(D, q, k_pages, v_pages, k_scales, v_scales,          \
                     page_table, positions, out, S, H, Hkv, P, page_size, \
                     max_pages, scale, s)
  if (q_dtype == 0 && page_dtype == 0) return THP_LAUNCH(float, float);
  if (q_dtype == 1 && page_dtype == 1)
    return THP_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == 0 && quant) return THP_LAUNCH(float, int8_t);
  if (q_dtype == 1 && quant) return THP_LAUNCH(__nv_bfloat16, int8_t);
#undef THP_LAUNCH
  return (int)cudaErrorInvalidValue;
}
