#!/usr/bin/env python3
"""Time the design choices of the port's f32 flash forward on the card.

    python3 tools/torch_fwd_f32_variants.py [variant ...]

Each variant is ``csrc/flash_fwd.cu`` with a few lines replaced (the
substitutions below must match the source as it is; a variant whose text
is gone fails loudly). All are compiled with the port's nvcc flags, one
nvcc each in parallel, into ``build/variants/``, and run through
``flash_attention`` on the same inputs: first a check against the plain
version (1e-5 abs) and the f64 measure (no O row further from the f64
evaluation than the plain f32 version's by more than 2e-5 of the row, also
with q x 4), then CUDA-event times at the main paths' shapes, the variants
timed in turns (forward order, then reversed; the lower time of the two is
printed). ptxas spills are reported per variant. Needs one CUDA card.

  base     the source as it is
  kg2      score short sums of 2 k-steps (the backward's SCORE_KSTEPS; 4)
  s16      d_head 128: 16 keys a stage in 4 stages (32 in 2)
  expf     p = expf(x - m) of x = s * scale, as the plain version rounds
           (ex2.approx with log2(e) folded into the score scale)
  lds128   the first design's P V: output columns permuted so that one
           16-byte shared load brings four n-tiles' B fragments, short sums
           over 32 keys (the backward's accumulate_3xtf32: a 4-byte load
           per fragment word, one short sum per stage)
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "tensorhive_tpu_torch" / "csrc"
OUT = REPO / "build" / "variants"

#: the P V of the first design: the output columns permuted so that one
#: 16-byte shared load brings four n-tiles' B fragments (lane g's columns
#: of n-tile 4i + c are 32i + 4g + c), short sums over 32 keys
_FWD_PV = r"""constexpr int PV_KEYS = 32;

// N 32-bit words of shared memory at ``addr`` (16- or 8-byte aligned).
// Volatile, as the products are: they stay in the order written.
__device__ __forceinline__ void lds_vec(uint32_t (&x)[4], uint32_t addr) {
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(addr));
}

__device__ __forceinline__ void lds_vec(uint32_t (&x)[2], uint32_t addr) {
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n"
               : "=r"(x[0]), "=r"(x[1]) : "r"(addr));
}

// acc (16 x D) += P V over the STREAM keys of a stage: P (16 x STREAM) in
// the score registers, V the split tile at ``v_tile`` (its lo LO bytes
// on). n-tile 4i + c of acc holds, for lane g, column 32i + 4g + c of O
// (d_head 16: n-tile n, column 2g + n): the B fragments of NG n-tiles are
// one NG-word load (row 8j + 2t + e, those columns), hi and lo.
template <int D, int STREAM, uint32_t LO>
__device__ __forceinline__ void fwd_pv(float (&acc)[D / 8][4],
                                       const float (&p)[STREAM / 8][4],
                                       uint32_t v_tile, int g, int t4) {
  constexpr int NG = D >= 32 ? 4 : 2;              // n-tiles a load
  constexpr uint32_t ROW8 = 8 * (D >= 32 ? 128 : 64);
  constexpr int JG = (PV_KEYS < STREAM ? PV_KEYS : STREAM) / 8;  // a sum
  static_assert(STREAM % (8 * JG) == 0, "whole short sums in a stage");
  uint32_t a_hi[STREAM / 8][4], a_lo[STREAM / 8][4];
#pragma unroll
  for (int j = 0; j < STREAM / 8; ++j) {
    const uint32_t a[4] = {__float_as_uint(p[j][0]), __float_as_uint(p[j][2]),
                           __float_as_uint(p[j][1]), __float_as_uint(p[j][3])};
    split_tf32(a, a_hi[j], a_lo[j]);
  }
  uint32_t row[2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
    row[e] = v_tile +
             f32_offset<D, STREAM>(2 * t4 + e, D >= 32 ? 4 * g : 2 * g);
#pragma unroll
  for (int j0 = 0; j0 < STREAM / 8; j0 += JG)
#pragma unroll
    for (int grp = 0; grp < D / 8 / NG; ++grp) {
      float part[NG][4];
#pragma unroll
      for (int j = j0; j < j0 + JG; ++j) {
        uint32_t ah[NG][4], al[NG][4], b_hi[NG][2], b_lo[NG][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint32_t at = row[e] + j * ROW8 + grp * STREAM * 128;
          uint32_t hi[NG], lo[NG];
          lds_vec(hi, at);
          lds_vec(lo, at + LO);
#pragma unroll
          for (int c = 0; c < NG; ++c) b_hi[c][e] = hi[c], b_lo[c][e] = lo[c];
        }
#pragma unroll
        for (int c = 0; c < NG; ++c)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            ah[c][x] = a_hi[j][x], al[c][x] = a_lo[j][x];
        if (j == j0)
          mma_3xtf32<NG>(part, ah, al, b_hi, b_lo);
        else
          mma_3xtf32<NG, true>(part, ah, al, b_hi, b_lo);
      }
#pragma unroll
      for (int c = 0; c < NG; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[grp * NG + c][e] += part[c][e];
    }
}

"""
_ACCUMULATE = """          float (*const out[1])[4] = {acc};
          const float (*const in[1])[4] = {s};
          const uint32_t v_tile[1] = {kt + 2 * T::TILE_BYTES};
          accumulate_3xtf32<D, SB, T::LO, 1>(out, in, v_tile, g, t4);"""
_EPILOGUE = """        float* const out =
            o + (((long)b * S + qpos[r]) * H + h) * D + 2 * t4;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<float2*>(out + 8 * n) = make_float2(
              acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom);"""
_PERMUTED_EPILOGUE = """\
        float* const out = o + (((long)b * S + qpos[r]) * H + h) * D;
        if constexpr (D >= 32) {
#pragma unroll
          for (int grp = 0; grp < D / 32; ++grp)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              *reinterpret_cast<float4*>(out + 32 * grp + 8 * t4 + 4 * e) =
                  make_float4(acc[4 * grp][2 * r + e] / denom,
                              acc[4 * grp + 1][2 * r + e] / denom,
                              acc[4 * grp + 2][2 * r + e] / denom,
                              acc[4 * grp + 3][2 * r + e] / denom);
        } else {
          *reinterpret_cast<float4*>(out + 4 * t4) = make_float4(
              acc[0][2 * r] / denom, acc[1][2 * r] / denom,
              acc[0][2 * r + 1] / denom, acc[1][2 * r + 1] / denom);
        }"""
_CTA = "// One CTA of the f32 forward: the ROWS-row q tile"

VARIANTS = {
    "base": [],
    "kg2": [("constexpr int KG = D >= 64 ? 4 : 2;",
             "constexpr int KG = 2;")],
    "s16": [("static constexpr int STREAM = D == 128 || D == 16 ? 32 : 64;",
             "static constexpr int STREAM = D == 128 ? 16 : D == 16 ? 32 : "
             "64;"),
            ("static constexpr int STAGES = D == 128 ? 2 : D == 64 ? 3 : 4;",
             "static constexpr int STAGES = D == 64 ? 3 : 4;")],
    "expf": [("            correction[r] = exp2_approx(m[r] - m_new);",
              "            correction[r] = expf(m[r] - m_new);"),
             ("? 0.f\n                                                : "
              "exp2_approx(x - m_new);",
              "? 0.f\n                                                : "
              "expf(x - m_new);"),
             ("acc[n][2 * r + 1] / denom);\n        if (t4 == 0) "
              "lse[(long)bh * S + qpos[r]] = m[r] * LN2 + logf(denom);",
              "acc[n][2 * r + 1] / denom);\n        if (t4 == 0) "
              "lse[(long)bh * S + qpos[r]] = m[r] + logf(denom);"),
             ("const float scale_log2 = scale * LOG2E;\n  cudaError_t "
              "status;\n  if (G == 0) {\n    status = cudaFuncSetAttribute("
              "flash_fwd_f32_kernel",
              "const float scale_log2 = scale;\n  cudaError_t status;\n  "
              "if (G == 0) {\n    status = cudaFuncSetAttribute("
              "flash_fwd_f32_kernel")],
    "lds128": [(_CTA, _FWD_PV + _CTA),
               (_ACCUMULATE,
                "          fwd_pv<D, SB, T::LO>(acc, s, "
                "kt + 2 * T::TILE_BYTES, g, t4);"),
               (_EPILOGUE, _PERMUTED_EPILOGUE)],
}

#: (batch, seq, heads, kv_heads, d, causal, G): the 7b prefill bucket and
#: a long S (K1/K2), the encoder's attention at G 4, causal or not, and
#: t2t-big's (K3)
SHAPES = ((1, 4095, 32, 8, 128, True, 1), (1, 16384, 4, 1, 128, True, 1),
          (64, 1024, 8, 8, 64, False, 4), (64, 1024, 8, 8, 64, True, 4),
          (8, 4096, 16, 16, 64, False, 4))
#: (batch, seq, heads, kv_heads, d, causal, q scale) of the checks
CHECKS = ((1, 4095, 32, 8, 128, True, 1.0), (2, 1000, 8, 2, 64, True, 4.0),
          (2, 1000, 8, 2, 128, True, 4.0), (2, 200, 4, 2, 16, False, 1.0),
          (2, 129, 4, 1, 32, True, 1.0), (8, 1024, 8, 8, 64, False, 1.0))


def build(names):
    """{name: (library, spill report)} of every variant that compiles."""
    sys.path.insert(0, str(REPO))
    from tensorhive_tpu_torch.ops import cuda_build

    started = {}
    for name in names:
        folder = OUT / name
        shutil.rmtree(folder, ignore_errors=True)
        shutil.copytree(CSRC, folder)
        source = folder / "flash_fwd.cu"
        text = source.read_text()
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the source holds {old[:60]!r} "
                                 f"{text.count(old)} times, not once")
            text = text.replace(old, new)
        source.write_text(text)
        command = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                   str(folder / "lib.so"), str(source)]
        started[name] = subprocess.Popen(command, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, process in started.items():
        output, _ = process.communicate()
        if process.returncode:
            print(f"{name}: build failed\n{output[-3000:]}")
            continue
        spills, kernel = [], "?"
        for line in output.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            spilled = re.search(r"(\d+) bytes spill stores", line)
            if entry:
                kernel = entry.group(1)
            elif spilled and int(spilled.group(1)) and "f32" in kernel:
                spills.append(f"{kernel[-40:]}: {line.strip()}")
        library = ctypes.CDLL(str(OUT / name / "lib.so"))
        library.thp_flash_fwd.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_void_p])
        library.thp_flash_fwd.restype = ctypes.c_int
        library.thp_flash_fwd_bh.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        library.thp_flash_fwd_bh.restype = ctypes.c_int
        built[name] = (library, spills)
    return built


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    names = sys.argv[1:] or list(VARIANTS)
    built = build(names)
    from tensorhive_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    generator = torch.Generator(device="cuda").manual_seed(0)

    def draw(batch, seq, heads, kv_heads, d):
        return [torch.randn((batch, seq, h, d), generator=generator,
                            device="cuda") for h in (heads, kv_heads, kv_heads)]

    def excess(out, plain, exact):
        error = (out.double() - exact).norm(dim=-1)
        own = (plain.double() - exact).norm(dim=-1)
        return ((error - own) / exact.norm(dim=-1)).max().item()

    checks = []
    for batch, seq, heads, kv_heads, d, causal, q_scale in CHECKS:
        q, k, v = draw(batch, seq, heads, kv_heads, d)
        q = q * q_scale
        plain = fa.reference_attention(q, k, v, causal=causal)
        exact = torch.cat([fa.reference_attention(
            q[b:b + 1].double(), k[b:b + 1].double(), v[b:b + 1].double(),
            causal=causal) for b in range(batch)])
        checks.append(((seq, d, causal, q_scale), (q, k, v), plain, exact))
    for name, (library, spills) in built.items():
        fa._library = lambda library=library: library
        parts = []
        for (seq, d, causal, q_scale), (q, k, v), plain, exact in checks:
            out = fa.flash_attention(q, k, v, causal=causal)
            parts.append(f"S {seq} d {d} q x {q_scale:g}: |O - plain| "
                         f"{(out - plain).abs().max().item():.2e}, excess "
                         f"{excess(out, plain, exact):.2e}")
        print(f"{name}: spills {spills or 'none'}; " + "; ".join(parts))
    del checks
    data = {shape: draw(*shape[:5]) for shape in SHAPES}
    times = {name: {} for name in built}
    for order in (list(built), list(built)[::-1]):
        for name in order:
            fa._library = lambda library=built[name][0]: library
            for shape, (q, k, v) in data.items():
                def run():
                    fa.flash_attention(q, k, v, causal=shape[5],
                                       bh_block=shape[6])
                run()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(5):
                    run()
                end.record()
                torch.cuda.synchronize()
                times[name].setdefault(shape, []).append(
                    start.elapsed_time(end) / 5)
    for name, rows in times.items():
        print(f"{name}: " + "; ".join(
            f"B {s[0]} S {s[1]} H {s[2]} Hkv {s[3]} d {s[4]} "
            f"{'causal' if s[5] else 'non-causal'} G {s[6]} {min(t):.4f} ms"
            for s, t in rows.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
