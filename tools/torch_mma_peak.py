#!/usr/bin/env python3
"""The card's rate for mma.sync products held in registers.

    python3 tools/torch_mma_peak.py

The port's f32 kernels run their products as mma.sync (m16n8k8 TF32, three
a product; m16n8k4 f64 for the backward's dO V^T); the card's data-sheet
rates (495 TFLOP/s TF32, 67 f64 dense) are wgmma's and the f64 pipe's.
This compiles a kernel that issues nothing but independent mma.sync
products on register operands (CHAINS accumulators a warp, WARPS warps a
CTA, 4 CTAs an SM), times it with CUDA events and prints TFLOP/s per type
and configuration: the ceiling of an mma.sync design, before loads,
softmax and barriers. bf16 m16n8k16 is printed beside. Builds into
``build/mma_peak/`` with the port's nvcc flags; needs one CUDA card.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "build" / "mma_peak"

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int KIND, int CHAINS>
__global__ void peak(float* out, int iters) {
  const uint32_t x = threadIdx.x * 2654435761u;
  float acc[CHAINS][4] = {};
  double dacc[CHAINS][4] = {};
  const uint32_t a[4] = {x, x ^ 1u, x ^ 2u, x ^ 3u};
  const uint32_t b[2] = {x ^ 5u, x ^ 7u};
  const double da = 1.0 + threadIdx.x, db = 2.0 - threadIdx.x;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      if (KIND == 0)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]),
              "+f"(acc[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      else if (KIND == 1)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]),
              "+f"(acc[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
            "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
            : "+d"(dacc[c][0]), "+d"(dacc[c][1]), "+d"(dacc[c][2]),
              "+d"(dacc[c][3])
            : "d"(da), "d"(db), "d"(da));
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum += acc[c][e] + (float)dacc[c][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

template <int KIND>
int run(int chains, float* out, int iters, int blocks, int threads,
        cudaStream_t stream) {
  if (chains == 4)
    peak<KIND, 4><<<blocks, threads, 0, stream>>>(out, iters);
  else if (chains == 8)
    peak<KIND, 8><<<blocks, threads, 0, stream>>>(out, iters);
  else
    peak<KIND, 16><<<blocks, threads, 0, stream>>>(out, iters);
  return (int)cudaGetLastError();
}

extern "C" int thp_mma_peak(int kind, int chains, float* out, int iters,
                            int blocks, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) return run<0>(chains, out, iters, blocks, threads, s);
  if (kind == 1) return run<1>(chains, out, iters, blocks, threads, s);
  return run<2>(chains, out, iters, blocks, threads, s);
}
"""

#: (name, kind, FLOPs a warp's product)
KINDS = (("tf32 m16n8k8", 0, 2 * 16 * 8 * 8),
         ("bf16 m16n8k16", 1, 2 * 16 * 8 * 16),
         ("f64 m16n8k4", 2, 2 * 16 * 8 * 4))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from tensorhive_tpu_torch.ops import cuda_build

    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "mma_peak.cu").write_text(SOURCE)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                    str(OUT / "libmma_peak.so"), str(OUT / "mma_peak.cu")],
                   check=True, capture_output=True)
    library = ctypes.CDLL(str(OUT / "libmma_peak.so"))
    library.thp_mma_peak.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p]
                                     + [ctypes.c_int] * 3
                                     + [ctypes.c_void_p])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    for name, kind, flops in KINDS:
        for warps in (2, 4, 8):
            for chains in (4, 8, 16):
                blocks, threads = 4 * sms, 32 * warps
                out = torch.empty(blocks * threads, device="cuda")
                stream = torch.cuda.current_stream().cuda_stream

                def launch():
                    status = library.thp_mma_peak(kind, chains,
                                                  out.data_ptr(), iters,
                                                  blocks, threads, stream)
                    if status:
                        raise RuntimeError(f"launch failed: {status}")

                launch()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(3):
                    launch()
                end.record()
                torch.cuda.synchronize()
                seconds = start.elapsed_time(end) / 3 / 1e3
                total = flops * chains * iters * blocks * warps
                print(f"{name}: {4 * warps} warps an SM, {chains} "
                      f"independent products a warp: "
                      f"{total / seconds / 1e12:.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
