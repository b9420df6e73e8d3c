#!/usr/bin/env python3
"""Hold the port's flash backward kernels bitwise to another checkout's.

    python3 tools/torch_compare_backward.py <path of another checkout>

Builds ``csrc/flash_bwd.cu`` of this checkout and of the other one (each
into its own ``build/``), then runs both libraries through this checkout's
``flash_attention_backward`` on the same inputs (q, k, v, dO drawn from a
seed; O and LSE from this checkout's forward; the same delta) and compares
dq, dk and dv bit for bit, f32 and bf16, over the chip_smoke backward
shapes and a grid of head dims, GQA groups and ragged lengths. A change
that only moves code between the kernels' sources must leave every bit in
place. Needs one CUDA card; exits 1 on any difference.
"""
from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

#: (batch, seq, heads, kv_heads, d, causal): chip_smoke's backward shapes
#: (t2t-base, t2t-big, 7b heads, ragged 4095, the encoder's non-causal),
#: then every head dim with GQA and ragged lengths
SHAPES = ((64, 1024, 8, 8, 64, True), (8, 4096, 16, 16, 64, True),
          (1, 4096, 32, 8, 128, True), (1, 4095, 32, 8, 128, True),
          (64, 1024, 8, 8, 64, False), (2, 1000, 8, 2, 16, True),
          (2, 255, 4, 1, 32, False), (2, 129, 8, 2, 64, True),
          (2, 1000, 8, 4, 128, False), (2, 1, 4, 4, 64, True))


def other_library(checkout: Path) -> ctypes.CDLL:
    """The other checkout's flash_bwd library, built by its own
    ``cuda_build``."""
    spec = importlib.util.spec_from_file_location(
        "other_cuda_build",
        checkout / "tensorhive_tpu_torch" / "ops" / "cuda_build.py")
    other_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other_build)
    other_build.build(["flash_bwd"])
    library = ctypes.CDLL(str(other_build.library_path("flash_bwd")))
    function = library.thp_flash_bwd
    function.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                         + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                 ctypes.c_void_p])
    function.restype = ctypes.c_int
    return library


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from tensorhive_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    mine = fa._bwd_library()
    other = other_library(Path(sys.argv[1]).resolve())
    generator = torch.Generator(device="cuda").manual_seed(0)
    differing = 0
    for dtype in (torch.float32, torch.bfloat16):
        for batch, seq, heads, kv_heads, d, causal in SHAPES:
            def draw(h):
                return torch.randn((batch, seq, h, d), generator=generator,
                                   device="cuda").to(dtype)

            q, k, v, do = draw(heads), draw(kv_heads), draw(kv_heads), draw(
                heads)
            out, lse = fa.flash_attention(q, k, v, causal=causal,
                                          return_lse=True)
            delta = fa.flash_bwd_delta(do, out)
            grads = {}
            for name, library in (("this", mine), ("other", other)):
                fa._bwd_library = lambda library=library: library
                grads[name] = fa.flash_attention_backward(
                    q, k, v, out, lse, do, causal=causal, delta=delta)
            torch.cuda.synchronize()
            counts = [int((a.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32)
                           != b.view(torch.int16 if dtype == torch.bfloat16
                                     else torch.int32)).sum().item())
                      for a, b in zip(grads["this"], grads["other"])]
            differing += sum(counts)
            print(f"{str(dtype)[6:]} B={batch} S={seq} H={heads} "
                  f"Hkv={kv_heads} d={d} {'causal' if causal else 'non-causal'}"
                  f": differing elements dq {counts[0]}, dk {counts[1]}, "
                  f"dv {counts[2]} of {q.numel()}, {k.numel()}, "
                  f"{v.numel()}")
            del grads
            torch.cuda.empty_cache()
    print(f"backward kernels bitwise equal: {differing == 0}")
    return 0 if differing == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
