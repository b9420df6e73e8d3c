#!/usr/bin/env python3
"""Time the main path's kernels of this checkout and another one in turns.

    python3 tools/torch_kernel_turns.py <path of another checkout>

Builds the kernels of both checkouts (each into its own ``build/``, in
parallel), then times each checkout's paged decode (bf16, f32 and int8
pages, int8 under a bf16 query; cold L2) and bf16 flash forward at the 7b
serving shapes (``chip_smoke.py``'s ``PAGED_SERVING`` and S 4095, H 32, Hkv
8, d 128) and its bf16 flash backward at the t2t-base training shape with
that checkout's own ``chip_smoke.py`` helpers, in turns: other, this, this,
other. Each turn is a process of its own, so each imports only its
checkout's modules. A change to a kernel is held to its parent only inside
one such call, on one card, whose name and power limit the first line
prints. Needs one CUDA card.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

#: one turn: build (a no-op once built) and time, from the checkout in argv
TURN = r"""
import os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as c
from tensorhive_tpu_torch.ops import cuda_build
cuda_build.build(("flash_fwd", "flash_bwd", "paged_decode"))
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
label = sys.argv[1]
for variant in ("bf16", "f32", "int8", "int8/bf16q"):
    row = c.paged_case(variant, gen, *c.PAGED_SERVING)
    print(f"TURN {label} paged_decode {variant} {row['ms']:.4f}", flush=True)
row = c.flash_case(1, 4095, 32, 8, 128, "bf16", gen)
print(f"TURN {label} flash_fwd bf16 {row['ms']:.4f}", flush=True)
row = c.flash_backward_case(*c.BACKWARD_SHAPES[0], "bf16", gen)
print(f"TURN {label} flash_bwd bf16 {row['ms']:.4f}", flush=True)
"""

BUILD = ("from tensorhive_tpu_torch.ops import cuda_build; "
         "cuda_build.build(('flash_fwd', 'flash_bwd', 'paged_decode'))")


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    trees = {"other": other, "this": REPO}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True)
    print(card.stdout.strip().splitlines()[0] if card.returncode == 0
          else f"nvidia-smi failed: {card.stderr.strip()}", flush=True)
    builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=tree)
              for tree in trees.values()]
    if any(build.wait() for build in builds):
        print("a build failed", file=sys.stderr)
        return 1
    times = {}
    for label in ("other", "this", "this", "other"):
        done = subprocess.run([sys.executable, "-c", TURN, label],
                              cwd=trees[label], capture_output=True,
                              text=True)
        if done.returncode:
            print(done.stdout[-3000:], done.stderr[-3000:], file=sys.stderr)
            return 1
        for line in done.stdout.splitlines():
            if line.startswith("TURN "):
                _, who, kernel, variant, ms = line.split()
                times.setdefault((kernel, variant), {}).setdefault(
                    who, []).append(float(ms))
                print(line[5:], flush=True)
    print("kernel variant: other ms (turns) | this ms (turns) | this / other")
    for (kernel, variant), by in times.items():
        ratio = sum(by["this"]) / sum(by["other"])
        print(f"{kernel} {variant}: {by['other']} | {by['this']} | "
              f"{ratio:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
