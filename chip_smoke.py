#!/usr/bin/env python3
"""Drive tensorhive_tpu_torch — the PyTorch + CUDA port — on one NVIDIA
H100 and check it end to end.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card of compute capability 9.0 and builds the kernels itself (nvcc,
into build/tensorhive_tpu_torch/). Phases, each fatal on failure:

1. device   — CUDA sm_90 present; prints the card's name and power limit.
2. build    — the three kernel libraries compiled from csrc/, one nvcc
              each, in parallel; ptxas registers/spills per kernel and the
              flash forward's dynamic shared memory per d_head; the
              SASS of the bf16 flash forward and of both bf16 backward
              kernels (dQ, dK/dV) at d_head 64/128 must hold wgmma (HGMMA)
              and TMA loads (UTMALDG), that of both f32 forward kernels
              (per-head, head-blocked) and both f32 backward kernels at
              every d_head TF32 mma.sync (HMMA.1688.F32.TF32) and TMA loads,
              and ptxas must report neither spills nor a performance loss
              (serialized wgmma) for them, nor a spill in any paged-decode
              kernel.
3. kernels  — every kernel variant against its plain PyTorch version at
              the main paths' shapes (serving: 7b heads, H 32, Hkv 8,
              d 128, and a long S 16384; training: the t2t-base forward
              (B 64, S 1024, H 8, d 64), the t2t-base and t2t-big
              attention, the 7b heads and a ragged S 4095 for the flash
              backward, and the encoder's non-causal backward; the
              head-blocked forward at the encoder's t2t-base attention, G
              2/4/8, causal or not, t2t-big's at G 4 and a ragged S 1000,
              also against the per-head kernel on the same input, which it
              must equal bitwise; paged decode at the serving shape and in a
              sweep of 1, 8 and 32 slots at position 4095, page 16, and 8
              slots at page 64, timed with a cold L2 and, warm, in a CUDA
              graph), timed beside its bound and, for flash,
              PyTorch's scaled_dot_product_attention and its backward
              (timed here only; SDPA's f32 outputs and gradients also held
              to the f64 evaluation by the kernel's measure, reported only);
              forward and backward lines add TFLOP/s, the share of the
              bound and the time over SDPA's. Every f32 forward and backward
              row is also held to the plain version evaluated in f64, and a
              large-score control (q x 4) must pass that measure while the
              plain version with single-pass TF32 matmuls fails it.
4. model    — a 2-layer model at 7b widths in f32: logits on the card
              (flash kernel) against the CPU (plain reference).
5. training — the training path, train_loop / make_train_step with the
              flash forward and backward kernels: a 2-layer t2t-base-width
              f32 model, 3 steps on the card against the same steps on the
              CPU; t2t-base at b64 x s1024 (remat off) and t2t-big at
              b8 x s4096 (remat "mlp"), bf16 compute on f32 masters, on a
              fixed batch whose loss must fall; launch counters exact
              (flash forward = layers x steps, twice under "block" remat;
              backward = layers x steps); a torch.profiler window over two
              t2t-base steps (device time by kind of kernel, busy share).
6. families — the MLM encoder and LoRA: the t2t-base encoder at b64 x
              s1024 (remat off, head-blocked flash forward at G 4) fed by
              fake token shards -> TokenDataset -> prefetch_to_device,
              masked anew each step, 20 steps whose masked loss must fall,
              then mlm_evaluate over two prefetched batches and a profiler
              window; the encoder in f32, 2 layers, card vs CPU; LoRA
              rank 8 on wq/wv over the full 7b preset (frozen bf16 base)
              at b4 x s2048, 8 steps whose loss must fall, the base
              bitwise unchanged, then merge and 8 greedy tokens from the
              merged tree. Launch counters exact as in training (the
              encoder's forward is the head-blocked kernel, "bh_bf16").
7. serving  — the main path: the full 7b preset served through
              build_engine -> SlotEngine.submit -> step/pump -> result.
              With whole-prompt prefill (prefix_cache="off"): int8 pages,
              then bf16 pages, then the f32 model with f32 pages; launch
              counters must equal layers x prefills and layers x decode
              steps exactly, and each join tick is timed. Then the
              default engine (int8 pages, prefix cache with chunks of
              256) on shared-system-prompt traffic: a 2,048-token prompt
              P warmed, then P + 1/17/300/1,000, the warm prompt again, a
              mid-page divergence and a 3,000-token miss, one join per
              tick; 6 hits and 2 misses, the chunk count the page rule
              gives, no flash launch, paged launches = layers x step
              dispatches, no leaked page; TTFT of hits and misses, the
              longest tick with a chunk against the longest whole-prompt
              join tick; the same on bf16 pages. Then KV-page tiering
              (int8 pages, chunks of 256, 1 GiB of host RAM, a 340-page
              pool): P + 17 missed, then hit on the device (tokens T),
              two 3,000-token misses that push P's 129 cached pages out
              to the host, two background requests decoding while P + 17
              comes back as a host hit, and P + 17 again; the host hit's
              and the last hit's tokens must be T, the promoted pages
              byte-identical to a snapshot taken before the churn, 129
              promotions with no recompute fallback, no leaked page, the
              stats' host keys equal to the counters; TTFT of the miss and
              the hits, the tier's copies timed (copy stream, CUDA
              events; the lane's jobs), and the ticks with the promotion
              in flight against the ticks around them. On that engine, a
              0.3 s deadline must end a 3,000-token miss mid-prefill
              with no page leaked, and an injected step fault must raise
              out of step() once, the next ticks giving the unfaulted
              run's tokens. Then the contiguous
              layout (bf16 rows): flash launches = layers x prefills, no
              paged launch. Then 3,000 positions of K/V written in chunks
              of 256 against the whole-prompt prefill (2-layer 7b widths,
              f32): every row within 1e-5. Every run so far pins
              speculative="off". Then the speculative lane (spec_tokens
              4): f32 weights and pages with the 16-layer self-draft and
              with an independent 1b draft, each token-identical to the
              spec-off f32 run (on a mismatch the first divergence and the
              target's top-2 logit gap there are printed first); bf16
              pages with the self-draft (agreement informational); the
              default engine, speculative="auto" -> on, on the shared-
              system-prompt traffic with the same hit, miss and chunk
              checks; flash launches = (layers + draft layers) x
              prefills, paged = draft layers x 3 draft steps x draft
              dispatches; then the
              spec-off f32 and default engines again, so spec-on and
              spec-off are timed in turns. torch.profiler windows over
              three decode steps (device busy share), three ticks that
              each run a chunk and a decode step, and three speculative
              ticks of the default engine close the phase.
8. service  — the serving daemon: GenerationService (built from a port
              Config: the full 7b preset, the default engine, speculative
              off, the flight recorder and the tenant meter on, a 20 ms
              pump tick) on its own thread, serving 8 prompts of 17-3,000
              tokens with no shared prefix (32 new tokens each) from 4
              client threads with their own user keys. Each stream must
              equal a bare engine's tokens for that prompt alone; paged
              decode launches = layers x step dispatches and no flash
              launch; one completed ledger row per request with its phases
              in order, and spans carrying its id; every engine family of
              the registry (parse_rendered) equal to stats() and the
              engine's counters; the tenants' device-seconds = the
              engine's busySlotSeconds; the flight recorder's ticks summing
              to the engine's counters; the telemetry drop file's bytes in
              use = torch.cuda.memory_allocated (idle). Then decode ticks
              with the recorder and meter on and off in turns; a fatal
              step fault through the fault plan (every in-flight stream
              ends with an error chunk and a failed row, one crash dump
              holding those rows, one rebuild, the same tokens again,
              device memory back within 1 GiB); a 1 s trace while the
              daemon serves that must name the paged-decode kernel, with
              a second capture refused; shutdown() draining a 3,000-token
              request while admission answers EngineDrainingError with
              the drain's Retry-After; and a train.save_checkpoint file at
              7b widths, 4 layers, bf16 (about 1.9 GB) served by a daemon
              with the in-memory params' greedy tokens, while the 32-layer
              preset on it leaves the daemon up with no engine and the
              reason published.

The second-to-last line is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``; any failure exits non-zero without
them.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel is the
# larger of its bytes over the memory rate and its FLOPs over the rate of
# its operand type. f32: three TF32 tensor-core products (495 TFLOP/s) give
# one f32-accurate product, so 495 / 3 is the least time this card needs
# for f32 work, less than the 67 TFLOP/s of exact f32 on the CUDA cores
# (CUDA_CORE_F32_FLOPS, the bound the f32 rows used to be held to, printed
# beside it).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 495e12 / 3}
CUDA_CORE_F32_FLOPS = 67e12

# Kernel vs plain. f32 outputs (f32 pages, int8 pages under an f32 query)
# differ by accumulation order only: max |out - plain| <= ABS_TOL. A bf16
# output, and the flash kernel's bf16 probabilities, round to 8 significant
# bits, an error that scales with the output row; with N(0, 1) inputs a row
# attending over thousands of keys is ~0.02 in size, so an absolute bound
# would pass errors of tens of percent there. bf16 outputs are held per
# output row (the d_head values of one token and head) instead:
# ||out - plain||_2 / ||plain||_2 <= ROW_REL_TOL, about 5x the rounding.
ABS_TOL = 1e-5
ROW_REL_TOL = 1e-2
LSE_TOL = 5e-5                              # f32 LSE ~10 in magnitude
MODEL_TOL = 1e-3
# Flash backward, per gradient row (the d_head values of one token and
# head). bf16: ||grad - plain||_2 / ||plain||_2 <= GRAD_ROW_TOL; the plain
# version rounds P and dS to bf16 where the kernel does, so rows differ by
# the output rounding and rare rounding flips. f32: against the plain
# version evaluated in f64 on the same inputs ("exact"), no row may be
# further from it than the exact-f32 plain version's own row is, by more
# than GRAD_ROW_TOL of the row: ||grad - exact|| <= ||plain - exact|| +
# GRAD_ROW_TOL ||exact||. Most rows are held to about 2e-5 of exact; a row
# that cancels to a small part of its terms (a causal row that sees two
# keys, a saturated softmax) is one where f32 arithmetic itself is far from
# exact, and there the kernel may be no worse than the plain f32 version.
# The kernel's products do not round as the plain version's do, so its
# error there must be smaller than an f32 one: dP is an f64 product. The
# one row that is zero in exact arithmetic — dq of the first query under
# the causal mask, whose softmax sees one key — is noise on both sides and
# is held against the largest dq row norm instead. A control: the plain
# backward with single-pass TF32 matmuls must fail this measure.
GRAD_ROW_TOL = {"bf16": 1e-2, "f32": 2e-5}
# Training on the card vs the CPU (f32 both): loss and pre-clip grad norm
# within TRAIN_REL_TOL (measured 1.2e-6); params on average per leaf within
# 1e-3 of the summed learning rates. No bound on the largest element: Adam
# moves an element whose gradient is rounding noise by up to a full
# learning rate either way, so two correct runs can differ there by twice
# the summed rates.
TRAIN_REL_TOL = 1e-5
# f32 forward, per output row, by the f32 backward's measure: against the
# plain version evaluated in f64 on the same inputs ("exact"), no O row may
# be further from it than the exact-f32 plain version's own row, by more
# than FWD_ROW_EXCESS of the row: ||O - exact|| <= ||plain - exact|| +
# FWD_ROW_EXCESS ||exact||. The kernel's products are three TF32 passes;
# with scores of std 4 (q x 4) the plain f32 version itself is ~1e-5 from
# exact, and one TF32 pass (the control) is far beyond it.
FWD_ROW_EXCESS = 2e-5


def log(message: str) -> None:
    print(message, flush=True)


class PhaseFailure(RuntimeError):
    pass


def require(condition: bool, message: str) -> None:
    if not condition:
        raise PhaseFailure(message)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` launches (CUDA
    events around the whole run, after ``warmup`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(fn, reps: int, flush_bytes: int = 256 << 20) -> float:
    """Mean device time of one ``fn`` launch in ms with a cold L2: before
    each launch ``flush_bytes`` (5x the 50 MB L2) are written, and one
    event pair brackets the launch alone. A sleep kernel first puts the
    card behind the host, and each flush takes longer on the card than the
    host takes to enqueue the next launch, so the launch is queued before
    its start event is reached: host time does not enter the pair."""
    import torch

    flush = torch.empty(flush_bytes // 4, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for start, end in pairs:
        flush.fill_(1.0)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms with a warm L2 and no host in the
    way: ``reps`` calls captured in one CUDA graph, replayed between CUDA
    events."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def errors(out, ref):
    """(max |out - ref|, max over output rows of ||out - ref|| / ||ref||),
    rows along the last axis."""
    diff = out.float() - ref
    row_rel = diff.norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)
    return diff.abs().max().item(), row_rel.max().item()


def within_tolerance(abs_err: float, row_rel_err: float, bf16_out: bool):
    if bf16_out:
        return math.isfinite(row_rel_err) and row_rel_err <= ROW_REL_TOL
    return math.isfinite(abs_err) and abs_err <= ABS_TOL


def grad_errors(grad, ref, first_row_zero):
    """(max |grad - ref|, max row-relative error, rows under 1% of the
    largest row norm) of one [B, S, H, D] gradient. With
    ``first_row_zero`` the rows of token 0 are held against the largest
    row norm (they are zero in exact arithmetic)."""
    diff = grad.float() - ref.float()
    norms = ref.float().norm(dim=-1)
    largest = norms.max()
    require(largest.item() > 0, "the plain gradient is all zeros")
    rel = diff.norm(dim=-1) / norms.clamp_min(1e-30)
    if first_row_zero:
        rel[:, 0] = diff[:, 0].norm(dim=-1) / largest
    small = int((norms < 1e-2 * largest).sum().item())
    return diff.abs().max().item(), rel.max().item(), small


def f32_row_errors(out, plain, exact, first_row_zero=False):
    """(max |out - exact|, max row ||out - exact|| / ||exact||, max row
    (||out - exact|| - ||plain - exact||) / ||exact||) of one [B, S, H, D]
    f32 output or gradient against the f64 evaluation ``exact``, beside the
    exact-f32 ``plain`` version; with ``first_row_zero`` the rows of token 0
    are held against the largest row norm."""
    exact = exact.double()
    norms = exact.norm(dim=-1)
    largest = norms.max()
    require(largest.item() > 0, "the plain version is all zeros")
    error = (out.double() - exact).norm(dim=-1)
    own = (plain.double() - exact).norm(dim=-1)
    scale = norms.clamp_min(1e-300)
    if first_row_zero:
        scale[:, 0] = largest
    return ((out.double() - exact).abs().max().item(),
            (error / scale).max().item(), ((error - own) / scale).max().item())


def bound_ms(flops: float, nbytes: float, variant: str):
    op_ms = flops / PEAK_FLOPS[variant] * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(op_ms, byte_ms), ("operations" if op_ms >= byte_ms else "bytes")


def timed_steps(run_step, steps, sync_every):
    """Run ``run_step(index)`` ``steps`` times, waiting for the card every
    ``sync_every`` steps as train_loop does; returns (steady step ms,
    rejected windows) by train_loop's rule."""
    import torch

    from tensorhive_tpu_torch import train

    windows = []
    torch.cuda.synchronize()
    start = time.perf_counter()
    for index in range(steps):
        run_step(index)
        if (index + 1) % sync_every == 0:
            torch.cuda.synchronize()
            now = time.perf_counter()
            windows.append(((now - start) / sync_every, True))
            start = now
    step_s, rejected = train._steady_step_time(windows)
    return step_s * 1e3, rejected


def profile_train_steps(label, run, step_ms, steps=2):
    """torch.profiler over ``steps`` more calls of ``run`` (one train
    step); logs the device ms per step by kind of kernel and the busy share
    of the untraced ``step_ms``; returns the kinds."""
    kinds, launched = profile_window(run, steps)
    total = sum(kinds.values())
    require(total > 0, f"{label}: the trace shows no device time")
    log(f"  profile ({steps} steps): {total:.1f} ms of kernels per step (" +
        ", ".join(f"{kind} {ms:.1f}" for kind, ms in kinds.items())
        + f"); {launched:.0f} kernel launches per step; device busy "
        f"{100 * total / step_ms:.1f}% of the untraced {step_ms:.1f} ms step")
    return kinds


def falling(label, losses):
    values = [loss.item() for loss in losses]
    require(all(math.isfinite(x) for x in values),
            f"{label}: loss not finite: {values}")
    require(values[-1] < values[0], f"{label}: loss did not fall: {values}")
    return values


# -- phase 1 + 2 --------------------------------------------------------------

def phase_device():
    import torch

    capability = torch.cuda.get_device_capability(0)
    require(capability == (9, 0),
            f"needs compute capability 9.0 (Hopper), got {capability}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    # the plain versions are the reference: full f32 matmuls, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} capability {capability} "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return card


def kernel_label(mangled):
    """``name<template ints>`` of a mangled kernel symbol (the identifier
    whose length prefix ends in ``kernel``). Matches overlap: a length may
    follow a digit of the anonymous namespace's hash, and a digit run of
    that hash (which depends on the source's path) can read as a length
    that spans the namespace and the name, so the name is the last
    identifier that ends in ``kernel``."""
    label = mangled
    for match in re.finditer(r"(?=(\d+)([A-Za-z_]))", mangled):
        start = match.start(2)
        name = mangled[start:start + int(match.group(1))]
        if name.endswith("kernel"):
            dims = re.findall(r"Li(\d+)E", mangled[start + len(name):])
            label = f"{name}<{', '.join(dims)}>"
    return label


#: SASS counted per kernel: wgmma (HGMMA), TF32 mma.sync (HMMA.1688.F32.TF32),
#: f64 mma.sync (DMMA), TMA loads (UTMALDG) and mbarrier operations (SYNCS)
SASS_OPS = ("HGMMA", "HMMA.1688.F32.TF32", "DMMA", "UTMALDG", "SYNCS")
#: by library: (kernels, d_heads, SASS each must hold) — the bf16 TMA +
#: wgmma kernels, the f32 forward's kernels (three-pass TF32 products) and
#: the f32 backward's (three-pass TF32 products, dO V^T in f64)
SASS_REQUIRED = {
    "flash_fwd": ((("flash_fwd_bf16_kernel", "flash_fwd_bh_bf16_kernel"),
                   (64, 128), ("HGMMA", "UTMALDG")),
                  (("flash_fwd_f32_kernel", "flash_fwd_bh_f32_kernel"),
                   (16, 32, 64, 128), ("HMMA.1688.F32.TF32", "UTMALDG"))),
    "flash_bwd": ((("flash_dq_bf16_kernel", "flash_dkv_bf16_kernel"),
                   (64, 128), ("HGMMA", "UTMALDG")),
                  (("flash_dq_f32_kernel", "flash_dkv_f32_kernel"),
                   (16, 32, 64, 128),
                   ("HMMA.1688.F32.TF32", "DMMA", "UTMALDG")))}


def phase_build():
    from tensorhive_tpu_torch.ops import cuda_build

    started = time.perf_counter()
    reports = cuda_build.build()
    log(f"build: {sorted(reports)} in {time.perf_counter() - started:.1f} s")
    spills, serialized = {}, set()
    for name, report in sorted(reports.items()):
        kernel = "?"
        for line in report.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            loss = re.search(r"Performance Loss: .* function '(\w+)'", line)
            if entry:
                kernel = kernel_label(entry.group(1))
            elif loss:
                # ptxas made every wgmma of the kernel wait for the last
                serialized.add(kernel_label(loss.group(1)))
                log(f"  ptxas {name}: {line.strip()}")
            elif ("registers" in line or "spill" in line or "smem" in line
                  or "setmaxnreg" in line or "warning" in line):
                log(f"  ptxas {name} {kernel}: {line.strip()}")
                spilled = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                    r"spill loads", line)
                if spilled:
                    spills[kernel] = (spills.get(kernel, 0)
                                      + sum(map(int, spilled.groups())))
    smem = cuda_build.load("flash_fwd").thp_flash_fwd_smem
    log("  flash_fwd dynamic shared memory a CTA (K1/K2 and K3): "
        + ", ".join(f"{variant} d {d} {smem(code, d)} B"
                    for code, variant in ((0, "f32"), (1, "bf16"))
                    for d in (16, 32, 64, 128)))
    paged = [kernel for kernel in spills if kernel.startswith("paged_decode")]
    require(paged, "ptxas reported no paged_decode kernel")
    for kernel in paged:
        require(spills[kernel] == 0,
                f"{kernel}: ptxas reports {spills[kernel]} spill bytes")
    log(f"  paged_decode: {len(paged)} kernels, 0 spill bytes")
    for library, groups in SASS_REQUIRED.items():
        sass = subprocess.run(
            [cuda_build.toolkit_tool("cuobjdump"), "-sass",
             str(cuda_build.library_path(library))],
            capture_output=True, text=True, timeout=300)
        require(sass.returncode == 0,
                f"cuobjdump failed: {sass.stderr[-2000:]}")
        counts, kernel = {}, None
        for line in sass.stdout.splitlines():
            function = re.search(r"Function : (\w+)", line)
            if function:
                kernel = kernel_label(function.group(1))
                counts[kernel] = dict.fromkeys(SASS_OPS, 0)
            elif kernel is not None:
                for op in SASS_OPS:
                    counts[kernel][op] += op in line
        for names, d_heads, required in groups:
            for d in d_heads:
                for name in names:
                    label = f"{name}<{d}>"
                    found = counts.get(label, {})
                    log(f"  sass {label}: " + ", ".join(
                        f"{op} {found.get(op, 0)}" for op in SASS_OPS)
                        + f"; ptxas spill bytes "
                        f"{spills.get(label, 'not reported')}")
                    for op in required:
                        require(found.get(op, 0) > 0,
                                f"{label} issues no {op}")
                    require(spills.get(label) == 0,
                            f"{label}: ptxas reports spills "
                            f"({spills.get(label, 'no report')})")
                    require(label not in serialized,
                            f"{label}: ptxas reports a performance loss "
                            f"(serialized products)")


# -- phase 3 ------------------------------------------------------------------

#: (batch, seq, heads, kv_heads, d) of the per-head flash forward checks,
#: bf16 and f32: the 7b serving prefill (H 32, Hkv 8, d 128) at 512, the
#: 4095 bucket and 4096, and a long S 16384 over one KV head; bf16 adds the
#: t2t-base training attention (B 64, S 1024, H 8, d 64)
FORWARD_SHAPES = ((1, 512, 32, 8, 128), (1, 4095, 32, 8, 128),
                  (1, 4096, 32, 8, 128), (1, 16384, 4, 1, 128))

#: (batch, seq, heads, kv_heads, d, causal) of the flash backward checks:
#: the t2t-base and t2t-big training attention, the 7b heads (GQA), ragged
#: S, and the encoder's non-causal t2t-base attention
BACKWARD_SHAPES = ((64, 1024, 8, 8, 64, True), (8, 4096, 16, 16, 64, True),
                   (1, 4096, 32, 8, 128, True), (1, 4095, 32, 8, 128, True))
ENCODER_BACKWARD = (64, 1024, 8, 8, 64, False)

def rate_report(flops, kernel_ms, bound, library_ms):
    """Achieved TFLOP/s, share of the bound and the time over SDPA's, for
    a forward or backward row and its log line."""
    rates = {"tflops": flops / kernel_ms / 1e9, "bound_share": bound / kernel_ms,
             "vs_sdpa": kernel_ms / library_ms}
    text = (f"{rates['tflops']:.0f} TFLOP/s, {100 * rates['bound_share']:.1f}% "
            f"of the bound, {rates['vs_sdpa']:.2f}x SDPA")
    return rates, text


def exact_forward(q, k, v, causal):
    """The plain forward evaluated in f64 on the same inputs, over batch
    chunks whose f64 score matrices stay near 2 GB (the function is
    independent per batch element)."""
    import torch

    from tensorhive_tpu_torch.ops import flash_attention as fa

    batch, seq, heads, _ = q.shape
    chunk = max(1, (2 << 30) // (heads * seq * seq * 8))
    return torch.cat([fa.reference_attention(
        q[i:i + chunk].double(), k[i:i + chunk].double(),
        v[i:i + chunk].double(), causal=causal)
        for i in range(0, batch, chunk)])


def forward_excess(out, plain, exact, library):
    """The f32 forward's measure: (kernel's max row distance from exact,
    plain f32's, kernel's max row excess over plain's own, SDPA's excess),
    failing the phase when the kernel's excess tops FWD_ROW_EXCESS."""
    _, rel, excess = f32_row_errors(out, plain, exact)
    own = f32_row_errors(plain, plain, exact)[1]
    library_excess = f32_row_errors(library, plain, exact)[2]
    require(math.isfinite(excess) and excess <= FWD_ROW_EXCESS,
            f"max row (||O - exact|| - ||plain - exact||) / ||exact|| "
            f"{excess} > {FWD_ROW_EXCESS}")
    return rel, own, excess, library_excess


def flash_case(batch, seq, heads, kv_heads, d, variant, generator):
    import torch
    import torch.nn.functional as F

    from tensorhive_tpu_torch.ops import flash_attention as fa

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[variant]

    def draw(h):
        return torch.randn((batch, seq, h, d), generator=generator,
                           device="cuda", dtype=torch.float32).to(dtype)

    q, k, v = draw(heads), draw(kv_heads), draw(kv_heads)
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    ref_out, ref_lse = fa.reference_attention(
        q.float(), k.float(), v.float(), causal=True, return_lse=True)
    torch.cuda.synchronize()
    label = f"flash_fwd {variant} B={batch} S={seq} H={heads} Hkv={kv_heads} d={d}"
    require(out.shape == q.shape and lse.shape == (batch * heads, 1, seq),
            f"{label}: output shapes")
    err, rel = errors(out, ref_out)
    lse_err = (lse - ref_lse).abs().max().item()
    require(within_tolerance(err, rel, variant == "bf16"),
            f"{label}: max |O - plain| {err}, max row "
            f"||O - plain|| / ||plain|| {rel}; tolerance "
            f"{ROW_REL_TOL if variant == 'bf16' else ABS_TOL}")
    require(math.isfinite(lse_err) and lse_err <= LSE_TOL,
            f"{label}: max |LSE - plain| {lse_err} > {LSE_TOL}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    measure = None
    if variant == "f32":
        library = F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
        measure = forward_excess(out, ref_out, exact_forward(q, k, v, True),
                                 library)
        del library
    del ref_out, ref_lse
    reps = 20 if seq <= 4096 else 5
    kernel_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                        reps)
    plain_ms = cuda_ms(lambda: fa.reference_attention(q, k, v, causal=True),
                       3, warmup=1)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps)
    itemsize = q.element_size()
    flops = 2.0 * seq * seq * heads * d * batch    # causal QK^T + PV
    nbytes = batch * (2 * seq * (heads + kv_heads) * d * itemsize
                      + 4 * seq * heads)           # q,k,v,o + lse
    bound, bound_by = bound_ms(flops, nbytes, variant)
    rates, rate_text = rate_report(flops, kernel_ms, bound, library_ms)
    row = {"batch": batch, "seq": seq, "heads": heads, "kv_heads": kv_heads,
           "d": d, "max_abs_err": err, "max_row_rel_err": rel,
           "lse_err": lse_err, "ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound, "bound_by": bound_by, **rates}
    log(f"{label} causal: err {err:.3e} row_rel {rel:.3e} lse_err "
        f"{lse_err:.3e} kernel {kernel_ms:.4f} ms plain {plain_ms:.4f} ms "
        f"sdpa {library_ms:.4f} ms bound {bound:.4f} ms ({bound_by}); "
        f"{rate_text}")
    if measure:
        row["max_row_excess"], row["library_max_row_excess"] = measure[2:]
        log_forward_measure(measure)
    return row


def log_forward_measure(measure):
    rel, own, excess, library_excess = measure
    log(f"  O rows vs exact: kernel {rel:.2e} (plain f32 {own:.2e}); beyond "
        f"the plain f32 version's: kernel {excess:.3e}, sdpa "
        f"{library_excess:.3e} (bound {FWD_ROW_EXCESS})")


#: (batch, seq, heads, d, causal, requested G) of the head-blocked forward
#: (K3) checks: the t2t-base encoder's attention at every G, t2t-big's at
#: the G a request of 4 gets, and a ragged S
BH_SHAPES = ((64, 1024, 8, 64, False, (2, 4, 8)),
             (64, 1024, 8, 64, True, (2, 4, 8)),
             (8, 4096, 16, 64, False, (4,)),
             (8, 1000, 8, 64, False, (4,)))


def flash_bh_cases(batch, seq, heads, d, causal, requests, variant,
                   generator):
    """The head-blocked forward at each requested G against the plain
    version (K1's function) on one input, timed beside its bound, the
    per-head kernel on the same input, the plain version and SDPA. The
    per-head kernel's output is compared too: the head-blocked kernel runs
    its per-tile code, so 0 difference is expected."""
    import torch
    import torch.nn.functional as F

    from tensorhive_tpu_torch.ops import flash_attention as fa

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[variant]
    q, k, v = (torch.randn((batch, seq, heads, d), generator=generator,
                           device="cuda", dtype=torch.float32).to(dtype)
               for _ in range(3))
    ref_out, ref_lse = fa.reference_attention(
        q.float(), k.float(), v.float(), causal=causal, return_lse=True)
    per_head, per_head_lse = fa.flash_attention(q, k, v, causal=causal,
                                                return_lse=True)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    exact = library = None
    if variant == "f32":
        exact = exact_forward(q, k, v, causal)
        library = F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal).transpose(1, 2)
    reps = 10 if variant == "bf16" else 3
    per_head_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                          reps)
    plain_ms = cuda_ms(lambda: fa.reference_attention(q, k, v, causal=causal),
                       1, warmup=1)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal), reps)
    itemsize = q.element_size()
    flops = (2.0 if causal else 4.0) * seq * seq * heads * d * batch
    nbytes = 4 * batch * seq * heads * d * itemsize + 4 * batch * heads * seq
    bound, bound_by = bound_ms(flops, nbytes, variant)
    rows = []
    for requested in requests:
        g = fa.fwd_bh_block(batch * heads, 1, seq, d, dtype, requested)
        require(g > 1, f"flash_bh: G {g} for a request of {requested}")
        before = fa.launches[f"bh_{variant}"]
        out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True,
                                      bh_block=requested)
        torch.cuda.synchronize()
        require(fa.launches[f"bh_{variant}"] == before + 1,
                "flash_bh: the head-blocked kernel did not launch")
        label = (f"flash_fwd_bh {variant} B={batch} S={seq} H={heads} d={d} "
                 f"{'causal' if causal else 'non-causal'} G={g}")
        require(out.shape == q.shape and lse.shape == (batch * heads, 1, seq),
                f"{label}: output shapes")
        err, rel = errors(out, ref_out)
        lse_err = (lse - ref_lse).abs().max().item()
        require(within_tolerance(err, rel, variant == "bf16"),
                f"{label}: max |O - plain| {err}, max row ||O - plain|| / "
                f"||plain|| {rel}; tolerance "
                f"{ROW_REL_TOL if variant == 'bf16' else ABS_TOL}")
        require(math.isfinite(lse_err) and lse_err <= LSE_TOL,
                f"{label}: max |LSE - plain| {lse_err} > {LSE_TOL}")
        vs_per_head = max((out.float() - per_head.float()).abs().max().item(),
                          (lse - per_head_lse).abs().max().item())
        measure = (forward_excess(out, ref_out, exact, library)
                   if variant == "f32" else None)
        del out, lse
        require(vs_per_head == 0,
                f"{label}: O/LSE differ from the per-head kernel's by "
                f"{vs_per_head}; the two run one tile body and must agree "
                f"bitwise")
        kernel_ms = cuda_ms(lambda: fa.flash_attention(
            q, k, v, causal=causal, bh_block=requested), reps)
        rates, rate_text = rate_report(flops, kernel_ms, bound, library_ms)
        rows.append({"batch": batch, "seq": seq, "heads": heads, "d": d,
                     "causal": causal, "g": g, "max_abs_err": err,
                     "max_row_rel_err": rel, "lse_err": lse_err,
                     "vs_per_head": vs_per_head, "ms": kernel_ms,
                     "per_head_ms": per_head_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound,
                     "bound_by": bound_by, **rates})
        log(f"{label}: err {err:.3e} row_rel {rel:.3e} lse_err "
            f"{lse_err:.3e} |K3 - K1| {vs_per_head:.1e}; kernel "
            f"{kernel_ms:.4f} ms, per-head kernel {per_head_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound:.4f} "
            f"ms ({bound_by}); {rate_text}")
        if measure:
            rows[-1]["max_row_excess"] = measure[2]
            rows[-1]["library_max_row_excess"] = measure[3]
            log_forward_measure(measure)
    del ref_out, ref_lse, per_head, per_head_lse, exact, library
    torch.cuda.empty_cache()
    return rows


def plain_backward(q, k, v, out, lse, do, delta, causal, exact=False):
    """The plain backward over batch chunks whose score matrices stay near
    2 GB (the function is independent per batch element); ``exact``
    evaluates it in f64 on the same inputs: [dq, dk, dv]."""
    import torch

    from tensorhive_tpu_torch.ops import flash_attention as fa

    batch, seq, heads, _ = q.shape
    width = 8 if exact else 4
    chunk = max(1, (2 << 30) // (heads * seq * seq * width))
    lse = lse.reshape(batch, heads, 1, seq)
    delta = delta.reshape(batch, heads, 1, seq)
    parts = []
    for start in range(0, batch, chunk):
        rows = slice(start, start + chunk)
        n = q[rows].shape[0]
        inputs = [q[rows], k[rows], v[rows], out[rows],
                  lse[rows].reshape(n * heads, 1, seq), do[rows],
                  delta[rows].reshape(n * heads, 1, seq)]
        if exact:
            inputs = [t.double() for t in inputs]
        parts.append(fa.flash_attention_backward_reference(
            *inputs[:6], causal=causal, delta=inputs[6]))
    return [torch.cat(grads) for grads in zip(*parts)]


def flash_backward_case(batch, seq, heads, kv_heads, d, causal, variant,
                        generator):
    """Both backward kernels (dQ, dK/dV) against the plain backward on the
    same inputs, per gradient; timed beside the bound, the plain version
    and the backward of PyTorch's scaled_dot_product_attention (its
    forward excluded)."""
    import torch
    import torch.nn.functional as F

    from tensorhive_tpu_torch.ops import flash_attention as fa

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[variant]

    def draw(h):
        return torch.randn((batch, seq, h, d), generator=generator,
                           device="cuda", dtype=torch.float32).to(dtype)

    q, k, v, do = draw(heads), draw(kv_heads), draw(kv_heads), draw(heads)
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    delta = fa.flash_bwd_delta(do, out)
    grads = fa.flash_attention_backward(q, k, v, out, lse, do, causal=causal,
                                        delta=delta)
    refs = plain_backward(q, k, v, out, lse, do, delta, causal)
    exact = (plain_backward(q, k, v, out, lse, do, delta, causal, exact=True)
             if variant == "f32" else None)
    torch.cuda.synchronize()
    label = (f"flash_bwd {variant} B={batch} S={seq} H={heads} "
             f"Hkv={kv_heads} d={d} {'causal' if causal else 'non-causal'}")
    worst = [0.0, 0.0]
    excess = 0.0
    per_grad = []
    for index, (grad, ref, like, name) in enumerate(zip(grads, refs, (q, k, v),
                                                        "qkv")):
        require(grad.shape == like.shape and grad.dtype == dtype,
                f"{label}: d{name} shape/dtype")
        require(bool(torch.isfinite(grad).all()), f"{label}: d{name} not "
                f"finite")
        first = causal and name == "q"
        if variant == "f32":
            err, rel, beyond = f32_row_errors(grad, ref, exact[index], first)
            own = f32_row_errors(ref, ref, exact[index], first)[1]
            require(math.isfinite(beyond)
                    and beyond <= GRAD_ROW_TOL[variant],
                    f"{label}: d{name} max row (||g - exact|| - ||plain - "
                    f"exact||) / ||exact|| {beyond} > {GRAD_ROW_TOL[variant]}")
            excess = max(excess, beyond)
            per_grad.append(f"d{name} {rel:.2e} vs exact (plain f32 "
                            f"{own:.2e}), beyond plain {beyond:.2e}")
        else:
            err, rel, small = grad_errors(grad, ref, first_row_zero=first)
            require(math.isfinite(rel) and rel <= GRAD_ROW_TOL[variant],
                    f"{label}: d{name} max row ||g - plain|| / ||plain|| "
                    f"{rel} > {GRAD_ROW_TOL[variant]}")
            per_grad.append(f"d{name} {rel:.2e} ({small} rows < 1% of the "
                            f"largest)")
        worst = [max(worst[0], err), max(worst[1], rel)]
    del grads
    big = batch * heads * seq * seq * d > 2 ** 34
    reps = 3 if variant == "f32" or big else 10
    kernel_ms = cuda_ms(lambda: fa.flash_attention_backward(
        q, k, v, out, lse, do, causal=causal, delta=delta), reps)
    plain_ms = cuda_ms(lambda: plain_backward(q, k, v, out, lse, do, delta,
                                              causal), 1, warmup=1)
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(
        *leaves, is_causal=causal, enable_gqa=kv_heads != heads)
    grad_out = do.transpose(1, 2)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        sdpa_out, leaves, grad_out, retain_graph=True), reps)
    # is SDPA's backward the same function? its gradients' row errors by
    # the kernel's measures (f32: against the exact evaluation, and beyond
    # the plain f32 version's own error)
    library_rel = library_excess = 0.0
    sdpa_grads = torch.autograd.grad(sdpa_out, leaves, grad_out)
    for index, (grad, name) in enumerate(zip(sdpa_grads, "qkv")):
        grad, first = grad.transpose(1, 2), causal and name == "q"
        if variant == "f32":
            _, rel, beyond = f32_row_errors(grad, refs[index], exact[index],
                                             first)
            library_excess = max(library_excess, beyond)
        else:
            rel = grad_errors(grad, refs[index], first_row_zero=first)[1]
        library_rel = max(library_rel, rel)
    del sdpa_out, leaves, refs, exact, sdpa_grads
    itemsize = q.element_size()
    # 5 products of 2 S^2 D per head (halved by the causal mask)
    flops = (5.0 if causal else 10.0) * seq * seq * heads * d * batch
    nbytes = (4 * batch * seq * (heads + kv_heads) * d * itemsize
              + 2 * 4 * batch * heads * seq)          # + lse, delta
    bound, bound_by = bound_ms(flops, nbytes, variant)
    rates, rate_text = rate_report(flops, kernel_ms, bound, library_ms)
    row = {"batch": batch, "seq": seq, "heads": heads, "kv_heads": kv_heads,
           "d": d, "causal": causal, "max_abs_err": worst[0],
           "max_row_rel_err": worst[1], "ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_max_row_rel_err": library_rel,
           "bound_ms": bound, "bound_by": bound_by, **rates}
    if variant == "f32":
        row["max_row_excess"] = excess
        row["library_max_row_excess"] = library_excess
    cuda_core = ("" if variant == "bf16" else
                 f", {flops / CUDA_CORE_F32_FLOPS * 1e3:.4f} ms at the "
                 f"{CUDA_CORE_F32_FLOPS / 1e12:.0f} TFLOP/s of exact f32")
    log(f"{label}: err {worst[0]:.3e} row_rel {worst[1]:.3e} kernel "
        f"{kernel_ms:.4f} ms plain {plain_ms:.4f} ms "
        f"sdpa bwd {library_ms:.4f} ms (row_rel {library_rel:.3e}) bound "
        f"{bound:.4f} ms ({bound_by}{cuda_core}); {rate_text}")
    log(f"  row_rel by gradient: {'; '.join(per_grad)}")
    if variant == "f32":
        log(f"  max row error beyond the plain f32 version's: kernel "
            f"{excess:.3e}, sdpa {library_excess:.3e} (bound "
            f"{GRAD_ROW_TOL['f32']})")
    torch.cuda.empty_cache()
    return row


def f32_backward_control(generator):
    """The f32 backward measure tells f32 from TF32 arithmetic: on one
    causal GQA case with scores of std about 4 (q x 4, where an error in a
    score grows through exp) the kernel holds it, and the plain backward
    with single-pass TF32 matmuls (cuBLAS's TF32 mode) must not."""
    import torch

    from tensorhive_tpu_torch.ops import flash_attention as fa

    batch, seq, heads, kv_heads, d = 2, 1000, 8, 2, 64

    def draw(h):
        return torch.randn((batch, seq, h, d), generator=generator,
                           device="cuda")

    q, k, v, do = draw(heads) * 4.0, draw(kv_heads), draw(kv_heads), draw(
        heads)
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    delta = fa.flash_bwd_delta(do, out)
    grads = fa.flash_attention_backward(q, k, v, out, lse, do, causal=True,
                                        delta=delta)
    refs = plain_backward(q, k, v, out, lse, do, delta, True)
    exact = plain_backward(q, k, v, out, lse, do, delta, True, exact=True)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = plain_backward(q, k, v, out, lse, do, delta, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    kernel, single = (max(f32_row_errors(g, r, e, name == "q")[2]
                          for g, r, e, name in zip(grads, refs, exact, "qkv"))
                      for grads in (grads, tf32))
    log(f"flash_bwd f32 control B={batch} S={seq} H={heads} Hkv={kv_heads} "
        f"d={d} causal q x 4: max row error beyond the plain f32 version's: "
        f"kernel {kernel:.3e}, single-pass TF32 plain {single:.3e} (bound "
        f"{GRAD_ROW_TOL['f32']})")
    require(kernel <= GRAD_ROW_TOL["f32"],
            f"f32 control: kernel {kernel} > {GRAD_ROW_TOL['f32']}")
    require(single > GRAD_ROW_TOL["f32"],
            f"f32 control: single-pass TF32 {single} passes the f32 measure")


def f32_forward_control(generator):
    """The f32 forward measure on large scores (q x 4: std about 4, where an
    error in a score grows through exp), causal, GQA group 4, ragged S 1000,
    d_head 64 and 128: the kernel holds it, and the plain forward with
    single-pass TF32 matmuls (cuBLAS's TF32 mode) must not. SDPA's f32
    forward is measured beside them."""
    import torch
    import torch.nn.functional as F

    from tensorhive_tpu_torch.ops import flash_attention as fa

    batch, seq, heads, kv_heads = 2, 1000, 8, 2
    for d in (64, 128):
        def draw(h):
            return torch.randn((batch, seq, h, d), generator=generator,
                               device="cuda")

        q, k, v = draw(heads) * 4.0, draw(kv_heads), draw(kv_heads)
        out = fa.flash_attention(q, k, v, causal=True)
        plain = fa.reference_attention(q, k, v, causal=True)
        exact = exact_forward(q, k, v, True)
        library = F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in (q, k, v)), is_causal=True,
            enable_gqa=True).transpose(1, 2)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = fa.reference_attention(q, k, v, causal=True)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.synchronize()
        rel, own, kernel, sdpa = forward_excess(out, plain, exact, library)
        single = f32_row_errors(tf32, plain, exact)[2]
        log(f"flash_fwd f32 control B={batch} S={seq} H={heads} "
            f"Hkv={kv_heads} d={d} causal q x 4: O rows vs exact: kernel "
            f"{rel:.2e} (plain f32 {own:.2e}); beyond the plain f32 "
            f"version's: kernel {kernel:.3e}, sdpa {sdpa:.3e}, single-pass "
            f"TF32 plain {single:.3e} (bound {FWD_ROW_EXCESS})")
        require(single > FWD_ROW_EXCESS,
                f"f32 forward control: single-pass TF32 {single} passes the "
                f"f32 measure")


#: the serving shape: 8 slots at page 16 over a 4096-token window, mixed
#: positions, slot 6 parked (position 0, a row of trash pages)
PAGED_SERVING = ([4095, 2999, 1499, 299, 16, 15, 0, 2047], 16, 256, (6,))
#: the sweep: 1, 8 and 32 slots all at position 4095, page 16; 8 slots at
#: page 64
PAGED_SWEEP = (([4095], 16, 256, ()), ([4095] * 8, 16, 256, ()),
               ([4095] * 32, 16, 256, ()), ([4095] * 8, 64, 64, ()))


def paged_case(variant, generator, positions, page_size, max_pages, parked):
    """7b heads (H 32, Hkv 8, d 128) over a shuffled page pool. ``variant``
    is the page type; ``int8/bf16q`` is int8 pages under a bf16 query, the
    serving case. Timed with a cold L2 (the serving step reads each layer's
    pages once) and, warm, in a CUDA graph."""
    import numpy as np
    import torch

    from tensorhive_tpu_torch.ops import paged_attention as pa

    heads, kv_heads, d = 32, 8, 128
    rng = np.random.default_rng(7)
    live = [0 if slot in parked else pos // page_size + 1
            for slot, pos in enumerate(positions)]
    num_pages = 1 + sum(live) + 64                 # trash + live + spare
    physical = rng.permutation(np.arange(1, num_pages))
    table = np.zeros((len(positions), max_pages), np.int32)
    cursor = 0
    for slot, count in enumerate(live):
        table[slot, :count] = physical[cursor:cursor + count]
        cursor += count
    quant = variant.startswith("int8")
    q_dtype = torch.bfloat16 if variant in ("bf16", "int8/bf16q") \
        else torch.float32
    shape = (num_pages, page_size, kv_heads, d)
    q = torch.randn((len(positions), 1, heads, d), generator=generator,
                    device="cuda").to(q_dtype)
    if quant:
        k_pages = torch.randint(-127, 128, shape, generator=generator,
                                device="cuda", dtype=torch.int8)
        v_pages = torch.randint(-127, 128, shape, generator=generator,
                                device="cuda", dtype=torch.int8)
        k_scales = 0.005 + 0.015 * torch.rand((num_pages, kv_heads),
                                              generator=generator,
                                              device="cuda")
        v_scales = 0.005 + 0.015 * torch.rand((num_pages, kv_heads),
                                              generator=generator,
                                              device="cuda")
    else:
        k_pages = torch.randn(shape, generator=generator,
                              device="cuda").to(q_dtype)
        v_pages = torch.randn(shape, generator=generator,
                              device="cuda").to(q_dtype)
        k_scales = v_scales = None
    page_table = torch.from_numpy(table).cuda()
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    out = pa.paged_attention(q, k_pages, v_pages, page_table, pos,
                             k_scales=k_scales, v_scales=v_scales)
    plain_pages = ((k_pages, v_pages) if quant
                   else (k_pages.float(), v_pages.float()))
    ref = pa.paged_attention_reference(q.float(), *plain_pages, page_table,
                                       pos, k_scales, v_scales)
    torch.cuda.synchronize()
    require(out.shape == q.shape and out.dtype == q.dtype,
            "paged output shape/dtype")
    require(bool(torch.isfinite(out).all()), "paged output not finite")
    live_slots = [s for s in range(len(positions)) if s not in parked]
    err, rel = errors(out[live_slots], ref[live_slots])
    bf16_out = q_dtype == torch.bfloat16
    require(within_tolerance(err, rel, bf16_out),
            f"paged {variant}: max |out - plain| {err}, max row "
            f"||out - plain|| / ||plain|| {rel}; tolerance "
            f"{ROW_REL_TOL if bf16_out else ABS_TOL}")

    def kernel():
        pa.paged_attention(q, k_pages, v_pages, page_table, pos,
                           k_scales=k_scales, v_scales=v_scales)

    kernel_ms = cold_ms(kernel, 20)
    warm_ms = graph_ms(kernel, 20)
    plain_ms = cuda_ms(lambda: pa.paged_attention_reference(
        q, k_pages, v_pages, page_table, pos, k_scales, v_scales), 5)
    # bytes this data needs: the K and V rows of every visible position of
    # every slot once, the scale rows and table entries of the live pages,
    # q and out
    rows = sum(max(p, 0) + 1 for p in positions)
    pages_read = sum(max(p, 0) // page_size + 1 for p in positions)
    nbytes = (rows * 2 * kv_heads * d * k_pages.element_size()
              + pages_read * ((8 * kv_heads if quant else 0) + 4)
              + 2 * q.numel() * q.element_size())
    flops = 4.0 * heads * d * rows
    bound, bound_by = bound_ms(flops, nbytes,
                               "f32" if q_dtype == torch.float32 else "bf16")
    row = {"slots": len(positions), "max_abs_err": err,
           "max_row_rel_err": rel, "ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound,
           "bound_by": bound_by}
    log(f"paged_decode {variant}: {len(positions)} slots, page {page_size}, "
        f"{rows} rows, {nbytes / 1e6:.2f} MB; err {err:.3e} row_rel "
        f"{rel:.3e}; kernel {kernel_ms:.4f} ms cold L2, {warm_ms:.4f} warm; "
        f"plain {plain_ms:.4f} ms; bound {bound:.4f} ms ({bound_by}); "
        f"{100 * bound / kernel_ms:.1f}% of the bound")
    return row


def phase_kernels():
    import torch

    generator = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for variant in ("bf16", "f32"):
        rows = [flash_case(*shape, variant, generator)
                for shape in FORWARD_SHAPES]
        if variant == "bf16":
            rows.append(flash_case(64, 1024, 8, 8, 64, variant, generator))
        results[f"flash_fwd_{variant}"] = rows
        torch.cuda.empty_cache()
    for variant in ("bf16", "f32", "int8", "int8/bf16q"):
        results[f"paged_decode_{variant}"] = [
            paged_case(variant, generator, *case)
            for case in (PAGED_SERVING,) + PAGED_SWEEP]
        torch.cuda.empty_cache()
    for variant in ("bf16", "f32"):
        results[f"flash_bwd_{variant}"] = [
            flash_backward_case(*shape, variant, generator)
            for shape in BACKWARD_SHAPES + (ENCODER_BACKWARD,)]
    f32_backward_control(generator)
    f32_forward_control(generator)
    for variant in ("bf16", "f32"):
        results[f"flash_fwd_bh_{variant}"] = [
            row for shape in BH_SHAPES
            for row in flash_bh_cases(*shape, variant, generator)]
    return results


# -- phase 4 ------------------------------------------------------------------

def phase_model():
    import dataclasses

    import torch

    from tensorhive_tpu_torch.convert import params_from_jax, params_to_numpy
    from tensorhive_tpu_torch.models.transformer import PRESETS, TransformerLM

    config = dataclasses.replace(PRESETS["7b"], n_layers=2,
                                 dtype=torch.float32)
    generator = torch.Generator(device="cuda").manual_seed(1)
    params = TransformerLM.init(config, generator, device="cuda")
    tokens = torch.randint(0, config.vocab_size, (1, 300),
                           generator=generator, device="cuda")
    logits = TransformerLM.apply(params, tokens, config)
    cpu_params = params_from_jax(params_to_numpy(params), config, "cpu")
    cpu_logits = TransformerLM.apply(cpu_params, tokens.cpu(), config)
    err = (logits.cpu() - cpu_logits).abs().max().item()
    agree = (logits.argmax(-1).cpu() == cpu_logits.argmax(-1)).float().mean()
    log(f"model: 2-layer 7b widths f32, 300 tokens: max |logits(cuda) - "
        f"logits(cpu)| {err:.3e} (tolerance {MODEL_TOL}); argmax agreement "
        f"{agree.item():.4f}")
    require(bool(torch.isfinite(logits).all()), "model logits not finite")
    require(err <= MODEL_TOL, f"model parity {err} > {MODEL_TOL}")
    return {"max_abs_err": err}


# -- phase 5 ------------------------------------------------------------------

def reset_flash_counters():
    from tensorhive_tpu_torch.ops import flash_attention as fa

    for key in fa.launches:
        fa.launches[key] = 0


def check_training_launches(label, config, steps, variant):
    """Flash forward = layers x steps (twice under "block" remat: the
    backward re-runs the block), backward = layers x steps; nothing else.
    The forward is the head-blocked kernel ("bh_" counters) when the
    config asks for a head block (flash_bh_block > 1; the encoders checked
    here are MHA, where the request holds), else the per-head one."""
    from tensorhive_tpu_torch.ops import flash_attention as fa

    counts = dict(fa.launches)
    reruns = 2 if config.remat and config.remat_policy == "block" else 1
    forward = f"bh_{variant}" if config.flash_bh_block > 1 else variant
    expected = {key: 0 for key in counts}
    expected[forward] = config.n_layers * steps * reruns
    expected[f"bwd_{variant}"] = config.n_layers * steps
    require(counts == expected, f"{label}: flash launches {counts}, "
            f"expected {expected}")
    log(f"  launches: {counts} = {config.n_layers} layers x {steps} steps"
        + (" x 2 (block remat)" if reruns == 2 else ""))
    return counts


def training_parity(label="training parity", loss_fn=None, make_batch=None,
                    **config_fields):
    """A 2-layer model at t2t-base widths in f32 under "block" remat: 3
    steps of make_train_step on the card against the same steps on the CPU
    from the same params and batch. The LM objective on a synthetic batch
    by default; another objective passes ``loss_fn`` and ``make_batch``
    (config, train config, CPU generator -> batch), and ``config_fields``
    change the config (the encoder's ``causal``, ``flash_bh_block``)."""
    import dataclasses

    import torch

    from tensorhive_tpu_torch import train
    from tensorhive_tpu_torch.models.transformer import PRESETS, TransformerLM

    loss_fn = loss_fn or TransformerLM.loss
    config = dataclasses.replace(PRESETS["t2t-base"], n_layers=2,
                                 dtype=torch.float32, remat=True,
                                 remat_policy="block", **config_fields)
    tc = train.TrainConfig(batch_size=4, seq_len=256, warmup_steps=1,
                           total_steps=10, learning_rate=1e-3)
    optimizer = train.make_optimizer(tc)
    cpu_params, cpu_opt = train.init_train_state(
        config, tc, torch.Generator().manual_seed(11), device="cpu")
    card_params = train.tree_map(lambda t: t.to("cuda", copy=True),
                                 cpu_params)
    card_opt = optimizer.init(card_params)
    start = train.tree_map(lambda t: t.clone(), cpu_params)
    if make_batch is None:
        tokens = train.synthetic_batch(torch.Generator().manual_seed(12), tc,
                                       config.vocab_size, device="cpu")
    else:
        tokens = make_batch(config, tc, torch.Generator().manual_seed(12))
    cpu_step = train.make_train_step(config, tc, loss_fn=loss_fn)
    card_step = train.make_train_step(config, tc, loss_fn=loss_fn)
    reset_flash_counters()
    lr_sum, worst = 0.0, 0.0
    for index in range(3):
        card_params, card_opt, card = card_step(card_params, card_opt,
                                                tokens.to("cuda"))
        cpu_params, cpu_opt, cpu = cpu_step(cpu_params, cpu_opt, tokens)
        for key in ("loss", "grad_norm"):
            a, b = float(card[key]), float(cpu[key])
            rel = abs(a - b) / abs(b)
            worst = max(worst, rel)
            require(math.isfinite(a) and rel <= TRAIN_REL_TOL,
                    f"{label} step {index + 1}: {key} card {a} vs "
                    f"cpu {b} (rel {rel:.2e} > {TRAIN_REL_TOL})")
        if index == 0:               # learning rate 0: nothing may move
            for leaf, first in zip(train.tree_leaves(card_params),
                                   train.tree_leaves(start)):
                require(torch.equal(leaf.cpu(), first),
                        f"{label}: step 1 (lr 0) moved a param")
        lr_sum += optimizer.learning_rate(index)
    mean_diff = 0.0
    for card_leaf, cpu_leaf in zip(train.tree_leaves(card_params),
                                   train.tree_leaves(cpu_params)):
        diff = (card_leaf.cpu() - cpu_leaf).abs()
        mean_diff = max(mean_diff, diff.mean().item())
    log(f"{label}: 2-layer t2t-base widths f32, block remat, b4 x "
        f"s256, 3 steps card vs cpu: loss {float(card['loss']):.6f} vs "
        f"{float(cpu['loss']):.6f}; max rel err of loss/grad_norm "
        f"{worst:.2e} (tolerance {TRAIN_REL_TOL}); params: worst leaf mean "
        f"|diff| {mean_diff:.2e} (summed lr {lr_sum:.1e})")
    require(mean_diff <= 1e-3 * lr_sum,
            f"{label}: params differ (worst leaf mean {mean_diff}, "
            f"summed lr {lr_sum})")
    counts = check_training_launches(label, config, 3, "f32")
    return {"launches": counts, "max_rel_err": worst}


def training_run(preset, batch, seq, remat, policy, steps, sync_every):
    """train_loop on a fixed batch (bf16 compute, f32 masters): the loss
    must fall."""
    import dataclasses
    import itertools

    import torch

    from tensorhive_tpu_torch import train
    from tensorhive_tpu_torch.models.transformer import (
        PRESETS,
        TransformerLM,
        train_flops_per_token,
    )

    config = dataclasses.replace(PRESETS[preset], remat=remat,
                                 remat_policy=policy)
    tc = train.TrainConfig(batch_size=batch, seq_len=seq, warmup_steps=2,
                           total_steps=100)
    losses = []

    def recording_loss(params, tokens, model_config):
        loss = TransformerLM.loss(params, tokens, model_config)
        losses.append(loss.detach())
        return loss

    tokens = train.synthetic_batch(
        torch.Generator(device="cuda").manual_seed(21), tc,
        config.vocab_size, device="cuda")
    reset_flash_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    metrics = train.train_loop(
        config, tc, num_steps=steps, seed=0, log_every=0,
        sync_every=sync_every, batches=itertools.repeat(tokens),
        loss_fn=recording_loss, device="cuda")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    label = (f"training {preset} b{batch} x s{seq}, remat "
             f"{policy if remat else 'off'}")
    loss_values = falling(label, losses)
    step_ms = metrics["step_time_s"] * 1e3
    tokens_per_s = batch * seq / metrics["step_time_s"]
    mfu = tokens_per_s * train_flops_per_token(config, seq) / PEAK_FLOPS["bf16"]
    log(f"{label}: {steps} steps, loss {loss_values[0]:.4f} -> "
        f"{loss_values[-1]:.4f}; step {step_ms:.1f} ms (median of the steady "
        f"{sync_every}-step windows, {int(metrics['rejected_windows'])} "
        f"rejected); {tokens_per_s:.0f} tokens/s; MFU {mfu:.4f} of "
        f"{PEAK_FLOPS['bf16'] / 1e12:.0f} TFLOP/s; peak memory {peak_gb:.2f} GB")
    counts = check_training_launches(label, config, steps, "bf16")
    return {"config": config, "batch": batch, "seq": seq, "step_ms": step_ms,
            "tokens_per_s": tokens_per_s, "mfu": mfu, "peak_gb": peak_gb,
            "losses": loss_values, "launches": counts}


def training_profile(run, steps=2):
    """torch.profiler over ``steps`` make_train_step calls at ``run``'s
    configuration: device time by kind of kernel and the busy share of the
    untraced step time."""
    import torch

    from tensorhive_tpu_torch import train

    config, batch, seq = run["config"], run["batch"], run["seq"]
    tc = train.TrainConfig(batch_size=batch, seq_len=seq, warmup_steps=2,
                           total_steps=100)
    params, opt_state = train.init_train_state(
        config, tc, torch.Generator(device="cuda").manual_seed(0), "cuda")
    tokens = train.synthetic_batch(
        torch.Generator(device="cuda").manual_seed(21), tc,
        config.vocab_size, device="cuda")
    step = train.make_train_step(config, tc)
    state = [params, opt_state]

    def one_step():
        state[0], state[1], _ = step(state[0], state[1], tokens)

    one_step()
    kinds = profile_train_steps(f"training profile b{batch} x s{seq}",
                                one_step, run["step_ms"], steps)
    require(kinds["flash_bwd"] > 0 and kinds["flash_fwd"] > 0,
            f"training profile: no flash kernel time in the trace {kinds}")
    busy = sum(kinds.values()) / run["step_ms"]

    # the LM head's three f32 products (forward, d_x, d_w) on their own
    tokens_n, d, vocab = batch * seq, config.d_model, config.vocab_size
    x = torch.randn((tokens_n, d), device="cuda")
    w = torch.randn((d, vocab), device="cuda")
    g = torch.randn((tokens_n, vocab), device="cuda")
    head_ms = (cuda_ms(lambda: x @ w, 3) + cuda_ms(lambda: g @ w.T, 3)
               + cuda_ms(lambda: x.T @ g, 3))
    head_tflop = 3 * 2 * tokens_n * d * vocab / 1e12
    log(f"  LM head in f32: 3 GEMMs of {tokens_n} x {d} x {vocab} = "
        f"{head_tflop:.2f} TFLOP in {head_ms:.1f} ms "
        f"({head_tflop / head_ms * 1e3:.1f} TFLOP/s), "
        f"{100 * head_ms / run['step_ms']:.1f}% of the step")
    del x, w, g
    torch.cuda.empty_cache()
    return {"kinds": kinds, "busy": busy, "head_ms": head_ms}


def phase_training():
    import torch

    results = {"parity": training_parity()}
    results["t2t-base"] = training_run("t2t-base", 64, 1024, remat=False,
                                       policy="block", steps=20, sync_every=5)
    torch.cuda.empty_cache()
    results["t2t-big"] = training_run("t2t-big", 8, 4096, remat=True,
                                      policy="mlp", steps=8, sync_every=2)
    torch.cuda.empty_cache()
    results["profile"] = training_profile(results["t2t-base"])
    launches = {}
    for run in ("parity", "t2t-base", "t2t-big"):
        for key, count in results[run]["launches"].items():
            name = ("flash_bwd_" + key[4:] if key.startswith("bwd_")
                    else "flash_fwd_" + key)
            launches[name] = launches.get(name, 0) + count
    results["launches"] = launches
    return results


# -- phase 6 ------------------------------------------------------------------

def encoder_run():
    """The MLM encoder's main path at t2t-base, b64 x s1024, remat off,
    bf16 compute on f32 masters, head-blocked flash forward at G 4: token
    shards -> TokenDataset -> prefetch_to_device (one fixed batch), masked
    anew every step, pack_mlm_batch -> make_train_step(mlm_loss_packed);
    then mlm_evaluate over two more prefetched batches."""
    import dataclasses
    import tempfile

    import torch

    from tensorhive_tpu_torch import data, train
    from tensorhive_tpu_torch.models import encoder
    from tensorhive_tpu_torch.models.transformer import train_flops_per_token
    from tensorhive_tpu_torch.ops import flash_attention as fa

    config = dataclasses.replace(encoder.ENCODER_PRESETS["t2t-base"],
                                 remat=False, flash_bh_block=4)
    batch, seq, steps, sync_every = 64, 1024, 20, 5
    tc = train.TrainConfig(batch_size=batch, seq_len=seq, warmup_steps=2,
                           total_steps=100)
    label = f"encoder t2t-base b{batch} x s{seq}, G 4"
    with tempfile.TemporaryDirectory() as shards:
        # [MASK] (the top id) is never text
        pattern = data.fake_shards(shards, tokens_per_shard=1 << 20,
                                   vocab_size=config.vocab_size - 1)
        dataset = data.TokenDataset(data.DataConfig(
            pattern=pattern, seq_len=seq - 1, batch_size=batch,
            vocab_size=config.vocab_size))
        tokens = next(data.prefetch_to_device(dataset, 0, 1, device="cuda"))
        held_out = list(data.prefetch_to_device(dataset, 1, 2, device="cuda"))
    require(tokens.shape == (batch, seq) and tokens.device.type == "cuda"
            and torch.equal(tokens.cpu(),
                            torch.from_numpy(dataset.batch_at(0))),
            f"{label}: the prefetched batch is not batch_at(0)")
    losses = []

    def recording_loss(params, packed, model_config):
        loss = encoder.mlm_loss_packed(params, packed, model_config)
        losses.append(loss.detach())
        return loss

    params, opt_state = train.init_train_state(
        config, tc, torch.Generator(device="cuda").manual_seed(0), "cuda")
    step = train.make_train_step(config, tc, loss_fn=recording_loss)
    masks = torch.Generator(device="cuda").manual_seed(31)
    state = [params, opt_state]

    def one_step(_):
        packed = encoder.pack_mlm_batch(masks, tokens, config)
        state[0], state[1], _ = step(state[0], state[1], packed)

    reset_flash_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_ms, rejected = timed_steps(one_step, steps, sync_every)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    values = falling(label, losses)
    tokens_per_s = batch * seq / step_ms * 1e3
    mfu = tokens_per_s * train_flops_per_token(config, seq) / PEAK_FLOPS["bf16"]
    log(f"{label}: {steps} steps, masked loss {values[0]:.4f} -> "
        f"{values[-1]:.4f}; step {step_ms:.1f} ms (median of the steady "
        f"{sync_every}-step windows, {rejected} rejected); {tokens_per_s:.0f} "
        f"tokens/s; MFU {mfu:.4f} of {PEAK_FLOPS['bf16'] / 1e12:.0f} "
        f"TFLOP/s; peak memory {peak_gb:.2f} GB")
    counts = check_training_launches(label, config, steps, "bf16")
    evaluation = encoder.mlm_evaluate(state[0], config, iter(held_out), 2)
    eval_launches = fa.launches["bh_bf16"] - counts["bh_bf16"]
    require(math.isfinite(evaluation["loss"])
            and eval_launches == config.n_layers * 2
            and fa.launches["bf16"] == 0,
            f"{label}: mlm_evaluate {evaluation}, head-blocked launches "
            f"{eval_launches} (expected {config.n_layers * 2})")
    log(f"  mlm_evaluate over 2 prefetched batches: masked loss "
        f"{evaluation['loss']:.4f}, pseudo-perplexity "
        f"{evaluation['pseudo_perplexity']:.1f}; {eval_launches} head-blocked "
        f"launches")
    counts = dict(counts, bh_bf16=counts["bh_bf16"] + eval_launches)

    one_step(0)
    kinds = profile_train_steps(label, lambda: one_step(0), step_ms)
    require(kinds["flash_fwd_bh"] > 0 and kinds["flash_fwd"] == 0,
            f"{label}: the profile does not show the head-blocked kernel "
            f"alone: {kinds}")
    del state, params, opt_state
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "tokens_per_s": tokens_per_s, "mfu": mfu,
            "peak_gb": peak_gb, "losses": values, "launches": counts,
            "eval": evaluation, "kinds": kinds}


def encoder_parity():
    """The encoder through the head-blocked kernel in f32 (G 4 over
    B 4 x H 8), 3 packed MLM steps card vs CPU."""
    import torch

    from tensorhive_tpu_torch.models import encoder

    def packed_batch(config, tc, generator):
        tokens = torch.randint(0, config.vocab_size - 1,
                               (tc.batch_size, tc.seq_len),
                               generator=generator, dtype=torch.int32)
        return encoder.pack_mlm_batch(generator, tokens, config)

    return training_parity("encoder parity", encoder.mlm_loss_packed,
                           packed_batch, causal=False, flash_bh_block=4)


def leaf_checksums(tree):
    """Two integer sums over the raw bits of every leaf (plain and
    position-weighted), on the card: a change to any element, or two
    elements trading places, changes them."""
    import torch

    from tensorhive_tpu_torch.train import tree_leaves

    sums = []
    for leaf in tree_leaves(tree):
        width = {2: torch.int16, 4: torch.int32}[leaf.element_size()]
        bits = leaf.contiguous().view(width).flatten().to(torch.int64)
        weights = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        sums.append(torch.stack([bits.sum(), (bits * weights).sum()]))
        del bits, weights
    return torch.stack(sums).cpu()


def lora_run():
    """LoRA on the full 7b preset: a frozen bf16 base from a seed, rank-8
    f32 adapters on wq/wv, remat "mlp" (the preset's own), b4 x s2048, 8
    steps on one fixed batch; the loss must fall and the base stay bitwise
    as it was. Then merge and decode.generate 8 greedy tokens from the
    merged tree, whose logits must differ from the base's."""
    import torch

    from tensorhive_tpu_torch import train
    from tensorhive_tpu_torch.models import decode, lora
    from tensorhive_tpu_torch.models.transformer import PRESETS, TransformerLM

    config = PRESETS["7b"]
    # b4 x s2048 fits: 33.3 GB at peak on an 80 GB H100
    batch, seq, steps, sync_every = 4, 2048, 8, 2
    label = f"lora 7b rank 8 on wq/wv, b{batch} x s{seq}, remat mlp"
    generator = torch.Generator(device="cuda").manual_seed(41)
    base = TransformerLM.init(config, generator, "cuda")
    lora_config = lora.LoraConfig(rank=8, alpha=16.0)
    adapters = lora.init_lora(base, lora_config, generator)
    before = leaf_checksums(base)
    tc = train.TrainConfig(batch_size=batch, seq_len=seq, warmup_steps=2,
                           total_steps=100, learning_rate=1e-3)
    tokens = train.synthetic_batch(generator, tc, config.vocab_size, "cuda")
    losses = []

    def recording_loss(trained, batch_tokens, model_config):
        loss = lora.lora_loss(trained, batch_tokens, model_config,
                              base_params=base, lora_config=lora_config)
        losses.append(loss.detach())
        return loss

    step = train.make_train_step(config, tc, loss_fn=recording_loss)
    state = [adapters, train.make_optimizer(tc).init(adapters)]

    def one_step(_):
        state[0], state[1], _ = step(state[0], state[1], tokens)

    reset_flash_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_ms, rejected = timed_steps(one_step, steps, sync_every)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    values = falling(label, losses)
    tokens_per_s = batch * seq / step_ms * 1e3
    adapter_count = sum(t.numel() for t in train.tree_leaves(state[0]))
    log(f"{label}: {adapter_count} adapter params, {steps} steps, loss "
        f"{values[0]:.4f} -> {values[-1]:.4f}; step {step_ms:.1f} ms (median "
        f"of the steady {sync_every}-step windows, {rejected} rejected); "
        f"{tokens_per_s:.0f} tokens/s; peak memory {peak_gb:.2f} GB")
    counts = check_training_launches(label, config, steps, "bf16")
    require(torch.equal(leaf_checksums(base), before),
            f"{label}: the frozen base changed")
    log(f"  base unchanged: checksums of all "
        f"{len(train.tree_leaves(base))} leaves equal before and after")
    kinds = profile_train_steps(label, lambda: one_step(0), step_ms)

    with torch.no_grad():
        merged = lora.merge(base, state[0], lora_config)
        prompt = tokens[:1, :16]
        moved = (TransformerLM.apply(merged, prompt, config)
                 - TransformerLM.apply(base, prompt, config)).abs().max()
        out = decode.generate(merged, config, prompt, max_new_tokens=8,
                              device="cuda")
    torch.cuda.synchronize()
    require(moved.item() > 0, f"{label}: merged logits equal the base's")
    require(out.shape == (1, 24) and torch.equal(out[:, :16], prompt.int())
            and bool(((out >= 0) & (out < config.vocab_size)).all()),
            f"{label}: generate from the merged tree gave {out.tolist()}")
    require(torch.equal(leaf_checksums(base), before),
            f"{label}: merge or generate changed the base")
    log(f"  merged: max |logits(merged) - logits(base)| {moved.item():.3e}; "
        f"8 greedy tokens {out[0, 16:].tolist()}")
    del merged, base, state, adapters
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "tokens_per_s": tokens_per_s,
            "peak_gb": peak_gb, "losses": values, "launches": counts,
            "kinds": kinds}


def phase_families():
    results = {"encoder": encoder_run(), "parity": encoder_parity(),
               "lora": lora_run()}
    launches = {}
    for run in results.values():
        for key, count in run["launches"].items():
            name = ("flash_bwd_" + key[4:] if key.startswith("bwd_")
                    else "flash_fwd_" + key)
            launches[name] = launches.get(name, 0) + count
    results["launches"] = launches
    return results


# -- phase 7 ------------------------------------------------------------------

def release_device_memory():
    """Collect the reference cycles that keep a dropped engine's tensors
    alive (request <-> handle -> engine, engine <-> draft lane), then
    return the cached blocks: the serving runs hold 30-45 GB each."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def launch_expectation(engine):
    """(flash, paged) launches the engine's counters must show, with the
    product each is: every whole-prompt prefill launches the flash forward
    once per layer of the target and of the draft lane (whose mirror runs
    each prefill); a plain paged step launches paged decode once per layer;
    a speculative tick launches it only in the draft's k - 1 single-token
    steps, once per draft layer (the catch-up and verify windows attend in
    plain PyTorch); the contiguous layout's attention is plain PyTorch."""
    layers = engine.config.n_layers
    lane = engine._spec
    draft_layers = lane.draft_config.n_layers if lane is not None else 0
    flash = ((layers + draft_layers) * engine.prefills,
             f"({layers} + {draft_layers}) x {engine.prefills} prefills")
    if not engine.paged:
        return flash, (0, "0 (contiguous layout)")
    if lane is None:
        return flash, (layers * engine.step_dispatches,
                       f"{layers} x {engine.step_dispatches} step dispatches")
    steps = engine.spec_tokens - 1
    return flash, (draft_layers * steps * engine.draft_dispatches,
                   f"{draft_layers} draft layers x {steps} draft steps x "
                   f"{engine.draft_dispatches} draft dispatches")


def lane_report(engine):
    """The speculative lane's line of a run: acceptance, dispatches and the
    draft KV bytes beside the target's."""
    stats = engine.stats()
    if engine._spec is None:
        return "speculative off"
    draft = engine._spec.draft_config
    kind = "self" if engine._spec.shares_target else "own weights"
    return (f"speculative on: draft {draft.n_layers} layers (d_model "
            f"{draft.d_model}, {kind}), "
            f"specTokens {stats['specTokens']}, specAcceptanceRate "
            f"{stats['specAcceptanceRate']} ({stats['specAccepted']} of "
            f"{stats['specProposed']}), {engine.draft_dispatches} draft + "
            f"{engine.step_dispatches} verify dispatches; draft lane KV "
            f"{engine._spec.kv_cache_bytes / 1e9:.2f} GB beside the "
            f"target's {engine.kv_cache_bytes / 1e9:.2f} GB")


def serve(engine_factory, label, prompts, new_tokens, expected_buckets):
    """Reset the launch counters, build the engine (warmup included), serve
    the prompts with staggered joins, and check the counters exactly."""
    import torch

    from tensorhive_tpu_torch.ops import flash_attention as fa
    from tensorhive_tpu_torch.ops import paged_attention as pa
    from tensorhive_tpu_torch.train import tree_leaves

    for counter in (fa.launches, pa.launches):
        for key in counter:
            counter[key] = 0
    torch.cuda.synchronize()
    started = time.perf_counter()
    engine = engine_factory()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - started
    config = engine.config
    flash_key = "bf16" if config.dtype == torch.bfloat16 else "f32"
    paged_key = ("int8" if engine.kv_quant == "on" else flash_key)
    served = time.perf_counter()
    handles, join_ms = [], []
    for prompt in prompts:                        # staggered joins
        handles.append(engine.submit(prompt, max_new_tokens=new_tokens))
        before = time.perf_counter()
        engine.step()                             # prefill + decode step
        join_ms.append((time.perf_counter() - before) * 1e3)
    decode_ms = []
    while engine.has_work():
        before = time.perf_counter()
        engine.step()
        decode_ms.append((time.perf_counter() - before) * 1e3)
    wall_s = time.perf_counter() - served
    summaries = [h.result(timeout_s=60) for h in handles]
    flash_launches = dict(fa.launches)
    paged_launches = dict(pa.launches)
    stats = engine.stats()
    for prompt, summary in zip(prompts, summaries):
        require(summary["outcome"] == "completed"
                and len(summary["tokens"]) == new_tokens,
                f"{label}: request of {len(prompt)} tokens ended "
                f"{summary['outcome']} with {len(summary['tokens'])} tokens")
        require(all(0 <= t < config.vocab_size for t in summary["tokens"]),
                f"{label}: token out of vocabulary")
    if engine.paged:
        require(stats["kvPagesFree"] == stats["kvPagesTotal"],
                f"{label}: pages leaked: {stats['kvPagesFree']} free of "
                f"{stats['kvPagesTotal']}")
    else:
        require(stats["kvPagesTotal"] is None and stats["slotsBusy"] == 0,
                f"{label}: contiguous engine reports pages or busy slots")
    require(engine.prefills == len(expected_buckets),
            f"{label}: {engine.prefills} prefills, expected "
            f"{len(expected_buckets)} (buckets {expected_buckets})")
    (flash_expected, flash_what), (paged_expected, paged_what) = \
        launch_expectation(engine)
    require(flash_launches[flash_key] == flash_expected
            and sum(flash_launches.values()) == flash_launches[flash_key],
            f"{label}: flash launches {flash_launches} != {flash_what}")
    require(paged_launches[paged_key] == paged_expected
            and sum(paged_launches.values()) == paged_launches[paged_key],
            f"{label}: paged launches {paged_launches} != {paged_what}")
    require(engine.prefill_chunks == 0,
            f"{label}: {engine.prefill_chunks} chunked prefills")
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(engine.params))
    tokens = sum(len(s["tokens"]) for s in summaries)
    steady = decode_ms[len(decode_ms) // 4:] or decode_ms
    tick = "speculative tick" if engine._spec is not None else "decode step"
    log(f"serving {label}: build+warmup {build_s:.2f} s; "
        f"{len(prompts)} requests x {new_tokens} tokens in {wall_s:.3f} s = "
        f"{tokens / wall_s:.1f} tokens/s; {tick} "
        f"{sum(steady) / len(steady):.2f} ms (mean of the last "
        f"{len(steady)} of {len(decode_ms)} ticks after the joins, 8 slots); "
        f"weights {param_bytes / 1e9:.2f} GB + KV cache "
        f"{engine.kv_cache_bytes / 1e9:.2f} GB")
    log(f"  {lane_report(engine)}")
    log(f"  TTFT s: " + ", ".join(
        f"{len(p)}->{s['ttftS']:.3f}" for p, s in zip(prompts, summaries)))
    log(f"  join ticks ms (whole-prompt prefill + decode step): " + ", ".join(
        f"{len(p)}->{ms:.1f}" for p, ms in zip(prompts, join_ms))
        + f"; longest {max(join_ms):.1f}")
    log(f"  launches: flash {flash_launches} = {flash_what}; paged "
        f"{paged_launches} = {paged_what}")
    result = {"tokens": [s["tokens"] for s in summaries],
              "step_ms": sum(steady) / len(steady),
              "tokens_per_s": tokens / wall_s,
              "acceptance": stats["specAcceptanceRate"],
              "longest_join_ms": max(join_ms),
              "flash": (flash_key, flash_launches[flash_key]),
              "paged": (paged_key, paged_launches[paged_key])}
    del engine, handles
    release_device_memory()
    return result


KERNEL_KINDS = (("paged_decode", ("paged_decode",)),
                ("flash_fwd_bh", ("flash_fwd_bh",)),
                ("flash_fwd", ("flash_fwd",)),
                ("flash_bwd", ("flash_dq", "flash_dkv")),
                ("matmul", ("gemm", "nvjet", "cutlass", "xmma")))


def profile_window(run, steps):
    """Trace ``steps`` calls of ``run`` with torch.profiler; returns the
    device ms per call by kind of kernel and the kernel launches per
    call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    kinds = {kind: 0.0 for kind, _ in KERNEL_KINDS}
    kinds["other"] = 0.0
    launched = 0
    for event in prof.key_averages():
        if event.device_type != DeviceType.CUDA:
            continue
        kind = next((kind for kind, tags in KERNEL_KINDS
                     if any(tag in event.key for tag in tags)), "other")
        kinds[kind] += event.self_device_time_total / 1e3 / steps
        launched += event.count
    return kinds, launched / steps


def profile_steps(engine, label, steps=3):
    """Trace ``steps`` decode steps; print the device time per step by kind
    of kernel and the kernels launched per step, and return the device
    (kernel) ms per step."""
    kinds, launched = profile_window(engine.step, steps)
    total = sum(kinds.values())
    require(total > 0, f"{label}: the trace shows no device time")
    log(f"  profile ({steps} decode steps, 8 slots): {total:.2f} ms of "
        f"kernels per step (" + ", ".join(
            f"{kind} {ms:.2f}" for kind, ms in kinds.items())
        + f"); {launched:.0f} kernel launches per step")
    return total


def phase_serving(card):
    import dataclasses

    import numpy as np
    import torch

    from tensorhive_tpu_torch.config import GenerationConfig
    from tensorhive_tpu_torch.core.services.generation import build_engine
    from tensorhive_tpu_torch.models.decode import _prefill_bucket
    from tensorhive_tpu_torch.models.transformer import PRESETS, TransformerLM
    from tensorhive_tpu_torch.serving.engine import SlotEngine

    max_len, new_tokens = 4096, 32
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 32_000, length).tolist()
               for length in (1, 17, 300, 1500, 3000)]
    warm = [_prefill_bucket(max(1, n - 1), max_len - 1)
            for n in (16, max_len // 2)]
    buckets = warm + [_prefill_bucket(len(p) - 1, max_len - 1)
                      for p in prompts if len(p) > 1]
    log(f"serving: 7b preset, 8 slots, max_len {max_len}, prompts "
        f"{[len(p) for p in prompts]}, prefill buckets {buckets}")

    def generation(**knobs):
        # every run that measures the plain step pins the lane off (auto
        # turns it on for the card); the speculative section asks for it
        knobs.setdefault("speculative", "off")
        return GenerationConfig(preset="7b", slots=8, max_len=max_len,
                                paged_kernel="on", prefix_cache="off",
                                **knobs)

    runs = {}
    runs["int8"] = serve(lambda: build_engine(generation()),
                         "bf16 weights, int8 pages", prompts, new_tokens,
                         buckets)
    runs["bf16"] = serve(lambda: build_engine(generation(kv_quant="off")),
                         "bf16 weights, bf16 pages", prompts, new_tokens,
                         buckets)
    greedy = [a == b for x, y in zip(runs["int8"]["tokens"],
                                     runs["bf16"]["tokens"])
              for a, b in zip(x, y)]
    log(f"  greedy match rate int8 vs bf16 pages: "
        f"{sum(greedy) / len(greedy):.4f} (informational)")

    f32_config = dataclasses.replace(PRESETS["7b"], dtype=torch.float32)

    def f32_engine(speculative="off", **knobs):
        # the same seeded weights in every f32 run
        engine = SlotEngine(TransformerLM.init(f32_config, device="cuda"),
                            f32_config, slots=8, max_len=max_len,
                            paged_kernel="on", kv_quant="off",
                            prefix_cache="off", max_new_tokens_cap=128,
                            speculative=speculative, device="cuda", **knobs)
        engine.warmup(prompt_lens=(16, max_len // 2))
        return engine

    runs["f32"] = serve(f32_engine, "f32 weights, f32 pages", prompts,
                        new_tokens, buckets)

    default = GenerationConfig(preset="7b", slots=8, max_len=max_len,
                               paged_kernel="on", speculative="off")
    runs["prefix"] = shared_prompt_run(
        default, "default engine (int8 pages), shared system prompt",
        runs["int8"]["longest_join_ms"])
    # the same traffic on bf16 pages, whose chunk writes need no
    # data-dependent indexing (the int8 row merge's does)
    runs["prefix_bf16"] = shared_prompt_run(
        dataclasses.replace(default, kv_quant="off"),
        "prefix cache on bf16 pages, shared system prompt",
        runs["bf16"]["longest_join_ms"])
    runs["tiering"] = tiering_run(card)
    runs["contiguous"] = serve(
        lambda: build_engine(generation(paged=False)),
        "bf16 weights, contiguous bf16 cache", prompts, new_tokens, buckets)
    greedy = [a == b for x, y in zip(runs["contiguous"]["tokens"],
                                     runs["bf16"]["tokens"])
              for a, b in zip(x, y)]
    log(f"  greedy match rate contiguous vs bf16 pages: "
        f"{sum(greedy) / len(greedy):.4f} (informational)")
    chunked_vs_whole_prefill()
    speculative_runs(runs, prompts, new_tokens, buckets, generation,
                     f32_engine, f32_config, default)

    # where a tick's device time goes, traced after the timed runs (the
    # profiler slows every later step of the process)
    engine = build_engine(generation())
    for prompt in prompts:
        engine.submit(prompt, max_new_tokens=new_tokens)
        engine.step()
    kernel_ms = profile_steps(engine, "bf16 weights, int8 pages")
    log(f"  device busy {100 * kernel_ms / runs['int8']['step_ms']:.1f}% of "
        f"the int8-page decode step ({runs['int8']['step_ms']:.2f} ms, "
        f"untraced)")
    engine.pump()
    del engine
    release_device_memory()
    engine = build_engine(default)
    profile_chunk_ticks(engine)
    del engine
    release_device_memory()
    profile_spec_ticks(dataclasses.replace(default, speculative="auto"),
                       prompts)
    return runs


def first_divergence(reference, tokens, prompts, params_factory, config):
    """Print where two runs' greedy tokens first part, and the plain f32
    target's top-2 logit gap there (a full forward of the prompt and the
    reference tokens before it): a gap near f32 rounding says a near-tie
    flipped between the window attention and the kernel; a wide one says
    the lane is wrong."""
    import torch

    from tensorhive_tpu_torch.models.transformer import TransformerLM

    for index, (ref, got) in enumerate(zip(reference, tokens)):
        position = next((j for j, (a, b) in enumerate(zip(ref, got))
                         if a != b), None)
        if position is None:
            continue
        params = params_factory()
        sequence = torch.tensor([prompts[index] + ref[:position]],
                                dtype=torch.int32, device="cuda")
        with torch.no_grad():
            logits = TransformerLM.apply(params, sequence, config)[0, -1]
        top = torch.topk(logits.float(), 2).values.tolist()
        log(f"  first divergence: request {index} ({len(prompts[index])} "
            f"tokens), generated position {position}: spec-off {ref[position]}"
            f", spec-on {got[position]}; spec-off target's top-2 logit gap "
            f"{top[0] - top[1]:.3e} (top logit {top[0]:.4f})")
        del params
        release_device_memory()
        return


def speculative_runs(runs, prompts, new_tokens, buckets, generation,
                     f32_engine, f32_config, default):
    """The speculative lane at the full 7b preset: f32 weights and pages
    with the 16-layer self-draft and with an independent 1b draft, each
    token-identical to the spec-off f32 run on the same seeded weights;
    bf16 pages (agreement informational); the default engine (int8 pages,
    prefix cache, ``speculative="auto"`` -> on) on the shared-system-prompt
    traffic. Then the spec-off f32 and default engines again, so spec-on
    and spec-off are timed in turns in this one process."""
    import dataclasses

    from tensorhive_tpu_torch.core.services.generation import build_engine
    from tensorhive_tpu_torch.models.transformer import TransformerLM

    def identical(key, label):
        if runs[key]["tokens"] != runs["f32"]["tokens"]:
            first_divergence(runs["f32"]["tokens"], runs[key]["tokens"],
                             prompts,
                             lambda: TransformerLM.init(f32_config,
                                                        device="cuda"),
                             f32_config)
        require(runs[key]["tokens"] == runs["f32"]["tokens"],
                f"{label}: greedy tokens differ from the spec-off f32 run's")
        log(f"  greedy tokens identical to the spec-off f32 run's "
            f"({sum(len(t) for t in runs[key]['tokens'])} tokens)")

    log("speculative lane (spec_tokens 4):")
    runs["spec_f32"] = serve(
        lambda: f32_engine("on"), "f32 weights, f32 pages, speculative, "
        "16-layer self-draft", prompts, new_tokens, buckets)
    identical("spec_f32", "speculative f32 self-draft")
    runs["spec_f32_1b"] = serve(
        lambda: f32_engine("on", draft_preset="1b"), "f32 weights, f32 "
        "pages, speculative, independent 1b draft", prompts, new_tokens,
        buckets)
    identical("spec_f32_1b", "speculative f32 with the 1b draft")
    runs["spec_bf16"] = serve(
        lambda: build_engine(generation(kv_quant="off", speculative="on")),
        "bf16 weights, bf16 pages, speculative, 16-layer self-draft",
        prompts, new_tokens, buckets)
    greedy = [a == b for x, y in zip(runs["spec_bf16"]["tokens"],
                                     runs["bf16"]["tokens"])
              for a, b in zip(x, y)]
    log(f"  greedy match rate spec-on vs spec-off bf16 pages: "
        f"{sum(greedy) / len(greedy):.4f} (informational)")
    auto = dataclasses.replace(default, speculative="auto")
    runs["spec_default"] = shared_prompt_run(
        auto, "default engine (int8 pages, prefix cache, speculative auto)",
        runs["int8"]["longest_join_ms"])
    require(runs["spec_default"]["speculative"] == "on",
            "speculative='auto' did not turn the lane on for the card")
    # in turns: the spec-off engines once more after the spec-on ones
    runs["f32_again"] = serve(f32_engine, "f32 weights, f32 pages, again",
                              prompts, new_tokens, buckets)
    require(runs["f32_again"]["tokens"] == runs["f32"]["tokens"],
            "the second spec-off f32 run's tokens differ from the first's")
    runs["prefix_again"] = shared_prompt_run(
        default, "default engine with speculative off, again",
        runs["int8"]["longest_join_ms"])
    log("speculative in turns (tokens/s, mean tick ms, acceptance): "
        + "; ".join(
            f"{key} {runs[key]['tokens_per_s']:.1f}, "
            f"{runs[key]['step_ms']:.2f}, {runs[key]['acceptance']}"
            for key in ("f32", "spec_f32", "spec_f32_1b", "f32_again",
                        "bf16", "spec_bf16", "prefix", "spec_default",
                        "prefix_again")))


def profile_spec_ticks(generation, prompts, steps=3):
    """The default engine with the lane on: the five prompts joined (128
    new tokens each, so all stay busy), prefilled in chunks, then three
    speculative ticks timed untraced and three traced; prints the device
    time per tick by kind of kernel and the busy share."""
    from tensorhive_tpu_torch.core.services.generation import build_engine

    engine = build_engine(generation)
    require(engine.speculative == "on", "profile: the lane is off")
    for prompt in prompts:
        engine.submit(prompt, max_new_tokens=128)
        engine.step()
    while any(slot is not None and not slot.prefill_done
              for slot in engine._slots):
        engine.step()
    busy = engine.stats()["slotsBusy"]
    untraced = []
    for _ in range(steps):
        before = time.perf_counter()
        engine.step()
        untraced.append((time.perf_counter() - before) * 1e3)
    chunks = engine.prefill_chunks
    tick_ms = sum(untraced) / len(untraced)
    kinds, launched = profile_window(engine.step, steps)
    require(engine.prefill_chunks == chunks,
            "speculative profile: a chunk ran in the traced ticks")
    total = sum(kinds.values())
    require(total > 0, "speculative profile: the trace shows no device time")
    log(f"  profile ({steps} speculative ticks, default engine, {busy} busy "
        f"slots): {total:.2f} ms of kernels per tick (" + ", ".join(
            f"{kind} {ms:.2f}" for kind, ms in kinds.items())
        + f"); {launched:.0f} kernel launches per tick; untraced tick "
        f"{tick_ms:.2f} ms (mean of {steps}), device busy "
        f"{100 * total / tick_ms:.1f}%")
    del engine                      # the unfinished requests go with it
    release_device_memory()


def expected_prefix(prompts, page_size, chunk_tokens, min_tokens):
    """What the prefix cache's page rule gives each prompt admitted in this
    order, each after the earlier ones' prefills were dispatched: (cached
    tokens, prefill chunks) per prompt. Whole pages only, never the page
    holding the prompt's last position, a match shorter than
    ``min_tokens`` a miss; the prefill covers positions cached ..
    len - 2 in chunks of ``chunk_tokens``."""
    cached_pages = set()
    result = []
    for prompt in prompts:
        target = len(prompt) - 1
        limit = target // page_size
        matched = 0
        while (matched < limit and tuple(prompt[:(matched + 1) * page_size])
               in cached_pages):
            matched += 1
        cached = matched * page_size
        if cached < min_tokens:
            cached = 0
        remaining = target - min(cached, target)
        result.append((cached, -(-remaining // chunk_tokens)))
        cached_pages.update(tuple(prompt[:(j + 1) * page_size])
                            for j in range(limit))
    return result


def shared_prompt_run(generation, label, whole_prompt_longest_ms):
    """A prefix-cache engine (chunked prefill, chunks of 256) on a chat
    service's traffic: a 2,048-token system prompt P, a warm
    request P + 63 served to its first token, then one join per tick —
    P + 1/17/300/1,000 tokens, the warm prompt again, P[:1000] + 200
    divergent tokens, an unrelated 3,000-token prompt — 32 new tokens
    each. Checks the prefix counters, the chunk count the page rule gives,
    the launch counters (no flash launch) and that no page leaked."""
    import numpy as np
    import torch

    from tensorhive_tpu_torch.core.services.generation import build_engine
    from tensorhive_tpu_torch.ops import flash_attention as fa
    from tensorhive_tpu_torch.ops import paged_attention as pa

    new_tokens = 32
    for counter in (fa.launches, pa.launches):
        for key in counter:
            counter[key] = 0
    torch.cuda.synchronize()
    started = time.perf_counter()
    engine = build_engine(generation)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - started
    config = engine.config
    paged_key = "int8" if engine.kv_quant == "on" else "bf16"
    stats = engine.stats()
    require(stats["prefixCache"] == "on" and stats["prefillChunkTokens"] == 256
            and config.dtype == torch.bfloat16,
            f"{label}: not a bf16 prefix-cache engine: {stats}")
    warmup_chunks = engine.prefill_chunks
    rng = np.random.default_rng(1)

    def unique(n):
        return rng.integers(0, config.vocab_size, n).tolist()

    system = unique(2048)
    warm = system + unique(63)
    divergent = system[:1000] + unique(200)
    divergent[1000] = (system[1000] + 1) % config.vocab_size
    requests = [("P+63 warm", warm), ("P+1", system + unique(1)),
                ("P+17", system + unique(17)), ("P+300", system + unique(300)),
                ("P+1000", system + unique(1000)), ("warm again", list(warm)),
                ("P[:1000]+200", divergent), ("unrelated 3000", unique(3000))]
    expected = expected_prefix([prompt for _, prompt in requests],
                               engine.page_size, engine.prefill_chunk_tokens,
                               engine.prefix_min_tokens)
    log(f"serving {label}: 7b preset, 8 slots, max_len {engine.max_len}, "
        f"chunks of {engine.prefill_chunk_tokens}, build+warmup "
        f"{build_s:.2f} s; requests (tokens, cached, chunks): " + ", ".join(
            f"{name} ({len(prompt)}, {cached}, {chunks})"
            for (name, prompt), (cached, chunks) in zip(requests, expected)))
    ticks = []                                  # (ms, chunks dispatched)

    def tick():
        chunks = engine.prefill_chunks
        before = time.perf_counter()
        engine.step()
        ticks.append(((time.perf_counter() - before) * 1e3,
                      engine.prefill_chunks - chunks))

    served = time.perf_counter()
    handles = [engine.submit(warm, max_new_tokens=new_tokens)]
    while engine.stats()["tokensEmitted"] == 0:
        tick()
    warm_ticks = len(ticks)
    for _, prompt in requests[1:]:                # one join per tick
        handles.append(engine.submit(prompt, max_new_tokens=new_tokens))
        tick()
    while engine.has_work():
        tick()
    wall_s = time.perf_counter() - served
    summaries = [h.result(timeout_s=60) for h in handles]
    stats = engine.stats()
    flash_launches, paged_launches = dict(fa.launches), dict(pa.launches)
    for (name, _), summary in zip(requests, summaries):
        require(summary["outcome"] == "completed"
                and len(summary["tokens"]) == new_tokens
                and all(0 <= t < config.vocab_size
                        for t in summary["tokens"]),
                f"{label}: {name} ended {summary['outcome']} with "
                f"{summary['tokens']}")
    hits = sum(1 for cached, _ in expected if cached)
    require((hits, len(expected) - hits) == (6, 2),
            f"{label}: the page rule gives {hits} hits, expected 6")
    require((stats["prefixHits"], stats["prefixMisses"]) == (6, 2),
            f"{label}: {stats['prefixHits']} hits, {stats['prefixMisses']} "
            "misses, expected 6 and 2")
    chunks = engine.prefill_chunks - warmup_chunks
    require(chunks == sum(c for _, c in expected)
            and sum(c for _, c in ticks) == chunks,
            f"{label}: {chunks} chunks, the page rule gives "
            f"{sum(c for _, c in expected)}")
    require(warm_ticks == expected[0][1],
            f"{label}: warm request's first token after {warm_ticks} ticks, "
            f"expected {expected[0][1]} chunks")
    require(engine.prefills == 0 and sum(flash_launches.values()) == 0,
            f"{label}: flash launches {flash_launches}, "
            f"{engine.prefills} whole-prompt prefills")
    # the draft lane mirrors each chunk without adding to prefill_chunks
    paged_expected, paged_what = launch_expectation(engine)[1]
    require(paged_launches[paged_key] == paged_expected
            and sum(paged_launches.values()) == paged_launches[paged_key],
            f"{label}: paged launches {paged_launches} != {paged_what}")
    require(stats["kvPagesFree"] + stats["cachedPages"]
            == stats["kvPagesTotal"] and stats["slotsBusy"] == 0,
            f"{label}: pages leaked: {stats['kvPagesFree']} free + "
            f"{stats['cachedPages']} cached of {stats['kvPagesTotal']}")
    chunk_ticks = [ms for ms, c in ticks if c]
    decode_ticks = [ms for ms, c in ticks[warm_ticks + len(requests) - 1:]
                    if not c]
    steady = decode_ticks[len(decode_ticks) // 4:] or decode_ticks
    tokens = sum(len(s["tokens"]) for s in summaries)
    log(f"  {len(requests)} requests x {new_tokens} tokens in {wall_s:.3f} s "
        f"= {tokens / wall_s:.1f} tokens/s; {chunks} chunks in "
        f"{len(chunk_ticks)} ticks; prefixHits {stats['prefixHits']}, "
        f"prefixMisses {stats['prefixMisses']}, cachedPages "
        f"{stats['cachedPages']}, kvPagesFree {stats['kvPagesFree']} of "
        f"{stats['kvPagesTotal']}")
    log("  TTFT s: " + ", ".join(
        f"{name} {'hit' if cached else 'miss'} -> {s['ttftS']:.3f}"
        for (name, _), (cached, _), s in zip(requests, expected, summaries)))
    tick = "speculative tick" if engine._spec is not None else "decode step"
    log(f"  {tick} {sum(steady) / len(steady):.2f} ms (mean of the last "
        f"{len(steady)} ticks without a chunk); longest tick with a chunk "
        f"{max(chunk_ticks):.1f} ms (mean {sum(chunk_ticks) / len(chunk_ticks):.1f}"
        f") against {whole_prompt_longest_ms:.1f} ms for the longest "
        f"whole-prompt join tick of the prefix_cache=\"off\" {paged_key} "
        "run")
    by_chunks = {}
    for ms, count in ticks:
        by_chunks.setdefault(count, []).append(ms)
    log("  tick ms by chunks dispatched in it: " + ", ".join(
        f"{count} -> mean {sum(v) / len(v):.1f}, max {max(v):.1f} "
        f"({len(v)} ticks)" for count, v in sorted(by_chunks.items())))
    log(f"  launches: flash {flash_launches}; paged {paged_launches} = "
        f"{paged_what}")
    log(f"  {lane_report(engine)}")
    result = {"tokens": [s["tokens"] for s in summaries],
              "speculative": engine.speculative,
              "step_ms": sum(steady) / len(steady),
              "tokens_per_s": tokens / wall_s,
              "acceptance": stats["specAcceptanceRate"],
              "flash": ("bf16", flash_launches["bf16"]),
              "paged": (paged_key, paged_launches[paged_key])}
    del engine, handles
    release_device_memory()
    return result


def promoting(engine):
    """Whether a slot is parked on a promotion still in the copy lane."""
    return any(state is not None and state.promote_job is not None
               for state in engine._slots)


def tier_copy_rates(engine, pages, card):
    """The tier's copies of ``pages`` (a promoted run) on this engine: the
    device-to-host and host-to-device copies alone, on the engine's copy
    stream between pinned buffers, timed with CUDA events; and the copy
    lane's two jobs on their own thread's clock — the demotion (pinned
    staging, copy out, wait, split per page) and the promotion (assembly
    into pinned staging, copy up, wait). Prints ms and GB/s of the
    pages' bytes and returns them."""
    import torch

    from tensorhive_tpu_torch.serving.paging import HostPageEntry

    extracted, ready = engine._dispatch_page_extract(pages)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in extracted)
    require(nbytes == len(pages) * engine._page_bytes,
            f"tier: {nbytes} bytes for {len(pages)} pages of "
            f"{engine._page_bytes}")
    stream = engine._copy_stream
    pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
              for t in extracted]
    back = [torch.empty_like(t) for t in extracted]

    def timed(copy, reps=5):
        with torch.cuda.stream(stream):
            copy()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for _ in range(reps):
                copy()
            end.record(stream)
        end.synchronize()
        return start.elapsed_time(end) / reps

    def down():
        for host, tensor in zip(pinned, extracted):
            host.copy_(tensor, non_blocking=True)

    def up():
        for tensor, host in zip(back, pinned):
            tensor.copy_(host, non_blocking=True)

    d2h_ms, h2d_ms = timed(down), timed(up)
    require(all(torch.equal(a, b) for a, b in zip(back, extracted)),
            "tier: pages changed on a copy out and back")
    before = time.perf_counter()
    _, split = engine._materialize_demotion([b""] * len(pages), extracted,
                                            ready)
    demote_lane_ms = (time.perf_counter() - before) * 1e3
    entries = [HostPageEntry(*page, last_used=0) for page in split]
    before = time.perf_counter()
    staged, _ = engine._stage_promotion(entries)
    promote_lane_ms = (time.perf_counter() - before) * 1e3
    require(all(torch.equal(a, b) for a, b in zip(staged, extracted)),
            "tier: a staged promotion differs from the gathered pages")
    rate = lambda ms: nbytes / ms / 1e6                       # GB/s
    log(f"  tier copies of {len(pages)} pages ({nbytes / 1e6:.1f} MB, "
        f"{card}): copy out (device to pinned host, copy stream, CUDA "
        f"events) {d2h_ms:.3f} ms = {rate(d2h_ms):.1f} GB/s; copy up "
        f"{h2d_ms:.3f} ms = {rate(h2d_ms):.1f} GB/s; the lane's demotion "
        f"job {demote_lane_ms:.2f} ms = {rate(demote_lane_ms):.1f} GB/s and "
        f"promotion job {promote_lane_ms:.2f} ms = "
        f"{rate(promote_lane_ms):.1f} GB/s (host clock, staging included)")
    return {"d2h_ms": d2h_ms, "h2d_ms": h2d_ms,
            "demote_lane_ms": demote_lane_ms,
            "promote_lane_ms": promote_lane_ms}


def tiering_run(card):
    """KV-page tiering on the full 7b preset through build_engine: int8
    pages, chunks of 256, spec off, 1 GiB of host RAM, a pool small enough
    that two 3,000-token misses push a 2,048-token system prompt's cached
    run out to the host. Traffic, one join per tick: P + 17 (a miss),
    P + 17 (an HBM hit, tokens T), two 3,000-token misses, then two
    background requests decoding while P + 17 comes back as a host hit
    (its promotion in flight beside their ticks), and P + 17 once more (an
    HBM hit on the run the promotion reseeded). Then two guards on the same
    engine: a deadline that ends a 3,000-token miss mid-prefill, and an
    injected step fault the next ticks recover from with the same
    tokens."""
    import numpy as np
    import torch

    from tensorhive_tpu_torch.config import GenerationConfig
    from tensorhive_tpu_torch.core.services.generation import build_engine
    from tensorhive_tpu_torch.ops import flash_attention as fa
    from tensorhive_tpu_torch.ops import paged_attention as pa
    from tensorhive_tpu_torch.serving import faults
    from tensorhive_tpu_torch.serving.paging import page_content_key

    new_tokens, page, pool = 32, 16, 340
    label = "tiering (7b, int8 pages, 1 GiB host)"
    for counter in (fa.launches, pa.launches):
        for key in counter:
            counter[key] = 0
    torch.cuda.synchronize()
    started = time.perf_counter()
    engine = build_engine(GenerationConfig(
        preset="7b", slots=8, max_len=4096, paged_kernel="on",
        speculative="off", page_size=page, kv_pages=pool,
        host_kv_bytes=1 << 30))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - started
    config = engine.config
    require(engine.kv_quant == "on" and engine.prefill_chunk_tokens == 256
            and engine._copy_stream is not None
            and engine._copy_stream.cuda_stream
            != torch.cuda.current_stream().cuda_stream
            and engine.default_deadline_s == 120.0,
            f"{label}: not a tiered int8 engine with a copy stream")
    rng = np.random.default_rng(2)

    def unique(n):
        return rng.integers(0, config.vocab_size, n).tolist()

    system = unique(2048)
    p17 = system + unique(17)
    misses = [unique(3000), unique(3000)]
    background = [unique(100), unique(100)]
    pages_for = engine._pool.pages_for
    run_pages = (len(p17) - 1) // page
    miss_pages, miss_cached = pages_for(3000 + new_tokens), 2999 // page
    free_after = pool - run_pages - miss_cached
    log(f"serving {label}: build+warmup {build_s:.2f} s; pool {pool} pages "
        f"of {engine._page_bytes} B; P + 17 needs "
        f"{pages_for(len(p17) + new_tokens)} pages and caches {run_pages}; "
        f"a 3,000-token miss needs {miss_pages} and caches {miss_cached}: "
        f"after the HBM hit {pool - run_pages} pages are free, after the "
        f"first miss {free_after}, and the second's shortfall of "
        f"{miss_pages - free_after} evicts P's {run_pages} least recently "
        "used pages first")
    ticks = []                              # (ms, chunks, promotion in flight)

    def tick():
        chunks, was = engine.prefill_chunks, promoting(engine)
        before = time.perf_counter()
        engine.step()
        ticks.append(((time.perf_counter() - before) * 1e3,
                      engine.prefill_chunks - chunks,
                      was or promoting(engine)))

    def serve_alone(prompt):
        handle = engine.submit(prompt, max_new_tokens=new_tokens)
        while engine.has_work():
            tick()
        return handle.result(timeout_s=60)

    miss = serve_alone(p17)
    hbm = serve_alone(p17)
    tokens = hbm["tokens"]
    cached, run = engine._prefix.match(p17)
    require(cached == run_pages * page and len(run) == run_pages,
            f"{label}: P + 17 cached {cached} tokens, expected "
            f"{run_pages * page}")
    snapshot = [t[:, run].clone() for t in engine._cache]
    for prompt in misses:
        require(serve_alone(prompt)["outcome"] == "completed",
                f"{label}: a 3,000-token miss did not complete")
    store = engine._host_store
    require(engine._prefix.match(p17)[0] == 0
            and all(page_content_key(p17, i, page) in store
                    for i in range(run_pages)),
            f"{label}: P's run was not pushed out to the host whole")
    runners = [engine.submit(prompt, max_new_tokens=64)
               for prompt in background]
    while min(len(h._request.generated) for h in runners) < 4:
        tick()
    first_tick = len(ticks)
    host = engine.submit(p17, max_new_tokens=new_tokens)
    tick()
    require(promoting(engine) or engine.host_kv_promotions == run_pages,
            f"{label}: the host hit did not park on a promotion")
    while not host._request.generated:
        tick()
    again = engine.submit(p17, max_new_tokens=new_tokens)
    while engine.has_work():
        tick()
    host_summary = host.result(timeout_s=60)
    again_summary = again.result(timeout_s=60)
    require(all(h.result(timeout_s=60)["outcome"] == "completed"
                for h in runners), f"{label}: a background request failed")
    require(host_summary["tokens"] == tokens
            and again_summary["tokens"] == tokens,
            f"{label}: host hit {host_summary['tokens']} / HBM hit again "
            f"{again_summary['tokens']} != HBM hit {tokens}")
    _, promoted = engine._prefix.match(p17)
    require(len(promoted) == run_pages
            and all(torch.equal(t[:, promoted], before)
                    for t, before in zip(engine._cache, snapshot)),
            f"{label}: the promoted pages differ from the snapshot taken "
            "before the churn")
    require(engine.host_kv_hits == 1
            and engine.host_kv_promotions == run_pages
            and host._request.record.host_hit_pages == run_pages
            and engine.host_kv_fallbacks == 0,
            f"{label}: hits {engine.host_kv_hits}, promotions "
            f"{engine.host_kv_promotions} (schedule: {run_pages}), fallbacks "
            f"{engine.host_kv_fallbacks}")
    stats = engine.stats()
    require(stats["kvPagesFree"] + stats["cachedPages"] == pool
            and stats["slotsBusy"] == 0,
            f"{label}: pages leaked: {stats['kvPagesFree']} free + "
            f"{stats['cachedPages']} cached of {pool}")
    lookups = engine.host_kv_hits + engine.host_kv_misses
    require(stats["hostPagesResident"] == store.resident_pages
            == engine.host_kv_demotions and store.evictions == 0
            and stats["hostBytesUsed"] == store.bytes_used
            == store.resident_pages * engine._page_bytes
            and stats["hostHitRate"] == round(engine.host_kv_hits / lookups,
                                              4)
            and stats["hostKvBytes"] == 1 << 30,
            f"{label}: stats host keys disagree with the counters: {stats}")
    flash_launches, paged_launches = dict(fa.launches), dict(pa.launches)
    layers = config.n_layers
    require(sum(flash_launches.values()) == 0
            and paged_launches["int8"] == layers * engine.step_dispatches
            and sum(paged_launches.values()) == paged_launches["int8"],
            f"{label}: launches flash {flash_launches}, paged "
            f"{paged_launches} != {layers} x {engine.step_dispatches}")
    span = ticks[first_tick:]
    in_flight = [ms for ms, chunks, flying in span if flying]
    around = [ms for ms, chunks, flying in span if not flying and not chunks]
    log(f"  TTFT s ({card}): P + 17 miss {miss['ttftS']:.3f}, HBM hit "
        f"{hbm['ttftS']:.3f}, host hit {host_summary['ttftS']:.3f} (promote "
        f"{host._request.record.promote_ms:.1f} ms, join to inject, host "
        "clock), "
        f"HBM hit after the promotion {again_summary['ttftS']:.3f}")
    log(f"  ticks with 2-4 slots decoding ({card}): {len(in_flight)} with "
        f"the promotion in flight, mean {sum(in_flight) / len(in_flight):.1f} "
        f"ms, max {max(in_flight):.1f} (" + ", ".join(
            f"{ms:.1f}" for ms in in_flight) + f"); {len(around)} around "
        f"them without a chunk, mean {sum(around) / len(around):.1f} ms, "
        f"max {max(around):.1f}")
    log(f"  host tier: hits {engine.host_kv_hits}, misses "
        f"{engine.host_kv_misses}, demotions {engine.host_kv_demotions}, "
        f"promotions {engine.host_kv_promotions}, fallbacks "
        f"{engine.host_kv_fallbacks}; {stats['hostPagesResident']} pages "
        f"resident, {stats['hostBytesUsed'] / 1e6:.1f} MB of "
        f"{stats['hostKvBytes'] / 2**20:.0f} MiB; kvPagesFree "
        f"{stats['kvPagesFree']} + cachedPages {stats['cachedPages']} = "
        f"{pool}; launches paged {paged_launches['int8']} = {layers} x "
        f"{engine.step_dispatches}")
    rates = tier_copy_rates(engine, promoted, card)

    # guard 1: a deadline that passes mid-prefill frees the slot
    doomed = engine.submit(unique(3000), max_new_tokens=new_tokens,
                           deadline_s=0.3)
    chunks = engine.prefill_chunks
    while engine.has_work():
        engine.step()
    summary = doomed.result(timeout_s=60)
    stats = engine.stats()
    require(summary["outcome"] == "timeout" and summary["tokens"] == []
            and 0 < engine.prefill_chunks - chunks < 12
            and stats["kvPagesFree"] + stats["cachedPages"] == pool
            and stats["slotsBusy"] == 0,
            f"{label}: the 0.3 s deadline ended {summary['outcome']} after "
            f"{engine.prefill_chunks - chunks} of 12 chunks; pages "
            f"{stats['kvPagesFree']} + {stats['cachedPages']} of {pool}")
    log(f"  deadline 0.3 s on a 3,000-token miss: timeout after "
        f"{engine.prefill_chunks - chunks} of 12 chunks, "
        f"{summary['durationS']:.3f} s ({card}); no page leaked")

    # guard 2: an injected step fault, then the same tokens
    probes = [p17, unique(20)]

    def serve_probes(fault_at=None):
        handles = [engine.submit(p, max_new_tokens=16) for p in probes]
        raised, ticks_run = 0, 0
        while engine.has_work():
            if ticks_run == fault_at:
                engine.fault_plan.fail_next("step")
            try:
                engine.step()
            except faults.DeviceLostError:
                raised += 1
            ticks_run += 1
        return [h.result(timeout_s=60)["tokens"] for h in handles], raised

    reference, _ = serve_probes()
    engine.fault_plan = faults.ServingFaultPlan()
    recovered, raised = serve_probes(fault_at=5)
    require(raised == 1 and engine.fault_plan.faults_injected["step"] == 1
            and recovered == reference,
            f"{label}: an injected step fault raised {raised} times; tokens "
            f"after it {recovered} != {reference}")
    log("  injected step fault: raised out of step() once; the next ticks "
        "gave the unfaulted run's tokens")
    log(f"  tiering section {time.perf_counter() - started:.1f} s, build "
        f"included ({card})")
    result = {"tokens": tokens, "flash": ("bf16", flash_launches["bf16"]),
              "paged": ("int8", paged_launches["int8"]),
              "ttft": (miss["ttftS"], hbm["ttftS"], host_summary["ttftS"]),
              **rates}
    del engine, host, again, runners, doomed
    release_device_memory()
    return result


def chunked_vs_whole_prefill(prompt_len=3000, chunk=256):
    """A 2-layer model at 7b widths in f32 with f32 pages: one prompt's K/V
    written in chunks of ``chunk`` through the chunked prefill body and at
    once through the whole-prompt body (the f32 flash-forward kernel) into
    a second page set. Every written K/V row (the d_head values of one
    position and KV head) must be within ABS_TOL of the other, relative to
    the row."""
    import dataclasses

    import torch

    from tensorhive_tpu_torch.models.decode import KVCache, _prefill_bucket
    from tensorhive_tpu_torch.models.transformer import (
        PRESETS,
        TransformerLM,
        _rmsnorm,
    )
    from tensorhive_tpu_torch.serving.engine import (
        _paged_chunk_prefill_body,
        _paged_prefill_body,
    )

    config = dataclasses.replace(PRESETS["7b"], n_layers=2,
                                 dtype=torch.float32)
    generator = torch.Generator(device="cuda").manual_seed(2)
    params = TransformerLM.init(config, generator, device="cuda")
    page_size, max_len = 16, 4096
    num_pages = max_len // page_size
    prompt = torch.randint(0, config.vocab_size, (prompt_len,),
                           generator=generator, device="cuda",
                           dtype=torch.int32)
    written = prompt_len - 1                  # the head the engine prefills
    row = torch.arange(1, num_pages + 1, dtype=torch.int32, device="cuda")
    shape = (config.n_layers, num_pages + 1, page_size, config.kv_heads,
             config.d_head)
    chunked, whole = (KVCache(torch.zeros(shape, device="cuda"),
                              torch.zeros(shape, device="cuda"))
                      for _ in range(2))
    for start in range(0, written, chunk):
        length = min(chunk, written - start)
        head = torch.zeros((1, chunk), dtype=torch.int32, device="cuda")
        head[0, :length] = prompt[start:start + length]
        _paged_chunk_prefill_body(params, head, chunked, row, start, length,
                                  config)
    head = torch.zeros((1, _prefill_bucket(written, max_len - 1)),
                       dtype=torch.int32, device="cuda")
    head[0, :written] = prompt[:written]
    _paged_prefill_body(params, head, whole, row, written, config)
    positions = torch.arange(written, device="cuda")
    pages, offsets = row.long()[positions // page_size], positions % page_size
    worst = {}
    for name, ours, theirs in zip(("k", "v"), chunked, whole):
        for layer in range(config.n_layers):
            a = ours[layer][pages, offsets]           # [written, Hkv, Dh]
            b = theirs[layer][pages, offsets]
            require(bool(torch.isfinite(a).all()) and b.abs().max() > 0,
                    f"chunked prefill {name}{layer}: not finite or empty")
            rel = ((a - b).norm(dim=-1)
                   / b.norm(dim=-1).clamp_min(1e-30)).max().item()
            worst[f"{name}{layer}"] = rel
    # layer 0's K/V see no attention: what differs there is the f32 GEMM of
    # the K projection at M = chunk rows against M = the bucket's rows
    block = params["blocks"][0]
    normed = _rmsnorm(params["tok_embed"][head.long()],
                      block["attn_norm"]["scale"])
    narrow = normed[:, :chunk] @ block["wk"]
    wide = (normed @ block["wk"])[:, :chunk]
    projection = ((narrow - wide).norm(dim=-1)
                  / wide.norm(dim=-1).clamp_min(1e-30)).max().item()
    log(f"chunked vs whole-prompt prefill: 2-layer 7b widths f32, f32 pages, "
        f"{prompt_len}-token prompt, chunks of {chunk}: largest row-relative "
        f"K/V difference " + ", ".join(f"{key} {value:.3e}"
                                       for key, value in worst.items())
        + f" (tolerance {ABS_TOL}); the layer-0 K projection alone, M "
        f"{chunk} against M {head.shape[1]}: {projection:.3e}")
    require(max(worst.values()) <= ABS_TOL,
            f"chunked prefill K/V differ from the whole-prompt prefill's by "
            f"{max(worst.values()):.3e} > {ABS_TOL} of the row")
    del params, chunked, whole
    release_device_memory()
    return worst


def profile_chunk_ticks(engine, steps=3):
    """Two requests decoding while an unrelated 3,000-token prompt chunks:
    trace ``steps`` ticks that each run a prefill chunk and a decode step;
    print the device time per tick by kind of kernel."""
    import numpy as np

    rng = np.random.default_rng(3)
    vocab = engine.config.vocab_size
    for length in (17, 300):
        engine.submit(rng.integers(0, vocab, length).tolist(),
                      max_new_tokens=32)
        engine.step()
    engine.submit(rng.integers(0, vocab, 3000).tolist(), max_new_tokens=4)
    engine.step()                               # chunk 1
    chunks = engine.prefill_chunks
    kinds, launched = profile_window(engine.step, steps)
    require(engine.prefill_chunks - chunks == steps,
            f"chunk profile: {engine.prefill_chunks - chunks} chunks in "
            f"{steps} ticks")
    total = sum(kinds.values())
    require(total > 0, "chunk profile: the trace shows no device time")
    log(f"  profile ({steps} ticks, each a 256-token chunk of a 3000-token "
        f"miss + a decode step of 2 slots): {total:.2f} ms of kernels per "
        f"tick (" + ", ".join(f"{kind} {ms:.2f}" for kind, ms in kinds.items())
        + f"); {launched:.0f} kernel launches per tick")
    engine.pump()


# -- report -------------------------------------------------------------------

# -- phase 8 ------------------------------------------------------------------

SERVICE_PROMPT_LENS = (17, 100, 300, 600, 1000, 1500, 2200, 3000)


def reset_launches():
    from tensorhive_tpu_torch.ops import flash_attention as fa
    from tensorhive_tpu_torch.ops import paged_attention as pa

    for counter in (fa.launches, pa.launches):
        for key in counter:
            counter[key] = 0


def service_generation(**knobs):
    """The daemon's serving config: the full 7b preset, the default engine
    (int8 pages, prefix cache, chunks of 256), the speculative lane off
    (int8 pages with the lane are not token-exact), a 20 ms pump tick."""
    from tensorhive_tpu_torch.config import GenerationConfig

    base = dict(preset="7b", slots=8, max_len=4096, paged_kernel="on",
                speculative="off", interval_s=0.02)
    return GenerationConfig(**{**base, **knobs})


def serve_clients(prompts, new_tokens, clients=4):
    """``clients`` threads each submit their share of ``prompts`` to the
    published engine under their own user key, all at once, then read the
    streams as an API layer would; returns the threads and, per prompt,
    (tokens, error, request id, client TTFT s, handle). A client reads its
    streams one after the other, so its TTFT is measured on its first
    stream only (None on the others)."""
    import threading

    from tensorhive_tpu_torch import serving

    results = [None] * len(prompts)

    def client(index):
        engine = serving.get_engine()
        submitted = {n: (time.perf_counter(), engine.submit(
            prompts[n], max_new_tokens=new_tokens,
            user_key=f"client{index}"))
            for n in range(index, len(prompts), clients)}
        for order, (n, (started, handle)) in enumerate(submitted.items()):
            tokens, first, error = [], None, None
            try:
                for token in handle.tokens(timeout_s=120):
                    if first is None and order == 0:
                        first = time.perf_counter() - started
                    tokens.append(token)
            except (RuntimeError, TimeoutError) as exc:
                error = f"{type(exc).__name__}: {exc}"
            results[n] = (tokens, error, handle.request_id, first, handle)

    threads = [threading.Thread(target=client, args=(index,))
               for index in range(clients)]
    for thread in threads:
        thread.start()
    return threads, results


def join_all(threads, label, timeout_s=180):
    for thread in threads:
        thread.join(timeout=timeout_s)
    require(not any(thread.is_alive() for thread in threads),
            f"{label}: a client thread did not finish")


def check_registry(engine, baseline, requests, label):
    """Every engine family of the registry against ``stats()`` and the
    engine's counters (``baseline``: the counters when the registry was
    zeroed; ``requests``: the requests served since, each to its last
    token)."""
    from tensorhive_tpu_torch.observability import (
        get_registry,
        parse_rendered,
    )

    samples = parse_rendered(get_registry().render())
    stats = engine.stats()

    def sample(name):
        return samples.get(name, 0.0)

    emitted = engine.emitted_tokens
    expected = {
        'tpuhive_generate_requests_total{outcome="completed"}':
            engine.completed_requests,
        "tpuhive_generate_tokens_total": emitted,
        "tpuhive_generate_queue_depth": stats["queueDepth"],
        "tpuhive_generate_queue_capacity": stats["queueCapacity"],
        "tpuhive_generate_slots_busy": stats["slotsBusy"],
        "tpuhive_generate_slots_total": stats["slots"],
        "tpuhive_generate_kv_pages_free": stats["kvPagesFree"],
        "tpuhive_generate_kv_pages_total": stats["kvPagesTotal"],
        "tpuhive_generate_kv_bytes_capacity":
            stats["kvPagesTotal"] * engine._page_bytes,
        "tpuhive_generate_kv_bytes_used":
            engine._pool.used_pages * engine._page_bytes,
        "tpuhive_generate_mesh_devices": stats["numDevices"],
        "tpuhive_generate_prefix_hits_total": stats["prefixHits"],
        "tpuhive_generate_prefix_misses_total": stats["prefixMisses"],
        "tpuhive_generate_prefix_cached_pages": stats["cachedPages"],
        "tpuhive_generate_ttft_seconds_count": requests,
        "tpuhive_generate_queue_wait_seconds_count": requests,
        "tpuhive_generate_intertoken_seconds_count": emitted - requests,
        "tpuhive_generate_batch_efficiency_count":
            engine.steps - baseline["steps"],
        "tpuhive_generate_prefill_chunks_count": requests,
        "tpuhive_generate_prefill_chunks_sum":
            engine.prefill_chunks - baseline["chunks"],
    }
    for index in range(engine.capacity):
        expected[f'tpuhive_generate_slot_kv_pages{{slot="{index}"}}'] = \
            float(len(engine._pool.owned_pages(index)))
    wrong = {name: (sample(name), value) for name, value in expected.items()
             if sample(name) != value}
    require(not wrong, f"{label}: registry != engine: {wrong}")
    return len(expected)


def service_run(card):
    """The serving daemon on the full 7b preset: GenerationService's pump
    thread serving client threads, with the engine's observability, then a
    fatal fault and the rebuild, the drain, and checkpoint loading."""
    import dataclasses
    import json
    import shutil
    import threading

    import numpy as np
    import torch

    from tensorhive_tpu_torch import config as port_config
    from tensorhive_tpu_torch import serving, train
    from tensorhive_tpu_torch.config import Config
    from tensorhive_tpu_torch.core.services.generation import (
        GenerationService,
        build_engine,
    )
    from tensorhive_tpu_torch.models.transformer import PRESETS, TransformerLM
    from tensorhive_tpu_torch.observability import (
        get_registry,
        get_request_ledger,
        get_tracer,
        parse_rendered,
        profiling,
        reset_observability,
    )
    from tensorhive_tpu_torch.observability.accounting import \
        get_tenant_meter
    from tensorhive_tpu_torch.ops import flash_attention as fa
    from tensorhive_tpu_torch.ops import paged_attention as pa
    from tensorhive_tpu_torch.serving import EngineDrainingError, faults
    from tensorhive_tpu_torch.serving.flight_recorder import (
        list_crash_dumps,
        load_crash_dump,
    )
    from tensorhive_tpu_torch.telemetry import TelemetryEmitter

    label = "service (7b, GenerationService)"
    started = time.perf_counter()
    new_tokens = 32
    workdir = REPO / "build" / "service_smoke"
    shutil.rmtree(workdir, ignore_errors=True)
    release_device_memory()
    generation = service_generation()
    rng = np.random.default_rng(4)
    # no two prompts share a first token, so none can match another's
    # cached prefix (prefix_min_tokens 32): no request's tokens depend on
    # the order of arrival
    firsts = rng.permutation(32_000)[:len(SERVICE_PROMPT_LENS)]
    prompts = [[int(first)] + rng.integers(0, 32_000, n - 1).tolist()
               for first, n in zip(firsts, SERVICE_PROMPT_LENS)]

    # each prompt alone through a bare engine of the same config
    bare = build_engine(generation)
    bare_build_s = time.perf_counter() - started
    expected = []
    for prompt in prompts:
        handle = bare.submit(prompt, max_new_tokens=new_tokens)
        bare.pump()
        expected.append(handle.result(timeout_s=120)["tokens"])
    del bare, handle
    release_device_memory()
    bare_s = time.perf_counter() - started

    reset_observability()
    config = Config(config_dir=workdir)
    config.generation = generation
    service = GenerationService(config)
    engine = service.engine
    require(engine is not None and serving.get_engine() is engine
            and engine.device.type == "cuda" and engine.kv_quant == "on"
            and engine.prefill_chunk_tokens == 256
            and engine.flight_recorder is not None
            and engine.tenant_meter is get_tenant_meter() is not None,
            f"{label}: not the published default engine with its hooks")
    layers = engine.config.n_layers
    # warmup's dispatches; the engine's request counters start at 0
    baseline = {"steps": engine.steps, "chunks": engine.prefill_chunks}
    dispatches = engine.step_dispatches
    torch.cuda.synchronize()
    reset_launches()
    service.start()
    served = time.perf_counter()
    threads, results = serve_clients(prompts, new_tokens)
    emitter = TelemetryEmitter(name="chip-smoke",
                               metrics_dir=str(workdir / "metrics"),
                               min_write_interval_s=0.0)
    time.sleep(0.5)
    before = torch.cuda.memory_allocated()
    busy_sample = emitter.sample(step_time_s=0.5)
    after = torch.cuda.memory_allocated()
    join_all(threads, label)
    wall_s = time.perf_counter() - served
    deadline = time.monotonic() + 60
    while engine.has_work() and time.monotonic() < deadline:
        time.sleep(0.01)
    require(service.is_alive() and not engine.has_work(),
            f"{label}: the pump thread died or left work behind")
    ticks = service.tick_latency_stats()
    duty = service._tick_hist.sum / (time.perf_counter() - served)
    launches = (dict(fa.launches), dict(pa.launches))
    step_dispatches = engine.step_dispatches - dispatches
    for n, (tokens, error, rid, _, _) in enumerate(results):
        require(error is None and tokens == expected[n],
                f"{label}: request {n} ({len(prompts[n])} tokens) gave "
                f"{tokens} / {error}, alone {expected[n]}")
    require(sum(launches[0].values()) == 0
            and launches[1]["int8"] == layers * step_dispatches
            and sum(launches[1].values()) == launches[1]["int8"],
            f"{label}: launches flash {launches[0]}, paged {launches[1]} != "
            f"{layers} x {step_dispatches} step dispatches")
    rows = {row["requestId"]: row for row in get_request_ledger().recent()}
    require(len(rows) == len(prompts)
            and all(rows[r[2]]["outcome"] == "completed" for r in results),
            f"{label}: ledger rows {[(k, v['outcome']) for k, v in rows.items()]}")
    for rid, row in rows.items():
        require(row["queueMs"] <= row["ttftMs"] <= row["totalMs"]
                and row["prefillMs"] >= 0 and row["decodeMs"] >= 0
                and row["prefillCompile"] == "hit"
                and row["tokens"] == new_tokens,
                f"{label}: row {rid} phases out of order: {row}")
    spans = get_tracer().recent(kind="generate")
    for rid in rows:
        names = [s["name"] for s in spans if s["attrs"]["request_id"] == rid]
        require(names[:1] == ["generate.queue"]
                and "generate.decode" in names
                and ("generate.prefill" in names),
                f"{label}: spans of {rid}: {names}")
    checked = check_registry(engine, baseline, len(prompts), label)
    stats = engine.stats()
    totals = engine.tenant_meter.totals()
    device_s = sum(usage.device_seconds for usage in totals.values())
    require(stats["busySlotSeconds"] > 0 and abs(
        device_s - engine.busy_slot_seconds) <= 1e-6 * device_s
            and set(totals) == {f"client{i}" for i in range(4)},
            f"{label}: tenants' device-seconds {device_s} != busy "
            f"slot-seconds {engine.busy_slot_seconds}: {totals}")
    recorder = engine.flight_recorder
    ring = recorder.snapshot()
    require(recorder.recorded == len(ring)
            and sum(t["admitted"] for t in ring) == len(prompts)
            and sum(t["prefillChunks"] for t in ring)
            == engine.prefill_chunks - baseline["chunks"]
            and sum(t["decodeSlots"] for t in ring) == engine.emitted_tokens
            and sum(t["compiles"] + t["faults"] for t in ring) == 0,
            f"{label}: the recorder's {recorder.recorded} ticks do not sum "
            "to the engine's counters")
    used = busy_sample["0"]["hbm_used_bytes"]
    require(min(before, after) - (1 << 30) <= used <= max(before, after)
            + (1 << 30) and busy_sample["0"]["hbm_total_bytes"]
            == torch.cuda.get_device_properties(0).total_memory,
            f"{label}: telemetry under load {used} B, memory_allocated "
            f"{before}..{after}")
    idle_sample = emitter.sample(step_time_s=0.0)
    idle_bytes = torch.cuda.memory_allocated()
    with open(emitter.path) as handle:
        drop = json.load(handle)
    require(idle_sample["0"]["hbm_used_bytes"] == idle_bytes
            and drop == idle_sample and set(drop["0"]) == {
                "hbm_used_bytes", "hbm_total_bytes", "duty_cycle_pct"},
            f"{label}: idle drop file {drop}, memory_allocated {idle_bytes}")
    emitter.close()
    # the live-bytes gauge, refreshed at scrape time while profiling is on
    config.profiling.enabled = True
    port_config.set_config(config)
    summary = profiling.device_memory_summary(get_registry())
    live = parse_rendered(get_registry().render()).get(
        'tpuhive_device_hbm_live_bytes{device="cuda:0"}')
    require(summary["totalLiveBytes"] == live == idle_bytes
            == torch.cuda.memory_allocated(),
            f"{label}: device memory summary {summary}, gauge {live}, "
            f"memory_allocated {idle_bytes}")
    port_config.reset_config()
    ledger_ttft = [rows[r[2]]["ttftMs"] for r in results]
    handle_ttft = [r[4].result(timeout_s=5)["ttftS"] * 1e3 for r in results]
    client_ttft = [f"{r[3] * 1e3:.1f}" if r[3] is not None else "-"
                   for r in results]
    log(f"service {card}: bare engine built in {bare_build_s:.1f} s, each "
        f"prompt alone {bare_s - bare_build_s:.1f} s; "
        f"daemon: {len(prompts)} requests x {new_tokens} tokens from 4 "
        f"client threads in {wall_s:.3f} s; launches paged "
        f"{launches[1]['int8']} = {layers} x {step_dispatches}, flash 0; "
        f"{len(rows)} ledger rows, {len(spans)} spans, {checked} registry "
        f"samples = stats/counters; tenants' device-seconds {device_s:.6f} = "
        f"busySlotSeconds {stats['busySlotSeconds']}; {recorder.recorded} "
        f"recorder ticks")
    log(f"  pump: {service.ticks_completed} ticks, p50 "
        f"{ticks['p50'] * 1e3:.1f} ms, max {ticks['max'] * 1e3:.1f} ms, "
        f"{service.tick_overruns} overruns; duty cycle {100 * duty:.1f}% "
        f"(tick time over wall time since start)")
    log("  TTFT ms by prompt length, ledger row / handle summary / client "
        "thread: " + ", ".join(
            f"{len(p)}->{a:.1f}/{b:.1f}/{c}" for p, a, b, c in zip(
                prompts, ledger_ttft, handle_ttft, client_ttft)))
    log(f"  telemetry drop file: under load {used} B in use (memory_allocated "
        f"{before}..{after}); idle {idle_bytes} B = memory_allocated = "
        "tpuhive_device_hbm_live_bytes")

    # hooks on against off, in turns, on the daemon's engine stopped
    service.shutdown()
    service.join(timeout=60)
    require(not service.is_alive(), f"{label}: the pump did not stop")
    engine.resume()
    short = [[int(first)] + rng.integers(0, 32_000, 16).tolist()
             for first in firsts]
    hooks = (engine.flight_recorder, engine.tenant_meter)
    # the hooks' own host time, apart from the tick's: their entry points
    # timed through instance attributes, removed after the turns
    hook_s = [0.0]

    def timed(fn):
        def run(*args, **kwargs):
            began = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                hook_s[0] += time.perf_counter() - began
        return run

    recorder, meter = hooks
    timed_hooks = ((engine, "_meter_tick"), (recorder, "record"),
                   (meter, "count_tokens"), (meter, "charge_queue"))
    for owner, name in timed_hooks:
        setattr(owner, name, timed(getattr(owner, name)))
    turns = []                              # (hooks, tick ms of the turn)
    for turn in ("on", "off", "off", "on"):
        engine.flight_recorder, engine.tenant_meter = (
            hooks if turn == "on" else (None, None))
        for prompt in short:
            engine.submit(prompt, max_new_tokens=24)
        engine.step()                       # the joins and their chunks
        ticks_ms = []
        while engine.has_work():
            before_tick = time.perf_counter()
            engine.step()
            ticks_ms.append((time.perf_counter() - before_tick) * 1e3)
        turns.append((turn, sum(ticks_ms) / len(ticks_ms), len(ticks_ms)))
    engine.flight_recorder, engine.tenant_meter = hooks
    for owner, name in timed_hooks:
        delattr(owner, name)
    mean = {side: sum(ms for turn, ms, _ in turns if turn == side) / 2
            for side in ("on", "off")}
    on_ticks = sum(count + 1 for turn, _, count in turns if turn == "on")
    log(f"  decode tick, 8 slots, hooks (recorder + meter; ledger and "
        f"registry always on) on {mean['on']:.2f} ms vs off "
        f"{mean['off']:.2f} ms; turns " + ", ".join(
            f"{turn} {ms:.2f}" for turn, ms, _ in turns)
        + f" ({turns[0][2]} ticks each); the hooks' own host time "
        f"{hook_s[0] / on_ticks * 1e6:.1f} us a tick ({card})")

    # the fatal fault: the daemon again, a fault plan on its engine
    service = GenerationService(config, engine=engine,
                                engine_factory=service._engine_factory)
    service.start()
    plan = faults.ServingFaultPlan()
    engine.fault_plan = plan
    threads, doomed = serve_clients(prompts, new_tokens)
    deadline = time.monotonic() + 120
    while (sum(1 for slot in engine._slots if slot is not None)
           < engine.capacity and time.monotonic() < deadline):
        time.sleep(0.01)
    torch.cuda.synchronize()
    memory_before = torch.cuda.memory_allocated()
    fault_at = time.perf_counter()
    plan.fail_next("step")
    while serving.get_engine() in (None, engine):
        require(time.monotonic() < deadline + 120,
                f"{label}: no rebuilt engine published")
        time.sleep(0.005)
    rebuilt_s = time.perf_counter() - fault_at
    join_all(threads, label)
    rebuilt = serving.get_engine()
    probe = rebuilt.submit(prompts[0], max_new_tokens=new_tokens)
    probe_tokens = list(probe.tokens(timeout_s=120))
    serves_s = time.perf_counter() - fault_at
    release_device_memory()
    torch.cuda.synchronize()
    memory_after = torch.cuda.memory_allocated()
    dumps = list_crash_dumps(str(config.flightrec_dir))
    dump = (load_crash_dump(str(config.flightrec_dir), dumps[0]["file"])
            if dumps else {"inFlight": []})
    failed_ids = {r[2] for r in doomed}
    in_dump = {row["requestId"] for row in dump["inFlight"]}
    rows = {row["requestId"]: row for row in get_request_ledger().recent()}
    restarts = parse_rendered(get_registry().render()).get(
        "tpuhive_generate_engine_restarts_total")
    require(all(r[1] is not None and "engine fault" in r[1] for r in doomed)
            and all(rows[rid]["outcome"] == "failed" for rid in failed_ids),
            f"{label}: in-flight streams after the fault: "
            f"{[(len(r[0]), r[1]) for r in doomed]}")
    require(len(dumps) == 1 and failed_ids <= in_dump
            and "DeviceLostError" in dump["reason"]
            and dump["ticks"][-1]["faults"] == 1
            and "firingAlerts" not in dump,
            f"{label}: crash dumps {dumps}")
    require(serving.get_serving_state()["restarts"] == 1 and restarts == 1
            and rebuilt is not engine and engine.params is None,
            f"{label}: restarts {serving.get_serving_state()} / {restarts}")
    require(probe_tokens == expected[0],
            f"{label}: the rebuilt engine gave {probe_tokens}, "
            f"{expected[0]} before the fault")
    require(abs(memory_after - memory_before) <= 1 << 30,
            f"{label}: device memory {memory_before} B before the fault, "
            f"{memory_after} B after the rebuild")
    threads, again = serve_clients(prompts, new_tokens)
    join_all(threads, label)
    require([r[0] for r in again] == expected,
            f"{label}: the rebuilt engine's tokens differ from the bare "
            "engine's")
    log(f"  fatal step fault with {len(failed_ids)} requests in flight: "
        f"{len(failed_ids)} error chunks and failed rows, 1 crash dump "
        f"({len(in_dump)} in-flight rows, {len(dump['ticks'])} ticks), "
        f"restarts 1; rebuilt and published {rebuilt_s:.2f} s after the "
        f"fault, first request served {serves_s:.2f} s after it; device "
        f"memory {memory_before / 2**30:.3f} GiB before, "
        f"{memory_after / 2**30:.3f} GiB after ({card}); the same prompts "
        "gave the same tokens")

    # the trace while the daemon decodes; a second capture is refused
    engine = serving.get_engine()
    steps = engine.steps
    threads, traced = serve_clients(prompts[:4], 2 * new_tokens)
    deadline = time.monotonic() + 60
    while engine.steps < steps + 2 and time.monotonic() < deadline:
        time.sleep(0.005)
    refused = []

    def second():
        time.sleep(0.3)
        try:
            profiling.capture_trace(str(workdir / "profile-b"), 0.1)
        except profiling.ProfileInFlightError:
            refused.append(True)

    racer = threading.Thread(target=second)
    racer.start()
    traced_steps = engine.steps
    capture = profiling.capture_trace(str(workdir / "profile"), 1.0,
                                      tracer=get_tracer())
    traced_steps = engine.steps - traced_steps
    racer.join(timeout=30)
    join_all(threads, label)
    trace = json.loads((workdir / "profile" / capture["files"][0])
                       .read_text())
    kernels = {event.get("name", "") for event in trace["traceEvents"]
               if event.get("cat") == "kernel"}
    paged = sorted(name for name in kernels if "paged_decode" in name)
    require(refused == [True] and paged
            and all(r[1] is None for r in traced),
            f"{label}: trace of {capture['bytes']} B over {traced_steps} "
            f"decode steps, {len(kernels)} kernel names, paged decode "
            f"{paged[:1]}; second capture refused: {refused}; streams "
            f"{[r[1] for r in traced]}")
    log(f"  trace capture 1 s while serving: {capture['bytes']} B, "
        f"{traced_steps} decode steps, {len(kernels)} kernel names incl. "
        f"{paged[0][:60]}; a second capture refused")

    # the drain: shutdown with a long request in flight
    engine = serving.get_engine()
    long_request = engine.submit(prompts[-1], max_new_tokens=new_tokens)
    deadline = time.monotonic() + 60
    while (not any(slot is not None for slot in engine._slots)
           and time.monotonic() < deadline):
        time.sleep(0.005)
    stopper = threading.Thread(target=service.shutdown)
    stopper.start()
    while not engine.draining and time.monotonic() < deadline:
        time.sleep(0.001)
    estimate = engine.drain_retry_after()
    try:
        engine.submit(prompts[0], max_new_tokens=4)
        refused_with = None
    except EngineDrainingError as exc:
        refused_with = exc.retry_after_s
    after_estimate = engine.drain_retry_after()
    stopper.join(timeout=60)
    service.join(timeout=60)
    summary = long_request.result(timeout_s=60)
    # a prefix hit now (the prompt's pages are cached): on int8 pages its
    # tokens need not be a miss's, so only the completion is checked
    require(summary["outcome"] == "completed"
            and len(summary["tokens"]) == new_tokens
            and refused_with is not None
            and min(estimate, after_estimate) <= refused_with
            <= max(estimate, after_estimate)
            and serving.get_engine() is None and not service.is_alive(),
            f"{label}: drain: {summary['outcome']} with "
            f"{len(summary['tokens'])} tokens, refused with Retry-After "
            f"{refused_with} (estimates {estimate}, {after_estimate}), "
            f"published {serving.get_engine()}, pump alive "
            f"{service.is_alive()}")
    log(f"  drain: shutdown with a {len(prompts[-1])}-token request in "
        f"flight completed it; admission refused with Retry-After "
        f"{refused_with} s")
    del engine, rebuilt, service, long_request, probe
    del doomed, again, traced, results
    release_device_memory()

    # checkpoint load at 7b widths, 4 layers (the disk write ~2 GB)
    PRESETS["7b-4-layers"] = dataclasses.replace(PRESETS["7b"], n_layers=4)
    small = service_generation(preset="7b-4-layers", max_len=4096)
    params = TransformerLM.init(PRESETS["7b-4-layers"], device="cuda")
    in_memory = build_engine(small, params=params)
    handle = in_memory.submit(prompts[3], max_new_tokens=new_tokens)
    in_memory.pump()
    reference = handle.result(timeout_s=120)["tokens"]
    del in_memory, handle
    on_host = train.tree_map(lambda t: t.cpu(), params)
    del params
    release_device_memory()
    checkpoint = workdir / "checkpoint"
    saved = time.perf_counter()
    train.save_checkpoint(str(checkpoint), 7, on_host,
                          {"count": 0, "mu": {}, "nu": {}})
    nbytes = sum(path.stat().st_size for path in checkpoint.iterdir())
    save_s = time.perf_counter() - saved
    config.generation = dataclasses.replace(
        small, checkpoint_path=str(checkpoint))
    loaded = time.perf_counter()
    service = GenerationService(config)
    load_s = time.perf_counter() - loaded
    handle = service.engine.submit(prompts[3], max_new_tokens=new_tokens)
    service.engine.pump()
    from_disk = handle.result(timeout_s=120)["tokens"]
    service.shutdown()
    require(from_disk == reference,
            f"{label}: the checkpoint served {from_disk}, the in-memory "
            f"params {reference}")
    config.generation = dataclasses.replace(
        service_generation(), checkpoint_path=str(checkpoint))
    wrong = GenerationService(config)
    reason = serving.get_unavailable_reason()
    require(wrong.engine is None and serving.get_engine() is None
            and "does not fit preset params" in reason,
            f"{label}: the 7b daemon on a 4-layer checkpoint: engine "
            f"{wrong.engine}, reason {reason}")
    wrong.shutdown()
    log(f"  checkpoint: train.save_checkpoint wrote {nbytes} B (7b widths, "
        f"4 layers, bf16) in {save_s:.1f} s; a daemon on it built in "
        f"{load_s:.1f} s and served the in-memory params' greedy tokens; "
        f"the 32-layer 7b daemon on it stayed up with no engine: "
        f"{reason[:100]}")
    del service, wrong, handle, on_host
    del PRESETS["7b-4-layers"]
    shutil.rmtree(workdir, ignore_errors=True)
    release_device_memory()
    log(f"  service section {time.perf_counter() - started:.1f} s ({card})")
    return {"flash": ("bf16", 0), "paged": ("int8", launches[1]["int8"])}


def kernel_report(kernels, runs, path_launches):
    flash_src = "tensorhive_tpu_torch/csrc/flash_fwd.cu"
    paged_src = "tensorhive_tpu_torch/csrc/paged_decode.cu"
    bwd_src = "tensorhive_tpu_torch/csrc/flash_bwd.cu"
    flash_tpu = ("tensorhive_tpu/ops/flash_attention.py:191 "
                 "_fwd_kernel_resident + :228 _fwd_kernel")
    bh_tpu = "tensorhive_tpu/ops/flash_attention.py:265 _fwd_kernel_resident_bh"
    bwd_tpu = ("tensorhive_tpu/ops/flash_attention.py:440 _dq_kernel_resident"
               " + :521 _dq_kernel + :473 _dkv_kernel_resident + :549 "
               "_dkv_kernel")
    paged_tpu = "tensorhive_tpu/ops/paged_attention.py:128 _decode_kernel"
    launches = dict(path_launches)
    for run in runs.values():
        for kind in ("flash", "paged"):
            key, count = run[kind]
            name = f"{'flash_fwd' if kind == 'flash' else 'paged_decode'}_{key}"
            launches[name] = launches.get(name, 0) + count
    entries = []
    for name, rows in kernels.items():
        if name == "paged_decode_int8/bf16q":
            continue
        if name.startswith("flash_fwd_bh"):
            # the encoder's training attention, G 4, non-causal
            row = next(r for r in rows if r["seq"] == 1024
                       and not r["causal"] and r["g"] == 4)
            err = max(r["max_abs_err"] for r in rows)
            rel = max(r["max_row_rel_err"] for r in rows)
            source, replaces = flash_src, bh_tpu
        elif name.startswith("flash"):
            # the serving prefill bucket for the forward, the t2t-base
            # training attention for the backward
            row = (next(r for r in rows if r["seq"] == 4095)
                   if name.startswith("flash_fwd") else rows[0])
            err = max(r["max_abs_err"] for r in rows)
            rel = max(r["max_row_rel_err"] for r in rows)
            source, replaces = ((flash_src, flash_tpu)
                                if name.startswith("flash_fwd")
                                else (bwd_src, bwd_tpu))
        else:
            # the serving shape (rows[0]); errors over it and the sweep
            if name.endswith("int8"):
                # the serving case: int8 pages under a bf16 query
                rows = rows + kernels["paged_decode_int8/bf16q"]
                row = kernels["paged_decode_int8/bf16q"][0]
            else:
                row = rows[0]
            err = max(r["max_abs_err"] for r in rows)
            rel = max(r["max_row_rel_err"] for r in rows)
            source = paged_src
            replaces = paged_tpu + (
                "(quant=True)" if name.endswith("int8") else "(quant=False)")
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": err, "max_row_rel_err": rel, "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]}
        for key in ("library_max_row_rel_err", "max_row_excess",
                    "library_max_row_excess"):
            if key in row:
                entry[key] = max(r[key] for r in rows)
        entries.append(entry)
    return entries


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 2
    if not (REPO / "tensorhive_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: run it from a checkout of the repository "
              f"({REPO} has no tensorhive_tpu_torch/)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    started = time.perf_counter()
    phase = "device"
    try:
        card = phase_device()
        phase = "build"
        phase_build()
        phase = "kernels"
        log("== kernels")
        kernels = phase_kernels()
        phase = "model"
        log("== model")
        phase_model()
        phase = "training"
        log("== training")
        training = phase_training()
        phase = "families"
        log("== families")
        families = phase_families()
        phase = "serving"
        log("== serving")
        runs = phase_serving(card)
        phase = "service"
        log("== service")
        runs["service"] = service_run(card)
    except Exception:                       # every phase failure is fatal
        traceback.print_exc()
        print(f"chip_smoke: phase {phase} FAILED", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - started:.1f} s")
    launches = dict(training["launches"])
    for name, count in families["launches"].items():
        launches[name] = launches.get(name, 0) + count
    print(json.dumps({"kernels": kernel_report(kernels, runs, launches)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
