#!/usr/bin/env python3
"""Drive tensorhive_tpu_torch — the PyTorch + CUDA port — on one NVIDIA
H100 and check it end to end.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card of compute capability 9.0 and builds the kernels itself (nvcc,
into build/tensorhive_tpu_torch/). Phases, each fatal on failure:

1. device   — CUDA sm_90 present; prints the card's name and power limit.
2. build    — the three kernel libraries compiled from csrc/, one nvcc
              each, in parallel; ptxas registers/spills per kernel; the
              SASS of the bf16 flash forward and of both bf16 backward
              kernels (dQ, dK/dV) at d_head 64/128 must hold wgmma (HGMMA)
              and TMA loads (UTMALDG), that of both f32 backward kernels at
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
              (timed here only; the backward's gradients also held to the
              plain version by the kernel's measure, reported only);
              forward and backward lines add TFLOP/s, the share of the
              bound and the time over SDPA's.
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
              build_engine -> SlotEngine.submit -> pump -> result, paged
              with int8 pages (the default), then with bf16 pages, then
              the f32 model with f32 pages; launch counters must equal
              layers x prefills and layers x decode steps exactly. A
              torch.profiler window over three decode steps of the
              default engine closes the phase (device busy share).

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


def f32_grad_errors(grad, plain, exact, first_row_zero):
    """(max |grad - exact|, max row ||grad - exact|| / ||exact||, max row
    (||grad - exact|| - ||plain - exact||) / ||exact||) of one [B, S, H, D]
    f32 gradient against the f64 evaluation ``exact``, beside the exact-f32
    ``plain`` version; with ``first_row_zero`` the rows of token 0 are held
    against the largest row norm."""
    exact = exact.double()
    norms = exact.norm(dim=-1)
    largest = norms.max()
    require(largest.item() > 0, "the plain gradient is all zeros")
    error = (grad.double() - exact).norm(dim=-1)
    own = (plain.double() - exact).norm(dim=-1)
    scale = norms.clamp_min(1e-300)
    if first_row_zero:
        scale[:, 0] = largest
    return ((grad.double() - exact).abs().max().item(),
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
    follow a digit of the anonymous namespace's hash."""
    for match in re.finditer(r"(?=(\d+)([A-Za-z_]))", mangled):
        start = match.start(2)
        name = mangled[start:start + int(match.group(1))]
        if name.endswith("kernel"):
            dims = re.findall(r"Li(\d+)E", mangled[start + len(name):])
            return f"{name}<{', '.join(dims)}>"
    return mangled


#: SASS counted per kernel: wgmma (HGMMA), TF32 mma.sync (HMMA.1688.F32.TF32),
#: f64 mma.sync (DMMA), TMA loads (UTMALDG) and mbarrier operations (SYNCS)
SASS_OPS = ("HGMMA", "HMMA.1688.F32.TF32", "DMMA", "UTMALDG", "SYNCS")
#: by library: (kernels, d_heads, SASS each must hold) — the bf16 TMA +
#: wgmma kernels, and the f32 backward's kernels (three-pass TF32 products,
#: dO V^T in f64)
SASS_REQUIRED = {
    "flash_fwd": ((("flash_fwd_bf16_kernel", "flash_fwd_bh_bf16_kernel"),
                   (64, 128), ("HGMMA", "UTMALDG")),),
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
    del ref_out, ref_lse
    reps = 20 if seq <= 4096 else 5
    kernel_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                        reps)
    plain_ms = cuda_ms(lambda: fa.reference_attention(q, k, v, causal=True),
                       3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
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
    return row


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
    reps = 10 if variant == "bf16" else 3
    per_head_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                          reps)
    plain_ms = cuda_ms(lambda: fa.reference_attention(q, k, v, causal=causal),
                       1, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
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
    del ref_out, ref_lse, per_head, per_head_lse
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
            err, rel, beyond = f32_grad_errors(grad, ref, exact[index], first)
            own = f32_grad_errors(ref, ref, exact[index], first)[1]
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
            _, rel, beyond = f32_grad_errors(grad, refs[index], exact[index],
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
    kernel, single = (max(f32_grad_errors(g, r, e, name == "q")[2]
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
    handles = []
    for prompt in prompts:                        # staggered joins
        handles.append(engine.submit(prompt, max_new_tokens=new_tokens))
        engine.step()
    decode_ms = []
    while engine.has_work():
        before = time.perf_counter()
        engine.step()
        decode_ms.append((time.perf_counter() - before) * 1e3)
    wall_s = time.perf_counter() - served
    summaries = [h.result(timeout_s=60) for h in handles]
    layers = config.n_layers
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
    require(stats["kvPagesFree"] == stats["kvPagesTotal"],
            f"{label}: pages leaked: {stats['kvPagesFree']} free of "
            f"{stats['kvPagesTotal']}")
    require(engine.prefills == len(expected_buckets),
            f"{label}: {engine.prefills} prefills, expected "
            f"{len(expected_buckets)} (buckets {expected_buckets})")
    require(flash_launches[flash_key] == layers * engine.prefills
            and sum(flash_launches.values()) == flash_launches[flash_key],
            f"{label}: flash launches {flash_launches} != {layers} x "
            f"{engine.prefills} prefills")
    require(paged_launches[paged_key] == layers * engine.step_dispatches
            and sum(paged_launches.values()) == paged_launches[paged_key],
            f"{label}: paged launches {paged_launches} != {layers} x "
            f"{engine.step_dispatches} step dispatches")
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(engine.params))
    tokens = sum(len(s["tokens"]) for s in summaries)
    steady = decode_ms[len(decode_ms) // 4:] or decode_ms
    log(f"serving {label}: build+warmup {build_s:.2f} s; "
        f"{len(prompts)} requests x {new_tokens} tokens in {wall_s:.3f} s = "
        f"{tokens / wall_s:.1f} tokens/s; decode step "
        f"{sum(steady) / len(steady):.2f} ms (mean of the last "
        f"{len(steady)} steps, 8 slots); weights {param_bytes / 1e9:.2f} GB "
        f"+ KV cache {engine.kv_cache_bytes / 1e9:.2f} GB")
    log(f"  TTFT s: " + ", ".join(
        f"{len(p)}->{s['ttftS']:.3f}" for p, s in zip(prompts, summaries)))
    log(f"  launches: flash {flash_launches} = {layers} x {engine.prefills} "
        f"prefills; paged {paged_launches} = {layers} x "
        f"{engine.step_dispatches} step dispatches")
    result = {"tokens": [s["tokens"] for s in summaries],
              "step_ms": sum(steady) / len(steady),
              "flash": (flash_key, flash_launches[flash_key]),
              "paged": (paged_key, paged_launches[paged_key])}
    del engine
    torch.cuda.empty_cache()
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


def phase_serving():
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

    def f32_engine():
        config = dataclasses.replace(PRESETS["7b"], dtype=torch.float32)
        engine = SlotEngine(TransformerLM.init(config, device="cuda"), config,
                            slots=8, max_len=max_len, paged_kernel="on",
                            kv_quant="off", prefix_cache="off",
                            max_new_tokens_cap=128, device="cuda")
        engine.warmup(prompt_lens=(16, max_len // 2))
        return engine

    runs["f32"] = serve(f32_engine, "f32 weights, f32 pages", prompts,
                        new_tokens, buckets)

    # where a decode step's device time goes, traced after the timed runs
    # (the profiler slows every later step of the process)
    engine = build_engine(generation())
    for prompt in prompts:
        engine.submit(prompt, max_new_tokens=new_tokens)
        engine.step()
    kernel_ms = profile_steps(engine, "bf16 weights, int8 pages")
    log(f"  device busy {100 * kernel_ms / runs['int8']['step_ms']:.1f}% of "
        f"the int8-page decode step ({runs['int8']['step_ms']:.2f} ms, "
        f"untraced)")
    engine.pump()
    return runs


# -- report -------------------------------------------------------------------

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
        phase_device()
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
        runs = phase_serving()
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
