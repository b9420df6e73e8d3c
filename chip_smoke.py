#!/usr/bin/env python3
"""Drive tensorhive_tpu_torch — the PyTorch + CUDA port — on one NVIDIA
H100 and check it end to end.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card of compute capability 9.0 and builds the kernels itself (nvcc,
into build/tensorhive_tpu_torch/). Phases, each fatal on failure:

1. device   — CUDA sm_90 present; prints the card's name and power limit.
2. build    — both kernels compiled from csrc/, one nvcc each, in parallel.
3. kernels  — every kernel variant against its plain PyTorch version at
              the serving path's shapes (7b heads: H 32, Hkv 8, d 128),
              timed beside its bound and, for flash, PyTorch's
              scaled_dot_product_attention (timed here only).
4. model    — a 2-layer model at 7b widths in f32: logits on the card
              (flash kernel) against the CPU (plain reference).
5. serving  — the main path: the full 7b preset served through
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
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel is the
# larger of its bytes over the memory rate and its FLOPs over the rate of
# its operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

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


def bound_ms(flops: float, nbytes: float, variant: str):
    op_ms = flops / PEAK_FLOPS[variant] * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(op_ms, byte_ms), ("operations" if op_ms >= byte_ms else "bytes")


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


def phase_build():
    from tensorhive_tpu_torch.ops import cuda_build

    started = time.perf_counter()
    reports = cuda_build.build()
    log(f"build: {sorted(reports)} in {time.perf_counter() - started:.1f} s")
    for name, report in sorted(reports.items()):
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


# -- phase 3 ------------------------------------------------------------------

def flash_case(seq, heads, kv_heads, variant, generator):
    import torch
    import torch.nn.functional as F

    from tensorhive_tpu_torch.ops import flash_attention as fa

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[variant]
    d = 128

    def draw(h):
        return torch.randn((1, seq, h, d), generator=generator, device="cuda",
                           dtype=torch.float32).to(dtype)

    q, k, v = draw(heads), draw(kv_heads), draw(kv_heads)
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    ref_out, ref_lse = fa.reference_attention(
        q.float(), k.float(), v.float(), causal=True, return_lse=True)
    torch.cuda.synchronize()
    require(out.shape == q.shape and lse.shape == (heads, 1, seq),
            "flash output shapes")
    err, rel = errors(out, ref_out)
    lse_err = (lse - ref_lse).abs().max().item()
    require(within_tolerance(err, rel, variant == "bf16"),
            f"flash {variant} S={seq}: max |O - plain| {err}, max row "
            f"||O - plain|| / ||plain|| {rel}; tolerance "
            f"{ROW_REL_TOL if variant == 'bf16' else ABS_TOL}")
    require(math.isfinite(lse_err) and lse_err <= LSE_TOL,
            f"flash {variant} S={seq}: max |LSE - plain| {lse_err} > {LSE_TOL}")
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
    flops = 2.0 * seq * seq * heads * d            # causal QK^T + PV
    nbytes = (2 * seq * (heads + kv_heads) * d * itemsize
              + 4 * seq * heads)                   # q,k,v,o + lse
    bound, bound_by = bound_ms(flops, nbytes, variant)
    row = {"seq": seq, "heads": heads, "kv_heads": kv_heads, "d": d,
           "max_abs_err": err, "max_row_rel_err": rel, "lse_err": lse_err,
           "ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound, "bound_by": bound_by}
    log(f"flash_fwd {variant} S={seq} H={heads} Hkv={kv_heads}: err {err:.3e} "
        f"row_rel {rel:.3e} lse_err {lse_err:.3e} kernel {kernel_ms:.4f} ms plain "
        f"{plain_ms:.4f} ms sdpa {library_ms:.4f} ms bound {bound:.4f} ms "
        f"({bound_by})")
    return row


def paged_case(variant, generator):
    """8 slots at page 16, mixed positions up to 4095, slot 6 parked (position
    0, a row of trash pages). ``variant`` is the page type; ``int8/bf16q``
    is int8 pages under a bf16 query, the serving case."""
    import numpy as np
    import torch

    from tensorhive_tpu_torch.ops import paged_attention as pa

    heads, kv_heads, d, page_size, max_pages = 32, 8, 128, 16, 256
    positions = [4095, 2999, 1499, 299, 16, 15, 0, 2047]
    parked = 6
    rng = np.random.default_rng(7)
    live = [0 if slot == parked else pos // page_size + 1
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
    live_slots = [s for s in range(len(positions)) if s != parked]
    err, rel = errors(out[live_slots], ref[live_slots])
    bf16_out = q_dtype == torch.bfloat16
    require(within_tolerance(err, rel, bf16_out),
            f"paged {variant}: max |out - plain| {err}, max row "
            f"||out - plain|| / ||plain|| {rel}; tolerance "
            f"{ROW_REL_TOL if bf16_out else ABS_TOL}")
    kernel_ms = cuda_ms(lambda: pa.paged_attention(
        q, k_pages, v_pages, page_table, pos, k_scales=k_scales,
        v_scales=v_scales), 50)
    plain_ms = cuda_ms(lambda: pa.paged_attention_reference(
        q, k_pages, v_pages, page_table, pos, k_scales, v_scales), 10)
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
    log(f"paged_decode {variant}: err {err:.3e} row_rel {rel:.3e} kernel {kernel_ms:.4f} ms "
        f"plain {plain_ms:.4f} ms bound {bound:.4f} ms ({bound_by})")
    return row


def phase_kernels():
    import torch

    generator = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for variant in ("bf16", "f32"):
        rows = [flash_case(seq, 32, 8, variant, generator)
                for seq in (512, 4095, 4096)]
        rows.append(flash_case(16384, 4, 1, variant, generator))
        results[f"flash_fwd_{variant}"] = rows
        torch.cuda.empty_cache()
    for variant in ("bf16", "f32", "int8", "int8/bf16q"):
        results[f"paged_decode_{variant}"] = [paged_case(variant, generator)]
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

def serve(engine_factory, label, prompts, new_tokens, expected_buckets):
    """Reset the launch counters, build the engine (warmup included), serve
    the prompts with staggered joins, and check the counters exactly."""
    import torch

    from tensorhive_tpu_torch.ops import flash_attention as fa
    from tensorhive_tpu_torch.ops import paged_attention as pa

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
                      for t in _tensors(engine.params))
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


def profile_steps(engine, label, steps=3):
    """Trace ``steps`` decode steps with torch.profiler; print the device
    time per step by kind of kernel and the kernels launched per step, and
    return the device (kernel) ms per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    kinds = {"paged_decode": 0.0, "flash_fwd": 0.0, "matmul": 0.0,
             "other": 0.0}
    launched = 0
    for event in prof.key_averages():
        if event.device_type != DeviceType.CUDA:
            continue
        name = event.key
        kind = ("paged_decode" if "paged_decode" in name
                else "flash_fwd" if "flash_fwd" in name
                else "matmul" if any(tag in name for tag in
                                     ("gemm", "nvjet", "cutlass", "xmma"))
                else "other")
        kinds[kind] += event.self_device_time_total / 1e3 / steps
        launched += event.count
    total = sum(kinds.values())
    require(total > 0, f"{label}: the trace shows no device time")
    log(f"  profile ({steps} decode steps, 8 slots): {total:.2f} ms of "
        f"kernels per step (" + ", ".join(
            f"{kind} {ms:.2f}" for kind, ms in kinds.items())
        + f"); {launched / steps:.0f} kernel launches per step")
    return total


def _tensors(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, list):
        for value in tree:
            yield from _tensors(value)
    else:
        yield tree


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

def kernel_report(kernels, runs):
    flash_src = "tensorhive_tpu_torch/csrc/flash_fwd.cu"
    paged_src = "tensorhive_tpu_torch/csrc/paged_decode.cu"
    flash_tpu = ("tensorhive_tpu/ops/flash_attention.py:191 "
                 "_fwd_kernel_resident + :228 _fwd_kernel")
    paged_tpu = "tensorhive_tpu/ops/paged_attention.py:128 _decode_kernel"
    launches = {}
    for run in runs.values():
        for kind in ("flash", "paged"):
            key, count = run[kind]
            name = f"{'flash_fwd' if kind == 'flash' else 'paged_decode'}_{key}"
            launches[name] = launches.get(name, 0) + count
    entries = []
    for name, rows in kernels.items():
        if name == "paged_decode_int8/bf16q":
            continue
        if name.startswith("flash"):
            row = next(r for r in rows if r["seq"] == 4095)
            err = max(r["max_abs_err"] for r in rows)
            rel = max(r["max_row_rel_err"] for r in rows)
            source, replaces = flash_src, flash_tpu
        else:
            row = rows[0]
            err, rel = row["max_abs_err"], row["max_row_rel_err"]
            source = paged_src
            replaces = paged_tpu + (
                "(quant=True)" if name.endswith("int8") else "(quant=False)")
            if name.endswith("int8"):
                # the serving case: int8 pages under a bf16 query
                row = kernels["paged_decode_int8/bf16q"][0]
                err = max(err, row["max_abs_err"])
                rel = max(rel, row["max_row_rel_err"])
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": err, "max_row_rel_err": rel, "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
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
        phase = "serving"
        log("== serving")
        runs = phase_serving()
    except Exception:                       # every phase failure is fatal
        traceback.print_exc()
        print(f"chip_smoke: phase {phase} FAILED", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - started:.1f} s")
    print(json.dumps({"kernels": kernel_report(kernels, runs)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
