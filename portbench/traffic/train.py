"""Train batches: ``batch`` rows of ``seq_len`` + 1 token ids from the
seed, each row packed with documents whose lengths are lognormal
(``document``), each document ended by the configuration's end-of-text id.
Every step's rows differ.

Set-up builds the one train step (``train.make_train_step``) with its f32
master params and AdamW state and drives it from the seed through the
first ``checked_steps`` steps, whose losses, first gradient and change
the reference follows; the same step and state then run the window, one
synchronised step after another, until ``--seconds`` have passed.
"""
from __future__ import annotations

import sys
import time
from typing import Dict

import numpy as np

from portbench.harness import check, draws, env, weights
from portbench.harness.faults import wrap_step
from portbench.harness.record import Check, Run
from portbench.harness.serve import memory_peak, model_config, release
from portbench.harness.main import log
from portbench.harness.trace import Tracer


def make_batch(seed: int, step: int, traffic: Dict, vocab: int, eos: int,
               device):
    """Step ``step``'s rows, [batch, seq_len + 1] int32, on the device."""
    import torch

    rows, length = traffic["batch"], traffic["seq_len"] + 1
    tokens = torch.randint(0, vocab, (rows, length),
                           generator=weights.generator(seed, device, 40,
                                                       step),
                           device=device, dtype=torch.int32)
    rng = draws.rng(seed, 41, step)
    doc = traffic["document"]
    ends = []
    for row in range(rows):
        position = -1
        while True:
            position += max(1, int(round(doc["median"] * np.exp(
                doc["sigma"] * rng.standard_normal()))))
            if position >= length:
                break
            ends.append(row * length + position)
    if ends:
        flat = tokens.view(-1)
        flat[torch.as_tensor(ends, device=device)] = eos
    return tokens


def run(context) -> Run:
    import torch
    from tensorhive_tpu_torch.train import (
        AdamW, TrainConfig, make_train_step)

    cell, config = context.spec.cell, context.spec.config
    traffic, settings = cell["traffic"], config["training"]
    seconds = context.seconds
    result = Run(config=config, cell=dict(cell, _seconds=seconds))
    device, shape, seed = context.device, context.shape, context.seed
    model = model_config(config, traffic["seq_len"], training=True)
    train_config = TrainConfig(
        learning_rate=settings["learning_rate"],
        warmup_steps=settings["warmup_steps"],
        total_steps=settings["total_steps"],
        weight_decay=settings["weight_decay"],
        max_grad_norm=settings["max_grad_norm"],
        batch_size=traffic["batch"], seq_len=traffic["seq_len"])
    eos = config["eos_token_id"]

    def batch(step: int):
        return make_batch(seed, step, traffic, shape.vocab, eos, device)

    params = weights.params(shape, seed, device, torch.float32)
    optimizer = AdamW(train_config)
    state = optimizer.init(params)
    log(context, "state built")
    step = wrap_step(context.args.fault, make_train_step(model,
                                                         train_config))
    checked = cell["check"]["steps"]
    program: Dict = {"loss": []}
    for index in range(1, checked + 1):
        params, state, out = step(params, state, batch(index))
        program["loss"].append(float(out["loss"]))
        if index == 1:
            program["grad"] = check.norms(state["mu"],
                                          1.0 / (1.0 - optimizer.b1))
    with torch.no_grad():
        program["change"] = check.change_norms(params, shape, seed, device)
    log(context, f"checked steps done: {program['loss']}")
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    sync()
    tracer = Tracer(bool(context.args.trace), cell["trace_steps"])
    tokens_per_step = traffic["batch"] * traffic["seq_len"]
    window_start = time.perf_counter()
    result.setup_s = window_start - context.started
    index = checked
    while True:
        index += 1
        started = time.perf_counter()
        tracer.before(started - window_start, seconds)
        traced = tracer.active
        with tracer.span("portbench.batch"):
            tokens = batch(index)
        with tracer.span("portbench.train_step"):
            params, state, out = step(params, state, tokens)
        sync()
        ended = time.perf_counter()
        if not result.steps or result.steps[-1][1] - window_start < seconds:
            result.steps.append((started, ended, tokens_per_step, traced))
        tracer.after()
        # a traced span that the window's end cut into runs to its end
        if ended - window_start >= seconds and not tracer.active:
            break
    tracer.close()
    result.window = (window_start, result.steps[-1][1])
    result.profile = tracer.result
    result.attempted = len(result.steps)
    result.memory_peak_bytes = memory_peak()
    del params, state, out, step, optimizer, tokens
    release()
    log(context, f"window closed: {len(result.steps)} steps")
    verify(context, result, program, batch)
    return result


def verify(context, result: Run, program: Dict, batch) -> None:
    """The first steps against the reference (and, under ``--control``,
    the reference in fp8 against it)."""
    cell = context.spec.cell
    limits = cell["check"]["limits"]
    steps = cell["check"]["steps"]
    reference = check.train_reference(context.shape, context.spec.config,
                                      context.seed, context.device, steps,
                                      batch)
    readings = check.train_gaps(program, reference)
    print(f"portbench: program {readings!r}", file=sys.stderr)
    if context.args.control:
        lower = check.train_reference(context.shape, context.spec.config,
                                      context.seed, context.device, steps,
                                      batch, quant=context.args.control)
        readings = check.train_gaps(lower, reference)
        print(f"portbench: control {readings!r}", file=sys.stderr)
    for name, value in readings.items():
        result.checks[name] = Check(value, limits[name])
    env.log(f"reference done at "
            f"{time.perf_counter() - context.started:.2f} s")
