"""Closed-loop clients: each of ``clients`` sends a request, waits for its
last token and sends the next at once (no think time). Prompts are
unshared, lognormal (``prompt``); answers uniform over ``answer``, except
each client's first, uniform over ``first_answer`` so that completions
spread through the window. Greedy, no stop token.

Set-up fills the engine: the window opens once every client's first
request has its first token. The window ends at the first step that
returns after ``--seconds``; nothing is followed after it.
"""
from __future__ import annotations

import time
from typing import Dict, List

from portbench.harness import check, draws, serve, weights
from portbench.harness.faults import plant
from portbench.harness.record import Request, Run
from portbench.harness.main import log
from portbench.harness.trace import Tracer


class Clients(serve.Source):
    def __init__(self, traffic: Dict, vocab: int, seed: int,
                 begin: float) -> None:
        super().__init__()
        rng = draws.rng(seed, 30)
        clients, depth = traffic["clients"], traffic["requests_per_client"]
        prompts = draws.lognormal(clients * depth, **traffic["prompt"],
                                  rng=rng)
        answers = draws.uniform(clients * (depth - 1), *traffic["answer"],
                                rng)
        firsts = draws.uniform(clients, *traffic["first_answer"], rng)
        self.queues: List[List[Request]] = []
        for client in range(clients):
            queue = []
            for turn in range(depth):
                length = int(prompts[client * depth + turn])
                answer = int(firsts[client] if turn == 0 else
                             answers[client * (depth - 1) + turn - 1])
                request = Request(prompt_len=length, max_new=answer, due=0.0,
                                  prompt=draws.tokens(rng, length, vocab))
                request.client = client
                queue.append(request)
            self.queues.append(queue)
        for client in range(clients):
            self._send(client, begin)
        #: each client's first request (set-up ends when all have begun)
        self.firsts = [item[2] for item in self._heap]

    def _send(self, client: int, now: float) -> None:
        if self.queues[client]:
            request = self.queues[client].pop(0)
            request.due = now
            self.push(now, request)

    def done(self, request: Request, now: float) -> None:
        self._send(request.client, now)


def run(context) -> Run:
    import torch

    cell, config = context.spec.cell, context.spec.config
    traffic = cell["traffic"]
    seconds = context.seconds
    result = Run(config=config, cell=dict(cell, _seconds=seconds))
    dtype = getattr(torch, config["serving"]["dtype"])
    model = serve.model_config(config, config["serving"]["max_len"])
    params = weights.params(context.shape, context.seed, context.device,
                            dtype)
    engine, recorder = serve.build_engine(context, params, model)
    log(context, "engine built")
    undo = plant(context.args.fault, context.shape.vocab)
    # each chunk width the cell's prompts map to, and one step
    engine.warmup(prompt_lens=traffic["warm_widths"])
    source = Clients(traffic, context.shape.vocab, context.seed,
                     time.perf_counter())
    firsts = source.firsts
    tracer = Tracer(bool(context.args.trace), cell["trace_ticks"])
    client = serve.Client(engine, recorder, source, result, tracer)
    client.loop(lambda now: all(r.first is not None or r.outcome
                                for r in firsts))
    window_start = time.perf_counter()
    client.window_start = window_start
    result.setup_s = window_start - context.started
    log(context, f"window opens; {len(result.requests)} requests sent in the fill")
    result.stats_before = engine.stats()
    window_end = window_start + seconds
    client.loop(lambda now: now >= window_end, in_window=True)
    stop = client.ticks[-1]["end"] if client.ticks else window_end
    # a traced span that the window's end cut into runs to its end
    client.loop(lambda now: not tracer.active or (
        not engine.has_work() and source.due() is None))
    tracer.close()
    result.window = (window_start, max(stop, window_end))
    result.stats_after = engine.stats()
    log(context, f"window closed; {len(client.ticks)} ticks in all")
    serve.recorder_rows(client, recorder)
    result.ticks = [t for t in client.ticks if t["traced"] or (
        window_start <= t["start"] and t["end"] <= result.window[1])]
    result.profile = tracer.result
    in_window = [r for r in result.requests
                 if r.times and r.times[-1] >= window_start or
                 (r.outcome is None and r.handle is not None)]
    result.attempted = len(in_window)
    result.failed = sum(1 for r in in_window if r.outcome in ("error",
                                                              "refused"))
    result.memory_peak_bytes = serve.memory_peak()
    chosen = check.sample(result.requests, draws.rng(context.seed, 31),
                          **cell["check"]["sample"])
    del engine, recorder, params, client
    undo()
    serve.release()
    log(context, "program released; " + serve.summary(result))
    check.verify_served(context, result, chosen)
    return result
