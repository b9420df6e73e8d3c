"""Open-loop chat sessions, replayed on a fixed schedule.

Sessions arrive as a Poisson process (``session_rate``). Each picks one of
a few shared system prompts by Zipf popularity and runs 1 to ``turns``
turns; a turn's prompt is the system prompt, the conversation so far and a
new user message, and its answer is ``answer`` tokens long (greedy, no
stop token). A session ends before a turn would pass ``max_context``.

The schedule is a recorded trace's: each next turn is due after the last
answer's tokens at ``answer_pace_s`` each and an exponential think time,
whatever the engine does, so every run of a seed sends the same requests at
the same times (a next turn that waited on the served answer would make
the load follow the engine's speed, and a small delay would grow). An
answer comes back into the history as tokens drawn from the seed, of the
answer's length: the work is the same as replaying the served tokens.

Sizes and gaps are the same set for every seed (``harness/draws.py``);
token ids, the order of sessions and which prompt each picks come from the
seed. The window opens ``warm_s`` after the first arrivals, once the
system prompts are cached and the population has built up. TTFT counts
from each request's due time; requests due in the window are followed
after it until each has its first token, for at most ``follow_s``.
"""
from __future__ import annotations

import time
from typing import Dict, List

from portbench.harness import check, draws, serve, weights
from portbench.harness.faults import plant
from portbench.harness.record import Request, Run
from portbench.harness.main import log
from portbench.harness.trace import Tracer


class Sessions(serve.Source):
    """The whole schedule, drawn before the run."""

    def __init__(self, traffic: Dict, seconds: float, vocab: int,
                 seed: int, begin: float) -> None:
        super().__init__()
        rng = draws.rng(seed, 20)
        warm = traffic["warm_s"]
        rate = traffic["session_rate"]
        count = max(1, round(rate * (warm + seconds)))
        arrivals = draws.exponential(count, 1.0 / rate, rng).cumsum()
        most = traffic["turns"]
        turns = draws.uniform(count, 1, most, rng)
        users = draws.lognormal(count * most, **traffic["user"], rng=rng)
        answers = draws.lognormal(count * most, **traffic["answer"], rng=rng)
        thinks = draws.exponential(count * most, traffic["think_s"], rng)
        picks = draws.zipf(count, len(traffic["system"]),
                           traffic["zipf"], rng)
        systems = [draws.tokens(rng, length, vocab)
                   for length in traffic["system"]]
        limit = traffic["max_context"]
        pace = traffic["answer_pace_s"]
        self.sessions: List[List[Request]] = []
        for index in range(count):
            history = list(systems[int(picks[index])])
            due = begin + float(arrivals[index])
            session = []
            for turn in range(int(turns[index])):
                at = index * most + turn
                user = draws.tokens(rng, int(users[at]), vocab)
                answer = int(answers[at])
                if len(history) + len(user) + answer > limit:
                    break
                history = history + user
                request = Request(prompt_len=len(history), max_new=answer,
                                  due=due, prompt=history)
                session.append(request)
                self.push(due, request)
                history = history + draws.tokens(rng, answer, vocab)
                due += answer * pace + float(thinks[at])
            self.sessions.append(session)


def run(context) -> Run:
    import torch

    cell, config = context.spec.cell, context.spec.config
    traffic = dict(cell["traffic"])
    if context.args.rate is not None:
        traffic["session_rate"] = context.args.rate
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
    begin = time.perf_counter()
    window_start = begin + traffic["warm_s"]
    source = Sessions(traffic, seconds, context.shape.vocab, context.seed,
                      begin)
    tracer = Tracer(bool(context.args.trace), cell["trace_ticks"])
    client = serve.Client(engine, recorder, source, result, tracer)
    client.loop(lambda now: now >= window_start)
    client.window_start = window_start
    result.setup_s = window_start - context.started
    log(context, f"window opens; {len(result.requests)} requests sent in warm-up")
    result.stats_before = engine.stats()
    window_end = window_start + seconds
    client.loop(lambda now: now >= window_end, in_window=True)
    result.window = (window_start, window_end)
    result.stats_after = engine.stats()
    source.pop(float("inf"))        # nothing more is sent
    due = result.window_requests()
    follow_end = time.perf_counter() + traffic["follow_s"]
    client.loop(lambda now: now >= follow_end
                or all(r.first is not None or r.outcome for r in due))
    # a traced span that the window's end cut into runs to its end
    client.loop(lambda now: not tracer.active or not engine.has_work())
    tracer.close()
    log(context, f"followed; {len(client.ticks)} ticks in all")
    serve.recorder_rows(client, recorder)
    result.ticks = [t for t in client.ticks if t["traced"] or (
        window_start <= t["start"] and t["end"] <= window_end)]
    result.profile = tracer.result
    result.attempted = len(due)
    result.failed = sum(1 for r in due if r.first is None)
    result.memory_peak_bytes = serve.memory_peak()
    chosen = check.sample(result.requests, draws.rng(context.seed, 21),
                          **cell["check"]["sample"])
    del engine, recorder, params, client
    undo()
    serve.release()
    log(context, "program released; " + serve.summary(result))
    check.verify_served(context, result, chosen)
    return result


