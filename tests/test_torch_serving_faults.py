"""The port's data-plane guards against the JAX engine's: the fault plan,
fail-fast, deadlines, drain and the Retry-After estimates.

Every engine case runs one scenario through the JAX ``SlotEngine`` and the
port's, each on its own ``FakeClock`` and, where it needs one, its own
package's ``ServingFaultPlan``, and compares what the scenario returns:
outcomes, tokens, raised error types, free pages, the Retry-After values
(the admission errors' ``retry_after_s`` included) and the latency
quantiles of ``stats()``. Retry-After is compared for equal engine state
and equal histogram observations, exactly (both round to 0.1 s after the
same float arithmetic): contiguous, paged, paged with shared prefix pages,
paged with host-resident pages, while draining. The plan's own tests run
its counters against the JAX plan's on the same calls.

Before this slice the port's ``QueueFullError`` and ``RateLimitError``
always carried the class default ``retry_after_s=1.0``; JAX quotes an
estimate (``test_admission_errors_carry_the_jax_estimate`` pins the
repair).

One difference by design: JAX's engine consults its plan before the host
tier's page extract and inject, but its plan lists only ``step``,
``prefill`` and ``verify`` and refuses any other kind, so a tiered JAX
engine with a plan raises ``ValueError`` at its first demotion. The port's
plan lists ``extract`` and ``inject`` too; an injected fault at either
point leaves the engine serving the same tokens. (A fault at the gather
inside admission would also have left JAX's granted slot unjoined; the
port joins it and requeues the demotions.)

Engines use ``tiny`` in f32 with weights from ``JaxLM.init``; f32 pages
unless a case says otherwise; the JAX engine decodes through its page
gather.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorhive_tpu.models.transformer import PRESETS as JAX_PRESETS
from tensorhive_tpu.models.transformer import TransformerLM as JaxLM
from tensorhive_tpu.serving import EngineDrainingError as JaxDrainingError
from tensorhive_tpu.serving import QueueFullError as JaxQueueFullError
from tensorhive_tpu.serving import RateLimitError as JaxRateLimitError
from tensorhive_tpu.serving import faults as jax_faults
from tensorhive_tpu.serving import paging as jax_paging
from tensorhive_tpu.serving.engine import SlotEngine as JaxSlotEngine
from tensorhive_tpu_torch.config import GenerationConfig
from tensorhive_tpu_torch.convert import params_from_jax
from tensorhive_tpu_torch.core.services.generation import build_engine
from tensorhive_tpu_torch.models.transformer import PRESETS
from tensorhive_tpu_torch.serving import (
    EngineDrainingError,
    QueueFullError,
    RateLimitError,
)
from tensorhive_tpu_torch.serving import faults
from tensorhive_tpu_torch.serving.engine import SlotEngine
from tensorhive_tpu_torch.serving.paging import LaneJob

JAX_KINDS = ("step", "prefill", "verify")
#: 24 tokens: with page 4, 5 cacheable pages (the tiering scenario)
PROMPT_A = list(range(3, 27))
PROMPT_C = list(range(70, 94))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tiny engines run thousands of small ops: one intra-op thread
    keeps them from contending with JAX and the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class FakeClock:
    def __init__(self, start: float = 1000.0) -> None:
        self.now = start

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds


class SyncLane:
    """A copy lane that runs each job as it is submitted."""

    def __init__(self, job_class) -> None:
        self.job_class = job_class

    def submit(self, fn, urgent=False):
        job = self.job_class(fn)
        job.run()
        return job


_PARAMS = {}


def weights(kv_heads=None):
    if kv_heads not in _PARAMS:
        jax_config = dataclasses.replace(
            JAX_PRESETS["tiny"], dtype=jnp.float32, use_flash=False,
            remat=False, max_seq_len=128, n_kv_heads=kv_heads)
        config = dataclasses.replace(PRESETS["tiny"], dtype=torch.float32,
                                     max_seq_len=128, n_kv_heads=kv_heads)
        jax_params = JaxLM.init(jax.random.PRNGKey(0), jax_config)
        params = params_from_jax(
            jax.tree_util.tree_map(np.asarray, jax_params), config,
            device="cpu")
        _PARAMS[kv_heads] = (jax_params, params, jax_config, config)
    return _PARAMS[kv_heads]


class Side:
    """One engine of a comparison with its clock and its package's plan
    and error classes."""

    def __init__(self, engine, clock, plan, mod):
        self.engine, self.clock, self.plan, self.mod = engine, clock, plan, mod


BASE = dict(slots=2, max_len=96, queue_depth=8, kv_quant="off",
            speculative="off")


def both(scenario, plan=False, **kwargs):
    """Run ``scenario(side)`` on a JAX and a port engine built alike;
    returns (JAX's result, the port's)."""
    jax_params, params, jax_config, config = weights()
    kwargs = {**BASE, **kwargs}
    results = []
    for package in ("jax", "port"):
        clock = FakeClock()
        mod = jax_faults if package == "jax" else faults
        fault_plan = mod.ServingFaultPlan() if plan else None
        if package == "jax":
            if kwargs.get("paged", True):
                kwargs_ = {**kwargs, "paged_kernel": "off"}
            else:
                kwargs_ = kwargs
            engine = JaxSlotEngine(jax_params, jax_config, clock=clock,
                                   fault_plan=fault_plan, **kwargs_)
        else:
            engine = SlotEngine(params, config, clock=clock,
                                fault_plan=fault_plan, device="cpu",
                                **kwargs)
        results.append(scenario(Side(engine, clock, fault_plan, mod)))
    return results


def drain(engine):
    while engine.has_work():
        engine.step()


def pages_free(engine):
    """(free, cached, busy slots, pool): after a scenario every page is
    free or cached and no slot is busy."""
    stats = engine.stats()
    return (stats["kvPagesFree"], stats["cachedPages"], stats["slotsBusy"],
            stats["kvPagesTotal"])


# -- the plan -----------------------------------------------------------------

def test_fault_plan_fail_next_exact_counts():
    counts = []
    for mod in (jax_faults, faults):
        plan = mod.ServingFaultPlan()
        plan.fail_next("step", 2)
        for _ in range(2):
            with pytest.raises(mod.DeviceLostError):
                plan.before_dispatch("step")
        plan.before_dispatch("step")                  # consumed: healthy
        plan.before_dispatch("prefill")               # other kinds untouched
        counts.append(({k: plan.dispatches[k] for k in JAX_KINDS},
                       {k: plan.faults_injected[k] for k in JAX_KINDS}))
    assert counts[1] == counts[0] == (
        {"step": 3, "prefill": 1, "verify": 0},
        {"step": 2, "prefill": 0, "verify": 0})


def test_fault_plan_seeded_probability_matches_jax():
    def outcomes(mod):
        plan = mod.ServingFaultPlan(seed=7, fail_probability=0.3)
        result = []
        for _ in range(64):
            try:
                plan.before_dispatch("step")
                result.append(True)
            except mod.DeviceLostError:
                result.append(False)
        return result

    ours = outcomes(faults)
    assert ours == outcomes(jax_faults) == outcomes(faults)
    assert not all(ours) and any(ours)                # the coin flips


def test_fault_plan_slow_dispatch_uses_injected_sleeper():
    sleeps = []
    plan = faults.ServingFaultPlan(sleeper=sleeps.append)
    plan.slow_next("verify", 2, seconds=0.25)
    for _ in range(3):
        plan.before_dispatch("verify")
    assert sleeps == [0.25, 0.25]
    assert plan.faults_injected["verify"] == 0        # slow is not a fault


def test_fault_plan_device_lost_until_cleared():
    plan = faults.ServingFaultPlan()
    plan.set_device_lost(True)
    for kind in faults.DISPATCH_KINDS:
        with pytest.raises(faults.DeviceLostError):
            plan.before_dispatch(kind)
    plan.set_device_lost(False)
    plan.before_dispatch("step")
    with pytest.raises(ValueError):
        plan.fail_next("decode")                      # unknown kind


@pytest.mark.parametrize("name", ["TransientDispatchError",
                                  "DeviceLostError", "InjectedFaultError"])
def test_classify_failure_matches_jax(name):
    ours = faults.classify_failure(getattr(faults, name)("x"))
    assert ours == jax_faults.classify_failure(
        getattr(jax_faults, name)("x"))
    assert faults.classify_failure(RuntimeError("out of memory")) == \
        faults.FATAL == jax_faults.classify_failure(RuntimeError("x"))


def test_tier_kinds_are_plan_kinds_in_the_port_only():
    """The difference by design (module docstring): JAX's plan refuses
    the tier's two kinds its engine consults it with; the port's takes
    them."""
    for kind in ("extract", "inject"):
        with pytest.raises(ValueError):
            jax_faults.ServingFaultPlan().before_dispatch(kind)
        plan = faults.ServingFaultPlan()
        plan.fail_next(kind)
        with pytest.raises(faults.DeviceLostError):
            plan.before_dispatch(kind)
        assert plan.faults_injected[kind] == 1


# -- fail-fast, requeue, retry ------------------------------------------------

def fail_all_scenario(side):
    engine, plan, mod = side.engine, side.plan, side.mod
    running = [engine.submit([1, 2, 3, 4], max_new_tokens=20),
               engine.submit([5, 6, 7], max_new_tokens=20)]
    engine.step()
    engine.step()                          # both mid-decode, tokens out
    queued = engine.submit([8, 9], max_new_tokens=4)
    plan.fail_next("step", 1)
    with pytest.raises(mod.DeviceLostError):
        engine.step()
    failed = engine.fail_all_inflight("engine fault (test)")
    streams = []
    for handle in running + [queued]:
        collected = []
        with pytest.raises(RuntimeError, match="engine fault") as info:
            for token in handle.tokens(timeout_s=1):
                collected.append(token)
        streams.append((collected, str(info.value), handle.done))
    return (failed, streams, pages_free(engine), engine.stats()["queueDepth"],
            engine.fail_all_inflight("again"), plan.faults_injected["step"])


def test_fail_all_inflight_matches_jax():
    theirs, ours = both(fail_all_scenario, plan=True)
    assert ours == theirs
    failed, streams, (free, cached, busy, pool), depth, again, _ = ours
    assert failed == 3 and busy == 0 and depth == 0 and again == 0
    assert all(len(collected) >= 1 for collected, _, _ in streams[:2])
    assert free + cached == pool


def legacy_prefill_scenario(side):
    engine, plan = side.engine, side.plan
    prompt = list(range(3, 12))
    plan.fail_next("prefill", 1)
    handle = engine.submit(prompt, max_new_tokens=5)
    with pytest.raises(side.mod.DeviceLostError):
        engine.step()
    after_fault = (engine.stats()["slotsBusy"], engine.stats()["queueDepth"])
    drain(engine)                          # the retry succeeds
    summary = handle.result(timeout_s=5)
    return after_fault, summary["outcome"], summary["tokens"], \
        pages_free(engine)


def test_whole_prompt_prefill_fault_requeues_like_jax():
    theirs, ours = both(legacy_prefill_scenario, plan=True,
                        prefix_cache="off")
    assert ours == theirs
    assert ours[0] == (0, 1) and ours[1] == "completed"


def chunk_retry_scenario(side):
    engine, plan = side.engine, side.plan
    prompt = list(range(1, 18))
    handle = engine.submit(prompt, max_new_tokens=4)
    engine.step()                          # chunk 1 dispatched
    plan.fail_next("prefill", 1)
    with pytest.raises(side.mod.DeviceLostError):
        engine.step()                      # chunk 2 fails before a write
    drain(engine)                          # chunk 2 retried
    summary = handle.result(timeout_s=5)
    return summary["outcome"], summary["tokens"], pages_free(engine), \
        plan.dispatches["prefill"]


def test_chunk_prefill_fault_retries_the_same_chunk_like_jax():
    theirs, ours = both(chunk_retry_scenario, plan=True,
                        prefill_chunk_tokens=4)
    assert ours == theirs
    assert ours[0] == "completed"


# -- deadlines ----------------------------------------------------------------

def queue_deadline_scenario(side):
    engine, clock = side.engine, side.clock
    running = engine.submit([1, 2, 3], max_new_tokens=50, deadline_s=600.0)
    engine.step()                          # takes the only slot
    waiting = engine.submit([4, 5, 6], max_new_tokens=4)
    clock.advance(11.0)
    engine.step()
    summary = waiting.result(timeout_s=1)
    outcome = (summary["outcome"], summary["tokens"], running.done)
    running.cancel()
    drain(engine)
    return outcome, running.result(timeout_s=1)["outcome"], \
        pages_free(engine)


def test_queue_deadline_matches_jax():
    theirs, ours = both(queue_deadline_scenario, slots=1,
                        default_deadline_s=10.0)
    assert ours == theirs
    assert ours[0] == ("timeout", [], False)


def mid_decode_deadline_scenario(side):
    engine, clock = side.engine, side.clock
    handle = engine.submit([1, 2, 3, 4], max_new_tokens=50)
    engine.step()                          # first token inside the budget
    clock.advance(1.5)
    engine.step()                          # this token is the last
    summary = handle.result(timeout_s=1)
    follow_up = engine.submit([9, 8, 7], max_new_tokens=4, deadline_s=600)
    drain(engine)
    return (summary["outcome"], summary["tokens"],
            follow_up.result(timeout_s=5)["tokens"], pages_free(engine))


def test_mid_decode_deadline_matches_jax():
    theirs, ours = both(mid_decode_deadline_scenario, slots=1,
                        default_deadline_s=1.0)
    assert ours == theirs
    assert ours[0] == "timeout" and 0 < len(ours[1]) < 50


def mid_prefill_deadline_scenario(side):
    engine, clock = side.engine, side.clock
    handle = engine.submit(list(range(1, 20)), max_new_tokens=4)
    engine.step()                          # admitted, chunk 1 dispatched
    clock.advance(6.0)
    engine.step()                          # deadline checked before chunk 2
    summary = handle.result(timeout_s=1)
    return summary["outcome"], summary["tokens"], pages_free(engine), \
        engine.has_work()


def test_mid_prefill_deadline_matches_jax():
    theirs, ours = both(mid_prefill_deadline_scenario,
                        prefill_chunk_tokens=4, default_deadline_s=5.0)
    assert ours == theirs
    outcome, tokens, (free, cached, busy, pool), _ = ours
    assert outcome == "timeout" and tokens == [] and busy == 0
    assert free + cached == pool


def test_deadline_override_validation_matches_jax():
    def scenario(side):
        engine = side.engine
        errors = []
        for value in (61.0, 0.0, -5.0):
            with pytest.raises(ValueError) as info:
                engine.submit([1, 2], max_new_tokens=4, deadline_s=value)
            errors.append(str(info.value))
        handle = engine.submit([1, 2], max_new_tokens=4, deadline_s=30.0)
        drain(engine)
        return errors, handle.result(timeout_s=5)["outcome"]

    theirs, ours = both(scenario, default_deadline_s=10.0,
                        max_deadline_s=60.0)
    assert ours == theirs
    assert ours[1] == "completed"


@pytest.mark.parametrize("knobs", [
    dict(default_deadline_s=-1.0), dict(max_deadline_s=0.0),
    dict(default_deadline_s=10.0, max_deadline_s=5.0)])
def test_deadline_knob_validation_matches_jax(knobs):
    jax_params, params, jax_config, config = weights()
    with pytest.raises(ValueError) as theirs:
        JaxSlotEngine(jax_params, jax_config, **knobs)
    with pytest.raises(ValueError) as ours:
        SlotEngine(params, config, device="cpu", **knobs)
    assert str(ours.value) == str(theirs.value)


def test_no_deadline_by_default_matches_jax():
    def scenario(side):
        handle = side.engine.submit([1, 2, 3], max_new_tokens=4)
        side.clock.advance(1e6)
        drain(side.engine)
        summary = handle.result(timeout_s=5)
        return summary["outcome"], summary["tokens"]

    theirs, ours = both(scenario)
    assert ours == theirs and ours[0] == "completed"


# -- latency quantiles, drain and Retry-After ---------------------------------

def latency_scenario(side):
    """Requests on a clock that moves 20 ms a tick (and 5 ms between a
    submit and the tick that admits it): the histograms see the same
    samples in both engines."""
    engine, clock = side.engine, side.clock
    handles = []
    for prompt in ([1, 2, 3, 4], [5, 6, 7], [8, 9, 10, 11, 12]):
        handles.append(engine.submit(prompt, max_new_tokens=6))
        clock.advance(0.005)
    while engine.has_work():
        clock.advance(0.02)
        engine.step()
    stats = engine.stats()
    return ([h.result(timeout_s=5)["tokens"] for h in handles],
            {key: stats[key] for key in ("ttftP50Ms", "ttftP95Ms",
                                         "intertokenP50Ms",
                                         "intertokenP95Ms")},
            engine.ttft_p95_s(), engine.queue_wait_p95_s(),
            engine.queue_saturation())


def test_latency_quantiles_match_jax():
    theirs, ours = both(latency_scenario)
    assert ours == theirs
    assert ours[1]["intertokenP50Ms"] > 0 and ours[3] > 0


def drain_scenario(side):
    engine = side.engine
    handle = engine.submit([1, 2, 3, 4], max_new_tokens=5)
    engine.submit([1, 2], max_new_tokens=7)
    engine.submit([3, 4], max_new_tokens=9)
    engine.step()
    for _ in range(40):
        engine._intertoken_hist.observe(0.4)
    engine.drain()
    draining = engine.stats()["draining"]
    error = (JaxDrainingError if side.mod is jax_faults
             else EngineDrainingError)
    with pytest.raises(error) as info:
        engine.submit([5, 6], max_new_tokens=4)
    quoted = (info.value.retry_after_s, engine.drain_retry_after())
    drain(engine)
    engine.resume()
    follow_up = engine.submit([5, 6], max_new_tokens=4)
    drain(engine)
    return (draining, quoted, handle.result(timeout_s=5)["outcome"],
            follow_up.result(timeout_s=5)["outcome"],
            engine.stats()["draining"])


def test_drain_and_its_retry_after_match_jax():
    theirs, ours = both(drain_scenario)
    assert ours == theirs
    assert ours[1][0] == ours[1][1] > 1.0


def retry_after_values(engine, asks):
    with engine._lock:
        return [engine._retry_after_locked(**ask) for ask in asks]


def contiguous_or_paged_scenario(side):
    """Three runners with 4, 10 and 16 tokens left, then Retry-After for a
    slot and for page asks small and large."""
    engine = side.engine
    for length, new in ((5, 6), (9, 12), (13, 18)):
        engine.submit(list(range(1, 1 + length)), max_new_tokens=new)
        engine.step()
    for gap in (0.3, 0.4, 0.5, 0.6) * 10:
        engine._intertoken_hist.observe(gap)
    return retry_after_values(engine, [
        {}, {"needed_pages": 1}, {"needed_pages": 2},
        {"needed_pages": 6}, {"needed_pages": 12}])


@pytest.mark.parametrize("layout", [
    dict(paged=False, prefix_cache="auto"),
    dict(page_size=8, kv_pages=10, prefix_cache="off")],
    ids=["contiguous", "paged"])
def test_retry_after_matches_jax(layout):
    theirs, ours = both(contiguous_or_paged_scenario, slots=3, **layout)
    assert ours == theirs
    assert min(ours) > 1.0
    # a contiguous engine waits for a slot whatever the ask; a paged one
    # tells the page asks apart
    assert len(set(ours)) == (1 if layout.get("paged") is False else 3)


def shared_prefix_scenario(side):
    """Two runners share a cached 24-token prefix (refcounts 3: the tree
    and both slots): a page frees only when its last holder leaves, and a
    prompt's cached prefix comes off its bill."""
    engine = side.engine
    system = list(range(100, 124))
    warm = engine.submit(system + [1], max_new_tokens=2)
    drain(engine)
    warm.result(timeout_s=5)
    engine.submit(system + [2, 3], max_new_tokens=6)
    engine.step()
    engine.submit(system + [4, 5, 6], max_new_tokens=14)
    engine.step()
    engine.submit(list(range(200, 206)), max_new_tokens=3)
    engine.step()
    for _ in range(40):
        engine._intertoken_hist.observe(2.0)
    values = retry_after_values(engine, [
        {"needed_pages": need} for need in (2, 5, 8, 11)] + [
        {"needed_pages": need, "prompt": system + [9] * 10}
        for need in (5, 8, 11)])
    return values, pages_free(engine)


def test_retry_after_with_shared_prefix_pages_matches_jax():
    theirs, ours = both(shared_prefix_scenario, slots=3, page_size=4,
                        kv_pages=14, prefix_min_tokens=4)
    assert ours == theirs
    values = ours[0]
    # the cached prefix takes six pages off the five-page ask: it fits at
    # the first completion, not the second
    assert values[4] < values[1]


def host_pages_scenario(side):
    """The scenario of ``test_retry_after_discounts_cached_and_host_pages``
    (tests/unit/test_tiering.py): A's five cacheable pages live on the
    host, a long runner shares C's cached run, a short private one holds
    three pages; the discounted ask for A waits for the short one, the
    cold ask for the long one."""
    engine = side.engine
    job_class = jax_paging.LaneJob if side.mod is jax_faults else LaneJob
    engine._host_lane = SyncLane(job_class)
    for prompt in (PROMPT_A, list(range(40, 64)), PROMPT_C):
        engine.submit(prompt, max_new_tokens=6)
        drain(engine)
    long = engine.submit(PROMPT_C, max_new_tokens=12)
    engine.step()
    short = engine.submit([200 + j for j in range(8)], max_new_tokens=4)
    for _ in range(2):
        engine.step()
    for _ in range(40):
        engine._intertoken_hist.observe(2.0)
    values = retry_after_values(engine, [
        {"needed_pages": 8}, {"needed_pages": 8, "prompt": PROMPT_A}])
    resident = engine._host_store.resident_pages
    short.cancel()
    long.cancel()
    drain(engine)
    return values, resident, pages_free(engine)


def test_retry_after_with_host_pages_matches_jax():
    theirs, ours = both(host_pages_scenario, kv_quant="on", max_len=64,
                        page_size=4, prefix_cache="on", prefix_min_tokens=4,
                        host_kv_bytes=1 << 20, kv_pages=12)
    assert ours == theirs
    (cold, warm), resident, _ = ours
    assert warm < cold and resident >= 5


def admission_errors_scenario(side):
    engine = side.engine
    engine.submit([1, 2, 3, 4, 5], max_new_tokens=6, user_key="alice")
    engine.step()
    engine.submit([6, 7, 8], max_new_tokens=20, user_key="bob")
    engine.step()
    for _ in range(10):
        engine._intertoken_hist.observe(0.7)
    jax_side = side.mod is jax_faults
    rate_limited = JaxRateLimitError if jax_side else RateLimitError
    queue_full = JaxQueueFullError if jax_side else QueueFullError
    with pytest.raises(rate_limited) as rate:
        engine.submit([9, 9], max_new_tokens=4, user_key="alice")
    engine.submit(list(range(30, 60)), max_new_tokens=8)   # fills the queue
    with pytest.raises(queue_full) as full:
        engine.submit(list(range(30, 50)), max_new_tokens=30)
    return rate.value.retry_after_s, full.value.retry_after_s


def test_admission_errors_carry_the_jax_estimate():
    """The repaired fault: the port's 429s used to carry the class default
    1.0; they now quote JAX's estimate for the same engine state."""
    theirs, ours = both(admission_errors_scenario, queue_depth=1,
                        max_concurrent_per_user=1, page_size=8,
                        kv_pages=12, prefix_cache="off")
    assert ours == theirs
    assert ours[0] > 1.0 and ours[1] > 1.0


# -- the tier's fault points, port only ----------------------------------------

@pytest.mark.parametrize("kind", ["extract", "inject"])
def test_tier_fault_points_leave_the_engine_serving(kind):
    """An injected fault at the tier's gather or inject raises out of
    ``step()`` before any write, with the granted slot joined and the
    demotions or the staged promotion still queued; the following ticks
    gather or inject them and serve the same tokens, the host hit
    included."""
    _, params, _, config = weights()
    plan = faults.ServingFaultPlan()
    engine = SlotEngine(params, config, slots=2, max_len=64, queue_depth=8,
                        page_size=4, prefix_cache="on", prefix_min_tokens=4,
                        host_kv_bytes=1 << 20, kv_pages=12, fault_plan=plan,
                        device="cpu")
    engine._host_lane = SyncLane(LaneJob)

    def serve(prompt):
        handle = engine.submit(prompt, max_new_tokens=6)
        while engine.has_work():
            try:
                engine.step()
            except faults.DeviceLostError:
                raised.append(kind)
        return handle.result(timeout_s=5)["tokens"]

    raised = []
    expected = serve(PROMPT_A)
    plan.fail_next(kind)
    serve(list(range(40, 64)))
    serve(PROMPT_C)
    assert serve(PROMPT_A) == expected
    assert raised == [kind] and plan.faults_injected[kind] == 1
    stats = engine.stats()
    assert stats["kvPagesFree"] + stats["cachedPages"] == 12
    assert engine.host_kv_hits == 1 and engine.host_kv_promotions == 5


def test_build_engine_wires_the_deadline_knobs():
    assert GenerationConfig().default_deadline_s == 120.0
    assert GenerationConfig().max_deadline_s == 600.0
    engine = build_engine(GenerationConfig(preset="tiny", slots=2,
                                           max_len=64, default_deadline_s=7.5,
                                           max_deadline_s=42.0),
                          device="cpu")
    assert engine.default_deadline_s == 7.5
    assert engine.max_deadline_s == 42.0
    with pytest.raises(ValueError):
        engine.submit([1, 2], max_new_tokens=4, deadline_s=43.0)
    handle = engine.submit([1, 2], max_new_tokens=4)
    assert handle._request.deadline_ts == pytest.approx(
        handle._request.submitted_ts + 7.5)
