"""The port's KV-page tiering against the JAX package's.

Cold int8 pages spill to a host-RAM store and are promoted back by copy,
and none of it may show in the tokens.

* **Host bookkeeping** (no device): ``HostPageStore`` LRU, budget and
  refresh; the copy lane's order (promotions ahead of queued demotions)
  and a contention run of 400 jobs from 8 threads; a seeded 400-step churn over ``PagePool`` + ``PrefixCache``
  + ``HostPageStore`` with the spill hook wired, through the JAX classes
  and the port's side by side: every spill, store count and eviction
  agrees, and pages are conserved after every step.
* **Page copies**: ``kvq.extract_pages``/``inject_pages`` against the JAX
  functions on the same numpy-made cache (bytewise: they are index ops),
  and an engine's extract -> store -> inject round trip byte for byte.
* **Engines**: ``make_tiered``'s settings of ``tests/unit/test_tiering.py``
  (page 4, 12 pages, 1 MiB of host RAM, ``prefix_min_tokens`` 4), MHA and
  GQA, one schedule through the JAX ``SlotEngine`` and the port's — a miss,
  an HBM hit, two requests that churn the first prompt's pages out to the
  host, a host hit, and a repeat that hits on the device again. Both
  engines run a synchronous copy lane, so the schedule is the same tick
  for tick. Tokens, ``host_kv_hits/misses/demotions/promotions``, the
  store's keys and ``bytes_used``, free and cached pages after every step
  must be identical. The store's int8 payloads must be within one
  quantization step of JAX's, at most 1% of them off: the chunked-prefill
  rule of ``test_torch_prefix_cache.py`` (a K/V value the two frameworks'
  f32 matmuls put on either side of a rounding boundary quantizes one step
  apart), since the demoted pages are what the chunks wrote. On these
  schedules they are bytewise equal. Scales within 1e-6 relative, a few
  f32 ULP: the two CPU matmuls sum in different orders (5.9e-7 measured).
* **The port alone**: miss, HBM hit and host hit give identical tokens on
  the real threaded lane; ``host_kv_bytes=0`` builds no store, lane or
  copy stream; a promotion that a stub lane holds parks its slot while the
  other slot gains a token every tick; a failed copy falls back to
  recompute with identical tokens; the validation messages are JAX's.

Every engine uses ``tiny`` in f32 with weights from ``JaxLM.init``; the JAX
engine decodes through its page gather (its int8 default).
"""
import dataclasses
import random
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorhive_tpu.models.transformer import PRESETS as JAX_PRESETS
from tensorhive_tpu.models.transformer import TransformerLM as JaxLM
from tensorhive_tpu.ops import kv_quant as jax_kvq
from tensorhive_tpu.serving import paging as jax_paging
from tensorhive_tpu.serving import prefix_cache as jax_prefix_cache
from tensorhive_tpu.serving.engine import SlotEngine as JaxSlotEngine
from tensorhive_tpu_torch.convert import params_from_jax
from tensorhive_tpu_torch.models.transformer import PRESETS
from tensorhive_tpu_torch.ops import kv_quant as kvq
from tensorhive_tpu_torch.serving.engine import SlotEngine
from tensorhive_tpu_torch.serving.paging import (
    HostCopyLane,
    HostPageStore,
    LaneJob,
    PagePool,
    page_content_key,
)
from tensorhive_tpu_torch.serving.prefix_cache import PrefixCache

#: 24 tokens, page 4 -> 20 cacheable tokens = 5 pages, past
#: prefix_min_tokens 4, so both tiers engage
PROMPT_A = list(range(3, 27))
PROMPT_B = list(range(40, 64))
PROMPT_C = list(range(70, 94))
#: share of store payload bytes that may sit one quantization step from
#: JAX's, and the relative bound on scales (see the module docstring)
INT8_FLIP_SHARE = 0.01
SCALE_RTOL = 1e-6


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


class StubLane:
    """A copy lane whose jobs complete only when the test runs them."""

    def __init__(self) -> None:
        self.jobs = []

    def submit(self, fn, urgent=False):
        job = LaneJob(fn)
        self.jobs.append(job)
        return job


class SyncLane:
    """A copy lane that runs each job as it is submitted, so two engines
    see their copies land on the same tick."""

    def __init__(self, job_class) -> None:
        self.job_class = job_class

    def submit(self, fn, urgent=False):
        job = self.job_class(fn)
        job.run()
        return job


_PARAMS = {}


def weights(kv_heads):
    """(JAX params, the port's params, JAX config, port config), made once
    per head layout from ``JaxLM.init`` and carried across."""
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


TIERED = dict(slots=2, max_len=64, queue_depth=8, page_size=4,
              prefix_cache="on", prefix_min_tokens=4,
              host_kv_bytes=1 << 20, kv_pages=12)


def make_tiered(kv_heads=None, **kwargs):
    _, params, _, config = weights(kv_heads)
    return SlotEngine(params, config, device="cpu", **{**TIERED, **kwargs})


def drain(engine, after_step=lambda: None):
    while engine.has_work():
        engine.step()
        after_step()


def run_one(engine, prompt, new_tokens=6, after_step=lambda: None):
    handle = engine.submit(prompt, max_new_tokens=new_tokens)
    drain(engine, after_step)
    return handle


def churn_out_prompt_a(engine, after_step=lambda: None):
    """Fill the tight pool with B and C so A's cached pages are evicted
    (and so spilled to the host store)."""
    for prompt in (PROMPT_B, PROMPT_C):
        assert run_one(engine, prompt, after_step=after_step).result(
            timeout_s=30)["outcome"] == "completed"


# -- host bookkeeping ---------------------------------------------------------

def _fake_page(fill, nbytes=512):
    """A payload whose four arrays total exactly ``nbytes``."""
    k = np.full((nbytes // 2,), fill, np.int8)
    return k, k.copy(), np.zeros(0, np.float32), np.zeros(0, np.float32)


def test_host_store_lru_budget_and_refresh():
    store = HostPageStore(capacity_bytes=1024)      # holds 2 x 512 B pages
    k, v, ks, vs = _fake_page(1)
    assert store.put(b"a", k, v, ks, vs)
    assert store.put(b"b", k, v, ks, vs)
    assert store.resident_pages == 2 and store.bytes_used == 1024
    # touch "a", so "b" is the LRU victim when "c" arrives
    assert store.get(b"a") is not None
    assert store.put(b"c", k, v, ks, vs)
    assert b"b" not in store and b"a" in store and b"c" in store
    assert store.evictions == 1 and store.bytes_used == 1024
    # re-demoting a resident key refreshes, never double-counts
    assert store.put(b"a", k, v, ks, vs)
    assert store.resident_pages == 2 and store.bytes_used == 1024
    assert store.clear() == 2
    assert store.bytes_used == 0 and store.resident_pages == 0


def test_host_store_refuses_oversized_and_bad_budget():
    with pytest.raises(ValueError):
        HostPageStore(capacity_bytes=0)
    store = HostPageStore(capacity_bytes=128)
    assert store.put(b"too-big", *_fake_page(1, nbytes=512)) is False
    assert store.resident_pages == 0 and store.bytes_used == 0


def spill_churn(pool_cls, cache_cls, store_cls, seed=1234, steps=400):
    """Joins, leaves and pressure evictions over one pool and tree with
    the spill hook wired to a store (the satellite property run of
    ``tests/unit/test_tiering.py``). Returns the log of every spill, grant
    and store count; asserts conservation after every step."""
    rng = random.Random(seed)
    pool = pool_cls(num_pages=24, page_size=4, slots=6, max_pages_per_slot=6)
    cache = cache_cls(pool, min_tokens=0)
    payload = _fake_page(7)
    store = store_cls(capacity_bytes=8 * 512)       # 8 fake pages deep
    log = []
    adopted = [0]

    def spill(key, page):
        assert 0 < page < pool.physical_pages
        log.append(("spill", key, page))
        if key not in store and store.put(key, *payload):
            adopted[0] += 1

    cache.spill = spill
    base = [rng.randrange(1, 50) for _ in range(20)]

    def prompt_for(kind):
        if kind == "identical":
            return list(base)
        if kind == "shared":
            cut = rng.choice((4, 8, 12, 16))
            return base[:cut] + [rng.randrange(50, 99)
                                 for _ in range(rng.randrange(1, 21 - cut))]
        return [rng.randrange(100, 199) for _ in range(rng.randrange(2, 21))]

    slots = {}
    for _ in range(steps):
        free_slots = [s for s in range(pool.slots) if s not in slots]
        if rng.random() < 0.55 and free_slots:
            slot = rng.choice(free_slots)
            prompt = prompt_for(rng.choice(("identical", "shared",
                                            "divergent")))
            cached, shared = cache.match(prompt)
            fresh = pool.pages_for(len(prompt) + 4) - len(shared)
            shortfall = fresh - pool.free_pages
            if shortfall > 0:
                cache.evict(shortfall)
            if pool.assign_shared(slot, shared, fresh):
                slots[slot] = prompt
                cache.insert(prompt, pool.owned_pages(slot),
                             cache.cacheable_tokens(len(prompt)))
        elif slots:
            slot = rng.choice(sorted(slots))
            del slots[slot]
            pool.release(slot)
        if rng.random() < 0.1:
            cache.evict(rng.randrange(1, 4))
        assert pool.free_pages + pool.live_pages == pool.num_pages
        assert store.bytes_used <= store.capacity_bytes
        assert adopted[0] == store.resident_pages + store.evictions
        log.append(("store", store.resident_pages, store.bytes_used,
                    store.evictions, pool.free_pages))
    assert adopted[0] > 0 and store.evictions > 0
    return log


def test_seeded_spill_churn_matches_the_jax_classes():
    theirs = spill_churn(jax_paging.PagePool, jax_prefix_cache.PrefixCache,
                         jax_paging.HostPageStore)
    ours = spill_churn(PagePool, PrefixCache, HostPageStore)
    assert ours == theirs


def test_page_content_key_matches_jax():
    prompt = list(range(10, 30))
    for index in range(4):
        assert (page_content_key(prompt, index, 4)
                == jax_paging.page_content_key(prompt, index, 4))
    assert page_content_key(prompt + [99], 1, 4) == page_content_key(
        prompt, 1, 4)


def test_copy_lane_runs_urgent_jobs_first():
    """A promotion (urgent) submitted behind queued demotions runs before
    them; every job runs once, in order within its class."""
    lane = HostCopyLane()
    gate = threading.Event()
    order = []
    blocker = lane.submit(gate.wait)             # holds the worker
    jobs = [lane.submit(lambda i=i: order.append(("queued", i)))
            for i in range(3)]
    jobs.append(lane.submit(lambda: order.append(("urgent", 0)),
                            urgent=True))
    gate.set()
    deadline = time.monotonic() + 10
    while not all(job.done for job in jobs) and time.monotonic() < deadline:
        time.sleep(0.001)
    assert blocker.done and all(job.done for job in jobs)
    assert order == [("urgent", 0), ("queued", 0), ("queued", 1),
                     ("queued", 2)]


def test_copy_lane_under_thread_contention():
    """Many submitters, a short switch interval: every job runs exactly
    once and publishes its result before ``done``."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        lane = HostCopyLane()
        jobs, lock = [], threading.Lock()

        def submitter(base):
            for i in range(50):
                job = lane.submit(lambda v=base + i: v, urgent=i % 7 == 0)
                with lock:
                    jobs.append((base + i, job))

        threads = [threading.Thread(target=submitter, args=(100 * t,))
                   for t in range(8)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=10)
        assert not any(thread.is_alive() for thread in threads)
        deadline = time.monotonic() + 10
        while (not all(job.done for _, job in jobs)
               and time.monotonic() < deadline):
            time.sleep(0.001)
        assert len(jobs) == 400
        assert all(job.done and job.result == value and job.error is None
                   for value, job in jobs)
    finally:
        sys.setswitchinterval(interval)


# -- page copies --------------------------------------------------------------

def test_extract_and_inject_pages_match_jax():
    rng = np.random.default_rng(5)
    pages = rng.integers(-127, 128, (2, 9, 4, 2, 16)).astype(np.int8)
    scales = rng.uniform(0.01, 0.05, (2, 9, 2)).astype(np.float32)
    ids = np.array([3, 1, 7], np.int32)
    k, k_scale = kvq.extract_pages(torch.from_numpy(pages),
                                   torch.from_numpy(scales),
                                   torch.from_numpy(ids))
    jk, jk_scale = jax_kvq.extract_pages(jnp.asarray(pages),
                                         jnp.asarray(scales),
                                         jnp.asarray(ids))
    assert np.array_equal(k.numpy(), np.asarray(jk))
    assert np.array_equal(k_scale.numpy(), np.asarray(jk_scale))
    targets = np.array([2, 8, 5], np.int32)
    ours = (torch.from_numpy(pages.copy()), torch.from_numpy(scales.copy()))
    kvq.inject_pages(*ours, torch.from_numpy(targets), k, k_scale)
    theirs = jax_kvq.inject_pages(jnp.asarray(pages), jnp.asarray(scales),
                                  jnp.asarray(targets), jk, jk_scale)
    for mine, other in zip(ours, theirs):
        assert np.array_equal(mine.numpy(), np.asarray(other))
    assert np.array_equal(ours[0].numpy()[:, targets], pages[:, ids])


def test_engine_round_trip_is_byte_exact():
    """Extract -> store -> inject: after the churn and the host hit, the
    pages the tree maps for A's run hold, byte for byte, what they held
    before A was evicted — payload and scales."""
    engine = make_tiered()
    expected = run_one(engine, PROMPT_A).result(timeout_s=30)["tokens"]
    _, run = engine._prefix.match(PROMPT_A)
    assert len(run) == 5
    snapshot = [tensor[:, run].clone() for tensor in engine._cache]
    churn_out_prompt_a(engine)
    assert engine._prefix.match(PROMPT_A)[0] == 0      # evicted
    host_hit = run_one(engine, PROMPT_A)
    assert host_hit.result(timeout_s=30)["tokens"] == expected
    assert engine.host_kv_promotions == 5
    _, promoted = engine._prefix.match(PROMPT_A)
    assert len(promoted) == 5
    for now, then in zip(engine._cache, snapshot):
        assert torch.equal(now[:, promoted], then)


# -- engines ------------------------------------------------------------------

TIER_COUNTERS = ("host_kv_hits", "host_kv_misses", "host_kv_demotions",
                 "host_kv_promotions")


def tier_state(engine):
    store = engine._host_store
    stats = engine.stats()
    return (tuple(getattr(engine, name) for name in TIER_COUNTERS),
            tuple(sorted(store._entries)), store.bytes_used,
            stats["kvPagesFree"], stats["cachedPages"])


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_tiered_engine_matches_jax_engine(kv_heads):
    jax_params, _, jax_config, _ = weights(kv_heads)
    engines = [JaxSlotEngine(jax_params, jax_config, **TIERED),
               make_tiered(kv_heads)]
    engines[0]._host_lane = SyncLane(jax_paging.LaneJob)
    engines[1]._host_lane = SyncLane(LaneJob)
    seen = [[], []]
    tokens = [[], []]
    for index, engine in enumerate(engines):
        def after_step(engine=engine, index=index):
            seen[index].append(tier_state(engine))

        for prompt in (PROMPT_A, PROMPT_A):            # miss, HBM hit
            tokens[index].append(run_one(engine, prompt,
                                         after_step=after_step).result(
                timeout_s=30)["tokens"])
        churn_out_prompt_a(engine, after_step)
        for prompt in (PROMPT_A, PROMPT_A):            # host hit, repeat
            tokens[index].append(run_one(engine, prompt,
                                         after_step=after_step).result(
                timeout_s=30)["tokens"])
    assert tokens[1] == tokens[0]
    assert all(run == tokens[0][0] for run in tokens[0])
    assert seen[1] == seen[0]
    jax_engine, engine = engines
    # the schedule engages every path: A's 5 pages demoted, one host hit
    # promoting them, the repeat a device hit
    assert engine.host_kv_hits == 1 and engine.host_kv_promotions == 5
    assert engine.host_kv_demotions >= 5 and engine.host_kv_fallbacks == 0
    ours, theirs = engine._host_store._entries, jax_engine._host_store._entries
    for key in theirs:
        for name in ("k", "v", "k_scale", "v_scale"):
            mine = getattr(ours[key], name)
            other = np.asarray(getattr(theirs[key], name))
            assert mine.shape == other.shape and mine.dtype == other.dtype
            if mine.dtype == np.int8:
                steps = np.abs(mine.astype(np.int32) - other.astype(np.int32))
                assert steps.max() <= 1, name
                assert np.mean(steps != 0) <= INT8_FLIP_SHARE, name
            else:
                np.testing.assert_allclose(mine, other, rtol=SCALE_RTOL,
                                           atol=0)


def test_miss_hbm_hit_host_hit_token_identity():
    """The same prompt through a cold miss, a device prefix hit and a
    host-tier promotion after eviction, on the real threaded copy lane,
    emits identical tokens, and the ledger row carries its promotion."""
    engine = make_tiered()
    assert isinstance(engine._host_lane, HostCopyLane)
    miss = run_one(engine, PROMPT_A)
    tokens = miss.result(timeout_s=30)["tokens"]
    assert engine.host_kv_hits == 0 and engine.host_kv_misses == 1
    assert miss._request.record.host_hit_pages == 0
    assert miss._request.record.promote_ms is None
    assert run_one(engine, PROMPT_A).result(timeout_s=30)["tokens"] == tokens
    assert engine.host_kv_hits == 0
    churn_out_prompt_a(engine)
    assert engine.host_kv_demotions > 0
    assert engine._host_store.resident_pages > 0
    host_hit = run_one(engine, PROMPT_A)
    assert host_hit.result(timeout_s=30)["tokens"] == tokens
    assert engine.host_kv_hits == 1 and engine.host_kv_promotions == 5
    assert host_hit._request.record.host_hit_pages == 5
    assert host_hit._request.record.promote_ms >= 0
    # a promotion reseeds the radix tree: the next identical prompt hits on
    # the device without touching the store
    assert run_one(engine, PROMPT_A).result(timeout_s=30)["tokens"] == tokens
    assert engine.host_kv_hits == 1
    stats = engine.stats()
    assert stats["hostKvBytes"] == 1 << 20
    assert stats["hostPagesResident"] == engine._host_store.resident_pages
    assert stats["hostBytesUsed"] == engine._host_store.bytes_used
    assert stats["hostHitRate"] == round(
        engine.host_kv_hits / (engine.host_kv_hits + engine.host_kv_misses),
        4)
    assert stats["kvPagesFree"] + stats["cachedPages"] == 12


def test_tier_off_builds_no_store_lane_or_stream():
    engine = make_tiered(host_kv_bytes=0)
    assert engine._host_store is None and engine._host_lane is None
    assert engine._copy_stream is None and engine._prefix.spill is None
    engine.warmup(prompt_lens=(len(PROMPT_A),))
    handle = run_one(engine, PROMPT_A)
    assert handle.result(timeout_s=30)["outcome"] == "completed"
    assert handle._request.record.host_hit_pages is None
    stats = engine.stats()
    for key in ("hostKvBytes", "hostPagesResident", "hostBytesUsed",
                "hostHitRate"):
        assert stats[key] is None, key
    assert engine.host_kv_hits == engine.host_kv_misses == 0


def test_warmup_runs_the_tier_path_and_moves_no_counter():
    """Warmup's trip through the tier (the trash page out and back) writes
    no real page and moves no counter, store or pool state."""
    engine = make_tiered()
    engine.warmup(prompt_lens=(len(PROMPT_A),))
    assert all(not tensor[:, 1:].any() for tensor in engine._cache)
    assert tier_state(engine) == ((0, 0, 0, 0), (), 0, 12, 0)
    assert not engine.has_work()


def test_slow_promotion_never_stalls_decode():
    """A stub lane whose copy 'lands' only when the test says so: the
    promoting slot parks, the OTHER slot gains a token every tick, and
    releasing the job resumes the parked prefill with identical tokens.
    The pump never waits on a copy."""
    clock = FakeClock()
    # a roomy pool: the runner and the parked promotion must coexist, so
    # the store is seeded by forced eviction instead of pool pressure
    engine = make_tiered(clock=clock, kv_pages=24)
    expected = run_one(engine, PROMPT_A).result(timeout_s=30)["tokens"]
    with engine._lock:
        engine._prefix.evict(5)                # spills A's cacheable pages
    drain(engine)                              # gather + adopt into store
    assert engine._host_store.resident_pages == 5

    stub = StubLane()
    engine._host_lane = stub
    runner = engine.submit([150 + j for j in range(8)], max_new_tokens=24)
    engine.step()                              # join + first chunk
    parked = engine.submit(PROMPT_A, max_new_tokens=6)
    while not stub.jobs:
        engine.step()                          # admit -> host hit -> park
    assert engine.host_kv_hits >= 1

    runner_request = runner._request
    emitted = len(runner_request.generated)
    for _ in range(10):
        clock.advance(0.01)
        engine.step()
        now = len(runner_request.generated)
        assert now > emitted, "a pending promotion stalled the pump"
        emitted = now
    assert len(parked._request.generated) == 0  # still parked
    assert engine.host_kv_promotions == 0

    stub.jobs[0].run()                          # the copy "lands"
    clock.advance(0.01)
    drain(engine)
    assert engine.host_kv_promotions == 5
    assert parked._request.record.promote_ms == pytest.approx(0.11 * 1e3,
                                                              abs=30.0)
    assert parked.result(timeout_s=30)["tokens"] == expected
    assert runner.result(timeout_s=30)["outcome"] == "completed"


def test_lane_error_falls_back_to_recompute():
    """A failed staging job costs only its latency: the slot un-parks and
    recomputes the span, tokens stay identical, the fallback is counted."""
    engine = make_tiered()
    expected = run_one(engine, PROMPT_A).result(timeout_s=30)["tokens"]
    churn_out_prompt_a(engine)
    stub = StubLane()
    engine._host_lane = stub
    retry = engine.submit(PROMPT_A, max_new_tokens=6)
    job = None
    while job is None:
        engine.step()
        with engine._lock:
            for state in engine._slots:
                if state is not None and state.promote_job is not None:
                    job = state.promote_job
    job.error = RuntimeError("injected copy failure")
    job.done = True
    # the admission's evictions queued demotion jobs on the stub too: run
    # them so the engine can drain its lane backlog
    for other in stub.jobs:
        if other is not job and not other.done:
            other.run()
    drain(engine)
    assert retry.result(timeout_s=30)["tokens"] == expected
    assert engine.host_kv_promotions == 0 and engine.host_kv_fallbacks == 1
    assert retry._request.record.host_hit_pages == 0
    assert retry._request.record.promote_ms is None


@pytest.mark.parametrize("knobs", [
    dict(host_kv_bytes=-1), dict(kv_quant="off"), dict(prefix_cache="off"),
    dict(paged=False, prefix_cache="auto")],
    ids=["negative", "bf16-pages", "no-prefix-cache", "contiguous"])
def test_validation_messages_match_jax(knobs):
    jax_params, params, jax_config, config = weights(None)
    args = {**TIERED, **knobs}
    if not args.get("paged", True):
        for key in ("page_size", "kv_pages", "prefix_min_tokens"):
            args.pop(key)
    with pytest.raises(ValueError) as theirs:
        JaxSlotEngine(jax_params, jax_config, **args)
    with pytest.raises(ValueError) as ours:
        SlotEngine(params, config, device="cpu", **args)
    assert str(ours.value) == str(theirs.value)
