"""The port's prefix cache and chunked prefill against the JAX package's.

Three layers, each on the same inputs as the JAX code it mirrors:

* **Host bookkeeping** (no device): the refcounted ``PagePool`` and the
  radix ``PrefixCache`` — the host half of ``tests/unit/test_prefix_cache.py``
  on the port's classes, plus one seeded churn run through the JAX classes
  and the port's side by side, which must agree on every match, page id and
  eviction count.
* **Device bodies**: ``_chunk_attend`` and ``_paged_chunk_prefill_body``
  against the JAX functions on the same numpy-made inputs, and the chunked
  body against the whole-prompt body on one prompt.
* **Engines**: one schedule through the JAX ``SlotEngine`` and the port's
  with the prefix cache on — a warm request over a 48-token system prompt,
  suffix hits (one a full-prefix hit), a copy-on-write divergence mid-page,
  a hit followed by several chunks, a long miss chunking while other slots
  decode, a cancel mid-chunk and follow-ups that reuse freed and evicted
  pages (a small pool) — with ``kv_quant`` off/on, MHA/GQA and 16-token or
  whole-prompt chunks. Greedy tokens, outcomes, the prefix counters,
  cached pages and free pages after every step must be identical; bf16/f32
  K/V within 1e-5 of the largest element, not bitwise, since XLA's CPU sums
  differ from PyTorch's (and XLA's own differ by prefill width). Int8
  pages cannot be held bytewise there: a K or V value that the two
  frameworks' f32 matmuls put on either side of a rounding boundary
  quantizes one step apart, and since a chunk attends the DEQUANTIZED
  context, that step reaches the next layer's K/V and their page scales.
  On the MHA schedule one layer-0 K value does so (69 of 32768 K bytes and
  49 V bytes end one step apart, scales up to 6.8e-4 relative; the GQA
  schedules stay bitwise). So every payload byte must be within one step
  of JAX's, at most 1% of them off, and every scale within one step of the
  page's amax (rtol 1/127). The quantizer itself is byte-identical on
  equal inputs (test_torch_kv_quant.py), and one chunk from a shared cache
  state is held bytewise below. Then: a running
  request gains one token per tick while a long prompt chunks, and a slot
  mid-prefill over shared pages leaves their bytes unchanged across decode
  ticks (the step's trash-page mask).

Every engine uses ``tiny`` in f32 with weights from ``JaxLM.init``; the JAX
engine decodes through its page gather (``paged_kernel="off"``).
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorhive_tpu.models import decode as jax_decode
from tensorhive_tpu.models.decode import KVCache as JaxKVCache
from tensorhive_tpu.models.decode import QuantKVCache as JaxQuantKVCache
from tensorhive_tpu.models.transformer import PRESETS as JAX_PRESETS
from tensorhive_tpu.models.transformer import TransformerLM as JaxLM
from tensorhive_tpu.serving import engine as jax_engine_module
from tensorhive_tpu.serving import paging as jax_paging
from tensorhive_tpu.serving import prefix_cache as jax_prefix_cache
from tensorhive_tpu.serving.engine import SlotEngine as JaxSlotEngine
from tensorhive_tpu_torch.convert import params_from_jax
from tensorhive_tpu_torch.models.decode import KVCache, QuantKVCache
from tensorhive_tpu_torch.models.transformer import PRESETS
from tensorhive_tpu_torch.serving import engine as engine_module
from tensorhive_tpu_torch.serving.engine import SlotEngine
from tensorhive_tpu_torch.serving.paging import (
    TRASH_PAGE,
    PagePool,
    page_content_key,
)
from tensorhive_tpu_torch.serving.prefix_cache import PrefixCache

VOCAB = PRESETS["tiny"].vocab_size
SYSTEM_PROMPT = [(13 * j) % VOCAB or 1 for j in range(48)]
#: relative bound for bf16/f32 K/V against JAX: of the largest element
KV_REL_TOL = 1e-5
#: int8 pages under chunked prefill: share of payload bytes that may sit one
#: quantization step from JAX's (see the module docstring)
INT8_FLIP_SHARE = 0.01


def configs(kv_heads):
    jax_config = dataclasses.replace(
        JAX_PRESETS["tiny"], dtype=jnp.float32, use_flash=False, remat=False,
        max_seq_len=128, n_kv_heads=kv_heads)
    config = dataclasses.replace(PRESETS["tiny"], dtype=torch.float32,
                                 max_seq_len=128, n_kv_heads=kv_heads)
    return jax_config, config


_PARAMS = {}


def weights(kv_heads):
    """(JAX params, the port's params, JAX config, port config), made once
    per head layout from ``JaxLM.init`` and carried across."""
    if kv_heads not in _PARAMS:
        jax_config, config = configs(kv_heads)
        jax_params = JaxLM.init(jax.random.PRNGKey(0), jax_config)
        params = params_from_jax(
            jax.tree_util.tree_map(np.asarray, jax_params), config,
            device="cpu")
        _PARAMS[kv_heads] = (jax_params, params, jax_config, config)
    return _PARAMS[kv_heads]


# -- host bookkeeping ---------------------------------------------------------

def test_refcounted_assign_shared_and_release():
    pool = PagePool(num_pages=8, page_size=4, slots=3, max_pages_per_slot=4)
    assert pool.assign(0, 3)
    run = pool.owned_pages(0)
    # slot 1 shares the first two pages and adds one private page
    assert pool.assign_shared(1, run[:2], 1)
    assert pool.refcount(run[0]) == 2 and pool.refcount(run[1]) == 2
    assert pool.free_pages == 8 - 4
    assert pool.owned_count(1) == 3
    assert pool.slot_ref_counts()[run[0]] == 2
    # slot 0 leaves: only its private third page frees
    assert pool.release(0) == 1
    assert pool.refcount(run[0]) == 1
    assert pool.free_pages == 5
    assert all(page == TRASH_PAGE for page in pool.page_table[0])
    assert pool.saturation() == 3 / 8
    assert pool.release(1) == 3
    assert pool.free_pages == 8
    assert pool.live_pages == 0


def test_sharing_a_free_page_is_an_invariant_violation():
    pool = PagePool(num_pages=4, page_size=4, slots=2, max_pages_per_slot=2)
    with pytest.raises(ValueError):
        pool.assign_shared(0, [1], 1)     # page 1 is free, nobody holds it
    with pytest.raises(ValueError):
        pool.assign_shared(0, [TRASH_PAGE], 1)
    assert pool.assign(0, 1)
    page = pool.owned_pages(0)[0]
    pool.cache_ref(page)
    assert pool.release(0) == 0           # the cache's reference keeps it
    assert pool.cached_only_pages() == 1
    assert pool.cache_unref(page) is True
    assert pool.free_pages == 4
    with pytest.raises(ValueError):
        pool.cache_unref(page)
    with pytest.raises(ValueError):
        pool.cache_ref(page)


def test_match_insert_cow_boundary():
    """Matches are whole pages only and never include the page holding the
    prompt's last position: the first page a request writes is private."""
    pool = PagePool(num_pages=8, page_size=4, slots=2, max_pages_per_slot=4)
    cache = PrefixCache(pool, min_tokens=0)
    prompt = list(range(10, 23))          # 13 tokens, target 12 -> 3 pages
    assert cache.cacheable_tokens(len(prompt)) == 12
    assert pool.assign(0, 4)
    row = pool.owned_pages(0)
    assert cache.insert(prompt, row, upto_tokens=12) == 3
    assert cache.cached_pages == 3
    cached, pages = cache.match(prompt)
    assert cached == 12 and pages == row[:3]
    # divergence MID page 2 (position 6): only page 0 matches
    divergent = prompt[:6] + [99] * 7
    cached, pages = cache.match(divergent)
    assert cached == 4 and pages == row[:1]
    # page-aligned prompt: the page holding the last position is excluded
    cached, pages = cache.match(prompt[:8])
    assert cached == 4 and pages == row[:1]
    # min_tokens gates matching, never insertion
    fussy = PrefixCache(pool, min_tokens=8)
    assert fussy.match(prompt[:6] + [99] * 7) == (0, [])
    # a content key is the whole prefix through the page's last position
    assert page_content_key(prompt, 1, 4) == np.asarray(
        prompt[:8], np.int32).tobytes()


def test_eviction_is_lru_leaf_only_and_never_referenced():
    pool = PagePool(num_pages=8, page_size=4, slots=2, max_pages_per_slot=4)
    cache = PrefixCache(pool, min_tokens=0)
    old = [1, 2, 3, 4, 5, 6, 7, 8, 9]     # 2 cacheable pages
    new = [9, 8, 7, 6, 5, 4, 3, 2, 1]
    assert pool.assign(0, 3)
    cache.insert(old, pool.owned_pages(0), upto_tokens=8)
    assert pool.release(0) == 1            # 2 stay cached
    assert pool.assign(0, 3)
    cache.insert(new, pool.owned_pages(0), upto_tokens=8)
    cache.match(new)                       # LRU: new is fresher than old
    assert pool.release(0) == 1
    assert cache.cached_pages == 4 and pool.free_pages == 4
    assert cache.evictable_pages() == 4
    # slot 1 shares OLD's prefix: those pages become unevictable
    cached, pages = cache.match(old)
    assert cached == 8
    assert pool.assign_shared(1, pages, 1)
    assert cache.evict(10) == 2            # only NEW's two pages could go
    assert cache.cached_pages == 2 and cache.evictions == 2
    assert all(pool.refcount(page) == 2 for page in pages)
    assert cache.match(new) == (0, [])
    assert cache.match(old)[0] == 8
    assert pool.free_pages + pool.live_pages == pool.num_pages
    assert cache.spill is None


def churn(pool_cls, cache_cls, seed=1234, steps=400):
    """A seeded storm of joins (identical, shared-head and divergent
    prompts), leaves and pressure evictions over one pool and tree, with
    the leak audit after every step. Returns the log of every match,
    grant, release and eviction result."""
    rng = random.Random(seed)
    page_size = 4
    pool = pool_cls(num_pages=24, page_size=page_size, slots=6,
                    max_pages_per_slot=6)
    cache = cache_cls(pool, min_tokens=0)
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
    log = []

    def audit():
        assert pool.free_pages + pool.live_pages == pool.num_pages
        for slot, pages in slots.items():
            assert pool.owned_pages(slot) == pages
            assert all(pool.refcount(page) >= 1 for page in pages)
        assert cache.cached_pages == sum(1 for _ in cache._iter_nodes())
        free_set = set(pool._free)
        for node in cache._iter_nodes():
            assert node.page not in free_set, "cached page on the free list"

    for _ in range(steps):
        action = rng.random()
        free_slots = [s for s in range(pool.slots) if s not in slots]
        if action < 0.55 and free_slots:
            slot = rng.choice(free_slots)
            prompt = prompt_for(rng.choice(("identical", "shared",
                                            "divergent")))
            needed = pool.pages_for(len(prompt) + 4)
            cached, shared = cache.match(prompt)
            fresh = needed - len(shared)
            shortfall = fresh - pool.free_pages
            evicted = cache.evict(shortfall) if shortfall > 0 else 0
            granted = pool.assign_shared(slot, shared, fresh)
            log.append(("join", slot, cached, list(shared), evicted, granted,
                        pool.page_table[slot].tolist()))
            if granted:
                slots[slot] = pool.owned_pages(slot)
                log.append(("insert", cache.insert(
                    prompt, pool.owned_pages(slot),
                    cache.cacheable_tokens(len(prompt)))))
        elif slots:
            slot = rng.choice(sorted(slots))       # a leave or a cancel
            del slots[slot]
            log.append(("release", slot, pool.release(slot)))
        if rng.random() < 0.1:
            log.append(("evict", cache.evict(rng.randrange(1, 4))))
        log.append(("pool", pool.free_pages, pool.live_pages,
                    cache.cached_pages, cache.evictions))
        audit()
    for slot in sorted(slots):
        pool.release(slot)
    log.append(("clear", cache.clear()))
    assert pool.free_pages == pool.num_pages and pool.live_pages == 0
    return log


def test_seeded_churn_never_leaks_and_never_frees_referenced():
    log = churn(PagePool, PrefixCache)
    assert any(entry[0] == "join" and entry[2] > 0 for entry in log)
    assert any(entry[0] == "evict" and entry[1] > 0 for entry in log)


def test_seeded_churn_matches_the_jax_classes():
    """The same churn through the JAX pool and tree and the port's: every
    match result, page-table row, eviction count and counter agrees."""
    theirs = churn(jax_paging.PagePool, jax_prefix_cache.PrefixCache)
    ours = churn(PagePool, PrefixCache)
    assert ours == theirs


# -- device bodies ------------------------------------------------------------

@pytest.mark.parametrize("kv_heads", [4, 2])
def test_chunk_attend_matches_jax(kv_heads):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 16, 4, 16)).astype(np.float32)
    k = rng.standard_normal((64, kv_heads, 16)).astype(np.float32)
    v = rng.standard_normal((64, kv_heads, 16)).astype(np.float32)
    positions = (20 + np.arange(16)).astype(np.int32)
    theirs = np.asarray(jax_engine_module._chunk_attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(positions)))
    ours = engine_module._chunk_attend(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(positions)).numpy()
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6)


def page_cache(config, quant, num_physical, page_size, seed):
    """(the port's cache, the JAX cache) holding the same random pages."""
    rng = np.random.default_rng(seed)
    shape = (config.n_layers, num_physical, page_size, config.kv_heads,
             config.d_head)
    if quant:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        scale_shape = shape[:2] + (config.kv_heads,)
        ks = rng.uniform(0.01, 0.05, scale_shape).astype(np.float32)
        vs = rng.uniform(0.01, 0.05, scale_shape).astype(np.float32)
        return (QuantKVCache(*(torch.from_numpy(a.copy())
                               for a in (k, v, ks, vs))),
                JaxQuantKVCache(*(jnp.asarray(a) for a in (k, v, ks, vs))))
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return (KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy())),
            JaxKVCache(jnp.asarray(k), jnp.asarray(v)))


@pytest.mark.parametrize("quant", [False, True])
def test_chunk_prefill_body_matches_jax(quant):
    """One mid-sequence chunk (start 20, 11 real positions padded to 16,
    over a row whose first pages hold an earlier prefix) through both
    bodies on the same cache: the same cells written, the rest untouched."""
    jax_params, params, jax_config, config = weights(2)
    row = np.array([3, 5, 1, 6, 0, 0], np.int32)          # 6 pages of 8
    ours, theirs = page_cache(config, quant, num_physical=8, page_size=8,
                              seed=4)
    head = np.zeros((1, 16), np.int32)
    head[0, :11] = np.arange(40, 51)
    theirs = jax_engine_module._paged_chunk_prefill_body(
        jax_params, jnp.asarray(head), theirs, jnp.asarray(row),
        jnp.int32(20), jnp.int32(11), jax_config)
    engine_module._paged_chunk_prefill_body(
        params, torch.from_numpy(head), ours, torch.from_numpy(row), 20, 11,
        config)
    for name, mine, other in zip(ours._fields, ours, theirs):
        mine, other = mine.numpy(), np.asarray(other)
        if mine.dtype == np.int8:
            assert np.array_equal(mine, other), name
        elif name.endswith("scale"):
            np.testing.assert_allclose(mine, other, rtol=1e-6, atol=0)
        else:
            assert np.abs(mine - other).max() <= (
                KV_REL_TOL * np.abs(other).max()), name
    # positions 20..30 live on row pages 2 and 3 (physical 1 and 6)
    untouched = [0, 2, 3, 4, 5, 7]
    fresh = page_cache(config, quant, num_physical=8, page_size=8, seed=4)[0]
    for mine, before in zip(ours, fresh):
        assert torch.equal(mine[:, untouched], before[:, untouched])


def test_chunked_body_writes_what_the_whole_prompt_body_writes():
    """A 75-position prompt head written in chunks of 16 through the chunked
    body and at once through the whole-prompt body (f32 pages): every
    written K/V cell within 1e-5 of the largest."""
    _, params, _, config = weights(2)
    page_size, width = 8, 128
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, VOCAB, 75).astype(np.int32)
    row = torch.arange(1, 11, dtype=torch.int32)          # 10 pages of 8
    shape = (config.n_layers, 11, page_size, config.kv_heads, config.d_head)
    chunked = KVCache(torch.zeros(shape), torch.zeros(shape))
    whole = KVCache(torch.zeros(shape), torch.zeros(shape))
    for start in range(0, 75, 16):
        length = min(16, 75 - start)
        head = torch.zeros((1, 16), dtype=torch.int32)
        head[0, :length] = torch.from_numpy(prompt[start:start + length])
        engine_module._paged_chunk_prefill_body(params, head, chunked, row,
                                                start, length, config)
    head = torch.zeros((1, width), dtype=torch.int32)
    head[0, :75] = torch.from_numpy(prompt)
    engine_module._paged_prefill_body(params, head, whole, row, 75, config)
    for ours, theirs in zip(chunked, whole):
        assert theirs.abs().max() > 0
        assert (ours - theirs).abs().max() <= KV_REL_TOL * theirs.abs().max()


# -- engines ------------------------------------------------------------------

def prefix_schedule(engine, after_step=lambda: None):
    """Run the prefix-cache schedule; returns each request's (outcome,
    tokens)."""
    def step():
        engine.step()
        after_step()

    def drain():
        while engine.has_work():
            step()

    handles = [engine.submit(SYSTEM_PROMPT + [3, 4], max_new_tokens=4)]
    drain()                                   # warm: 3 pages cached
    for prompt in (SYSTEM_PROMPT + [10],      # full-prefix hit, 0 chunks
                   SYSTEM_PROMPT + [11, 12],  # suffix hit, 1 chunk
                   SYSTEM_PROMPT[:40] + [7, 9, 11, 2],   # COW mid-page 2
                   SYSTEM_PROMPT + list(range(30, 70))):  # hit + 3 chunks
        handles.append(engine.submit(prompt, max_new_tokens=5))
        step()
    # a long miss that chunks while the others decode
    handles.append(engine.submit([(7 * j) % VOCAB or 2 for j in range(80)],
                                 max_new_tokens=6))
    drain()
    cancelled = engine.submit([(11 * j) % VOCAB or 3 for j in range(70)],
                              max_new_tokens=4)
    step()                                    # admitted, chunk 1 dispatched
    cancelled.cancel()
    step()
    handles.append(cancelled)
    # follow-ups on freed and evicted pages, and the warm prompt again
    for prompt in ([(5 * j) % VOCAB or 4 for j in range(60)],
                   [(3 * j) % VOCAB or 5 for j in range(60)],
                   SYSTEM_PROMPT + [3, 4]):
        handles.append(engine.submit(prompt, max_new_tokens=4))
        step()
    drain()
    return [(summary["outcome"], summary["tokens"])
            for summary in (h.result(timeout_s=5) for h in handles)]


PREFIX_STATS = ("prefixHits", "prefixMisses", "cachedPages", "kvPagesFree")


@pytest.mark.parametrize("chunk", [16, 0])
@pytest.mark.parametrize("kv_heads", [None, 2])
@pytest.mark.parametrize("kv_quant", ["off", "on"])
def test_prefix_engine_matches_jax_engine(kv_quant, kv_heads, chunk):
    jax_params, params, jax_config, config = weights(kv_heads)
    engine_args = dict(slots=4, max_len=96, queue_depth=8, page_size=16,
                       kv_pages=16, kv_quant=kv_quant, prefix_cache="on",
                       prefill_chunk_tokens=chunk, speculative="off")
    engines = [JaxSlotEngine(jax_params, jax_config, paged_kernel="off",
                             **engine_args),
               SlotEngine(params, config, device="cpu", **engine_args)]
    seen = [[], []]
    results = [prefix_schedule(engine, lambda: seen[index].append(
        tuple(engine.stats()[key] for key in PREFIX_STATS)))
        for index, engine in enumerate(engines)]
    assert results[1] == results[0]
    assert seen[1] == seen[0]
    assert [outcome for outcome, _ in results[0]] == (
        ["completed"] * 6 + ["cancelled"] + ["completed"] * 3)
    jax_engine, engine = engines
    assert engine._prefix.evictions == jax_engine._prefix.evictions > 0
    stats = engine.stats()
    assert stats["prefixHits"] >= 4 and stats["prefixMisses"] >= 5
    assert stats["kvPagesFree"] + stats["cachedPages"] == 16
    assert engine.prefills == 0 and engine.prefill_chunks > 0
    # page 0 is the trash page (parked slots' writes race there)
    for name, ours, theirs in zip(engine._cache._fields, engine._cache,
                                  jax_engine._cache):
        ours, theirs = ours.numpy()[:, 1:], np.asarray(theirs)[:, 1:]
        if ours.dtype == np.int8:
            steps = np.abs(ours.astype(np.int32) - theirs.astype(np.int32))
            assert steps.max() <= 1, name
            assert np.mean(steps != 0) <= INT8_FLIP_SHARE, name
        elif name.endswith("scale"):
            np.testing.assert_allclose(ours, theirs, rtol=1 / 127, atol=0)
        else:
            assert np.abs(ours - theirs).max() <= (
                KV_REL_TOL * np.abs(theirs).max()), name


def jax_generate(jax_params, jax_config, prompt, new_tokens):
    out = jax_decode.generate(jax_params, jax_config,
                              jnp.asarray([prompt], jnp.int32),
                              max_new_tokens=new_tokens, temperature=0.0)
    return np.asarray(out)[0, len(prompt):].tolist()


def test_interleaved_chunked_prefill_does_not_disturb_decode():
    """A long prompt chunk-prefilling leaves a running request's tokens as
    they are, and the running batch gains one token every tick while the
    chunks land."""
    jax_params, params, jax_config, config = weights(None)
    engine = SlotEngine(params, config, slots=4, max_len=96, kv_quant="off",
                        prefill_chunk_tokens=8, device="cpu")
    runner = engine.submit([5, 6, 7], max_new_tokens=20)
    engine.step()
    long_prompt = [(7 * j) % VOCAB or 2 for j in range(80)]
    joiner = engine.submit(long_prompt, max_new_tokens=3)
    before = len(runner._request.generated)
    for _ in range(5):                    # 5 ticks of chunking
        engine.step()
    assert len(runner._request.generated) == before + 5
    while engine.has_work():
        engine.step()
    assert (runner.result(timeout_s=5)["tokens"]
            == jax_generate(jax_params, jax_config, [5, 6, 7], 20))
    assert (joiner.result(timeout_s=5)["tokens"]
            == jax_generate(jax_params, jax_config, long_prompt, 3))
    assert engine.prefill_chunks == 1 + 10  # warm: none; runner 1, joiner 10


@pytest.mark.parametrize("kv_quant", ["off", "on"])
def test_slot_mid_prefill_leaves_shared_pages_unchanged(kv_quant):
    """The step writes K/V for every slot at its frozen position. A slot
    mid-prefill over a cached prefix holds the shared pages in its row and
    sits at position 0, so without the step's trash-page mask its write
    would land on shared page 0; with it, the shared pages' bytes stay
    unchanged across every decode tick of the chunking."""
    _, params, _, config = weights(2)
    engine = SlotEngine(params, config, slots=2, max_len=96, page_size=16,
                        kv_quant=kv_quant, prefill_chunk_tokens=16,
                        device="cpu")
    warm = engine.submit(SYSTEM_PROMPT + [3, 4], max_new_tokens=4)
    while engine.has_work():
        engine.step()
    assert warm.result(timeout_s=5)["outcome"] == "completed"
    shared = engine._prefix.match(SYSTEM_PROMPT + [1])[1]
    assert len(shared) == 3
    runner = engine.submit([5, 6, 7], max_new_tokens=12)
    engine.step()

    def snapshot():
        return [tensor[:, shared].clone() for tensor in engine._cache]

    before = snapshot()
    joiner = engine.submit(SYSTEM_PROMPT + list(range(30, 70)),
                           max_new_tokens=3)
    mid_prefill = 0
    while not joiner.done:
        generated = len(runner._request.generated)
        engine.step()
        state = engine._slots[1]
        if state is not None and not state.prefill_done:
            mid_prefill += 1
            # the parked slot's row really holds the shared pages
            assert engine._pool.page_table[1, :3].tolist() == shared
            assert engine._positions[1] == 0
            assert len(runner._request.generated) == generated + 1
            for now, then in zip(snapshot(), before):
                assert torch.equal(now, then)
    assert mid_prefill == 2               # chunks 1 and 2 of 3
    while engine.has_work():
        engine.step()
    assert runner.result(timeout_s=5)["outcome"] == "completed"

