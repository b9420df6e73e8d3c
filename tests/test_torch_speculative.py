"""The port's speculative lane against the JAX package's.

* **Device bodies**, on the same numpy-made inputs as the JAX functions:
  ``_window_attend`` (MHA and GQA; at W = 1 bitwise the port's
  ``decode_attention``), the paged draft propose and verify bodies with
  f32 and int8 pages, and their contiguous twins.
  Proposals and greedy tokens must be identical; K/V within 1e-5 of the
  largest element; int8 payloads bytewise and scales to a few f32 ULP (one
  call from a shared cache state). JAX drops invalid writes, the port sends
  them to its drop page (the cache's last page, one past any page table),
  so caches are compared without it.
* **Engines**: one schedule through the JAX ``SlotEngine(speculative="on")``
  and the port's — mixed prompts joined mid-batch, a prefix-cache miss and
  hit over a 40-token system prompt, a request whose limit falls inside the
  first window, a cancel between ticks, and follow-ups that reuse freed
  pages after heavy rollback — over ``kv_quant`` off/on x MHA/GQA x
  ``draft_layers`` 1 (mixed accept and rollback) and 2 (= ``n_layers``,
  every proposal accepted but where a window runs past a request's limit,
  runs that cross 8-token pages) x prefix cache on/off, plus the
  contiguous layout and an independent ``tiny`` draft carried across from
  JAX. The four two-way factors run as the half of their 16 combinations
  in which the prefix cache is on where an even number of the other three
  take their second value: each pair of factors still meets in all four
  combinations, and the file stays near 90 s in one process, most of it
  JAX compiling each engine's executables (all 16 took 118 s). Tokens,
  outcomes, ``spec_proposed``/``spec_accepted``, free and cached pages
  after every step must be identical, and both lanes' caches agree at the
  end: f32 within 1e-5 of the largest element; int8 payloads off on at
  most 1% of the bytes and by at most two quantization steps, scales to
  1/127. Int8 pages cannot be
  held bytewise across the frameworks (``test_torch_prefix_cache.py`` says
  why: a value their f32 matmuls put on either side of a rounding boundary
  quantizes one step apart); here a window write requantizes the whole
  page again on its running-max scale, so such a byte can end two steps
  apart: on the MHA schedule with the full-depth draft and the prefix
  cache, 5 of 41,984 bytes of a lane's K or V do, 0.2% are off at all and
  scales differ by up to 1.7e-3 relative; the GQA schedules stay bytewise.
* **Exactness** (f32, ``kv_quant`` off): spec-on tokens equal spec-off
  tokens and ``decode.generate``'s, for self-drafts and for the port's own
  independent ``tiny`` draft; an adversarial propose that is always wrong
  gives one token per tick and nothing accepted; sampled slots take one
  token per tick and count no proposals.
* **EOS.** ``tests/unit/test_speculative.py::test_eos_inside_speculative_tail``
  expects ``reference[:2]`` where EOS is greedy token #2, but with these
  weights greedy tokens #1 and #2 are the same token, so the right stream
  stops after one token. The port is held to the JAX engine's tokens in
  that setting and to the property the test means: the emitted stream is
  the reference greedy stream cut just after the first EOS, with the EOS
  inside an accepted run.
* **Churn**: no page leaks with the lane on, after every tick.

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
from tensorhive_tpu.serving import speculative as jax_spec
from tensorhive_tpu.serving.engine import SlotEngine as JaxSlotEngine
from tensorhive_tpu_torch.config import GenerationConfig
from tensorhive_tpu_torch.convert import params_from_jax
from tensorhive_tpu_torch.core.services.generation import build_engine
from tensorhive_tpu_torch.models import decode
from tensorhive_tpu_torch.models.decode import KVCache, QuantKVCache
from tensorhive_tpu_torch.models.transformer import PRESETS
from tensorhive_tpu_torch.ops.paged_attention import decode_attention
from tensorhive_tpu_torch.serving import QueueFullError
from tensorhive_tpu_torch.serving import speculative as spec
from tensorhive_tpu_torch.serving.engine import SlotEngine

VOCAB = PRESETS["tiny"].vocab_size


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's tiny engines run thousands of small ops: one intra-op
    thread keeps them from contending with the JAX compiles and with the
    other test workers for the cores (restored after this file)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

SYSTEM_PROMPT = [(3 * j) % VOCAB or 1 for j in range(40)]
#: relative bound for f32 K/V against JAX: of the largest element
KV_REL_TOL = 1e-5


def configs(kv_heads):
    jax_config = dataclasses.replace(
        JAX_PRESETS["tiny"], dtype=jnp.float32, use_flash=False, remat=False,
        max_seq_len=128, n_kv_heads=kv_heads)
    config = dataclasses.replace(PRESETS["tiny"], dtype=torch.float32,
                                 max_seq_len=128, n_kv_heads=kv_heads)
    return jax_config, config


_PARAMS = {}


def weights(kv_heads=None):
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


def reference_tokens(prompt, new_tokens, kv_heads=None):
    """The JAX ``decode.generate`` greedy continuation."""
    jax_params, _, jax_config, _ = weights(kv_heads)
    out = jax_decode.generate(jax_params, jax_config,
                              jnp.asarray([prompt], jnp.int32),
                              max_new_tokens=new_tokens, temperature=0.0)
    return np.asarray(out)[0, len(prompt):].tolist()


def port_generate(prompt, new_tokens):
    _, params, _, config = weights()
    out = decode.generate(params, config, [prompt], new_tokens,
                          device="cpu")
    return out[0, len(prompt):].tolist()


# -- knobs --------------------------------------------------------------------

def test_resolve_speculative_follows_the_device():
    """``auto`` is on for the card and off for the CPU; neither needs a
    card to decide."""
    assert spec.resolve_speculative("auto", torch.device("cuda")) == "on"
    assert spec.resolve_speculative("auto", torch.device("cpu")) == "off"
    for mode in ("on", "off"):
        for device in ("cpu", "cuda"):
            assert spec.resolve_speculative(mode, torch.device(device)) == mode
    with pytest.raises(ValueError, match="speculative"):
        spec.resolve_speculative("maybe", torch.device("cpu"))


def test_draft_validation_and_self_draft_sharing():
    _, params, _, config = weights()
    with pytest.raises(ValueError, match="spec_tokens"):
        SlotEngine(params, config, speculative="on", spec_tokens=0,
                   device="cpu")
    with pytest.raises(ValueError, match="speculative"):
        SlotEngine(params, config, speculative="maybe", device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        spec.build_draft(params, config, draft_preset="t2t-base")
    with pytest.raises(ValueError, match="unknown"):
        spec.build_draft(params, config, draft_preset="nope")
    with pytest.raises(ValueError, match="draft_layers"):
        spec.build_draft(params, config, draft_layers=3)
    draft_params, draft_config, shares = spec.build_draft(params, config)
    assert shares and draft_config.n_layers == 1
    for name in ("tok_embed", "final_norm", "w_lm_head"):
        assert draft_params[name] is params[name]
    assert draft_params["blocks"][0] is params["blocks"][0]
    preset_params, preset_config, shares = spec.build_draft(
        params, config, draft_preset="tiny")
    assert not shares and preset_config.dtype == torch.float32
    assert preset_params["tok_embed"] is not params["tok_embed"]
    # seeded: two builds make the same draft
    again = spec.build_draft(params, config, draft_preset="tiny")[0]
    assert torch.equal(again["w_lm_head"], preset_params["w_lm_head"])


# -- device bodies ------------------------------------------------------------

@pytest.mark.parametrize("kv_heads", [4, 2])
def test_window_attend_matches_jax(kv_heads):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 5, 4, 16)).astype(np.float32)
    k = rng.standard_normal((3, 64, kv_heads, 16)).astype(np.float32)
    v = rng.standard_normal((3, 64, kv_heads, 16)).astype(np.float32)
    positions = np.array([[0, 1, 2, 3, 4], [20, 21, 22, 23, 24],
                          [59, 60, 61, 62, 63]], np.int32)
    theirs = np.asarray(jax_spec._window_attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(positions)))
    ours = spec._window_attend(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(positions)).numpy()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)
    # W = 1 is the decode attention, bitwise
    one = spec._window_attend(torch.from_numpy(q[:, :1]),
                              torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(positions[:, :1]))
    step = decode_attention(torch.from_numpy(q[:, :1]), torch.from_numpy(k),
                            torch.from_numpy(v),
                            torch.from_numpy(positions[:, 0])[
                                :, None, None, None, None])
    assert torch.equal(one, step)


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


def assert_caches_agree(ours, theirs, pages=None, int8_steps=False):
    """The port's cache against JAX's over the first ``pages`` physical
    pages (the paged port's drop page left out): int8 payloads bytewise
    and scales to a few f32 ULP — or, with ``int8_steps`` (engines),
    payloads off on at most 1% of the bytes and by at most two steps, and
    scales to 1/127 — and f32 K/V within KV_REL_TOL of the largest
    element."""
    for name, mine, other in zip(ours._fields, ours, theirs):
        mine, other = mine.numpy()[:, :pages], np.asarray(other)[:, :pages]
        if mine.dtype == np.int8 and int8_steps:
            steps = np.abs(mine.astype(np.int32) - other.astype(np.int32))
            assert steps.max() <= 2, name
            assert np.mean(steps != 0) <= 0.01, name
        elif mine.dtype == np.int8:
            assert np.array_equal(mine, other), name
        elif name.endswith("scale"):
            np.testing.assert_allclose(mine, other, rtol=1 / 127 if int8_steps
                                       else 1e-6, atol=0)
        else:
            assert np.abs(mine - other).max() <= (
                KV_REL_TOL * np.abs(other).max()), name


#: four slots over 12 physical pages of 8: slot 0 mid-sequence, slot 1 with
#: a full window one short of its limit, slot 2 inactive (all trash), slot 3
#: near the end of its table (positions past the window in the draft steps)
#: and past its limit, where it reads the trash page
PAGE_TABLES = np.array([[3, 5, 1, 0], [6, 2, 0, 0], [0, 0, 0, 0],
                        [7, 8, 9, 10]], np.int32)
POSITIONS = np.array([13, 10, 0, 30], np.int32)
LIMITS = np.array([40, 12, -1, 31], np.int32)
CATCH_UP = np.array([[0, 0, 0, 7, 9], [4, 5, 6, 7, 8], [0, 0, 0, 0, 0],
                     [0, 0, 0, 0, 11]], np.int32)
CATCH_UP_LENS = np.array([2, 5, 0, 1], np.int32)
#: the port's drop page of these 12-page caches; JAX never writes it
DROP_PAGE = 11


@pytest.mark.parametrize("quant", [False, True])
def test_paged_draft_propose_body_matches_jax(quant):
    jax_params, params, jax_config, config = weights(2)
    ours, theirs = page_cache(config, quant, num_physical=12, page_size=8,
                              seed=4)
    jax_proposals, theirs = jax_spec._paged_spec_draft(
        jax_params, jnp.asarray(CATCH_UP), jnp.asarray(CATCH_UP_LENS),
        jnp.asarray(POSITIONS), jnp.asarray(LIMITS), jnp.asarray(PAGE_TABLES),
        theirs, config=jax_config)
    proposals = spec._paged_draft_propose_body(
        params, *(torch.from_numpy(a) for a in (
            CATCH_UP, CATCH_UP_LENS, POSITIONS, LIMITS, PAGE_TABLES)),
        ours, config)
    assert proposals.shape == (4, 4) and proposals.dtype == torch.int32
    assert proposals.numpy().tolist() == np.asarray(jax_proposals).tolist()
    assert_caches_agree(ours, theirs, pages=DROP_PAGE)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_spec_verify_body_matches_jax(quant):
    jax_params, params, jax_config, config = weights(2)
    ours, theirs = page_cache(config, quant, num_physical=12, page_size=8,
                              seed=5)
    window = np.array([[9, 1, 2, 3, 4], [8, 8, 8, 8, 8], [0, 1, 1, 1, 1],
                       [11, 12, 13, 14, 15]], np.int32)
    active = np.array([True, True, False, True])
    temps = np.zeros(4, np.float32)
    greedy, chosen, theirs, _ = jax_spec._paged_spec_verify(
        jax_params, jnp.asarray(window), jnp.asarray(POSITIONS),
        jnp.asarray(active), jnp.asarray(temps), jnp.asarray(LIMITS),
        jnp.asarray(PAGE_TABLES), theirs, jax.random.PRNGKey(0),
        config=jax_config, top_k=None)
    our_greedy, our_chosen = spec._paged_spec_verify_body(
        params, *(torch.from_numpy(a) for a in (
            window, POSITIONS, active, temps, LIMITS, PAGE_TABLES)),
        ours, torch.Generator().manual_seed(0), config, None)
    assert our_greedy.numpy().tolist() == np.asarray(greedy).tolist()
    # an inactive slot keeps its token
    assert our_chosen.numpy().tolist() == np.asarray(chosen).tolist()
    assert_caches_agree(ours, theirs, pages=DROP_PAGE)


def contiguous_cache(config, slots, max_len, seed):
    rng = np.random.default_rng(seed)
    shape = (config.n_layers, slots, max_len, config.kv_heads, config.d_head)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return (KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy())),
            JaxKVCache(jnp.asarray(k), jnp.asarray(v)))


#: the contiguous bodies over rows of 32: slot 3's window and draft steps
#: run past the row's end (clamped cells of one row name one position)
ROW_POSITIONS = np.array([13, 10, 0, 29], np.int32)
ROW_LIMITS = np.array([40, 12, -1, 31], np.int32)


def test_draft_propose_body_matches_jax():
    jax_params, params, jax_config, config = weights(2)
    ours, theirs = contiguous_cache(config, slots=4, max_len=32, seed=6)
    jax_proposals, theirs = jax_spec._spec_draft(
        jax_params, jnp.asarray(CATCH_UP), jnp.asarray(CATCH_UP_LENS),
        jnp.asarray(ROW_POSITIONS), jnp.asarray(ROW_LIMITS), theirs,
        config=jax_config)
    proposals = spec._draft_propose_body(
        params, *(torch.from_numpy(a) for a in (
            CATCH_UP, CATCH_UP_LENS, ROW_POSITIONS, ROW_LIMITS)),
        ours, config)
    assert proposals.numpy().tolist() == np.asarray(jax_proposals).tolist()
    assert_caches_agree(ours, theirs)


def test_spec_verify_body_matches_jax():
    jax_params, params, jax_config, config = weights(2)
    ours, theirs = contiguous_cache(config, slots=4, max_len=32, seed=7)
    window = np.array([[9, 1, 2, 3, 4], [8, 8, 8, 8, 8], [0, 1, 1, 1, 1],
                       [11, 12, 13, 14, 15]], np.int32)
    active = np.array([True, True, False, True])
    temps = np.zeros(4, np.float32)
    greedy, chosen, theirs, _ = jax_spec._spec_verify(
        jax_params, jnp.asarray(window), jnp.asarray(ROW_POSITIONS),
        jnp.asarray(active), jnp.asarray(temps), jnp.asarray(ROW_LIMITS),
        theirs, jax.random.PRNGKey(0), config=jax_config, top_k=None)
    our_greedy, our_chosen = spec._spec_verify_body(
        params, *(torch.from_numpy(a) for a in (
            window, ROW_POSITIONS, active, temps, ROW_LIMITS)),
        ours, torch.Generator().manual_seed(0), config, None)
    assert our_greedy.numpy().tolist() == np.asarray(greedy).tolist()
    assert our_chosen.numpy().tolist() == np.asarray(chosen).tolist()
    assert_caches_agree(ours, theirs)


# -- engines ------------------------------------------------------------------

MIXED_PROMPTS = [list(range(3, 11)), [5], list(range(1, 21)),
                 list(range(2, 14))]
MIXED_NEWS = [6, 9, 4, 7]

STEP_STATS = ("kvPagesFree", "cachedPages", "specProposed", "specAccepted",
              "slotsBusy")


def spec_schedule(engine, after_step=lambda: None):
    """Run the speculative schedule; returns each request's (outcome,
    tokens)."""
    def step():
        engine.step()
        after_step()

    def drain():
        while engine.has_work():
            step()

    handles = []
    for prompt, new in zip(MIXED_PROMPTS, MIXED_NEWS):
        handles.append(engine.submit(prompt, max_new_tokens=new))
        step()                              # join mid-batch, not en masse
    drain()
    for tail in ([7], [9, 4]):              # a miss, then a prefix hit
        handles.append(engine.submit(SYSTEM_PROMPT + tail, max_new_tokens=6))
        step()
    # limit inside the first window: 2 new tokens, k = 4
    handles.append(engine.submit(list(range(30, 41)), max_new_tokens=2))
    drain()
    cancelled = engine.submit([1, 2, 3, 4], max_new_tokens=50)
    step()
    step()
    cancelled.cancel()
    step()
    handles.append(cancelled)
    # follow-ups on the freed pages
    for prompt in ([9, 8, 7, 6, 5], list(range(40, 80))):
        handles.append(engine.submit(prompt, max_new_tokens=8))
        step()
    drain()
    return [(summary["outcome"], summary["tokens"])
            for summary in (h.result(timeout_s=5) for h in handles)]


def run_pair(kv_heads=None, draft_preset="", **engine_args):
    """The schedule through the JAX engine and the port's; returns
    (results, per-step stats) of each and the two engines."""
    jax_params, params, jax_config, config = weights(kv_heads)
    engine_args = dict(dict(slots=4, max_len=96, queue_depth=8,
                            page_size=8, kv_pages=40, prefix_min_tokens=8,
                            prefill_chunk_tokens=16, speculative="on",
                            draft_preset=draft_preset), **engine_args)
    jax_engine = JaxSlotEngine(jax_params, jax_config, paged_kernel="off",
                               **engine_args)
    engine = SlotEngine(params, config, device="cpu", **engine_args)
    if draft_preset:
        # the independent draft's weights, carried across from JAX
        engine._spec.params = params_from_jax(
            jax.tree_util.tree_map(np.asarray, jax_engine._spec.params),
            engine._spec.draft_config, device="cpu")
    outputs = []
    for one in (jax_engine, engine):
        seen = []
        results = spec_schedule(one, lambda one=one, seen=seen: seen.append(
            tuple(one.stats().get(key) for key in STEP_STATS)))
        outputs.append((results, seen))
    return outputs, jax_engine, engine


#: kv_quant x kv_heads x draft_layers x prefix_cache, a half fraction of the
#: 16 combinations that holds every pair of factors in all four of theirs
ENGINE_CASES = [
    (kv_quant, kv_heads, draft_layers,
     "on" if (quant + grouped + deep) % 2 == 0 else "off")
    for quant, kv_quant in enumerate(("off", "on"))
    for grouped, kv_heads in enumerate((None, 2))
    for deep, draft_layers in enumerate((1, 2))]


@pytest.mark.parametrize("kv_quant,kv_heads,draft_layers,prefix_cache",
                         ENGINE_CASES)
def test_spec_engine_matches_jax_engine(kv_quant, kv_heads, draft_layers,
                                        prefix_cache):
    outputs, jax_engine, engine = run_pair(
        kv_heads, kv_quant=kv_quant, draft_layers=draft_layers,
        prefix_cache=prefix_cache)
    (theirs, their_steps), (ours, our_steps) = outputs
    assert ours == theirs
    assert our_steps == their_steps
    assert [outcome for outcome, _ in ours] == (
        ["completed"] * 7 + ["cancelled"] + ["completed"] * 2)
    assert (engine.spec_proposed, engine.spec_accepted) == (
        jax_engine.spec_proposed, jax_engine.spec_accepted)
    pages = jax_engine._cache.k.shape[1]
    assert engine._cache.k.shape[1] == pages + 1
    assert_caches_agree(engine._cache, jax_engine._cache, pages=pages,
                        int8_steps=True)
    assert_caches_agree(engine._spec.cache, jax_engine._spec.cache,
                        pages=pages, int8_steps=True)
    stats = engine.stats()
    if draft_layers == 2:
        # the draft is the target: only windows that run past a request's
        # limit (where neither lane's cells are written) reject
        assert stats["specAcceptanceRate"] > 0.9
        assert stats["steps"] < stats["tokensEmitted"]
    else:
        assert 0 <= stats["specAccepted"] < stats["specProposed"]
    if prefix_cache == "on":
        assert stats["prefixHits"] >= 1
        assert stats["kvPagesFree"] + stats["cachedPages"] == 40
        assert engine.prefill_chunks > 0 and engine.prefills == 0
    else:
        assert stats["kvPagesFree"] == 40 and engine.prefills > 0
    # 2 whole-prompt engines: every draft dispatch paired with a verify
    assert engine.draft_dispatches == engine.step_dispatches == stats["steps"]


@pytest.mark.parametrize("draft_layers", [1, 2])
def test_contiguous_spec_engine_matches_jax_engine(draft_layers):
    outputs, jax_engine, engine = run_pair(
        2, paged=False, kv_quant="off", prefix_cache="off",
        draft_layers=draft_layers)
    (theirs, their_steps), (ours, our_steps) = outputs
    assert ours == theirs and our_steps == their_steps
    assert (engine.spec_proposed, engine.spec_accepted) == (
        jax_engine.spec_proposed, jax_engine.spec_accepted)
    assert engine.stats()["slotsBusy"] == 0
    assert_caches_agree(engine._cache, jax_engine._cache)
    assert_caches_agree(engine._spec.cache, jax_engine._spec.cache)


def test_independent_draft_engine_matches_jax_engine():
    """A ``tiny`` draft of its own weights (JAX's ``PRNGKey(7)`` draft,
    carried across): nearly every tick rolls back, and both engines agree
    on every token, counter and page."""
    outputs, _, engine = run_pair(kv_quant="off", draft_preset="tiny")
    (theirs, their_steps), (ours, our_steps) = outputs
    assert ours == theirs and our_steps == their_steps
    assert not engine._spec.shares_target
    assert engine.spec_accepted < engine.spec_proposed / 4
    assert [outcome for outcome, _ in ours] == (
        ["completed"] * 7 + ["cancelled"] + ["completed"] * 2)


# -- exactness ----------------------------------------------------------------

def run_mixed(engine):
    handles = []
    for prompt, new in zip(MIXED_PROMPTS, MIXED_NEWS):
        handles.append(engine.submit(prompt, max_new_tokens=new))
        engine.step()
    while engine.has_work():
        engine.step()
    return [handle.result(timeout_s=5)["tokens"] for handle in handles]


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("draft", [{}, {"draft_layers": 2},
                                   {"draft_preset": "tiny"}])
def test_spec_on_equals_spec_off_equals_generate(paged, draft):
    """f32 pages: the speculative engine's greedy tokens equal the plain
    engine's and the port's ``decode.generate``'s (held to JAX's in
    ``test_torch_decode.py``), whatever the draft — the half-depth
    self-draft, the full-depth one, and the port's own random ``tiny``
    draft."""
    _, params, _, config = weights()
    args = dict(slots=4, max_len=96, queue_depth=8, kv_quant="off",
                paged=paged, device="cpu")
    on = run_mixed(SlotEngine(params, config, speculative="on", **draft,
                              **args))
    off = run_mixed(SlotEngine(params, config, speculative="off", **args))
    assert on == off
    for prompt, new, tokens in zip(MIXED_PROMPTS, MIXED_NEWS, on):
        assert tokens == port_generate(prompt, new)


def test_adversarial_zero_accept_every_tick():
    """A propose that always gets the FIRST proposal wrong: every tick
    rolls back, and the engine emits exactly one reference token per tick
    with nothing accepted."""
    _, params, _, config = weights()
    engine = SlotEngine(params, config, slots=1, max_len=96, kv_quant="off",
                        speculative="on", device="cpu")
    prompt, new = list(range(3, 11)), 6
    ref = reference_tokens(prompt, new)
    original = engine._spec.propose

    def wrong_propose(*operands):
        proposals = original(*operands).clone()
        slot = engine._slots[0]
        if slot is not None:
            done = len(slot.request.generated)
            if done < len(ref):
                proposals[0, 0] = (ref[done] + 1) % VOCAB
        return proposals

    engine._spec.propose = wrong_propose
    handle = engine.submit(prompt, max_new_tokens=new)
    while engine.has_work():
        engine.step()
    assert handle.result(timeout_s=5)["tokens"] == ref
    assert engine.spec_accepted == 0
    assert engine.spec_proposed == new * engine.spec_tokens
    assert engine.stats()["steps"] == new


def test_sampled_slots_take_one_token_per_tick():
    _, params, _, config = weights()
    engine = SlotEngine(params, config, slots=2, max_len=96,
                        speculative="on", device="cpu")
    handle = engine.submit(list(range(3, 11)), max_new_tokens=5,
                           temperature=0.8)
    while engine.has_work():
        engine.step()
    summary = handle.result(timeout_s=5)
    assert summary["outcome"] == "completed"
    assert len(summary["tokens"]) == 5
    assert all(0 <= t < VOCAB for t in summary["tokens"])
    assert engine.steps == 5
    assert engine.spec_proposed == 0 and engine.spec_accepted == 0
    assert engine.stats()["specAcceptanceRate"] is None


def eos_run(engine_cls, params, config, prompt, eos, **kwargs):
    engine = engine_cls(params, config, slots=2, max_len=96, kv_quant="off",
                        speculative="on", draft_layers=2, eos_token=eos,
                        **kwargs)
    handle = engine.submit(prompt, max_new_tokens=50)
    while engine.has_work():
        engine.step()
    summary = handle.result(timeout_s=5)
    assert summary["outcome"] == "completed"
    assert engine.stats()["slotsBusy"] == 0
    return summary["tokens"]


def test_eos_in_the_jax_tests_setting():
    """``test_eos_inside_speculative_tail``'s own setting: EOS is greedy
    token #2, which equals token #1 with these weights, so the stream is
    one token long — the JAX engine's stream, and the reference cut after
    its first EOS."""
    jax_params, params, jax_config, config = weights()
    prompt = list(range(3, 11))
    reference = reference_tokens(prompt, 3)
    eos = reference[1]
    cut = reference[:reference.index(eos) + 1]
    theirs = eos_run(JaxSlotEngine, jax_params, jax_config, prompt, eos,
                     paged_kernel="off")
    ours = eos_run(SlotEngine, params, config, prompt, eos, device="cpu")
    assert ours == theirs == cut
    assert len(ours) == 1


def test_eos_inside_an_accepted_run_cuts_the_stream():
    """An EOS whose first occurrence is the third token of the first
    tick's five accepted tokens: the stream is the reference cut just after
    it, the rest of the run dropped and the slot freed."""
    jax_params, params, jax_config, config = weights()
    prompt = [(5 * j) % VOCAB or 1 for j in range(12)]
    reference = reference_tokens(prompt, 12)
    first = next(j for j in range(2, 4) if reference[j] not in reference[:j])
    eos = reference[first]
    ours = eos_run(SlotEngine, params, config, prompt, eos, device="cpu")
    assert ours == reference[:first + 1]
    assert ours == eos_run(JaxSlotEngine, jax_params, jax_config, prompt,
                           eos, paged_kernel="off")


@pytest.mark.parametrize("kv_quant", ["off", "on"])
def test_spec_churn_keeps_page_accounting_exact(kv_quant):
    """A seeded storm of shared-prefix, divergent and identical joins,
    cancels and page-pressure waits with the lane on: after every tick
    free + live == pool size and cache-only pages are live; at the end
    every page is free or cached."""
    _, params, _, config = weights()
    rng = random.Random(7)
    engine = SlotEngine(params, config, slots=3, max_len=96, kv_pages=18,
                        page_size=8, queue_depth=16, prefix_min_tokens=8,
                        prefill_chunk_tokens=16, kv_quant=kv_quant,
                        speculative="on", device="cpu")
    engine.warmup(prompt_lens=(24,))
    base = [(3 * j) % VOCAB or 1 for j in range(24)]
    pool = engine._pool
    live = []
    for _ in range(120):
        roll = rng.random()
        if roll < 0.4 and len(live) < 8:
            kind = rng.random()
            if kind < 0.4:
                prompt = base + [rng.randrange(1, 500)]
            elif kind < 0.7:
                prompt = (base[:rng.choice((8, 16))]
                          + [rng.randrange(1, 500)
                             for _ in range(rng.randrange(1, 6))])
            else:
                prompt = [rng.randrange(1, 500)
                          for _ in range(rng.randrange(2, 20))]
            try:
                live.append(engine.submit(
                    prompt, max_new_tokens=rng.randrange(1, 6)))
            except QueueFullError:
                pass
        elif live and roll < 0.5:
            rng.choice(live).cancel()
        engine.step()
        assert pool.free_pages + pool.live_pages == pool.num_pages
        assert pool.cached_only_pages() <= pool.live_pages
        live = [handle for handle in live if not handle.done]
    while engine.has_work():
        engine.step()
        assert pool.free_pages + pool.live_pages == pool.num_pages
    stats = engine.stats()
    assert stats["kvPagesFree"] + stats["cachedPages"] == 18
    assert stats["specProposed"] > 0


def test_build_engine_wires_the_spec_knobs():
    engine = build_engine(GenerationConfig(preset="tiny", max_len=64,
                                           speculative="on", spec_tokens=3,
                                           draft_layers=2), device="cpu")
    assert engine.speculative == "on" and engine.spec_tokens == 3
    assert engine._spec.draft_config.n_layers == 2
    assert engine.draft_dispatches == 1 and engine.step_dispatches == 1
    assert engine.spec_acceptance_rate() is None
    handle = engine.submit([1, 2, 3], max_new_tokens=4)
    engine.pump()
    assert handle.result(timeout_s=5)["outcome"] == "completed"
    assert engine.spec_acceptance_rate(min_proposed=1) == 1.0
    # a full-depth self-draft's lane is the target's size
    assert engine._spec.kv_cache_bytes == engine.kv_cache_bytes
