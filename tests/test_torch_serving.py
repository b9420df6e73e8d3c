"""The port's slot engine against the JAX engine on one schedule.

Both engines serve the same requests — staggered joins, a single-token
prompt, a cancel mid-decode and a follow-up that reuses the freed pages —
with the same JAX-made f32 weights (``tiny`` preset, MHA and GQA). The JAX
engine runs its whole-prompt prefill with the plain reference attention
and its decode through the page gather (``paged_kernel="off"``; the JAX
tests pin its kernel to that gather). Greedy tokens must be identical with
``kv_quant`` off and on, and after the schedule every int8 payload byte the
requests wrote must be identical. The f32 scales agree to a few ULP, not
bitwise: a scale is amax(K/V) / 127, and the K/V entering the quantizer
come from XLA's and PyTorch's CPU matmuls, which sum in different orders
(the quantizer itself is byte-identical on equal inputs,
test_torch_kv_quant.py). The contiguous layout (``paged=False``) runs the
same schedule. ``build_engine`` runs on the CPU too. The prefix cache with
chunked prefill has its own file, test_torch_prefix_cache.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorhive_tpu.models.transformer import PRESETS as JAX_PRESETS
from tensorhive_tpu.models.transformer import TransformerLM as JaxLM
from tensorhive_tpu.serving.engine import SlotEngine as JaxSlotEngine
from tensorhive_tpu_torch.config import GenerationConfig
from tensorhive_tpu_torch.convert import params_from_jax
from tensorhive_tpu_torch.core.services.generation import build_engine
from tensorhive_tpu_torch.models.transformer import PRESETS
from tensorhive_tpu_torch.ops import flash_attention as flash_module
from tensorhive_tpu_torch.serving.engine import SlotEngine

PROMPTS = [list(range(3, 11)), [5], list(range(1, 21)), list(range(2, 14))]
NEWS = [6, 9, 4, 7]


def configs(kv_heads):
    jax_config = dataclasses.replace(
        JAX_PRESETS["tiny"], dtype=jnp.float32, use_flash=False, remat=False,
        max_seq_len=128, n_kv_heads=kv_heads)
    config = dataclasses.replace(PRESETS["tiny"], dtype=torch.float32,
                                 max_seq_len=128, n_kv_heads=kv_heads)
    return jax_config, config


def run_schedule(engine, after_step=lambda: None):
    """Staggered joins, a cancel and a follow-up; returns each request's
    (outcome, tokens). ``after_step`` runs after every step."""
    def step():
        engine.step()
        after_step()

    handles = []
    for prompt, new in zip(PROMPTS, NEWS):
        handles.append(engine.submit(prompt, max_new_tokens=new))
        step()
    cancelled = engine.submit(list(range(4, 40)), max_new_tokens=20)
    step()
    step()
    cancelled.cancel()
    handles.append(cancelled)
    handles.append(engine.submit([9, 8, 7, 6, 5], max_new_tokens=8))
    while engine.has_work():
        step()
    return [(summary["outcome"], summary["tokens"])
            for summary in (h.result(timeout_s=5) for h in handles)]


@pytest.mark.parametrize("kv_heads", [None, 2])
@pytest.mark.parametrize("kv_quant", ["off", "on"])
def test_port_engine_matches_jax_engine(kv_quant, kv_heads):
    jax_config, config = configs(kv_heads)
    jax_params = JaxLM.init(jax.random.PRNGKey(0), jax_config)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                             config, device="cpu")
    engine_args = dict(slots=4, max_len=96, queue_depth=8, page_size=16,
                       kv_quant=kv_quant, prefix_cache="off",
                       speculative="off")
    jax_engine = JaxSlotEngine(jax_params, jax_config, paged_kernel="off",
                               **engine_args)
    engine = SlotEngine(params, config, device="cpu", **engine_args)
    expected = run_schedule(jax_engine)
    assert run_schedule(engine) == expected
    assert [outcome for outcome, _ in expected] == [
        "completed"] * 4 + ["cancelled", "completed"]
    stats = engine.stats()
    assert stats["kvPagesFree"] == stats["kvPagesTotal"]
    assert stats["kvQuant"] == kv_quant
    if kv_quant == "on":
        # page 0 is the trash page (parked slots' writes race there: any
        # winner is fine); every page a request wrote must match
        for name in ("k", "v"):
            ours = getattr(engine._cache, name).numpy()[:, 1:]
            theirs = np.asarray(getattr(jax_engine._cache, name))[:, 1:]
            assert ours.dtype == theirs.dtype == np.int8
            assert np.array_equal(ours, theirs)
        for name in ("k_scale", "v_scale"):
            ours = getattr(engine._cache, name).numpy()[:, 1:]
            theirs = np.asarray(getattr(jax_engine._cache, name))[:, 1:]
            np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kv_heads", [None, 2])
@pytest.mark.parametrize("kv_quant", ["off", "on"])
def test_port_engine_matches_jax_engine_with_eos(kv_quant, kv_heads):
    """The same schedule with an ``eos_token`` both engines reach (the third
    greedy token of the first request without one): identical tokens,
    outcomes and free pages after every step."""
    jax_config, config = configs(kv_heads)
    jax_params = JaxLM.init(jax.random.PRNGKey(0), jax_config)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                             config, device="cpu")
    engine_args = dict(slots=4, max_len=96, queue_depth=8, page_size=16,
                       kv_quant=kv_quant, prefix_cache="off",
                       speculative="off")
    probe = JaxSlotEngine(jax_params, jax_config, paged_kernel="off",
                          **engine_args)
    first = run_schedule(probe)[0][1]
    eos = first[2]
    engines = [JaxSlotEngine(jax_params, jax_config, paged_kernel="off",
                             eos_token=eos, **engine_args),
               SlotEngine(params, config, device="cpu", eos_token=eos,
                          **engine_args)]
    free = [[], []]
    results = [run_schedule(engine, lambda: free[index].append(
        engine.stats()["kvPagesFree"]))
        for index, engine in enumerate(engines)]
    assert results[1] == results[0]
    assert free[1] == free[0]
    # the first request stops at the first eos it emits
    assert results[0][0] == ("completed", first[:first.index(eos) + 1])
    for engine in engines:
        stats = engine.stats()
        assert stats["kvPagesFree"] == stats["kvPagesTotal"]


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_contiguous_port_engine_matches_jax_engine(kv_heads):
    """The contiguous layout (``paged=False``: one cache row per slot, no
    pool, no prefix cache, f32 K/V): the same schedule gives identical
    greedy tokens and outcomes, and every cache row within 1e-5 of the
    largest K/V element. The JAX whole-prompt prefill runs its plain
    reference attention, the port's the plain version of its flash
    wrapper; the step is the masked decode attention on both sides."""
    jax_config, config = configs(kv_heads)
    jax_params = JaxLM.init(jax.random.PRNGKey(0), jax_config)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                             config, device="cpu")
    engine_args = dict(slots=4, max_len=96, queue_depth=8, paged=False)
    jax_engine = JaxSlotEngine(jax_params, jax_config, **engine_args)
    engine = SlotEngine(params, config, device="cpu", **engine_args)
    expected = run_schedule(jax_engine)
    assert run_schedule(engine) == expected
    assert [outcome for outcome, _ in expected] == [
        "completed"] * 4 + ["cancelled", "completed"]
    stats = engine.stats()
    assert (stats["paged"], stats["kvQuant"], stats["prefixCache"]) == (
        False, "off", "off")
    assert stats["kvPagesTotal"] is None and stats["pageSize"] is None
    # the cancelled request leaves from the queue; [5] needs no prefill
    assert engine.prefill_chunks == 0 and engine.prefills == 4
    for ours, theirs in zip(engine._cache, jax_engine._cache):
        ours, theirs = ours.numpy(), np.asarray(theirs)
        assert ours.shape == theirs.shape == (2, 4, 96, config.kv_heads, 16)
        assert np.abs(ours - theirs).max() <= 1e-5 * np.abs(theirs).max()


@pytest.mark.parametrize("paged_kernel", ["on", "off"])
def test_build_engine_serves_on_cpu(paged_kernel):
    generation = GenerationConfig(preset="tiny", max_len=64, slots=2,
                                  paged_kernel=paged_kernel)
    if paged_kernel == "off":
        # the plain page gather is no operator choice: decode runs the
        # kernel (its plain version only for CPU tensors)
        with pytest.raises(ValueError, match="paged_kernel='off'"):
            build_engine(generation, device="cpu")
        return
    before = dict(flash_module.launches)
    engine = build_engine(generation, device="cpu")
    # CPU tensors take the plain versions: no kernel launch is counted
    assert flash_module.launches == before
    assert engine.stats()["pagedKernel"] == "cuda"
    assert engine.stats()["kvQuant"] == "on"
    # warmup: the chunk widths of (16, max_len // 2) — the default engine
    # prefills through the chunked body — and one step
    assert engine.stats()["prefixCache"] == "on"
    assert (engine.prefills, engine.prefill_chunks) == (0, 2)
    assert engine.step_dispatches == 1
    handles = [engine.submit([1, 2, 3], max_new_tokens=4),
               engine.submit([7], max_new_tokens=3, temperature=0.8)]
    engine.pump()
    tokens = [h.result(timeout_s=5)["tokens"] for h in handles]
    assert [len(t) for t in tokens] == [4, 3]
    assert all(0 <= t < PRESETS["tiny"].vocab_size for t in sum(tokens, []))
    assert engine.stats()["kvPagesFree"] == engine.stats()["kvPagesTotal"]


def test_page_pool_issues_the_jax_pools_page_ids():
    """The same assign/release churn on both pools: identical page tables
    and counters after every operation, so both engines put a schedule's
    K/V on the same physical pages."""
    from tensorhive_tpu.serving.paging import PagePool as JaxPagePool
    from tensorhive_tpu_torch.serving.paging import TRASH_PAGE, PagePool

    ours = PagePool(num_pages=12, page_size=8, slots=4, max_pages_per_slot=4)
    theirs = JaxPagePool(num_pages=12, page_size=8, slots=4,
                         max_pages_per_slot=4)
    rng = np.random.default_rng(5)
    for _ in range(60):
        slot = int(rng.integers(0, 4))
        if rng.random() < 0.5:
            assert ours.release(slot) == theirs.release(slot)
        elif not ours.page_table[slot].any():
            pages = int(rng.integers(1, 5))
            assert ours.assign(slot, pages) == theirs.assign(slot, pages)
        assert np.array_equal(ours.page_table, theirs.page_table)
        assert (ours.free_pages, ours.used_pages) == (theirs.free_pages,
                                                      theirs.used_pages)
    assert ours.pages_for(17) == theirs.pages_for(17) == 3
    assert ours.physical_pages == theirs.physical_pages == 13
    assert TRASH_PAGE == 0


def test_submit_validations_and_drain():
    from tensorhive_tpu_torch.serving import (
        EngineDrainingError,
        QueueFullError,
        RateLimitError,
    )

    _, config = configs(2)
    params = params_from_jax(jax.tree_util.tree_map(
        np.asarray, JaxLM.init(jax.random.PRNGKey(0), configs(2)[0])),
        config, device="cpu")
    engine = SlotEngine(params, config, slots=1, max_len=64, queue_depth=2,
                        kv_pages=3, max_new_tokens_cap=16,
                        max_concurrent_per_user=1, device="cpu")
    for prompt, new, temperature in [([], 4, 0.0), ([512], 4, 0.0),
                                     ([1], 0, 0.0), ([1], 17, 0.0),
                                     ([1] * 60, 8, 0.0), ([1], 4, -0.5)]:
        with pytest.raises(ValueError):
            engine.submit(prompt, max_new_tokens=new, temperature=temperature)
    with pytest.raises(ValueError, match="KV pages"):   # 4 pages > pool of 3
        engine.submit([1] * 50, max_new_tokens=10)
    engine.submit([1, 2], max_new_tokens=2, user_key="ann")
    with pytest.raises(RateLimitError):
        engine.submit([1, 2], max_new_tokens=2, user_key="ann")
    engine.submit([3], max_new_tokens=2)
    with pytest.raises(QueueFullError):
        engine.submit([4], max_new_tokens=2)
    engine.drain()
    with pytest.raises(EngineDrainingError):
        engine.submit([5], max_new_tokens=2)
    assert engine.draining
    engine.pump()
    engine.resume()
    done = engine.submit([5], max_new_tokens=2)
    engine.pump()
    assert done.result(timeout_s=5)["outcome"] == "completed"
    assert engine.stats()["requestsCompleted"] == 3
