"""The decode step's CUDA graph (``serving/step_graph.py``) where it must
not engage, the RoPE frequencies it needed made once, and the kernel
counters its replays add to.

On the CPU, and wherever the speculative lane replaces the step, the
engine steps eagerly: ``stepGraphCaptures`` and ``stepGraphReplays`` stay
0 and the tokens are the plain step's. The graph itself runs only on the
card; ``test_torch_cuda_kernels.py`` holds it bitwise to the eager step.
``serve_mixed`` is the schedule both files run.
"""
import dataclasses
import importlib
import pkgutil

import numpy as np
import pytest
import torch

from tensorhive_tpu_torch import ops
from tensorhive_tpu_torch.models.decode import generate
from tensorhive_tpu_torch.models.transformer import (
    PRESETS,
    TransformerLM,
    _rope_freqs,
)
from tensorhive_tpu_torch.ops.launch_counts import COUNTERS
from tensorhive_tpu_torch.serving.engine import SlotEngine
from tensorhive_tpu_torch.serving.step_graph import graphs_the_step

#: each layout's engine settings
LAYOUTS = {"int8": dict(paged=True, kv_quant="on"),
           "pages": dict(paged=True, kv_quant="off"),
           "contiguous": dict(paged=False)}
PROMPT_LENS = [3, 30, 1, 50, 17, 9, 64, 5, 40, 22]
NEW_TOKENS = [16, 7, 28, 5, 20, 9, 24, 14, 6, 14]


def serve_mixed(engine, temperature=0.0, warm=True):
    """Ten requests through the engine's slots, one joining each tick, then
    ticks until all are done: slots free and join again, prompts longer
    than a chunk park their slot over several ticks, contexts cross page
    boundaries. Every other request samples at ``temperature``. Returns
    the prompts, each request's tokens and the ticks stepped."""
    rng = np.random.default_rng(24)
    prompts = [rng.integers(1, engine.config.vocab_size, length).tolist()
               for length in PROMPT_LENS]
    if warm:
        engine.warmup(prompt_lens=(16, 64))
    handles = []
    ticks = 0
    for index, (prompt, new) in enumerate(zip(prompts, NEW_TOKENS)):
        handles.append(engine.submit(
            prompt, max_new_tokens=new,
            temperature=temperature if index % 2 else 0.0))
        engine.step()
        ticks += 1
    while engine.has_work():
        engine.step()
        ticks += 1
    return prompts, [h.result(timeout_s=30)["tokens"] for h in handles], ticks


def kernel_counters():
    """Every module-level launch counter (a dict named ``launch...``) of
    the ops modules, by ``module.name``."""
    found = {}
    for info in pkgutil.iter_modules(ops.__path__):
        module = importlib.import_module(f"{ops.__name__}.{info.name}")
        for name, value in vars(module).items():
            if name.startswith("launch") and isinstance(value, dict):
                found[f"{info.name}.{name}"] = value
    return found


def tiny_engine(params, config, layout, device="cpu", **kwargs):
    return SlotEngine(params, config, slots=4, max_len=128, page_size=4,
                      prefill_chunk_tokens=16, device=device,
                      **LAYOUTS[layout], **kwargs)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cpu_engines_never_graph_the_step(layout):
    """On the CPU the step is eager with the speculative lane off and on:
    no capture, no replay. On unquantized caches the greedy tokens of both
    are ``generate``'s for each prompt alone (int8 pages requantize a
    verify window's writes otherwise than one write a tick)."""
    config = dataclasses.replace(PRESETS["tiny"], dtype=torch.float32,
                                 max_seq_len=128, n_kv_heads=2)
    params = TransformerLM.init(config, torch.Generator().manual_seed(24),
                                device="cpu")
    served = {}
    for speculative in ("off", "on"):
        engine = tiny_engine(params, config, layout,
                             speculative=speculative)
        prompts, served[speculative], ticks = serve_mixed(engine)
        stats = engine.stats()
        assert engine._step_graph is None
        assert stats["stepGraphCaptures"] == stats["stepGraphReplays"] == 0
        # the lane accepts several tokens a tick
        assert ticks >= (40 if speculative == "off" else 1), ticks
    if layout != "int8":
        assert served["on"] == served["off"]
        for prompt, new, tokens in zip(prompts, NEW_TOKENS, served["off"]):
            want = generate(params, config, [prompt], new, device="cpu")
            assert tokens == want[0, len(prompt):].tolist()


@pytest.mark.parametrize("device, mesh, speculative, graphs", [
    ("cuda", None, False, True),
    ("cuda", object(), False, False),
    ("cuda", None, True, False),
    ("cpu", None, False, False),
])
def test_the_step_graphs_only_on_the_card_alone(device, mesh, speculative,
                                                graphs):
    """The rule an engine applies at construction: a CUDA device, no
    serving mesh (gloo collectives are not captured), no speculative lane
    (its propose and verify stay eager)."""
    assert graphs_the_step(torch.device(device), mesh, speculative) is graphs


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cached_rope_freqs_are_the_expression_bitwise(d, theta):
    """The frequencies made once per (d, theta, device) are the per-call
    expression's, bit for bit, and one tensor serves every call."""
    exponent = -torch.arange(0, d, 2, dtype=torch.float32) / d
    want = torch.pow(torch.tensor(theta, dtype=torch.float32), exponent)
    got = _rope_freqs(d, theta, torch.device("cpu"))
    assert got.dtype == torch.float32 and got.shape == (d // 2,)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert _rope_freqs(d, theta, torch.device("cpu")) is got


def test_every_kernel_counter_is_one_a_replay_adds_to():
    """Each launch counter of the ops modules is registered in
    ``launch_counts.COUNTERS``, the list a step graph takes a capture's
    counts back from and adds them to at each replay: a counter left out
    would count a graphed step once and its replays never."""
    found = kernel_counters()
    assert {"flash_attention.launches", "flash_attention.launch_heads",
            "paged_attention.launches",
            "paged_attention.launch_heads"} <= set(found)
    registered = {id(counter) for counter in COUNTERS}
    assert [name for name, counter in found.items()
            if id(counter) not in registered] == []
    assert len(COUNTERS) == len(registered) == len(found)
