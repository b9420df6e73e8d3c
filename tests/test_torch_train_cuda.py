"""The train step's phase record on the card (``train.StepPhases``).

These tests need the card and skip without a CUDA device. On the card,
where JAX is not installed, run them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_train_cuda.py

* The record adds no synchronising call: under
  ``torch.cuda.set_sync_debug_mode("error")`` the step completes exactly
  when the same step written out by hand (``TransformerLM.loss``,
  ``torch.autograd.grad``, ``AdamW.update``) does, also on the step that
  reads the events of the one before.
* A step taken while ``torch.profiler`` records only the device's
  activity (as the benchmark's traced span does) carries ``profiled=1``.
* The device phases, from the first event to the last, lie inside the
  step's synchronised host time and cover most of it.
"""
import dataclasses
import time

import pytest
import torch

from tensorhive_tpu_torch import observability, train
from tensorhive_tpu_torch.models.transformer import PRESETS, TransformerLM

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the phase events are the card's")
    return torch.device("cuda")


def setup(device):
    config = dataclasses.replace(PRESETS["tiny"], dtype=torch.bfloat16,
                                 n_layers=2, max_seq_len=128)
    tc = train.TrainConfig(batch_size=4, seq_len=128, warmup_steps=1,
                           total_steps=10, learning_rate=1e-3)
    params, state = train.init_train_state(
        config, tc, torch.Generator(device).manual_seed(0), device=device)
    tokens = torch.randint(0, config.vocab_size, (4, 129), device=device,
                           generator=torch.Generator(device).manual_seed(1))
    return config, tc, params, state, tokens


def outcome(call):
    """None when ``call`` completes under the sync check, else the error's
    first line."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
        return None
    except RuntimeError as error:
        return str(error).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


def test_phase_record_adds_no_synchronising_call(device):
    config, tc, params, state, tokens = setup(device)
    optimizer = train.make_optimizer(tc)

    def by_hand():
        live = train.tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = TransformerLM.loss(live, tokens, config)
        grads = list(torch.autograd.grad(loss, train.tree_leaves(live)))
        optimizer.update(train._unflatten(params, grads), state, params,
                         train.global_norm(grads))

    step = train.make_train_step(config, tc)
    by_hand()                                   # warm: kernels, cuBLAS
    step(params, state, tokens)
    parent = outcome(by_hand)
    # the second step reads the first one's events
    assert [outcome(lambda: step(params, state, tokens))
            for _ in range(2)] == [parent, parent]


def test_step_under_a_device_profiler_is_marked(device):
    config, tc, params, state, tokens = setup(device)
    observability.get_tracer().clear()
    step = train.make_train_step(config, tc)
    step(params, state, tokens)
    activities = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities):
        step(params, state, tokens)
        torch.cuda.synchronize()
    step(params, state, tokens)
    torch.cuda.synchronize()
    step(params, state, tokens)
    marked = [span["attrs"]["profiled"]
              for span in observability.get_tracer().recent(kind="train")
              if span["name"] == "train.step"]
    assert marked == ["0", "1", "0"]


def test_device_phases_lie_inside_the_step(device):
    config, tc, params, state, tokens = setup(device)
    observability.get_tracer().clear()
    step = train.make_train_step(config, tc)
    hosts = []
    for _ in range(4):
        torch.cuda.synchronize()
        started = time.perf_counter()
        step(params, state, tokens)
        torch.cuda.synchronize()
        hosts.append(time.perf_counter() - started)
    spans = observability.get_tracer().recent(kind="train")
    steps = [span for span in spans if span["name"] == "train.step"]
    assert len(steps) == 3
    for span, host in zip(steps, hosts):
        children = [child for child in spans
                    if child["parentId"] == span["spanId"]]
        phases = sum(child["durationMs"] for child in children)
        assert len(children) == 5 and all(
            child["durationMs"] > 0 for child in children)
        assert phases == pytest.approx(span["durationMs"], rel=1e-3)
        assert 0.5 * 1e3 * host <= span["durationMs"] <= 1e3 * host
