"""Faults planted under the timed path, to show that ``correct`` catches
them: the benchmark's own tests run a cell with each, and a chip run reads
them at a cell's size (``--fault``). Never planted in a measured run.

Serving: ``token`` alters a token where the engine produces it (the tenth
of every request, fed back as the next input); ``state`` leaves out the
decode step's write of its K/V, so the cache keeps its old state.
Training: ``half_batch`` steps on the first half of each batch, the mean
taken over the rest; ``state`` leaves the params and the optimizer state
as they were.
"""
from __future__ import annotations

from typing import Callable, Optional

SERVING = ("token", "state")
TRAINING = ("half_batch", "state")


def plant(name: Optional[str], vocab: int) -> Callable[[], None]:
    """Plant a serving fault in the engine; returns what undoes it."""
    if name is None:
        return lambda: None
    if name not in SERVING:
        raise ValueError(f"unknown serving fault {name!r}; one of {SERVING}")
    from tensorhive_tpu_torch.ops import kv_quant
    from tensorhive_tpu_torch.serving.engine import SlotEngine

    if name == "token":
        original = SlotEngine._apply_token_locked

        def altered(self, index, request, token, now):
            if len(request.generated) == 9:
                token = (token + 1) % vocab
                self._tokens[index] = token
            return original(self, index, request, token, now)

        SlotEngine._apply_token_locked = altered
        return lambda: setattr(SlotEngine, "_apply_token_locked", original)
    original_write = kv_quant.step_write
    kv_quant.step_write = lambda *args, **kwargs: None
    return lambda: setattr(kv_quant, "step_write", original_write)


def wrap_step(name: Optional[str], step: Callable) -> Callable:
    """The train step with a training fault planted."""
    if name is None:
        return step
    if name not in TRAINING:
        raise ValueError(f"unknown training fault {name!r}; one of "
                         f"{TRAINING}")
    if name == "half_batch":
        return lambda params, state, tokens: step(
            params, state, tokens[:max(1, tokens.shape[0] // 2)])
    from tensorhive_tpu_torch.train import AdamW

    def unchanged(params, state, tokens):
        original = AdamW.update
        AdamW.update = lambda self, grads, state, params, g_norm=None: state
        try:
            return step(params, state, tokens)
        finally:
            AdamW.update = original

    return unchanged
