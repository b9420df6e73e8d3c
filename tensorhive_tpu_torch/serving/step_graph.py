"""The serving engine's decode step as one CUDA graph, captured once and
replayed every tick over static device operands.

The eager step enqueues its kernels one by one: for a 32-layer model some
thousands of small launches a tick, and the host's dispatch of them, not
the card, sets the pace. A replay enqueues the same kernels with one call.
The graph holds the step's own body — the same hand-written paged kernel,
the same block math, the same Gumbel draw from the engine's generator — so
a replay emits the tokens the eager step emits, bit for bit. The generator
is registered with the graph: a replay draws from it and advances it as
the eager step does.

Operands. Each of the step's per-slot host arrays has a static device
tensor and a pinned host tensor. Each tick writes the arrays into the host
tensors and fills the device tensors with non-blocking copies. The host
tensors are written again only once the last copies out of them have
landed.

Capture. The first run executes the body eagerly on a side stream — it is
that tick's step, and it sets up the stream's library state (cuBLAS
workspace) outside the capture — and then captures the same body on that
stream. Every later run replays. ``reset`` drops the capture: the next run
captures again on the warmed stream and replays at once, so Python that
the body calls (a spy on the LM head, say) runs again, once.

Profiles. While ``observability/profiling.capture_trace`` runs, the engine
steps eagerly, so the trace holds the step's kernels. A replay's kernels
are not reliably recorded: kineto finalizes CUPTI after each session
(``TEARDOWN_CUPTI=1``, which a capture sets), and a session then records a
graph's kernels only if it is the first to start after the graph's
capture — not a later one, nor one the capture ran inside — and a daemon
that captured on its pump thread saw none even in that first one. The
eager step and the replay draw the same tokens, so the stream is the same.

Kernel counters (every counter of ``ops/launch_counts.COUNTERS``) count
kernels that ran: what a capture added is taken back, and each replay adds
it again.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.launch_counts import COUNTERS


def graphs_the_step(device: torch.device, mesh: object,
                    speculative: bool) -> bool:
    """Whether an engine replays its decode step as a CUDA graph: on a CUDA
    device, without a serving mesh (its gloo collectives cannot be
    captured) and without the speculative lane (whose propose and verify
    replace the step and stay eager)."""
    return device.type == "cuda" and mesh is None and not speculative


class StepGraph:
    """One engine's decode step as a CUDA graph. ``operands`` gives each
    host array's torch dtype and shape, in the order ``run`` takes them and
    hands them to the body."""

    def __init__(self, operands: Sequence[Tuple[torch.dtype, Tuple[int, ...]]],
                 generator: Optional[torch.Generator],
                 device: torch.device) -> None:
        self.device = device
        self._generator = generator
        #: (pinned host tensor, static device tensor) per operand
        self._operands = [
            (torch.empty(shape, dtype=dtype, pin_memory=True),
             torch.empty(shape, dtype=dtype, device=device))
            for dtype, shape in operands]
        #: recorded after each tick's copies out of the host tensors
        self._copied = torch.cuda.Event()
        #: the side stream the body first ran on and is captured on
        self._stream: Optional[torch.cuda.Stream] = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Optional[torch.Tensor] = None
        #: what one replay adds to each counter of ``COUNTERS``
        self._launches: List[Dict] = []
        self.captures = 0
        self.replays = 0

    def run(self, body: Callable[..., torch.Tensor],
            arrays: Sequence[np.ndarray]) -> torch.Tensor:
        """Stage ``arrays`` and run the step: the first call runs ``body``
        eagerly and captures it, every later call replays the capture.
        ``body`` takes the static device tensors and must be the same each
        call. The result is the graph's static output from the second call
        on: read it before the next ``run``."""
        self._copied.synchronize()
        for (host, static), array in zip(self._operands, arrays):
            host.numpy()[...] = array
            static.copy_(host, non_blocking=True)
        self._copied.record()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            current = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                out = body(*self._statics())
            current.wait_stream(self._stream)
            self._capture(body)
            return out
        if self._graph is None:
            self._capture(body)
        for counter, added in zip(COUNTERS, self._launches):
            for key, count in added.items():
                counter[key] = counter.get(key, 0) + count
        self._graph.replay()
        self.replays += 1
        return self._out

    def _statics(self) -> List[torch.Tensor]:
        return [static for _, static in self._operands]

    def _capture(self, body: Callable[..., torch.Tensor]) -> None:
        graph = torch.cuda.CUDAGraph()
        if self._generator is not None:
            graph.register_generator_state(self._generator)
        before = [dict(counter) for counter in COUNTERS]
        # thread_local: CUDA calls of the engine's other threads (the host
        # tier's copy lane) do not void this thread's capture
        with torch.cuda.graph(graph, stream=self._stream,
                              capture_error_mode="thread_local"):
            self._out = body(*self._statics())
        self._launches = []
        for counter, old in zip(COUNTERS, before):
            added = {key: count - old.get(key, 0)
                     for key, count in counter.items()
                     if count != old.get(key, 0)}
            for key in added:
                if key in old:
                    counter[key] = old[key]
                else:
                    del counter[key]
            self._launches.append(added)
        self._graph = graph
        self.captures += 1

    def reset(self) -> None:
        """Drop the capture; the next ``run`` captures the body again and
        replays it."""
        self._graph = None
        self._out = None

    def close(self) -> None:
        """Drop the graph and the staging tensors; the counts stay."""
        self.reset()
        self._operands = []
