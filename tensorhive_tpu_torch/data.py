"""Token data pipeline: memmapped shards -> deterministic batches -> device
— the PyTorch counterpart of ``tensorhive_tpu/data.py``.

* ``TokenDataset.batch_at(step)`` derives the batch from (seed, step)
  alone with the same numpy code as the JAX module (memmapped shards,
  Philox-keyed window offsets), so the two give byte-identical batches for
  the same shards and seed, and a resumed run needs only its step count.
* ``host_batch_at`` reads only this process's rows of the global batch; the
  rank and world size come from ``torch.distributed`` when it is
  initialised (else 0 and 1).
* ``prefetch_to_device`` reads ``buffer_size`` batches ahead on a
  background thread. For a CUDA device each batch is copied from pinned
  host memory on a side stream; the consumer's stream waits on the copy's
  event before the batch is handed out, and the batch is recorded on the
  consumer's stream for the caching allocator. For the CPU the batches are
  plain CPU tensors.

Shard format: raw little-endian token files (uint16 for vocab <= 65536,
uint32 otherwise), concatenated logically in sorted filename order.
"""
from __future__ import annotations

import dataclasses
import glob as globlib
import queue
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    pattern: str                 # glob for token shard files
    seq_len: int = 1024          # model sequence length (batches are +1 wide)
    batch_size: int = 8          # GLOBAL batch size
    seed: int = 0
    dtype: str = "uint16"
    #: model vocabulary size; when set, every produced batch is validated —
    #: an embedding lookup with an id past the vocabulary fails only on the
    #: card, mid-step, and a tokenizer/model mismatch is better named here
    vocab_size: Optional[int] = None


def _process_layout() -> Tuple[int, int]:
    """(rank, world size) from ``torch.distributed`` when initialised."""
    distributed = torch.distributed
    if distributed.is_available() and distributed.is_initialized():
        return distributed.get_rank(), distributed.get_world_size()
    return 0, 1


class TokenDataset:
    """Logically concatenated memmapped token shards with deterministic,
    step-addressable window sampling."""

    def __init__(self, config: DataConfig) -> None:
        self.config = config
        paths = sorted(globlib.glob(config.pattern))
        if not paths:
            raise FileNotFoundError(f"no token shards match {config.pattern!r}")
        self._shards: List[np.memmap] = [
            np.memmap(path, dtype=np.dtype(config.dtype), mode="r")
            for path in paths
        ]
        lengths = [len(shard) for shard in self._shards]
        #: exclusive prefix sums: shard i covers [starts[i], starts[i+1])
        self._starts = np.concatenate([[0], np.cumsum(lengths)])
        self.total_tokens = int(self._starts[-1])
        self.window = config.seq_len + 1          # inputs + shifted targets
        if self.total_tokens < self.window:
            raise ValueError(
                f"dataset has {self.total_tokens} tokens < one "
                f"window of {self.window}")

    def _read_window(self, offset: int) -> np.ndarray:
        """Window [offset, offset+window) across shard boundaries."""
        out = np.empty(self.window, np.int32)
        filled = 0
        while filled < self.window:
            pos = offset + filled
            shard_index = int(np.searchsorted(self._starts, pos,
                                              side="right")) - 1
            shard = self._shards[shard_index]
            local = pos - int(self._starts[shard_index])
            take = min(self.window - filled, len(shard) - local)
            out[filled:filled + take] = shard[local:local + take]
            filled += take
        return out

    def _offsets_at(self, step: int) -> np.ndarray:
        """All window offsets for ``step``, from a counter-based generator
        keyed on (seed, step): every process computes the same offsets for
        a step, across restarts and topologies."""
        config = self.config
        rng = np.random.Generator(np.random.Philox(
            key=np.uint64(config.seed), counter=[0, 0, 0, np.uint64(step)]))
        return rng.integers(
            0, self.total_tokens - self.window + 1, size=config.batch_size)

    def _check_vocab(self, batch: np.ndarray) -> np.ndarray:
        vocab = self.config.vocab_size
        if vocab is not None:
            top = int(batch.max())
            if top >= vocab:
                raise ValueError(
                    f"shard token id {top} >= model vocab_size {vocab} — "
                    f"tokenizer/model mismatch")
        return batch

    def batch_at(self, step: int) -> np.ndarray:
        """Global batch for ``step``: [batch_size, seq_len+1] int32."""
        return self._check_vocab(np.stack(
            [self._read_window(int(o)) for o in self._offsets_at(step)]))

    def host_batch_at(self, step: int, process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> np.ndarray:
        """This process's contiguous row slice of the global batch. Only
        its rows touch disk; offsets are cheap to draw for the whole
        batch."""
        rank, world = _process_layout()
        if process_index is None:
            process_index = rank
        if process_count is None:
            process_count = world
        if self.config.batch_size % process_count:
            raise ValueError(
                f"global batch {self.config.batch_size} not divisible by "
                f"{process_count} processes")
        rows = self.config.batch_size // process_count
        offsets = self._offsets_at(step)[process_index * rows:
                                         (process_index + 1) * rows]
        return self._check_vocab(
            np.stack([self._read_window(int(o)) for o in offsets]))


def prefetch_to_device(dataset: TokenDataset, start_step: int,
                       num_steps: int, device: DeviceLike = None,
                       buffer_size: int = 2) -> Iterator[torch.Tensor]:
    """Iterate [B, L+1] int32 batches on ``device`` (``None`` = CUDA) for
    steps [start_step, start_step + num_steps), read and copied
    ``buffer_size`` batches ahead of the consumer on a background thread.
    Under ``torch.distributed`` each process gets its own rows
    (``host_batch_at``). An exception in the producer is raised in the
    consumer; a consumer that stops early (``close()`` or garbage
    collection of the generator) stops the producer."""
    device = resolve_device(device)
    todo: queue.Queue = queue.Queue(maxsize=buffer_size)
    stop = threading.Event()
    multihost = _process_layout()[1] > 1
    copy_stream = (torch.cuda.Stream(device=device)
                   if device.type == "cuda" else None)

    def to_device(host_rows: np.ndarray):
        """(batch, event the consumer waits on or None)."""
        host = torch.from_numpy(host_rows)
        if copy_stream is None:
            return host, None
        host = host.pin_memory()
        with torch.cuda.stream(copy_stream):
            batch = host.to(device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return batch, ready

    def enqueue(item) -> bool:
        """put() that keeps watching ``stop``, so an abandoned consumer
        never leaves this thread parked on a full queue."""
        while not stop.is_set():
            try:
                todo.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer() -> None:
        try:
            for step in range(start_step, start_step + num_steps):
                if stop.is_set():
                    return
                host = (dataset.host_batch_at(step) if multihost
                        else dataset.batch_at(step))
                if not enqueue(to_device(host)):
                    return
            enqueue(None)
        except BaseException as exc:  # surfaces in the consumer, not lost
            enqueue(exc)

    thread = threading.Thread(target=producer, daemon=True,
                              name="data-prefetch")
    thread.start()
    try:
        while True:
            item = todo.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            batch, ready = item
            if ready is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(ready)
                batch.record_stream(stream)
            yield batch
    finally:
        stop.set()


def fake_shards(directory, num_shards: int = 2, tokens_per_shard: int = 4096,
                vocab_size: int = 32_000, seed: int = 0,
                dtype: str = "uint16") -> str:
    """Write synthetic token shards; returns the glob pattern (the JAX
    helper's numpy draws, so both write the same files)."""
    rng = np.random.default_rng(seed)
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    for index in range(num_shards):
        tokens = rng.integers(0, vocab_size, size=tokens_per_shard)
        tokens.astype(np.dtype(dtype)).tofile(
            directory / f"shard_{index:04d}.bin")
    return str(directory / "shard_*.bin")
