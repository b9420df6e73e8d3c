"""The port's token data pipeline against the JAX package's.

Both read the same shards (``fake_shards``, whose files are byte-identical
on both sides): ``batch_at`` and ``host_batch_at`` give byte-identical
batches for the same seed and step, the process layout comes from
``torch.distributed`` when it is initialised, and ``prefetch_to_device``
keeps the JAX producer's contract — order, exhaustion, an exception raised
in the consumer, and a producer that stops when the consumer does.
"""
import threading
import time

import numpy as np
import pytest
import torch

from tensorhive_tpu import data as jax_data
from tensorhive_tpu_torch import data


def shards(tmp_path, **knobs):
    """The same shards written by both helpers; returns the port's glob."""
    ours = data.fake_shards(tmp_path / "torch", **knobs)
    theirs = jax_data.fake_shards(tmp_path / "jax", **knobs)
    for name in ("shard_0000.bin", "shard_0001.bin"):
        assert ((tmp_path / "torch" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())
    return ours, theirs


@pytest.mark.parametrize("dtype,vocab", [("uint16", 32_000),
                                         ("uint32", 100_000)])
def test_batches_are_byte_identical_to_jax(tmp_path, dtype, vocab):
    ours, theirs = shards(tmp_path, tokens_per_shard=3000, vocab_size=vocab,
                          seed=3, dtype=dtype)
    knobs = dict(seq_len=700, batch_size=6, seed=11, dtype=dtype,
                 vocab_size=vocab)
    dataset = data.TokenDataset(data.DataConfig(pattern=ours, **knobs))
    reference = jax_data.TokenDataset(
        jax_data.DataConfig(pattern=theirs, **knobs))
    assert dataset.total_tokens == reference.total_tokens == 6000
    for step in (0, 1, 17, 10**6):
        batch = dataset.batch_at(step)
        assert batch.dtype == np.int32 and batch.shape == (6, 701)
        assert batch.tobytes() == reference.batch_at(step).tobytes()
        for index, count in ((0, 1), (0, 2), (1, 2), (2, 3)):
            assert (dataset.host_batch_at(step, index, count).tobytes()
                    == reference.host_batch_at(step, index, count).tobytes())
        assert dataset.host_batch_at(step).tobytes() == batch.tobytes()
    assert not np.array_equal(dataset.batch_at(0), dataset.batch_at(1))


def test_process_layout_comes_from_torch_distributed(tmp_path, monkeypatch):
    ours, theirs = shards(tmp_path)
    config = data.DataConfig(pattern=ours, seq_len=64, batch_size=4)
    dataset = data.TokenDataset(config)
    reference = jax_data.TokenDataset(jax_data.DataConfig(
        pattern=theirs, seq_len=64, batch_size=4))
    assert data._process_layout() == (0, 1)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    assert data._process_layout() == (1, 2)
    assert (dataset.host_batch_at(5).tobytes()
            == reference.host_batch_at(5, 1, 2).tobytes())
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 3)
    with pytest.raises(ValueError, match="not divisible by 3"):
        dataset.host_batch_at(5)


def test_process_layout_of_an_initialised_process_group(tmp_path):
    """A real (one-process, gloo) group: rank 0 of 1, so this process's
    rows are the whole batch."""
    pattern, _ = shards(tmp_path)
    dataset = data.TokenDataset(data.DataConfig(pattern=pattern, seq_len=32,
                                                batch_size=4))
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
        world_size=1)
    try:
        assert data._process_layout() == (0, 1)
        assert (dataset.host_batch_at(3).tobytes()
                == dataset.batch_at(3).tobytes())
    finally:
        torch.distributed.destroy_process_group()
    assert not torch.distributed.is_initialized()


def test_vocab_and_shard_checks(tmp_path):
    pattern, _ = shards(tmp_path, vocab_size=1000)
    dataset = data.TokenDataset(data.DataConfig(pattern=pattern, seq_len=32,
                                                batch_size=8, vocab_size=10))
    with pytest.raises(ValueError, match="vocab_size 10"):
        dataset.batch_at(0)
    with pytest.raises(FileNotFoundError):
        data.TokenDataset(data.DataConfig(pattern=str(tmp_path / "none*")))
    with pytest.raises(ValueError, match="one window"):
        data.TokenDataset(data.DataConfig(pattern=pattern, seq_len=8192))


def prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "data-prefetch"]


def wait_for_no_prefetch_thread(seconds=5.0):
    deadline = time.monotonic() + seconds
    while prefetch_threads() and time.monotonic() < deadline:
        time.sleep(0.02)
    return not prefetch_threads()


def test_prefetch_order_and_exhaustion(tmp_path):
    pattern, _ = shards(tmp_path)
    dataset = data.TokenDataset(data.DataConfig(pattern=pattern, seq_len=32,
                                                batch_size=3, seed=2))
    got = list(data.prefetch_to_device(dataset, 4, 5, device="cpu",
                                       buffer_size=2))
    assert len(got) == 5
    for step, batch in zip(range(4, 9), got):
        assert batch.device.type == "cpu" and batch.dtype == torch.int32
        assert np.array_equal(batch.numpy(), dataset.batch_at(step))
    assert wait_for_no_prefetch_thread()


def test_prefetch_surfaces_producer_errors(tmp_path):
    pattern, _ = shards(tmp_path)

    class Failing(data.TokenDataset):
        def batch_at(self, step):
            if step == 2:
                raise RuntimeError("disk went away")
            return super().batch_at(step)

    dataset = Failing(data.DataConfig(pattern=pattern, seq_len=16,
                                      batch_size=2))
    batches = data.prefetch_to_device(dataset, 0, 5, device="cpu")
    assert next(batches).shape == (2, 17)
    assert next(batches).shape == (2, 17)
    with pytest.raises(RuntimeError, match="disk went away"):
        next(batches)
    assert wait_for_no_prefetch_thread()


def test_abandoned_prefetch_stops_its_producer(tmp_path):
    """A consumer that stops after one batch of many: closing the iterator
    sets the stop flag, and the producer, parked on a full queue, exits."""
    pattern, _ = shards(tmp_path)
    dataset = data.TokenDataset(data.DataConfig(pattern=pattern, seq_len=16,
                                                batch_size=2))
    batches = data.prefetch_to_device(dataset, 0, 1000, device="cpu",
                                      buffer_size=1)
    next(batches)
    assert prefetch_threads()
    batches.close()
    assert wait_for_no_prefetch_thread()


def test_prefetch_needs_cuda_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    pattern, _ = shards(tmp_path)
    dataset = data.TokenDataset(data.DataConfig(pattern=pattern, seq_len=16,
                                                batch_size=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        next(data.prefetch_to_device(dataset, 0, 1))
