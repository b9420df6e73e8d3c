"""The traffic generators: fixed by the seed, the same sizes for every
seed, and following their stated distributions."""
import json
import math
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.harness import draws
from portbench.traffic import chat, closed, train


HOME = Path(__file__).resolve().parents[1]


def _cell(name):
    return json.loads((HOME / "cells" / f"{name}.json").read_text())


def _chat(seed, rate=1.0):
    traffic = dict(_cell("mistral-7b.chat")["traffic"], session_rate=rate)
    return chat.Sessions(traffic, 51.0, 32768, seed, begin=0.0)


def _schedule(source):
    return [(r.due, r.prompt, r.max_new) for s in source.sessions for r in s]


def test_chat_schedule_is_fixed_by_the_seed():
    one, again, other = _chat(11), _chat(11), _chat(12)
    assert _schedule(one) == _schedule(again)
    assert _schedule(one) != _schedule(other)
    due = sorted(d for d, _, _ in one._heap)
    assert due == sorted(d for d, _, _ in _schedule(one))
    # the next turn is due after the last answer at the replay's pace and
    # a think time, whatever the engine does
    for session in one.sessions:
        for before, after in zip(session, session[1:]):
            assert after.due >= before.due + 0.2 * before.max_new


def test_chat_sizes_are_the_same_set_for_every_seed():
    def sizes(source):
        return sorted(r.max_new for s in source.sessions for r in s)
    assert abs(len(sizes(_chat(11))) - len(sizes(_chat(99)))) <= 0.1 * len(
        sizes(_chat(11)))
    firsts = [sorted(s[0].due for s in _chat(seed).sessions if s)
              for seed in (11, 99)]
    assert firsts[0][-1] == pytest.approx(firsts[1][-1], rel=1e-9)


def test_chat_sessions_keep_to_the_context_limit_and_share_prompts():
    source = _chat(5)
    traffic = _cell("mistral-7b.chat")["traffic"]
    firsts = Counter()
    for session in source.sessions:
        for turn in session:
            assert len(turn.prompt) + turn.max_new <= traffic["max_context"]
        if session:
            firsts[tuple(session[0].prompt[:16])] += 1
    shares = sorted(firsts.values(), reverse=True)
    # four system prompts, Zipf 1.0: the most popular takes 12/25 of sessions
    assert len(shares) == 4
    assert shares[0] / sum(shares) == pytest.approx(12 / 25, abs=0.05)


def test_lognormal_follows_its_median_and_bounds():
    values = draws.lognormal(1000, median=128, sigma=1.0, low=16, high=1024,
                             rng=draws.rng(1))
    assert np.median(values) == pytest.approx(128, abs=2)
    assert values.min() >= 16 and values.max() <= 1024
    # the share under the median's e-fold is Phi(-1) = 0.159
    assert np.mean(values < 128 / math.e) == pytest.approx(0.159, abs=0.01)


def test_uniform_exponential_and_zipf():
    values = draws.uniform(1000, 512, 1024, draws.rng(2))
    assert values.min() == 512 and values.max() == 1024
    assert values.mean() == pytest.approx(768, abs=1)
    gaps = draws.exponential(1000, 0.5, draws.rng(3))
    assert gaps.mean() == pytest.approx(0.5, rel=0.01)
    assert np.median(gaps) == pytest.approx(0.5 * math.log(2), rel=0.01)
    picks = draws.zipf(250, 4, 1.0, draws.rng(4))
    counts = np.bincount(picks)
    assert counts.tolist() == [120, 60, 40, 30]


def test_closed_clients_are_fixed_by_the_seed_and_spread_first_answers():
    traffic = _cell("mistral-7b.decode")["traffic"]
    one = closed.Clients(traffic, 32768, 7, begin=0.0)
    again = closed.Clients(traffic, 32768, 7, begin=0.0)
    other = closed.Clients(traffic, 32768, 8, begin=0.0)
    firsts = [r.max_new for r in one.firsts]
    assert firsts == [r.max_new for r in again.firsts]
    assert [r.prompt for r in one.firsts] != [r.prompt for r in other.firsts]
    assert min(firsts) >= 1 and max(firsts) <= 1024
    assert sorted(firsts) == sorted(r.max_new for r in other.firsts)
    later = [r for queue in one.queues for r in queue]
    assert all(512 <= r.max_new <= 1024 for r in later)
    assert all(64 <= r.prompt_len <= 768 for r in later + one.firsts)
    assert len(one.firsts) == traffic["clients"]


def test_train_batches_differ_by_step_and_repeat_by_seed():
    traffic = {"batch": 2, "seq_len": 4096,
               "document": {"median": 1024, "sigma": 1.0}}
    device = torch.device("cpu")
    first = train.make_batch(3, 1, traffic, 92544, 2, device)
    assert first.shape == (2, 4097) and first.dtype == torch.int32
    assert torch.equal(first, train.make_batch(3, 1, traffic, 92544, 2,
                                               device))
    assert not torch.equal(first, train.make_batch(3, 2, traffic, 92544, 2,
                                                   device))
    # a document ends every ~1.6k tokens (lognormal mean at sigma 1)
    ends = int((first == 2).sum())
    assert 2 <= ends <= 16
