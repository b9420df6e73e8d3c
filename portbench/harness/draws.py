"""Traffic sizes that follow a stated distribution and are the same set
for every seed: ``n`` values at the distribution's quantiles (i + ½) / n,
put in an order drawn from the seed. Runs with different seeds then do the
same work in another order, so the seed does not move a cell's numbers."""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import List

import numpy as np

_NORMAL = NormalDist()


def _grid(n: int) -> List[float]:
    return [(index + 0.5) / n for index in range(n)]


def lognormal(n: int, median: float, sigma: float, low: int, high: int,
              rng: np.random.Generator) -> np.ndarray:
    """Whole numbers, lognormal about ``median``, clipped to [low, high]."""
    values = [min(high, max(low, round(median * math.exp(
        sigma * _NORMAL.inv_cdf(u))))) for u in _grid(n)]
    return rng.permutation(np.array(values, dtype=np.int64))


def uniform(n: int, low: int, high: int,
            rng: np.random.Generator) -> np.ndarray:
    """Whole numbers spread evenly over [low, high]."""
    values = [min(high, low + int(u * (high - low + 1))) for u in _grid(n)]
    return rng.permutation(np.array(values, dtype=np.int64))


def exponential(n: int, mean: float, rng: np.random.Generator) -> np.ndarray:
    values = [-mean * math.log(1.0 - u) for u in _grid(n)]
    return rng.permutation(np.array(values, dtype=np.float64))


def zipf(n: int, choices: int, exponent: float,
         rng: np.random.Generator) -> np.ndarray:
    """``n`` picks of ``choices`` ranks, rank r in proportion to
    1 / r^exponent (counts by largest remainder)."""
    weights = np.array([1.0 / (rank ** exponent)
                        for rank in range(1, choices + 1)])
    share = weights / weights.sum() * n
    counts = np.floor(share).astype(np.int64)
    for index in np.argsort(-(share - counts))[:n - counts.sum()]:
        counts[index] += 1
    return rng.permutation(np.repeat(np.arange(choices), counts))


def tokens(rng: np.random.Generator, count: int, vocab: int) -> List[int]:
    return rng.integers(0, vocab, size=count).tolist()


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), *tags])

