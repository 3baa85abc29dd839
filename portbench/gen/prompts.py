"""The request generator of the serving mixes.

A mix draws its prompt lengths and output lengths from stated
distributions. So that the seed changes the order of the work and not its
amount, the sizes come from a fixed pool: ``pool`` prompt lengths at the
distribution's quantiles (i + 0.5) / pool, paired with ``pool`` output
lengths the same way by one fixed permutation. The requests are the pool
again and again, each pass in an order drawn from the seed. Request k's
token ids are drawn from (seed, k), uniform over the vocabulary.

A distribution is {"dist": "loguniform" | "uniform", "lo": a, "hi": b},
integers from a to b inclusive.
"""
from __future__ import annotations

import math

import numpy as np


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The n sizes of ``dist`` at the quantiles (i + 0.5) / n."""
    q = (np.arange(n) + 0.5) / n
    lo, hi = float(dist["lo"]), float(dist["hi"])
    if dist["dist"] == "loguniform":
        x = np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
    elif dist["dist"] == "uniform":
        x = lo - 0.5 + q * (hi - lo + 1)
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def size_pool(traffic: dict) -> list[tuple[int, int]]:
    """The (prompt length, output length) pairs every pass serves."""
    n = int(traffic["pool"])
    prompt = quantiles(traffic["prompt_len"], n)
    out = quantiles(traffic["max_new"], n)
    pair = np.random.default_rng(0).permutation(n)
    return [(int(p), int(out[j])) for p, j in zip(prompt, pair)]


class Requests:
    """Request k of the seed's stream: (prompt token ids, max_new)."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        self.pool = size_pool(traffic)
        self.vocab = int(vocab)
        self.seed = int(seed)
        self._orders: dict = {}

    def sizes(self, k: int) -> tuple[int, int]:
        n = len(self.pool)
        rnd, i = divmod(k, n)
        if rnd not in self._orders:
            self._orders[rnd] = np.random.default_rng(
                [self.seed, 1, rnd]).permutation(n)
        return self.pool[self._orders[rnd][i]]

    def __getitem__(self, k: int) -> tuple[list, int]:
        length, max_new = self.sizes(k)
        ids = np.random.default_rng([self.seed, 2, k]).integers(
            0, self.vocab, size=length)
        return ids.tolist(), max_new
