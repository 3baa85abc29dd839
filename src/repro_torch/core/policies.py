"""Task-selection policies for steering campaigns.

A numpy-only copy of ``repro.core.policies``, kept here so that the port imports
nothing of ``repro``; the port's tests hold the two equal.

The paper's application uses Upper Confidence Bound over an MPNN ensemble;
we provide that plus the baselines (random, greedy) the paper compares in
Fig. 4, and generic batch selectors.
"""
from __future__ import annotations

import numpy as np


def ucb_scores(preds: np.ndarray, kappa: float = 2.0) -> np.ndarray:
    """preds (E, N) ensemble predictions -> UCB per candidate."""
    return preds.mean(axis=0) + kappa * preds.std(axis=0)


def greedy_scores(preds: np.ndarray) -> np.ndarray:
    return preds.mean(axis=0)


def random_scores(n: int, rng: np.random.Generator) -> np.ndarray:
    return rng.random(n)


def select_batch(scores: np.ndarray, k: int, exclude=()) -> list:
    """Top-k candidate indices by score, skipping `exclude`."""
    order = np.argsort(-scores)
    out = []
    excl = set(exclude)
    for i in order:
        if int(i) not in excl:
            out.append(int(i))
            if len(out) >= k:
                break
    return out


def epsilon_greedy(scores: np.ndarray, k: int, eps: float,
                   rng: np.random.Generator, exclude=()) -> list:
    """Mix of exploitation and uniform exploration."""
    n_rand = int(round(eps * k))
    top = select_batch(scores, k - n_rand, exclude)
    pool = [i for i in range(len(scores))
            if i not in set(exclude) and i not in set(top)]
    rand = list(rng.choice(pool, size=min(n_rand, len(pool)),
                           replace=False)) if pool and n_rand else []
    return top + [int(i) for i in rand]
