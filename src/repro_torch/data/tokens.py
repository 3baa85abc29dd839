"""Synthetic LM data: deterministic, step-keyed token streams.

The generator emits structured (not uniform-random) sequences -- a noisy
periodic Markov-ish pattern -- so a model trained for a few hundred steps
shows a clearly decreasing loss (used by examples/train_100m.py).  Batches
are a pure function of (seed, step), which makes data-parallel restart
trivially consistent: after checkpoint restore, step -> batch is identical.
"""
from __future__ import annotations

import numpy as np


def lm_batch(cfg, batch: int, seq: int, *, step: int, seed: int = 0):
    """Returns {"tokens": (B,S) int32, "labels": (B,S) int32} (labels are
    next-token)."""
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + step))
    vocab = cfg.vocab_size
    # structured stream: per-row random period + phase, tokens follow
    # t[i] = (base + i * stride) % vocab with occasional noise
    base = rng.integers(0, vocab, size=(batch, 1))
    stride = rng.integers(1, max(2, vocab // 7), size=(batch, 1))
    idx = np.arange(seq + 1)[None, :]
    stream = (base + idx * stride) % vocab
    noise_mask = rng.random((batch, seq + 1)) < 0.05
    noise = rng.integers(0, vocab, size=(batch, seq + 1))
    stream = np.where(noise_mask, noise, stream).astype(np.int32)
    return {"tokens": stream[:, :-1], "labels": stream[:, 1:]}


def frames_batch(cfg, batch: int, seq: int, *, step: int, seed: int = 0):
    """Stub modality frontend: precomputed frame/patch embeddings."""
    rng = np.random.default_rng(np.uint64(seed * 7_000_003 + step))
    return rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32)


def make_batch(cfg, shape_kind: str, batch: int, seq: int, *, step: int,
               seed: int = 0):
    """Family-aware batch for train/prefill programs."""
    out = lm_batch(cfg, batch, seq, step=step, seed=seed)
    if cfg.family == "vlm":
        out = {"embeds": frames_batch(cfg, batch, seq, step=step, seed=seed),
               "labels": out["labels"]}
        pos = np.broadcast_to(np.arange(seq)[None, None], (3, batch, seq))
        out["positions"] = np.ascontiguousarray(pos).astype(np.int32)
    if cfg.is_encdec:
        out["frames"] = frames_batch(cfg, batch, seq, step=step, seed=seed)
    return out
