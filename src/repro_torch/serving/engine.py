"""Batched serving engine: prefill + KV-cache decode. The port of
``repro/serving/engine.py``.

Requests are grouped into equal-prompt-length micro-batches. Two ways to
drive it, as in the JAX package:

- ``generate``: run a whole batch to completion.
- the stepwise triple ``prefill_batch`` / ``decode_batch`` /
  ``gather_rows``, for continuous batching: admit a prefill between other
  groups' decode steps, stream rows out as they finish, and gather a
  group's surviving rows into a smaller batch (slot reuse).

The prefill allocates the cache at its full reserve (prompt + generation)
once and decode writes it in place; the JAX engine pads a prompt-long cache
in ``grow_cache`` and rebuilds it at every step, with the same values.

Timing: each stepwise call is a layer span (``engine.prefill``,
``engine.decode``, ``engine.gather``; ``repro_torch.observability``),
always on. A prefill or decode span ends on its tokens' host copy, so it
holds the call's device work. ``stats`` counts calls and tokens.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import observability as obs
from repro_torch.configs.base import ModelConfig
from repro_torch.models import api


@dataclass
class GenState:
    """One decode group's device state between steps."""

    cache: dict                   # api.init_cache's tree; every leaf is
                                  # (layers, batch, ...): dense {k, v}
                                  # (layers, B, reserve, KVH, hd); zamba2
                                  # {mamba: {conv, ssm}, attn: {k, v}};
                                  # rwkv6 {tm_shift, cm_shift, state};
                                  # enc-dec {self: {k, v}, cross: {k, v}}
    cur: torch.Tensor             # (B, 1) last emitted token per row
    pos: int                      # tokens already written to the cache
    reserve: int                  # cache capacity (prompt + generation)
    padded_b: int                 # current batch dimension


def _gather(tree, idx):
    """Rows ``idx`` of axis 1 of every leaf of a nested dict."""
    return {k: _gather(v, idx) if isinstance(v, dict) else v.index_select(1, idx)
            for k, v in tree.items()}


class Engine:
    def __init__(self, cfg: ModelConfig, params, *, max_new: int = 32):
        self.cfg = cfg
        self.params = params
        self.max_new = max_new
        self.device = params["tok"]["embed"].device
        self.stats = {"prefill_calls": 0, "decode_steps": 0,
                      "tokens_out": 0}

    # -- stepwise API (continuous batching) ---------------------------------

    @torch.inference_mode()
    def prefill_batch(self, tokens: np.ndarray, *,
                      reserve: Optional[int] = None,
                      frames: Optional[np.ndarray] = None) -> tuple:
        """Prefill one equal-length micro-batch and reserve cache room for
        generation. tokens (B, S) -> ((B,) first generated tokens, GenState
        positioned for decode). An enc-dec model's encoder reads ``frames``
        (B, S_enc, D); without them it reads zeros of the prompt's length,
        as the JAX engine does."""
        B, S = tokens.shape
        reserve = reserve if reserve is not None else S + self.max_new
        with obs.layer("engine.prefill", rows=B, length=S):
            batch = {"tokens": torch.as_tensor(np.asarray(tokens, np.int64),
                                               device=self.device)}
            if self.cfg.is_encdec:
                if frames is None:
                    frames = np.zeros((B, S, self.cfg.d_model), np.float32)
                batch["frames"] = torch.as_tensor(frames, device=self.device)
            logits, cache = api.prefill(self.params, self.cfg, batch,
                                        reserve=reserve)
            self.stats["prefill_calls"] += 1
            first = logits.argmax(-1)
            state = GenState(cache=cache, cur=first[:, None], pos=S,
                             reserve=reserve, padded_b=B)
            self.stats["tokens_out"] += int(B)
            return first.cpu().numpy().astype(np.int32), state

    @torch.inference_mode()
    def decode_batch(self, state: GenState) -> np.ndarray:
        """One decode step for every row of the group; returns the (B,)
        next tokens and advances the state."""
        if state.pos >= state.reserve:
            raise ValueError(
                f"decode past reserved cache length {state.reserve}")
        with obs.layer("engine.decode", rows=state.padded_b, pos=state.pos):
            logits, state.cache = api.decode_step(
                self.params, self.cfg, state.cache, state.cur, state.pos)
            nxt = logits.argmax(-1)
            state.cur = nxt[:, None]
            state.pos += 1
            self.stats["decode_steps"] += 1
            self.stats["tokens_out"] += int(state.padded_b)
            return nxt.cpu().numpy().astype(np.int32)

    def gather_rows(self, state: GenState, rows: Sequence[int]) -> GenState:
        """Slot reuse: re-pack the group's state down to ``rows`` (engine
        batch indices). Every cache leaf is (layers, batch, ...), so the
        gather is along axis 1, over the whole nested tree."""
        with obs.layer("engine.gather", rows=len(rows)):
            idx = torch.as_tensor(list(rows), dtype=torch.long,
                                  device=self.device)
            cache = _gather(state.cache, idx)
            return GenState(cache=cache, cur=state.cur[idx], pos=state.pos,
                            reserve=state.reserve, padded_b=len(rows))

    # -- run-to-completion API ----------------------------------------------

    def generate(self, tokens: np.ndarray, *, max_new: Optional[int] = None,
                 frames: Optional[np.ndarray] = None) -> np.ndarray:
        """tokens (B, S) equal-length prompts -> (B, S + max_new); ``frames``
        as in ``prefill_batch``."""
        max_new = max_new or self.max_new
        S = tokens.shape[1]
        first, state = self.prefill_batch(tokens, reserve=S + max_new,
                                          frames=frames)
        out = [first]
        for _ in range(max_new - 1):
            out.append(self.decode_batch(state))
        return np.concatenate([tokens, np.stack(out, axis=1)], axis=1)
