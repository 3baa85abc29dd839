"""Operation counts of the models, from their shapes, for the ``mfu.*``
readers. A multiply-add is two operations.

MPNN: the message step counts 2 Hd^2 per member for each atom pair the
adjacency holds (the work the model's equations need, not what a dense
kernel does); the GRU 12 Hd^2 per member for each real atom, each step; the
readout 2 Hd R + 2 R per member and molecule. The one-hot edge build is a
lookup and counts nothing.

Language model (dense, GQA, SwiGLU): per token and layer the four
projections and the three MLP matrices, 2 (d H hd + 2 d KVH hd + H hd d +
3 d F); attention 4 H hd per (query, key) pair it attends (the causal
triangle in prefill, the valid cache in decode); the output head 2 d V for
each position whose logits are computed (the last in prefill, each row in
decode). Counted over the requests' own tokens: the rows that pad a batch
to its bucket, the left padding of a prompt to its bucket and the rows of
a group that have finished are left out, so that a program that stops
computing them reads against the same count.
"""
from __future__ import annotations

import numpy as np


def mpnn_forward_flops(config: dict, atoms_mask: np.ndarray,
                       pairs: np.ndarray) -> float:
    """Forward operations of every member over molecules with
    ``atoms_mask`` (..., N) and adjacency pair counts ``pairs``; a leading
    member axis on both means one sample per member, else every member
    scores every molecule."""
    hd, r, T = config["hidden"], config["readout_hidden"], \
        config["message_steps"]
    E = config["ensemble"]
    members = 1 if atoms_mask.ndim == 3 else E
    atoms = float(np.sum(atoms_mask)) * members
    n_pairs = float(np.sum(pairs)) * members
    molecules = float(np.prod(atoms_mask.shape[:-1])) * members
    return (T * (2 * hd * hd * n_pairs + 12 * hd * hd * atoms)
            + molecules * (2 * hd * r + 2 * r))


def adjacency_pairs(bonds: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Pairs (i, j) with a bond between two real atoms, per molecule."""
    m = np.asarray(mask) > 0
    return ((np.asarray(bonds) > 0) & m[..., :, None]
            & m[..., None, :]).sum(axis=(-2, -1))


def lm_dims(config: dict) -> dict:
    d, H = config["d_model"], config["num_heads"]
    hd = config["head_dim"] or d // H
    return {"d": d, "H": H, "KVH": config["num_kv_heads"], "hd": hd,
            "F": config["d_ff"], "V": config["vocab_size"],
            "L": config["num_layers"]}


def lm_matmul_flops_per_token(config: dict) -> float:
    c = lm_dims(config)
    d, H, KVH, hd, F = c["d"], c["H"], c["KVH"], c["hd"], c["F"]
    return 2.0 * c["L"] * (d * H * hd + 2 * d * KVH * hd + H * hd * d
                           + 3 * d * F)


def prefill_attention_flops(config: dict, lengths) -> float:
    """Causal attention over all layers of one prefill call whose rows
    hold prompts of ``lengths`` tokens."""
    c = lm_dims(config)
    pairs = sum(n * (n + 1) / 2 for n in lengths)
    return 4.0 * c["L"] * c["H"] * c["hd"] * pairs


def lm_call_flops(config: dict, kind: str, lengths) -> float:
    """One engine call over the rows of ``lengths``: ``prefill`` of
    prompts of those lengths, or ``decode`` of one token a row with that
    many of the row's positions already in the cache."""
    c = lm_dims(config)
    head = 2.0 * c["d"] * c["V"] * len(lengths)
    if kind == "prefill":
        return (sum(lengths) * lm_matmul_flops_per_token(config)
                + prefill_attention_flops(config, lengths) + head)
    return (len(lengths) * lm_matmul_flops_per_token(config)
            + 4.0 * c["L"] * c["H"] * c["hd"] * sum(n + 1 for n in lengths)
            + head)
