"""Training of the archs with their own layers against the JAX package's, in
f32: gemma2-2b (the local/global "lg" stack), seamless-m4t-medium (enc-dec,
the encoder reading ``frames``) and qwen2-vl-72b (``embeds`` and M-RoPE
(3, B, S) ``positions``). Three train steps of both packages at 1 and 2
microbatches, held by ``test_torch_train.hold_train_steps``, and remat
"block" against "none" bit for bit, gemma2's per-period remat body among
them.

Batches come from the family-aware ``data.tokens.make_batch``, as the
trainer draws them. Its M-RoPE positions are the same in every row and band;
here each (band, row) gets its own offset, so a microbatch split along the
wrong axis of ``positions`` gives other positions, not the same ones.
"""
import numpy as np
import pytest

from test_torch_train import (hold_remat, hold_train_steps,  # noqa: F401
                              one_torch_thread)
from repro_torch.data.tokens import make_batch

ARCHS = ["gemma2-2b", "seamless-m4t-medium", "qwen2-vl-72b"]
SEQ = 64     # past gemma2's reduced window of 32; one enc-dec chunk of 64


def family_batch(rng, cfg, seq, batch=4):
    out = make_batch(cfg, "train", batch, seq,
                     step=int(rng.integers(1 << 30)))
    if "positions" in out:
        offsets = rng.integers(0, 64, size=(3, batch, 1)).astype(np.int32)
        out["positions"] = out["positions"] + offsets
    return out


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch, microbatches):
    hold_train_steps(arch, microbatches, seq=SEQ, make=family_batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_block_grads_equal(arch):
    hold_remat(arch, "block", seq=SEQ, make=family_batch)


def test_family_batch_carries_each_arch_inputs():
    from repro_torch.configs.base import get_config
    rng = np.random.default_rng(0)
    keys = {arch: sorted(family_batch(rng, get_config(arch, reduced=True),
                                      SEQ)) for arch in ARCHS}
    assert keys == {"gemma2-2b": ["labels", "tokens"],
                    "seamless-m4t-medium": ["frames", "labels", "tokens"],
                    "qwen2-vl-72b": ["embeds", "labels", "positions"]}
    pos = family_batch(rng, get_config("qwen2-vl-72b", reduced=True),
                       SEQ)["positions"]
    assert pos.shape == (3, 4, SEQ)
    assert len({tuple(pos[b, r]) for b in range(3) for r in range(4)}) > 1
