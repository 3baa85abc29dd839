"""The port frees its tensors by reference counting: serving a request and
taking a train step leave no tensor that only the cyclic collector can free.

A tensor held in a reference cycle (a recursive closure over a list of
leaves, a wrapper stored on the object whose method it wraps) stays on the
card until Python's collector happens to run, and counts in the peak of
whatever runs next. Each case runs with the collector off, drops what it
made, and then asks the collector what it would free."""
from __future__ import annotations

import gc

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShardingConfig, TrainConfig, get_config
from repro_torch.data.tokens import make_batch
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.serving.engine import Engine
from repro_torch.utils.trees import tree_flatten_with_paths, tree_leaves


def tensors_left_to_the_collector(fn) -> list:
    """Run fn with the cyclic collector off; return the tensors that a
    collection afterwards finds unreachable."""
    gc.collect()
    gc.disable()
    try:
        fn()
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        return [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()


@pytest.mark.parametrize("arch", ["gemma2-2b", "seamless-m4t-medium",
                                  "qwen2-vl-72b", "zamba2-1.2b"])
def test_serving_leaves_no_tensor_in_a_cycle(arch):
    cfg = get_config(arch, reduced=True)

    def serve():
        params = api.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        engine = Engine(cfg, params, max_new=3)
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, cfg.vocab_size, size=(2, 64), dtype=np.int32)
        frames = (rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
                  if cfg.is_encdec else None)
        engine.generate(tokens, frames=frames)
        _, state = engine.prefill_batch(tokens, frames=frames)
        engine.decode_batch(engine.gather_rows(state, [1]))

    assert tensors_left_to_the_collector(serve) == []


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_leaves_no_tensor_in_a_cycle(microbatches):
    cfg = get_config("internlm2-1.8b", reduced=True)

    def train():
        state = steps.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
        step = steps.make_train_step(
            cfg, TrainConfig(warmup_steps=0),
            ShardingConfig(microbatches=microbatches))
        for i in range(2):
            batch = make_batch(cfg, "train", 2, 32, step=i, seed=0)
            state, _ = step(state, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})

    assert tensors_left_to_the_collector(train) == []


def test_tree_flatten_leaves_no_cycle():
    tree = {"a": torch.zeros(2), "b": [torch.ones(1), {"c": torch.ones(3)}]}

    def flatten():
        assert len(tree_flatten_with_paths(tree)) == 3
        assert len(tree_leaves(tree)) == 3

    gc.collect()
    gc.disable()
    try:
        flatten()
        assert gc.collect() == 0
    finally:
        gc.enable()
