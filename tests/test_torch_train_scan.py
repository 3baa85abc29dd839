"""Three train steps of the port against the JAX package's on reduced
zamba2 (Mamba2 groups with the shared attention block) and rwkv6, in f32
with 1 and 2 microbatches, over a sequence of two scan chunks (128
positions); and their gradients under remat, which wraps each zamba2 group
(each Mamba2 block inside it too) and each RWKV block. The holds and
tolerances are those of ``tests/test_torch_train.py``."""
import pytest

from test_torch_train import (hold_remat, hold_train_steps,  # noqa: F401
                              one_torch_thread)

ARCHS = ["zamba2-1.2b", "rwkv6-3b"]
SEQ = 128


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch, microbatches):
    hold_train_steps(arch, microbatches, seq=SEQ)


@pytest.mark.parametrize("remat", ["block", "policy"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_grads_equal(arch, remat):
    hold_remat(arch, remat, seq=SEQ)
