"""Three train steps of the port against the JAX package's on reduced
llama4-scout (top-1 of 4 experts) and kimi-k2 (top-2 of 8), in f32 with
1 and 2 microbatches: the loss adds router_aux_coef times the summed
load-balance loss, whose gradient reaches the routers. The holds and
tolerances are those of ``tests/test_torch_train.py``."""
import pytest

from test_torch_train import hold_train_steps, one_torch_thread  # noqa: F401


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b"])
def test_train_steps_match_jax(arch, microbatches):
    hold_train_steps(arch, microbatches, seq=32)
