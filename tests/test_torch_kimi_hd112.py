"""Reduced kimi-k2-1t-a32b at its published head dim, 112, against
``repro.models.api`` in f32. The reduced config draws hd 32; here both
packages take ``head_dim=112``, the width the flash binding zero-pads to the
kernel's 128.

``attn_impl="kernel"`` on both sides: the JAX package runs its Pallas flash
kernel in interpret mode (any head dim), the port the plain version of its
kernel (the tensors lie on the CPU). Logits, the summed load-balance loss
and the prefill's logits agree to rtol = atol = 1e-4, as in
tests/test_torch_moe_lm.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import api as jax_api
from repro_torch.configs.base import get_config
from repro_torch.models import api, convert

ARCH = "kimi-k2-1t-a32b"
B, S = 2, 64
TOL = 1e-4
KW = dict(param_dtype="float32", compute_dtype="float32", moe_impl="gmm",
          head_dim=112)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config(ARCH, reduced=True).replace(**KW)
    cfg = get_config(ARCH, reduced=True).replace(**KW)
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          cfg, "cpu")
    assert params["stack"]["uniform"]["attn"]["wq"].shape[-1] == 112
    return jcfg, jparams, cfg, params


def _tokens(cfg, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(B, S), dtype=np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("attn_impl", ["ref", "kernel"])
def test_forward_matches_jax_at_head_dim_112(model, attn_impl):
    jcfg, jparams, cfg, params = model
    tokens = _tokens(cfg, seed=1)
    want, want_aux = jax_api.forward(jparams, jcfg.replace(attn_impl=attn_impl),
                                     {"tokens": jnp.asarray(tokens)})
    got, aux = api.forward(params, cfg.replace(attn_impl=attn_impl),
                           {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (B, S, cfg.vocab_size)
    _close(got, want)
    _close(aux, want_aux)


def test_prefill_matches_jax_at_head_dim_112(model):
    jcfg, jparams, cfg, params = model
    kw = dict(attn_impl="kernel")
    tokens = _tokens(cfg, seed=2)
    want, jcache = jax_api.prefill(jparams, jcfg.replace(**kw),
                                   {"tokens": jnp.asarray(tokens)})
    got, cache = api.prefill(params, cfg.replace(**kw),
                             {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (B, cfg.vocab_size)
    _close(got, want)
    assert tuple(cache["k"].shape)[-1] == 112
    _close(cache["k"][:, :, :S], jcache["k"][:, :, :S])
