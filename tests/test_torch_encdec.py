"""The port's enc-dec stack (seamless-m4t-medium) against
``repro.models.api`` on the reduced config in f32 (2 encoder and 2 decoder
layers, cross-attention in every decoder layer), with the JAX package's
parameters carried across through numpy.

The encoder reads random frames (never zeros: zero frames give a zero
encoder output and zero cross K/V, which would hide a broken
cross-attention) of a length S_ENC other than the prompt's S, so the
cross-attention runs with Sq != Sk: through the flash path in prefill and the
plain path in decode, in both packages. In f32 logits, loss and caches agree
to rtol = atol = 1e-5 and greedy tokens are identical. The JAX side runs
``attn_impl="kernel"``, its Pallas flash attention in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import api as jax_api
from repro.serving.engine import Engine as JaxEngine
from repro_torch.configs.base import get_config
from repro_torch.models import api, convert
from repro_torch.serving.engine import Engine

ARCH = "seamless-m4t-medium"
B, S, S_ENC, NEW = 2, 128, 96, 8
TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, port cfg, port params) in f32."""
    kw = dict(param_dtype="float32", compute_dtype="float32",
              attn_impl="kernel")
    jcfg = jax_get_config(ARCH, reduced=True).replace(**kw)
    cfg = get_config(ARCH, reduced=True).replace(**kw)
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          cfg, "cpu")
    return jcfg, jparams, cfg, params


def _inputs(cfg, seed, seq=S, s_enc=S_ENC):
    """Tokens (B, seq) and random frames (B, s_enc, D)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, size=(B, seq), dtype=np.int32),
            rng.standard_normal((B, s_enc, cfg.d_model)).astype(np.float32))


def _batches(tokens, frames):
    return ({"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(tokens),
             "frames": torch.from_numpy(frames)})


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_layout(model):
    _, _, cfg, params = model
    st = params["stack"]
    assert set(st) == {"encoder", "enc_norm", "decoder"}
    assert st["encoder"]["attn"]["wq"].shape[0] == cfg.encoder_layers
    assert st["decoder"]["cross"]["wk"].shape[0] == cfg.num_layers
    assert {"ln_cross", "cross"} <= set(st["decoder"])
    assert "cross" not in st["encoder"]


def test_forward_matches_jax(model):
    jcfg, jparams, cfg, params = model
    jb, tb = _batches(*_inputs(cfg, 1))
    want, _ = jax_api.forward(jparams, jcfg, jb)
    got, aux = api.forward(params, cfg, tb)
    assert got.shape == (B, S, cfg.vocab_size) and float(aux) == 0.0
    _close(got, want)
    # the frames reach the logits: zeros move them by far more than TOL
    zeros = {**tb, "frames": torch.zeros_like(tb["frames"])}
    assert float((api.forward(params, cfg, zeros)[0] - got).abs().max()) > 1e-2


def test_loss_fn_matches_jax(model):
    jcfg, jparams, cfg, params = model
    tokens, frames = _inputs(cfg, 2, seq=S + 1)
    jb, tb = _batches(tokens[:, :-1], frames)
    jb["labels"], tb["labels"] = (jnp.asarray(tokens[:, 1:]),
                                  torch.from_numpy(tokens[:, 1:]))
    want, wm = jax_api.loss_fn(jparams, jcfg, jb)
    got, gm = api.loss_fn(params, cfg, tb)
    _close(got, want)
    assert float(gm["tokens"]) == float(wm["tokens"]) == B * S


def test_prefill_matches_jax(model):
    """Logits, the decoder's self K/V and the cross K/V of every decoder
    layer (L, B, S_ENC, KVH, hd)."""
    jcfg, jparams, cfg, params = model
    jb, tb = _batches(*_inputs(cfg, 3))
    want, jcache = jax_api.prefill(jparams, jcfg, jb)
    got, cache = api.prefill(params, cfg, tb)
    _close(got, want)
    kv = (cfg.num_kv_heads, cfg.resolved_head_dim)
    for part, seq in (("self", S), ("cross", S_ENC)):
        for name in ("k", "v"):
            a, b = cache[part][name], jcache[part][name]
            assert tuple(a.shape) == b.shape == (cfg.num_layers, B, seq, *kv)
            _close(a, b)


def test_decode_steps_match_jax(model):
    """NEW decode steps of the same tokens on both sides after prefill; the
    cross K/V pass through decode and ``grow_cache`` unchanged."""
    jcfg, jparams, cfg, params = model
    tokens, frames = _inputs(cfg, 4, seq=S + NEW)
    jb, tb = _batches(tokens[:, :S], frames)
    _, jcache = jax_api.prefill(jparams, jcfg, jb)
    jcache = jax_api.grow_cache(jcfg, jcache, S + NEW)
    _, cache = api.prefill(params, cfg, tb, reserve=S + NEW)
    cross = {k: v.clone() for k, v in cache["cross"].items()}
    assert api.grow_cache(cfg, cache, S + NEW + 4)["cross"] is cache["cross"]
    for i in range(NEW):
        step = tokens[:, S + i:S + i + 1]
        want, jcache = jax_api.decode_step(jparams, jcfg, jcache,
                                           jnp.asarray(step),
                                           jnp.asarray(S + i, jnp.int32))
        got, cache = api.decode_step(params, cfg, cache,
                                     torch.from_numpy(step), S + i)
        _close(got, want)
    for name in ("k", "v"):
        _close(cache["self"][name], jcache["self"][name])
        assert torch.equal(cache["cross"][name], cross[name])


def test_generate_matches_jax_engine(model):
    """Greedy tokens with random frames, and with the engines' default
    frames (zeros of the prompt's length, in both packages)."""
    jcfg, jparams, cfg, params = model
    prompts, frames = _inputs(cfg, 5)
    jax_engine = JaxEngine(jcfg, jparams, max_new=NEW)
    engine = Engine(cfg, params, max_new=NEW)
    want = jax_engine.generate(prompts, frames=frames)
    got = engine.generate(prompts, frames=frames)
    assert got.shape == (B, S + NEW)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(engine.generate(prompts),
                                  jax_engine.generate(prompts))


def test_gather_rows_over_self_and_cross(model):
    jcfg, jparams, cfg, params = model
    prompts, frames = _inputs(cfg, 6)
    prompts = np.concatenate([prompts, prompts[::-1]])
    frames = np.concatenate([frames, frames[:, ::-1]])
    jax_engine = JaxEngine(jcfg, jparams, max_new=NEW)
    engine = Engine(cfg, params, max_new=NEW)
    jfirst, jstate = jax_engine.prefill_batch(prompts, reserve=S + 3,
                                              frames=frames)
    first, state = engine.prefill_batch(prompts, reserve=S + 3, frames=frames)
    np.testing.assert_array_equal(first, jfirst)
    rows = [3, 0]
    jstate = jax_engine.gather_rows(jstate, rows)
    state = engine.gather_rows(state, rows)
    for part in ("self", "cross"):
        assert tuple(state.cache[part]["k"].shape) == jstate.cache[part]["k"].shape
    for _ in range(2):
        np.testing.assert_array_equal(engine.decode_batch(state),
                                      jax_engine.decode_batch(jstate))


def test_init_cache_matches_jax(model):
    jcfg, _, cfg, _ = model
    want = jax_api.init_cache(jcfg, B, S, enc_len=S_ENC)
    got = api.init_cache(cfg, B, S, enc_len=S_ENC, device="cpu")
    for part in ("self", "cross"):
        for name in ("k", "v"):
            assert tuple(got[part][name].shape) == want[part][name].shape
            assert not got[part][name].any()


def test_lm_params_from_numpy_checks_the_encdec_tree(model):
    jcfg, jparams, cfg, _ = model
    tree = jax.tree.map(np.asarray, jparams)
    convert.lm_params_from_numpy(tree, cfg, "cpu")
    dec = tree["stack"]["decoder"]
    bad = {**tree, "stack": {**tree["stack"], "decoder": {
        k: v for k, v in dec.items() if k != "cross"}}}
    with pytest.raises(ValueError, match="names"):
        convert.lm_params_from_numpy(bad, cfg, "cpu")
    bad = {**tree, "stack": {**tree["stack"], "enc_norm": {
        "scale": tree["stack"]["enc_norm"]["scale"][:-1]}}}
    with pytest.raises(ValueError, match="shape"):
        convert.lm_params_from_numpy(bad, cfg, "cpu")
