"""The port's MoE language models against ``repro.models.api`` on reduced
llama4-scout (4 experts, top-1) and reduced kimi-k2 (8 experts, top-2) in
f32, with the JAX package's parameters carried across through numpy.

Both sides run ``moe_impl="gmm"``: the JAX package its Pallas grouped
matmul in interpret mode, the port the plain version of its kernel (the
tensors lie on the CPU). In f32 both compute the same function, so logits,
the summed load-balance loss and the KV cache agree to rtol = atol = 1e-4.
Greedy tokens are held identical (safe in f32, where the logits agree to
1e-4).

Capacity-based routing depends on the sequence: in a full forward tokens
compete for an expert's slots, while a decoded token is routed alone. So
the port's decode is held to its own forward at ``capacity_factor=8.0``,
where nothing is dropped (tests/test_models.py::
test_incremental_decode_matches_forward does the same).
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

ARCHS = ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b"]
B, S, DECODE = 2, 32, 3
TOL = 1e-4
KW = dict(param_dtype="float32", compute_dtype="float32", moe_impl="gmm")


def _leaves(tree, path=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", v


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _close_tree(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for path in got:
        assert tuple(got[path].shape) == tuple(want[path].shape), path
        _close(got[path], want[path])


def _tokens(cfg, seq, seed, batch=B):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(batch, seq), dtype=np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(jax cfg, jax params, port cfg, port params) in f32."""
    jcfg = jax_get_config(request.param, reduced=True).replace(**KW)
    cfg = get_config(request.param, reduced=True).replace(**KW)
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          cfg, "cpu")
    return jcfg, jparams, cfg, params


def test_layout_and_conversion(model):
    """``lm_params_from_numpy`` takes the MoE tree as it stands: the router
    and the stacked (layers, experts, ...) expert weights, bit for bit."""
    jcfg, jparams, cfg, params = model
    ffn = params["stack"]["uniform"]["ffn"]
    L, E, D, F = cfg.num_layers, cfg.num_experts, cfg.d_model, cfg.d_ff
    assert {k: tuple(v.shape) for k, v in ffn.items()} == {
        "router": (L, D, E), "wi_gate": (L, E, D, F), "wi_up": (L, E, D, F),
        "wo": (L, E, F, D)}
    for (path, a), (_, b) in zip(_leaves(params), _leaves(jparams)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=path)
    drawn = api.init_params(cfg, device="cpu")
    for (path, a), (_, b) in zip(_leaves(drawn), _leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype, path


def test_lm_params_from_numpy_checks_the_moe_tree(model):
    _, jparams, cfg, _ = model
    tree = jax.tree.map(np.asarray, jparams)
    uni = tree["stack"]["uniform"]
    ffn = uni["ffn"]
    bad = {**tree, "stack": {"uniform": {**uni, "ffn": {
        k: v for k, v in ffn.items() if k != "router"}}}}
    with pytest.raises(ValueError, match="names"):
        convert.lm_params_from_numpy(bad, cfg, "cpu")
    # one expert too few
    bad = {**tree, "stack": {"uniform": {**uni, "ffn": {
        **ffn, "wo": ffn["wo"][:, 1:]}}}}
    with pytest.raises(ValueError, match="shape"):
        convert.lm_params_from_numpy(bad, cfg, "cpu")


def test_forward_and_aux_match_jax(model):
    jcfg, jparams, cfg, params = model
    tokens = _tokens(cfg, S, seed=1)
    want, want_aux = jax_api.forward(jparams, jcfg,
                                     {"tokens": jnp.asarray(tokens)})
    got, aux = api.forward(params, cfg, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (B, S, cfg.vocab_size) and got.dtype == torch.float32
    assert aux.dtype == torch.float32 and aux.shape == ()
    # every layer adds its loss, which is E * sum f_e P_e >= 1 when balanced
    assert float(aux) > 0.5 * cfg.num_layers
    _close(got, want)
    _close(aux, want_aux)


def test_plain_paths_match_jax(model):
    """moe_impl="dropping" and attn_impl="ref" on both sides."""
    jcfg, jparams, cfg, params = model
    kw = dict(moe_impl="dropping", attn_impl="ref")
    tokens = _tokens(cfg, S, seed=2)
    want, want_aux = jax_api.forward(jparams, jcfg.replace(**kw),
                                     {"tokens": jnp.asarray(tokens)})
    got, aux = api.forward(params, cfg.replace(**kw),
                           {"tokens": torch.from_numpy(tokens)})
    _close(got, want)
    _close(aux, want_aux)


def test_prefill_matches_jax(model):
    jcfg, jparams, cfg, params = model
    tokens = _tokens(cfg, S, seed=3)
    want, jcache = jax_api.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    got, cache = api.prefill(params, cfg, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (B, cfg.vocab_size)
    _close(got, want)
    _close_tree(cache, jcache)


def test_decode_steps_match_jax(model):
    """Prefill S tokens, then DECODE steps (one token each, capacity 1 per
    expert): logits and the whole cache after each step."""
    jcfg, jparams, cfg, params = model
    tokens = _tokens(cfg, S + DECODE, seed=4)
    _, jcache = jax_api.prefill(jparams, jcfg,
                                {"tokens": jnp.asarray(tokens[:, :S])})
    jcache = jax_api.grow_cache(jcfg, jcache, S + DECODE)
    _, cache = api.prefill(params, cfg,
                           {"tokens": torch.from_numpy(tokens[:, :S])},
                           reserve=S + DECODE)
    for i in range(DECODE):
        step = tokens[:, S + i:S + i + 1]
        want, jcache = jax_api.decode_step(jparams, jcfg, jcache,
                                           jnp.asarray(step),
                                           jnp.asarray(S + i, jnp.int32))
        got, cache = api.decode_step(params, cfg, cache,
                                     torch.from_numpy(step), S + i)
        _close(got, want)
        _close_tree(cache, jcache)


def test_decode_matches_forward_without_drops(model):
    _, _, cfg, params = model
    cfg = cfg.replace(capacity_factor=8.0)
    tokens = torch.from_numpy(_tokens(cfg, S + 1, seed=5))
    full, _ = api.forward(params, cfg, {"tokens": tokens})
    last, cache = api.prefill(params, cfg, {"tokens": tokens[:, :S]},
                              reserve=S + 1)
    torch.testing.assert_close(last, full[:, S - 1], rtol=TOL, atol=TOL)
    step, _ = api.decode_step(params, cfg, cache, tokens[:, S:], S)
    torch.testing.assert_close(step, full[:, S], rtol=TOL, atol=TOL)


def test_generate_matches_jax_engine(model):
    jcfg, jparams, cfg, params = model
    prompts = _tokens(cfg, S, seed=6)
    want = JaxEngine(jcfg, jparams, max_new=5).generate(prompts)
    got = Engine(cfg, params, max_new=5).generate(prompts)
    assert got.shape == want.shape == (B, S + 5)
    np.testing.assert_array_equal(got, want)


def test_gather_rows_matches_jax_engine(model):
    """Slot reuse: rows [2, 0] of a 3-row group are gathered after one
    decode step and decoded on. Capacity is per batch row, so dropping a
    row changes no other row's routing: the tokens equal the JAX engine's
    after the same gather, and the cache equals that of a group that held
    only those rows from the start."""
    jcfg, jparams, cfg, params = model
    prompts = _tokens(cfg, S, seed=7, batch=3)
    rows = [2, 0]
    out = {}
    for name, eng in (("jax", JaxEngine(jcfg, jparams, max_new=4)),
                      ("port", Engine(cfg, params, max_new=4))):
        first, state = eng.prefill_batch(prompts, reserve=S + 4)
        toks = [first, eng.decode_batch(state)]
        state = eng.gather_rows(state, rows)
        toks += [eng.decode_batch(state), eng.decode_batch(state)]
        out[name] = (toks, state)
    for a, b in zip(out["port"][0], out["jax"][0]):
        np.testing.assert_array_equal(a, b)
    engine = Engine(cfg, params, max_new=4)
    _, alone = engine.prefill_batch(prompts[rows], reserve=S + 4)
    for _ in range(3):
        engine.decode_batch(alone)
    state = out["port"][1]
    assert state.padded_b == 2 and state.pos == alone.pos == S + 3
    for (path, a), (_, b) in zip(_leaves(state.cache), _leaves(alone.cache)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=path)
