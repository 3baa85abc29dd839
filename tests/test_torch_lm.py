"""The port's language-model path against ``repro.models.api`` on reduced
internlm2 (GQA), qwen3 (qk-norm) and granite (MQA, KVH=1), with the JAX
package's parameters carried across through numpy.

In f32 both packages compute the same function, so logits and caches agree
to rtol = atol = 1e-4 (sums are taken in other orders). The JAX side runs
with ``attn_impl="kernel"``, i.e. its Pallas flash attention in interpret
mode, as the port's prefill runs through ``ops.attention``.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import api as jax_api
from repro_torch.configs.base import get_config
from repro_torch.models import api, convert

ARCHS = ["internlm2-1.8b", "qwen3-8b", "granite-20b"]
B, S, DECODE = 2, 64, 3
TOL = 1e-4


def _configs(arch, dtype="float32", attn_impl="kernel"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype, attn_impl=attn_impl)
    return (jax_get_config(arch, reduced=True).replace(**kw),
            get_config(arch, reduced=True).replace(**kw))


def _tokens(cfg, seq, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(B, seq), dtype=np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(jax cfg, jax params, port cfg, port params) in f32."""
    jcfg, cfg = _configs(request.param)
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          cfg, "cpu")
    return jcfg, jparams, cfg, params


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_forward_matches_jax(model):
    jcfg, jparams, cfg, params = model
    tokens = _tokens(cfg, S)
    want, _ = jax_api.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    got, aux = api.forward(params, cfg, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (B, S, cfg.vocab_size) and got.dtype == torch.float32
    assert float(aux) == 0.0
    _close(got, want)


def test_chunked_plain_forward_matches_jax(model):
    """attn_impl="ref": two 64-position chunks through mha_reference's
    online softmax, against the JAX package's chunked reference."""
    jcfg, jparams, cfg, params = model
    tokens = _tokens(cfg, 2 * S, seed=2)
    want, _ = jax_api.forward(jparams, jcfg.replace(attn_impl="ref"),
                              {"tokens": jnp.asarray(tokens)})
    got, _ = api.forward(params, cfg.replace(attn_impl="ref"),
                         {"tokens": torch.from_numpy(tokens)})
    _close(got, want)


def test_prefill_matches_jax(model):
    jcfg, jparams, cfg, params = model
    tokens = _tokens(cfg, S)
    want, jcache = jax_api.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    got, cache = api.prefill(params, cfg, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (B, cfg.vocab_size)
    _close(got, want)
    shape = (cfg.num_layers, B, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == shape == jcache[name].shape
        _close(cache[name], jcache[name])
    # a reserve leaves the first S positions as they are and zeros after
    _, wide = api.prefill(params, cfg, {"tokens": torch.from_numpy(tokens)},
                          reserve=S + 5)
    grown = api.grow_cache(cfg, cache, S + 5)
    for name in ("k", "v"):
        assert torch.equal(wide[name], grown[name])
        assert not wide[name][:, :, S:].any()


def test_decode_matches_forward(model):
    """Prefill S tokens, then decode DECODE more one at a time: each step's
    logits equal the full forward's at that position (the counterpart of
    tests/test_models.py::test_incremental_decode_matches_forward)."""
    _, _, cfg, params = model
    tokens = torch.from_numpy(_tokens(cfg, S + DECODE, seed=3))
    full, _ = api.forward(params, cfg, {"tokens": tokens})
    logits, cache = api.prefill(params, cfg, {"tokens": tokens[:, :S]},
                                reserve=S + DECODE)
    torch.testing.assert_close(logits, full[:, S - 1], rtol=TOL, atol=TOL)
    for i in range(DECODE):
        logits, cache = api.decode_step(params, cfg, cache,
                                        tokens[:, S + i:S + i + 1], S + i)
        torch.testing.assert_close(logits, full[:, S + i], rtol=TOL, atol=TOL)


def test_decode_step_matches_jax(model):
    jcfg, jparams, cfg, params = model
    tokens = _tokens(cfg, S + 1, seed=4)
    _, jcache = jax_api.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens[:, :S])})
    jcache = jax_api.grow_cache(jcfg, jcache, S + 1)
    want, jcache = jax_api.decode_step(jparams, jcfg, jcache,
                                       jnp.asarray(tokens[:, S:]),
                                       jnp.asarray(S, jnp.int32))
    _, cache = api.prefill(params, cfg, {"tokens": torch.from_numpy(tokens[:, :S])},
                           reserve=S + 1)
    got, cache = api.decode_step(params, cfg, cache,
                                 torch.from_numpy(tokens[:, S:]), S)
    _close(got, want)
    for name in ("k", "v"):
        _close(cache[name], jcache[name])


def test_bf16_forward_matches_jax():
    """bf16 parameters and compute on internlm2. Both packages round to bf16
    at the same points (after every matmul, after the f32 norms and rope,
    after attention and on each residual add), but the matmuls sum in other
    orders and silu rounds differently, so a value may land one bf16 ulp
    (2**-7 relative at most) away at any of those points, and the
    differences add up through 4 layers. The logits are at most about 4 in
    magnitude, where one ulp is 2**-6; the tolerance is 2**-4 absolute plus
    2**-4 relative (four ulps at magnitude 4 and more below), and the mean
    error is held under one ulp at magnitude 1 (2**-7). Measured on this
    seed: max 0.035, mean 0.0061."""
    jcfg, cfg = _configs("internlm2-1.8b", "bfloat16")
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          cfg, "cpu")
    tokens = _tokens(cfg, S, seed=5)
    want, _ = jax_api.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    got, _ = api.forward(params, cfg, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want)
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=2.0 ** -4, atol=2.0 ** -4)
    assert err.mean() < 2.0 ** -7, err.mean()


def test_bf16_numpy_conversion_is_exact():
    rng = np.random.default_rng(0)
    bits = rng.integers(-2 ** 15, 2 ** 15, size=(4, 257), dtype=np.int64)
    a = bits.astype(np.int16).view(ml_dtypes.bfloat16)
    a[0, :4] = [np.inf, -np.inf, 0.0, -0.0]
    t = convert.tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


def test_lm_params_from_numpy_checks_the_layout():
    jcfg, cfg = _configs("qwen3-8b")
    tree = jax.tree.map(np.asarray, jax_api.init_params(jcfg, jax.random.PRNGKey(0)))
    convert.lm_params_from_numpy(tree, cfg, "cpu")
    attn = tree["stack"]["uniform"]["attn"]
    bad = {**tree, "stack": {"uniform": {**tree["stack"]["uniform"],
                                         "attn": {k: v for k, v in attn.items()
                                                  if k != "q_norm"}}}}
    with pytest.raises(ValueError, match="names"):
        convert.lm_params_from_numpy(bad, cfg, "cpu")
    bad = {**tree, "final_norm": {"scale": tree["final_norm"]["scale"][:-1]}}
    with pytest.raises(ValueError, match="shape"):
        convert.lm_params_from_numpy(bad, cfg, "cpu")
    bad = {**tree, "final_norm": {"scale": tree["final_norm"]["scale"].astype(
        ml_dtypes.bfloat16)}}
    with pytest.raises(ValueError, match="dtype"):
        convert.lm_params_from_numpy(bad, cfg, "cpu")


def test_unported_layers_raise():
    """Every layer is ported: the gemma2 post-norms and local/global stack
    and M-RoPE, and expert-parallel MoE, which raised here until they were
    ported, build and run."""
    cfg = get_config("internlm2-1.8b", reduced=True).replace(
        param_dtype="float32", compute_dtype="float32")
    tokens = {"tokens": torch.from_numpy(_tokens(cfg, 8))}
    for kw in (dict(post_norm=True), dict(local_global_period=2),
               dict(mrope_sections=(4, 6, 6))):
        c = cfg.replace(**kw)
        logits, _ = api.forward(api.init_params(c, device="cpu"), c, tokens)
        assert bool(torch.isfinite(logits).all())
    # expert-parallel MoE is ported: with no mesh it falls back to the
    # dropping path, as the JAX package's moe_ep does
    moe = get_config("llama4-scout-17b-a16e", reduced=True).replace(
        param_dtype="float32", compute_dtype="float32")
    params = api.init_params(moe, device="cpu")
    want, _ = api.forward(params, moe, tokens)
    got, _ = api.forward(params, moe.replace(moe_impl="ep_a2a"), tokens)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,dtype,budget", [
    ((3, 4, 64, 32), torch.bfloat16, 64 * 32), ((300, 48), torch.float32, 960)])
def test_init_maker_draws_large_params_slice_by_slice(monkeypatch, shape,
                                                      dtype, budget):
    """A parameter larger than DRAW_ELEMS is drawn slice by slice (here
    slices of one (64, 32) matrix, and chunks of 20 rows of 48) and keeps
    the JAX package's distribution: a standard normal truncated to [-2, 2],
    times 1/sqrt(fan_in), whose standard deviation is 0.8796 of the scale;
    the slices are independent draws."""
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "DRAW_ELEMS", budget)
    mk = layers.InitMaker(torch.Generator().manual_seed(0), dtype, "cpu")
    t = mk.param(shape)
    assert t.shape == shape and t.dtype == dtype
    scale = 1.0 / np.sqrt(shape[-2])
    x = t.float() / scale
    assert float(x.abs().max()) <= 2.0 + 1e-2    # bf16 rounding of 2*scale
    assert abs(float(x.std()) / 0.8796 - 1.0) < 0.03
    assert abs(float(x.mean())) < 0.03
    slices = x.reshape(-1, budget)
    assert not torch.equal(slices[0], slices[1])
