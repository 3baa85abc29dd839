"""The port's RWKV6 path against the JAX package's on reduced rwkv6 in f32
(3 layers, d_model 128, 4 heads of 32), with the JAX package's parameters
carried across through numpy.

The JAX initializer zeroes the five time-mix lerp coefficients ``mu_*``,
the channel-mix ``mu_k``, the decay bias ``w0`` and the bonus ``u``, and
sets ``ln_x`` to ones; on those weights a wrong token shift or a wrong
bonus term would go unseen. So every test here overwrites those leaves
with the same numpy draws on both sides before comparing.

Prompts are 128 tokens, so the WKV scan runs two chunks of 64 and carries
the state between them. The JAX side runs with ``attn_impl="kernel"``: its
Pallas WKV scan in interpret mode; the port's prefill takes the plain
version of its kernel on the CPU. In f32 both packages compute the same
function, so logits and states agree to rtol = atol = 1e-4 (sums are taken
in other orders). Greedy tokens are held identical (safe in f32, where the
logits agree to 1e-4).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import api as jax_api
from repro.serving.engine import Engine as JaxEngine
from repro_torch.configs.base import get_config
from repro_torch.models import api, convert
from repro_torch.serving.engine import Engine

ROOT = Path(__file__).resolve().parents[1]
ARCH = "rwkv6-3b"
B, S, DECODE = 2, 128, 3
TOL = 1e-4


def _leaves(tree, path=""):
    """(path, leaf) pairs of a nested dict, in a fixed order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", v


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _close_tree(got, want, tol=TOL):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for path in got:
        assert tuple(got[path].shape) == tuple(want[path].shape), path
        _close(got[path], want[path], tol)


def _tokens(cfg, seq, seed, batch=B):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(batch, seq), dtype=np.int32)


def randomise_zero_init_leaves(tree, seed=0):
    """Overwrite, in place, the leaves the JAX initializer sets to zeros or
    ones with numpy draws: lerp coefficients in [0, 1), the decay bias and
    the bonus from normals, ``ln_x`` around 1."""
    rng = np.random.default_rng(seed)
    tm, cm = tree["stack"]["rwkv"]["tmix"], tree["stack"]["rwkv"]["cmix"]
    for leaves, name in [(tm, n) for n in ("mu_r", "mu_k", "mu_v", "mu_g",
                                           "mu_w")] + [(cm, "mu_k")]:
        leaves[name] = rng.uniform(0.0, 1.0, leaves[name].shape).astype(np.float32)
    tm["w0"] = rng.normal(0.0, 1.0, tm["w0"].shape).astype(np.float32)
    tm["u"] = rng.normal(0.0, 0.5, tm["u"].shape).astype(np.float32)
    tm["ln_x"] = rng.uniform(0.5, 1.5, tm["ln_x"].shape).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, port cfg, port params) in f32, the zero-init
    leaves randomised on both sides alike."""
    kw = dict(param_dtype="float32", compute_dtype="float32",
              attn_impl="kernel")
    jcfg = jax_get_config(ARCH, reduced=True).replace(**kw)
    cfg = get_config(ARCH, reduced=True).replace(**kw)
    tree = randomise_zero_init_leaves(
        jax.tree.map(np.asarray, jax_api.init_params(jcfg, jax.random.PRNGKey(0))))
    jparams = jax.tree.map(jnp.asarray, tree)
    params = convert.lm_params_from_numpy(tree, cfg, "cpu")
    return jcfg, jparams, cfg, params


def test_layout(model):
    _, _, cfg, params = model
    stack = params["stack"]
    assert set(stack) == {"rwkv"}
    assert set(stack["rwkv"]) == {"ln1", "tmix", "ln2", "cmix"}
    assert tuple(stack["rwkv"]["tmix"]["u"].shape) == (3, 4, 32)
    assert tuple(stack["rwkv"]["tmix"]["w_lora_a"].shape) == (3, 128, 64)
    assert tuple(stack["rwkv"]["cmix"]["wk"].shape) == (3, 128, 256)
    cache = api.init_cache(cfg, B, S, device="cpu")
    assert set(cache) == {"tm_shift", "cm_shift", "state"}
    assert tuple(cache["tm_shift"].shape) == (3, B, 1, 128)
    assert tuple(cache["cm_shift"].shape) == (3, B, 1, 128)
    assert tuple(cache["state"].shape) == (3, B, 4, 32, 32)
    assert cache["state"].dtype == torch.float32


def test_forward_matches_jax(model):
    jcfg, jparams, cfg, params = model
    tokens = _tokens(cfg, S, seed=1)
    want, _ = jax_api.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    got, aux = api.forward(params, cfg, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (B, S, cfg.vocab_size) and got.dtype == torch.float32
    assert float(aux) == 0.0
    _close(got, want)


def test_plain_forward_matches_jax(model):
    """attn_impl="ref" on both sides: the chunked plain scan."""
    jcfg, jparams, cfg, params = model
    tokens = _tokens(cfg, S, seed=2)
    want, _ = jax_api.forward(jparams, jcfg.replace(attn_impl="ref"),
                              {"tokens": jnp.asarray(tokens)})
    got, _ = api.forward(params, cfg.replace(attn_impl="ref"),
                         {"tokens": torch.from_numpy(tokens)})
    _close(got, want)


def test_randomised_leaves_reach_the_output(model):
    """The leaves the JAX initializer zeroes change the logits once drawn:
    the parity tests above do exercise the token shift, the decay bias and
    the bonus."""
    _, _, cfg, params = model
    tokens = torch.from_numpy(_tokens(cfg, 64, seed=8))
    base, _ = api.forward(params, cfg, {"tokens": tokens})
    for sub, name in (("tmix", "mu_k"), ("tmix", "w0"), ("tmix", "u"),
                      ("cmix", "mu_k")):
        leaf = params["stack"]["rwkv"][sub][name]
        saved = leaf.clone()
        leaf.zero_()
        try:
            other, _ = api.forward(params, cfg, {"tokens": tokens})
        finally:
            leaf.copy_(saved)
        assert (other - base).abs().max() > 1e-2, (sub, name)


def test_prefill_matches_jax(model):
    """Logits and every state: the time-mix and channel-mix token shifts
    and the WKV state of each layer; a reserve changes nothing, and
    grow_cache passes the cache through."""
    jcfg, jparams, cfg, params = model
    tokens = _tokens(cfg, S, seed=3)
    want, jcache = jax_api.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    got, cache = api.prefill(params, cfg, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (B, cfg.vocab_size)
    _close(got, want)
    _close_tree(cache, jcache)
    assert cache["state"].dtype == torch.float32
    _, wide = api.prefill(params, cfg, {"tokens": torch.from_numpy(tokens)},
                          reserve=S + 5)
    grown = api.grow_cache(cfg, cache, S + 5)
    assert grown is cache
    for (path, a), (_, b) in zip(_leaves(wide), _leaves(cache)):
        assert torch.equal(a, b), path


def test_decode_steps_match_jax(model):
    """Prefill S tokens, then DECODE steps: logits and the whole cache after
    each step, against the JAX package's prefill, grow_cache and
    decode_step."""
    jcfg, jparams, cfg, params = model
    tokens = _tokens(cfg, S + DECODE, seed=4)
    _, jcache = jax_api.prefill(jparams, jcfg,
                                {"tokens": jnp.asarray(tokens[:, :S])})
    jcache = jax_api.grow_cache(jcfg, jcache, S + DECODE)
    _, cache = api.prefill(params, cfg, {"tokens": torch.from_numpy(tokens[:, :S])},
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


def test_one_token_prompt_takes_the_decode_step(model):
    """A 1-token prefill runs the decode step from zero states in both
    packages (the JAX block takes wkv6_step when L == 1 and a cache is
    given)."""
    jcfg, jparams, cfg, params = model
    tokens = _tokens(cfg, 1, seed=5)
    want, jcache = jax_api.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    got, cache = api.prefill(params, cfg, {"tokens": torch.from_numpy(tokens)})
    _close(got, want)
    _close_tree(cache, jcache)


def test_generate_matches_jax_engine(model):
    jcfg, jparams, cfg, params = model
    prompts = _tokens(cfg, S, seed=6)
    want = JaxEngine(jcfg, jparams, max_new=6).generate(prompts)
    got = Engine(cfg, params, max_new=6).generate(prompts)
    assert got.shape == want.shape == (B, S + 6)
    np.testing.assert_array_equal(got, want)


def test_gather_rows_equals_rerunning_the_kept_rows(model):
    """Slot reuse on the RWKV6 cache: gathering rows [3, 0] of a 4-row
    group and decoding on gives the tokens and the states of a group that
    held only those rows from the start."""
    _, _, cfg, params = model
    engine = Engine(cfg, params, max_new=4)
    prompts = _tokens(cfg, S, seed=7, batch=4)
    rows = [3, 0]
    _, state = engine.prefill_batch(prompts, reserve=S + 4)
    engine.decode_batch(state)
    state = engine.gather_rows(state, rows)
    _, alone = engine.prefill_batch(prompts[rows], reserve=S + 4)
    engine.decode_batch(alone)
    assert state.padded_b == 2 and state.pos == alone.pos == S + 1
    for (path, a), (_, b) in zip(_leaves(state.cache), _leaves(alone.cache)):
        assert a.shape == b.shape, path
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for _ in range(2):
        np.testing.assert_array_equal(engine.decode_batch(state),
                                      engine.decode_batch(alone))


def test_lm_params_from_numpy_checks_the_rwkv_tree(model):
    jcfg, jparams, cfg, _ = model
    tree = jax.tree.map(np.asarray, jparams)
    rwkv = tree["stack"]["rwkv"]
    tm = rwkv["tmix"]
    bad = {**tree, "stack": {"rwkv": {**rwkv, "tmix": {
        k: v for k, v in tm.items() if k != "u"}}}}
    with pytest.raises(ValueError, match="names"):
        convert.lm_params_from_numpy(bad, cfg, "cpu")
    # the bonus flattened to (layers, d_model) instead of (layers, H, K)
    flat = {**tm, "u": tm["u"].reshape(3, -1)}
    bad = {**tree, "stack": {"rwkv": {**rwkv, "tmix": flat}}}
    with pytest.raises(ValueError, match="shape"):
        convert.lm_params_from_numpy(bad, cfg, "cpu")
    cast = {**tm, "w0": tm["w0"].astype(ml_dtypes.bfloat16)}
    bad = {**tree, "stack": {"rwkv": {**rwkv, "tmix": cast}}}
    with pytest.raises(ValueError, match="dtype"):
        convert.lm_params_from_numpy(bad, cfg, "cpu")


def test_serve_cli_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--device", "cpu", "--batch", "2", "--prompt-len", "64",
         "--max-new", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300,
        check=True).stdout
    assert "round 2: in (2, 64) -> out (2, 68)" in out
    assert "steady-state throughput:" in out and "decode_steps=9" in out
