"""The port's qwen2-vl-72b backbone against ``repro.models.api`` on the
reduced config in f32 (4 layers, GQA 4/2, head dim 32, M-RoPE sections
(4, 6, 6)), with the JAX package's parameters carried across through numpy.

The prompt is fed as a Qwen2-VL prompt reaches the backbone: precomputed
embeddings (the stub vision frontend's patch embeddings, then text) and
(3, B, S) positions, temporal / height / width: a grid of image patches at
one temporal position, then text whose positions continue on all three
axes. These positions differ between the axes, so a wrong section split of
M-RoPE shows (identical positions make M-RoPE equal plain RoPE). In f32
logits, loss and caches agree to rtol = atol = 1e-5 and greedy tokens are
identical. The JAX side runs ``attn_impl="kernel"``, its Pallas flash
attention in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import api as jax_api
from repro.models import layers as jax_layers
from repro.serving.engine import Engine as JaxEngine
from repro_torch.configs.base import get_config
from repro_torch.models import api, convert, layers
from repro_torch.serving.engine import Engine

ARCH = "qwen2-vl-72b"
B, S, NEW = 2, 128, 8
GRID = (8, 10)     # image patches: rows x columns, then S - 80 text tokens
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


def vl_positions(batch, seq, grid=GRID):
    """(3, B, S) M-RoPE positions of an image-then-text prompt: patch (r, c)
    at (0, r, c); text token j at max(grid) + j on every axis."""
    rows, cols = grid
    n = rows * cols
    pos = np.zeros((3, seq), np.int32)
    pos[1, :n] = np.arange(n) // cols
    pos[2, :n] = np.arange(n) % cols
    pos[:, n:] = max(grid) + np.arange(seq - n)
    return np.broadcast_to(pos[:, None], (3, batch, seq)).copy()


def _inputs(cfg, seed, seq=S):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, seq, cfg.d_model)).astype(np.float32),
            vl_positions(B, seq))


def _batches(embeds, positions):
    return ({"embeds": jnp.asarray(embeds), "positions": jnp.asarray(positions)},
            {"embeds": torch.from_numpy(embeds),
             "positions": torch.from_numpy(positions)})


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_mrope_tables_match_jax_and_differ_from_rope(model):
    """cos/sin of the distinct 3-axis positions against the JAX package's;
    they differ from plain RoPE over the temporal axis, and equal it when
    the three axes agree."""
    _, _, cfg, _ = model
    pos = vl_positions(B, S)
    hd, theta, secs = cfg.resolved_head_dim, cfg.rope_theta, cfg.mrope_sections
    got = layers.rope_cos_sin(torch.from_numpy(pos), hd, theta, secs)
    want = jax_layers.rope_cos_sin(jnp.asarray(pos), hd, theta, secs)
    for g, w in zip(got, want):
        _close(g, w)
    # at theta 1e6 the height and width bands turn slowly: over rows and
    # columns 0..9 their sines move by up to 0.22
    plain = layers.rope_cos_sin(torch.from_numpy(pos[0]), hd, theta)
    assert float((got[1] - plain[1]).abs().max()) > 0.1
    same = torch.from_numpy(np.broadcast_to(pos[2], pos.shape).copy())
    for g, p in zip(layers.rope_cos_sin(same, hd, theta, secs),
                    layers.rope_cos_sin(same[0], hd, theta)):
        assert torch.equal(g, p)


def test_forward_matches_jax(model):
    jcfg, jparams, cfg, params = model
    jb, tb = _batches(*_inputs(cfg, 1))
    want, _ = jax_api.forward(jparams, jcfg, jb)
    got, _ = api.forward(params, cfg, tb)
    assert got.shape == (B, S, cfg.vocab_size)
    _close(got, want)
    # the section split reaches the logits: plain RoPE over the temporal
    # axis moves them by far more than TOL
    plain, _ = api.forward(params, cfg.replace(mrope_sections=None), tb)
    assert float((plain - got).abs().max()) > 1e-2


def test_tokens_forward_matches_jax(model):
    """Token input with the default positions (0..S-1 on every axis)."""
    jcfg, jparams, cfg, params = model
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S),
                                               dtype=np.int32)
    want, _ = jax_api.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    got, _ = api.forward(params, cfg, {"tokens": torch.from_numpy(tokens)})
    _close(got, want)


def test_loss_fn_matches_jax(model):
    jcfg, jparams, cfg, params = model
    jb, tb = _batches(*_inputs(cfg, 3))
    labels = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, S),
                                               dtype=np.int32)
    jb["labels"], tb["labels"] = jnp.asarray(labels), torch.from_numpy(labels)
    want, _ = jax_api.loss_fn(jparams, jcfg, jb)
    got, _ = api.loss_fn(params, cfg, tb)
    _close(got, want)


def test_prefill_matches_jax(model):
    jcfg, jparams, cfg, params = model
    jb, tb = _batches(*_inputs(cfg, 5))
    want, jcache = jax_api.prefill(jparams, jcfg, jb)
    got, cache = api.prefill(params, cfg, tb)
    _close(got, want)
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == jcache[name].shape
        _close(cache[name], jcache[name])


def test_decode_steps_match_jax(model):
    """After an embeds + 3-axis-positions prefill, NEW greedy decode steps on
    both sides (decode positions continue at cur_len on every axis, as in
    the JAX package): identical tokens, logits within TOL."""
    jcfg, jparams, cfg, params = model
    jb, tb = _batches(*_inputs(cfg, 6))
    want, jcache = jax_api.prefill(jparams, jcfg, jb)
    jcache = jax_api.grow_cache(jcfg, jcache, S + NEW)
    got, cache = api.prefill(params, cfg, tb, reserve=S + NEW)
    for i in range(NEW):
        _close(got, want)
        jtok = jnp.argmax(want, axis=-1).astype(jnp.int32)[:, None]
        tok = got.argmax(-1)[:, None]
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        want, jcache = jax_api.decode_step(jparams, jcfg, jcache, jtok,
                                           jnp.asarray(S + i, jnp.int32))
        got, cache = api.decode_step(params, cfg, cache, tok, S + i)
    _close(got, want)


def test_generate_matches_jax_engine(model):
    jcfg, jparams, cfg, params = model
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S),
                                                dtype=np.int32)
    want = JaxEngine(jcfg, jparams, max_new=NEW).generate(prompts)
    got = Engine(cfg, params, max_new=NEW).generate(prompts)
    np.testing.assert_array_equal(got, want)


def test_lm_params_from_numpy_takes_the_vlm_tree(model):
    jcfg, jparams, cfg, _ = model
    tree = jax.tree.map(np.asarray, jparams)
    got = convert.lm_params_from_numpy(tree, cfg, "cpu")
    assert "unembed" in got["tok"] and "uniform" in got["stack"]
    bad = {**tree, "tok": {"embed": tree["tok"]["embed"]}}
    with pytest.raises(ValueError, match="names"):
        convert.lm_params_from_numpy(bad, cfg, "cpu")
