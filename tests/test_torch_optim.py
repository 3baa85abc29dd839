"""The port's optimizer pieces against ``repro.optim`` on the same seeded
numpy inputs: AdamW (f32 and bf16 params), global-norm clipping, the
non-finite guard, the schedules and the gradient compression; the port's
counterparts of the quadratic, clip and schedule tests of
``tests/test_substrate.py``; and the copied config pieces training uses.

f32 results agree to 1e-6 relative (the same operations in the same order;
only the libraries' elementwise kernels differ). A bf16 param is rounded
from an f32 update computed to that accuracy, so it may differ by one bf16
ulp where the f32 value lies next to a rounding boundary."""
import inspect

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.optim import adamw as jax_adamw
from repro.optim import clip as jax_clip
from repro.optim import compress as jax_compress
from repro.optim import schedules as jax_schedules
from repro_torch.configs import base
from repro_torch.configs.base import TrainConfig
from repro_torch.models.convert import tensor_from_numpy
from repro_torch.optim import adamw, clip, compress, schedules
from repro_torch.utils.trees import tree_global_norm

RTOL = 1e-6


def grads_tree(rng, dtype=np.float32, scale=1.0):
    return {"w": (scale * rng.standard_normal((8, 16))).astype(dtype),
            "b": (scale * rng.standard_normal((16,))).astype(dtype),
            "blk": {"k": (scale * rng.standard_normal((2, 4, 8))).astype(dtype)}}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return jax.tree.map(lambda a: tensor_from_numpy(np.asarray(a), "cpu"), tree)


def close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_adamw_matches_jax(dtype):
    """Five updates with a changing lr: params, m, v and the step."""
    rng = np.random.default_rng(0)
    tc, jtc = TrainConfig(), jax_base.TrainConfig()
    params = grads_tree(rng, dtype)
    jp, p = to_jax(params), to_torch(params)
    jstate, state = jax_adamw.init(jp), adamw.init(p)
    assert state.step.dtype == torch.int32 and state.step.shape == ()
    assert state.m["w"].dtype == torch.float32      # f32 moments for bf16
    for i in range(5):
        grads = grads_tree(rng, dtype, scale=0.1)
        lr = 1e-3 * (i + 1)
        jp, jstate = jax_adamw.update(to_jax(grads), jstate, jp,
                                      jnp.float32(lr), jtc)
        p2, state2 = adamw.update(to_torch(grads), state, p,
                                  torch.tensor(lr), tc)
        assert p2 is p and state2 is state              # in place
        assert int(state.step) == int(jstate.step) == i + 1
        for key in ("w", "b"):
            close(state.m[key], jstate.m[key])
            close(state.v[key], jstate.v[key])
            assert p[key].dtype == tensor_from_numpy(
                np.asarray(jp[key]), "cpu").dtype
            if dtype == np.float32:
                close(p[key], jp[key])
            else:
                ulp = 2.0 ** -7 * np.abs(np.asarray(jp[key], np.float32))
                close(p[key], jp[key], rtol=0, atol=ulp.max())
        close(state.m["blk"]["k"], jstate.m["blk"]["k"])


def test_adamw_decays_matrices_only():
    """Decoupled decay reaches params with ndim >= 2 only."""
    tc = TrainConfig(weight_decay=0.5)
    params = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    zero = {"w": torch.zeros(2, 2), "b": torch.zeros(2)}
    adamw.update(zero, adamw.init(params), params, torch.tensor(0.1), tc)
    assert torch.allclose(params["w"], torch.full((2, 2), 0.95))
    assert torch.equal(params["b"], torch.ones(2))


def test_adamw_optimizes_quadratic():
    tc = TrainConfig(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=100)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}        # d/dw of w^2
        params, state = adamw.update(grads, state, params, torch.tensor(0.05), tc)
    assert float(params["w"].abs().max()) < 0.05


# ---------------------------------------------------------------------------
# clipping and the non-finite guard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_matches_jax(dtype, max_norm):
    """The norm in f32, the grads scaled in f32 and cast back to their
    dtype (a large max_norm leaves them as they are)."""
    grads = grads_tree(np.random.default_rng(1), dtype)
    jg, jnorm = jax_clip.clip_by_global_norm(to_jax(grads), max_norm)
    g, norm = clip.clip_by_global_norm(to_torch(grads), max_norm)
    assert norm.dtype == torch.float32
    close(norm, jnorm)
    for key in ("w", "b"):
        assert g[key].dtype == to_torch(grads)[key].dtype
        if dtype == np.float32:
            close(g[key], jg[key])
        else:
            close(g[key], jg[key], rtol=0,
                  atol=2.0 ** -7 * np.abs(np.asarray(jg[key], np.float32)).max())


def test_clip_by_global_norm():
    g = {"a": torch.ones(4) * 10.0}
    clipped, norm = clip.clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 20.0) < 1e-4
    assert abs(float(tree_global_norm(clipped)) - 1.0) < 1e-4


@pytest.mark.parametrize("bad", [None, np.nan, np.inf])
def test_zero_nonfinite_matches_jax(bad):
    """One non-finite element anywhere zeroes every gradient."""
    grads = grads_tree(np.random.default_rng(2))
    if bad is not None:
        grads["blk"]["k"][1, 2, 3] = bad
    jg, jflag = jax_clip.zero_nonfinite(to_jax(grads))
    g, flag = clip.zero_nonfinite(to_torch(grads))
    assert bool(flag) == bool(jflag) == (bad is not None)
    for (key, want), got in zip(jax.tree_util.tree_leaves_with_path(jg),
                                jax.tree.leaves(g)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), str(key))
    if bad is not None:
        assert not any(t.any() for t in jax.tree.leaves(g))


def test_nonfinite_guard():
    g = {"a": torch.tensor([1.0, float("nan")])}
    fixed, bad = clip.zero_nonfinite(g)
    assert bool(bad)
    assert float(fixed["a"].abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(lr=3e-4, warmup_steps=10, total_steps=100),
                                dict(lr=1.0, warmup_steps=0, total_steps=7),
                                dict(lr=2e-3, warmup_steps=5, total_steps=5)])
def test_schedules_match_jax(kw):
    for step in [0, 1, 4, 5, 9, 10, 11, 50, 99, 100, 150]:
        jstep = jnp.asarray(step, jnp.int32)
        tstep = torch.tensor(step, dtype=torch.int32)
        got = schedules.warmup_cosine(tstep, **kw)
        assert got.dtype == torch.float32 and got.shape == ()
        close(got, jax_schedules.warmup_cosine(jstep, **kw))
        const = schedules.constant(tstep, **kw)
        assert const.dtype == torch.float32
        close(const, jax_schedules.constant(jstep, **kw), rtol=0)


def test_warmup_cosine_schedule():
    kw = dict(lr=1.0, warmup_steps=10, total_steps=100)
    s0 = float(schedules.warmup_cosine(torch.tensor(0), **kw))
    s10 = float(schedules.warmup_cosine(torch.tensor(10), **kw))
    s100 = float(schedules.warmup_cosine(torch.tensor(100), **kw))
    assert s0 == 0.0 and abs(s10 - 1.0) < 0.01 and s100 <= 0.11


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


def test_quantize_int8_matches_jax():
    """Round half to even in both: values placed exactly on .5 steps."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(1000).astype(np.float32)
    x[:8] = np.array([127, -127, 0.5, 1.5, 2.5, -0.5, -1.5, 3.5]) * (
        np.abs(x).max() / 127.0)
    jq, js = jax_compress.quantize_int8(jnp.asarray(x))
    q, s = compress.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    close(s, js, rtol=0)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    close(compress.dequantize_int8(q, s),
          jax_compress.dequantize_int8(jq, js), rtol=0)


@pytest.mark.parametrize("method", ["none", "bf16", "int8_ef"])
def test_compress_tree_matches_jax(method):
    """Three rounds with error feedback carried: payload, decompressed
    grads and errors."""
    rng = np.random.default_rng(4)
    jerr = err = None
    for _ in range(3):
        grads = grads_tree(rng, scale=0.01)
        jpay, jerr = jax_compress.compress_tree(to_jax(grads), method, jerr)
        pay, err = compress.compress_tree(to_torch(grads), method, err)
        jout = jax_compress.decompress_tree(jpay, method)
        out = compress.decompress_tree(pay, method)
        for key in ("w", "b"):
            close(out[key], jout[key], rtol=0)
        close(out["blk"]["k"], jout["blk"]["k"], rtol=0)
        if method == "int8_ef":
            np.testing.assert_array_equal(pay["w"][0].numpy(),
                                          np.asarray(jpay["w"][0]))
            close(err["w"], jerr["w"], rtol=0, atol=1e-9)
            close(err["blk"]["k"], jerr["blk"]["k"], rtol=0, atol=1e-9)
        elif method == "bf16":
            assert pay["w"].dtype == torch.bfloat16
        else:
            assert err is None


# ---------------------------------------------------------------------------
# copied config pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ShardingConfig", "TrainConfig", "param_count",
                                  "active_param_count", "model_flops_per_token"])
def test_config_copy_matches_original(name):
    assert inspect.getsource(getattr(base, name)) == \
        inspect.getsource(getattr(jax_base, name))


@pytest.mark.parametrize("arch", base.PORTED)
def test_flop_accounting_matches_jax(arch):
    cfg, jcfg = base.get_config(arch), jax_base.get_config(arch)
    assert base.param_count(cfg) == jax_base.param_count(jcfg)
    assert base.active_param_count(cfg) == jax_base.active_param_count(jcfg)
    for seq, training in ((2048, True), (128, False)):
        assert (base.model_flops_per_token(cfg, seq, training)
                == jax_base.model_flops_per_token(jcfg, seq, training))
