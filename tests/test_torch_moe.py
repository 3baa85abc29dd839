"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
``repro.models.moe`` on one layer of reduced llama4-scout (4 experts, top-1)
and reduced kimi-k2 (8 experts, top-2) in f32, with the JAX package's
parameters carried across through numpy.

Routing is held exactly: capacity, and slot positions from the same expert
choices; the router's expert choices themselves agree exactly on these
inputs, its gates to 1e-6 (f32 matmuls in other orders). Every
implementation (dropping, einsum, dense, gmm; the JAX gmm runs its Pallas
kernel in interpret mode) agrees with its JAX counterpart to rtol = atol =
1e-5 at capacity factors 1.25, 0.5 (tokens dropped) and 8.0 (none dropped).
In bf16 the gmm paths of both packages cast at the same places, so they
agree within one bf16 ulp of the largest |y|.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import api as jax_api
from repro.models import moe as jax_moe
from repro_torch.configs.base import get_config
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.models import moe

ARCHS = ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b"]
B, S = 2, 32
TOL = 1e-5
IMPLS = ["dropping", "einsum", "dense", "gmm"]
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _layer0_ffn(jcfg):
    """Layer 0's MoE parameters from the JAX initializer, as numpy."""
    tree = jax_api.init_params(jcfg, jax.random.PRNGKey(0))
    return {k: np.array(v[0]) for k, v in tree["stack"]["uniform"]["ffn"].items()}


@pytest.fixture(scope="module", params=ARCHS)
def layer(request):
    """(jax cfg, jax params, port cfg, port params, x as numpy (B,S,D))."""
    jcfg = jax_get_config(request.param, reduced=True).replace(**F32)
    cfg = get_config(request.param, reduced=True).replace(**F32)
    p = _layer0_ffn(jcfg)
    x = np.random.default_rng(0).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return (jcfg, {k: jnp.asarray(v) for k, v in p.items()}, cfg,
            {k: torch.from_numpy(v) for k, v in p.items()}, x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("seq", [1, 32, 2048])
def test_router_and_positions_match_jax(layer, seq):
    jcfg, jp, cfg, p, _ = layer
    x = np.random.default_rng(seq).standard_normal(
        (B, seq, cfg.d_model)).astype(np.float32)
    jg, jw, ji = jax_moe._router(jp, jnp.asarray(x), jcfg)
    g, w, i = moe._router(p, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    _close(g, jg, 1e-6)
    _close(w, jw, 1e-6)
    C = moe._capacity(cfg, seq)
    assert C == jax_moe._capacity(jcfg, seq)
    pos, keep = moe._route_positions(i, cfg, C)       # both rows at once
    for b in range(B):
        jpos, jkeep = jax_moe._route_positions(ji[b], jcfg, C)
        np.testing.assert_array_equal(pos[b].numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(keep[b].numpy(), np.asarray(jkeep))


@pytest.mark.parametrize("seq,want", [(2048, 256), (1024, 80), (1, 1),
                                      (32, 2), (2047, 256), (100, 8)])
def test_capacity_matches_jax_at_published_widths(seq, want):
    """llama4-scout's serving values: 2048 tokens round 160 up to 256 (the
    >128 rounding), 1024 tokens give 80, one decode token 1; 32 tokens give
    round(2.5) = 2 (Python rounds half to even, in both packages)."""
    arch = "llama4-scout-17b-a16e"
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert moe._capacity(cfg, seq) == jax_moe._capacity(jcfg, seq) == want
    kimi, jkimi = get_config("kimi-k2-1t-a32b"), jax_get_config("kimi-k2-1t-a32b")
    assert moe._capacity(kimi, seq) == jax_moe._capacity(jkimi, seq)


def test_aux_loss_matches_jax(layer):
    jcfg, jp, cfg, p, x = layer
    jg, _, ji = jax_moe._router(jp, jnp.asarray(x), jcfg)
    E = cfg.num_experts
    want = jax_moe.aux_load_balance_loss(jg, ji, E)
    got = moe.aux_load_balance_loss(torch.from_numpy(np.array(jg)),
                                    torch.from_numpy(np.array(ji)).long(), E)
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want, 1e-6)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5, 8.0])
@pytest.mark.parametrize("impl", IMPLS)
def test_moe_impl_matches_jax(layer, impl, capacity_factor):
    jcfg, jp, cfg, p, x = layer
    kw = dict(moe_impl=impl, capacity_factor=capacity_factor)
    jcfg, cfg = jcfg.replace(**kw), cfg.replace(**kw)
    want, want_aux = jax_moe.moe_ffn(jp, jnp.asarray(x), jcfg)
    got, aux = moe.moe_ffn(p, torch.from_numpy(x), cfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want)
    _close(aux, want_aux, 1e-6)
    # at 0.5 some assignments are dropped, at 8.0 none
    _, _, topi = moe._router(p, torch.from_numpy(x), cfg)
    _, keep = moe._route_positions(topi, cfg, moe._capacity(cfg, S))
    if capacity_factor == 0.5:
        assert not bool(keep.all())
    if capacity_factor == 8.0:
        assert bool(keep.all())


def test_dropped_tokens_pass_through_as_zeros(layer):
    """Capacity 1: every token past an expert's first slot gets y = 0 from
    every dropped choice (the residual stream carries it), in both
    packages."""
    jcfg, jp, cfg, p, x = layer
    jcfg, cfg = (c.replace(capacity_factor=1e-3, moe_impl="gmm")
                 for c in (jcfg, cfg))
    assert moe._capacity(cfg, S) == 1
    got, _ = moe.moe_ffn(p, torch.from_numpy(x), cfg)
    _, _, topi = moe._router(p, torch.from_numpy(x), cfg)
    _, keep = moe._route_positions(topi, cfg, 1)
    dropped = ~keep.any(-1)
    assert bool(dropped.any())
    assert bool((got[dropped] == 0).all())
    want, _ = jax_moe.moe_ffn(jp, jnp.asarray(x), jcfg)
    _close(got, want)


def _bf16_ulp(t) -> float:
    return 2.0 ** (math.floor(math.log2(float(np.abs(np.asarray(t, np.float32)).max()))) - 7)


def test_bf16_gmm_matches_jax(layer):
    jcfg, _, cfg, _, x = layer
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16", moe_impl="gmm")
    jcfg, cfg = jcfg.replace(**kw), cfg.replace(**kw)
    jp = {k: v.astype(jnp.bfloat16) for k, v in
          jax_api.init_params(jcfg, jax.random.PRNGKey(0))["stack"]["uniform"]["ffn"].items()}
    jp = {k: v[0] for k, v in jp.items()}
    p = {k: torch.from_numpy(np.asarray(v, np.float32)).bfloat16()
         for k, v in jp.items()}
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    want, _ = jax_moe.moe_ffn(jp, jx, jcfg)
    got, _ = moe.moe_ffn(p, tx, cfg)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_bf16_ulp(want))


def test_gmm_path_calls_the_kernel_once_per_product_on_untiled_weights(
        layer, monkeypatch):
    """Three gmm calls per layer, each over the (E, B*C, D) slots of all
    batch rows against the expert weights themselves: no per-row copy of
    any weight."""
    _, _, cfg, p, x = layer
    cfg = cfg.replace(moe_impl="gmm")
    calls = []
    real = gmm_ops.gmm

    def spy(xe, w, **kw):
        calls.append((tuple(xe.shape), w))
        return real(xe, w, **kw)

    monkeypatch.setattr(gmm_ops, "gmm", spy)
    moe.moe_ffn(p, torch.from_numpy(x), cfg)
    E, C, D, F = cfg.num_experts, moe._capacity(cfg, S), cfg.d_model, cfg.d_ff
    assert [s for s, _ in calls] == [(E, B * C, D), (E, B * C, D), (E, B * C, F)]
    for (_, w), name in zip(calls, ("wi_gate", "wi_up", "wo")):
        assert w.data_ptr() == p[name].data_ptr()


def test_dispatch_names_the_pending_path(layer):
    _, _, cfg, p, x = layer
    # ep_a2a is ported; with no mesh it is the dropping path, as in JAX
    got = moe.moe_ffn(p, torch.from_numpy(x), cfg.replace(moe_impl="ep_a2a"))
    want = moe.moe_dropping(p, torch.from_numpy(x), cfg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(KeyError):
        moe.moe_ffn(p, torch.from_numpy(x), cfg.replace(moe_impl="sorted"))
