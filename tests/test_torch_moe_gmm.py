"""The port's grouped matmul against the JAX package's: the Pallas ``gmm``
(interpret mode, as tests/test_kernels.py::test_gmm_kernel runs it, with
its block sizes) and ``gmm_reference``, on the JAX test's shapes, and the
plain version on ragged row counts against ``gmm_reference``. In f32 the
versions differ only in summation order: rtol 1e-5 and an atol of 1e-5 of
the largest |out| (a sum of D products of unit normals is O(sqrt(D)), and
where it nearly cancels its f32 rounding error is that of its terms, not
of itself; at D=256 it reached 1.8e-5 against |out| up to ~70). In bf16 every
version sums exact f32 products of the same bf16 inputs and rounds once, so
they may differ by one bf16 ulp of the largest |out| (``_bf16_ulp``). The
CUDA kernel itself is held against the plain version on a CUDA device
only:

    python -m pytest -q -m cuda tests/test_torch_moe_gmm.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.moe_gmm import moe_gmm, ops, ref

# (G, M, D, F): tests/test_kernels.py::test_gmm_kernel
CASES = [(4, 128, 256, 512), (8, 64, 128, 128)]
# ragged row counts: one slot, reduced kimi-k2's 53 slots per expert
RAGGED = [(4, 1, 128, 64), (8, 53, 128, 64)]
# shapes only the CUDA kernel's tests take: 8 rows (decode at B=8), 80 rows
# over several F tiles, and a D tail of 16 with an F tile of 80 columns
KERNEL_ONLY = [(16, 8, 512, 256), (3, 80, 256, 384), (2, 37, 144, 80)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = 1e-5


def _inputs(G, M, D, F, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((G, M, D)).astype(np.float32),
            rng.standard_normal((G, D, F)).astype(np.float32))


def _bf16_ulp(t) -> float:
    """One bf16 ulp (8 significant bits) at the largest |t|."""
    return 2.0 ** (math.floor(math.log2(float(np.abs(np.asarray(t, np.float32)).max()))) - 7)


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    if dtype == torch.float32:
        rtol, atol = TOL, TOL * float(np.abs(want).max())
    else:
        rtol, atol = 0.0, _bf16_ulp(want)
    np.testing.assert_allclose(got.float().cpu().numpy(), want, rtol=rtol,
                               atol=atol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_gmm_matches_jax(case, dtype):
    import jax.numpy as jnp
    from repro.kernels.moe_gmm.moe_gmm import gmm as jax_gmm
    from repro.kernels.moe_gmm.ref import gmm_reference as jax_ref
    xe, w = _inputs(*case)
    jxe, jw = (jnp.asarray(a).astype(jnp.dtype(dtype)) for a in (xe, w))
    txe, tw = (torch.from_numpy(a).to(DTYPES[dtype]) for a in (xe, w))
    got = ops.gmm(txe, tw)
    assert got.dtype == txe.dtype and got.shape == case[:2] + case[3:]
    assert torch.equal(got, ref.gmm_reference(txe, tw))
    for want in (jax_gmm(jxe, jw, block_c=64, block_f=128, block_d=128),
                 jax_ref(jxe, jw)):
        _close(got, want, DTYPES[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", RAGGED, ids=str)
def test_ragged_rows_match_jax_reference(case, dtype):
    import jax.numpy as jnp
    from repro.kernels.moe_gmm.ref import gmm_reference as jax_ref
    xe, w = _inputs(*case, seed=1)
    got = ops.gmm(*(torch.from_numpy(a).to(DTYPES[dtype]) for a in (xe, w)))
    want = jax_ref(*(jnp.asarray(a).astype(jnp.dtype(dtype)) for a in (xe, w)))
    _close(got, want, DTYPES[dtype])


def test_dispatch_on_cpu():
    xe, w = (torch.from_numpy(a) for a in _inputs(2, 8, 32, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ops.gmm(xe, w, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        moe_gmm.gmm_cuda(xe, w)
    with pytest.raises(ValueError, match="impl"):
        ops.gmm(xe, w, impl="pallas")
    want = ref.gmm_reference(xe, w)
    for impl in (None, "ref"):
        assert torch.equal(ops.gmm(xe, w, impl=impl), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES + RAGGED + KERNEL_ONLY, ids=str)
def test_kernel_matches_plain_version(cuda, case, dtype):
    xe, w = (torch.from_numpy(a).to(cuda, DTYPES[dtype])
             for a in _inputs(*case, seed=2))
    before = moe_gmm.LAUNCHES
    got = ops.gmm(xe, w, impl="kernel")
    want = ref.gmm_reference(xe, w)
    torch.cuda.synchronize()
    assert moe_gmm.LAUNCHES == before + 1
    assert got.dtype == xe.dtype and got.shape == want.shape
    _close(got, want.float().cpu(), DTYPES[dtype])


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    xe, w = (torch.from_numpy(a).to(cuda) for a in _inputs(2, 8, 64, 32))
    with pytest.raises(ValueError, match="multiples of 16"):
        ops.gmm(xe[..., :40], w[:, :40], impl="kernel")
    with pytest.raises(ValueError, match="multiples of 16"):
        ops.gmm(xe, w[..., :24].contiguous(), impl="kernel")
    with pytest.raises(ValueError, match="shapes"):
        ops.gmm(xe, w[:1].contiguous(), impl="kernel")
    with pytest.raises(TypeError, match="dtype"):
        ops.gmm(xe, w.bfloat16(), impl="kernel")
    with pytest.raises(ValueError, match="contiguous"):
        ops.gmm(xe.transpose(1, 2).contiguous().transpose(1, 2), w,
                impl="kernel")


# The Hopper bf16 kernel's tiles are 128 rows x 256 columns with K steps of
# 64: row counts 1, 8 (decode at B=8), 53 and 160 (one full tile and a
# ragged one), and D and F tails below one step or tile.
BF16_KERNEL = [(4, 1, 128, 64), (16, 8, 512, 256), (8, 53, 144, 80),
               (2, 160, 336, 272), (3, 300, 80, 528)]


def _moe_layer(arch, seed=0):
    """Reduced config of ``arch`` with moe_impl="gmm" and seeded f32 MoE
    weights at the initializer's scale."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch, reduced=True).replace(
        param_dtype="float32", compute_dtype="float32", moe_impl="gmm")
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    shapes = {"router": (d, e), "wi_gate": (e, d, f), "wi_up": (e, d, f),
              "wo": (e, f, d)}
    params = {k: torch.from_numpy(
        (rng.standard_normal(s) / math.sqrt(s[-2])).astype(np.float32))
        for k, s in shapes.items()}
    return cfg, params


@pytest.mark.parametrize("seq", [1, 16])
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b"])
def test_dispatch_live_matches_the_slot_table(arch, seq):
    """With ``pass_live``, ``dispatch`` hands the expert FFN live = experts
    whose slot column holds a token in some row: a numpy count of the slot
    table. The rows of every other expert are all the zero row. Without it,
    the expert FFN gets no ``live``."""
    from repro_torch.models import moe
    cfg, params = _moe_layer(arch)
    B = 3
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, seq, cfg.d_model)).astype(np.float32))
    seen = []

    def ffn(p, xe, c, live=None):
        seen.append((xe, live))
        return moe._expert_ffn(p, xe, c)

    y, _ = moe.dispatch(params, x, cfg, ffn, pass_live=True)
    want_y, _ = moe.dispatch(params, x, cfg, moe._expert_ffn)
    assert torch.equal(y, want_y)
    seen_live = seen.pop()
    moe.dispatch(params, x, cfg, ffn)
    assert seen.pop()[1] is None
    seen.append(seen_live)
    E, C = cfg.num_experts, moe._capacity(cfg, seq)
    _, _, topi = moe._router(params, x, cfg)
    pos, keep = moe._route_positions(topi, cfg, C)
    slots = moe._slot_table(topi, pos, keep, E, C).numpy()
    want = (slots < seq).sum(axis=(0, 2)) > 0
    (xe, live), = seen
    assert live.dtype == torch.bool and live.shape == (E,)
    np.testing.assert_array_equal(live.numpy(), want)
    assert not xe[~live].any()
    if seq == 1:     # decode: B tokens top-k leave experts empty
        assert want.sum() <= B * cfg.num_experts_per_token < E


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_live_changes_nothing_on_the_cpu(dtype):
    """On the CPU ``gmm`` does not hand ``live`` to the plain version, which
    computes every group: with and without it the results are equal."""
    xe, w = (torch.from_numpy(a).to(DTYPES[dtype]) for a in _inputs(4, 8, 32, 16))
    live = torch.tensor([True, False, True, False])
    xe[~live] = 0
    assert torch.equal(ops.gmm(xe, w, live=live), ops.gmm(xe, w))
    assert torch.equal(ops.gmm(xe, w, impl="ref", live=live),
                       ref.gmm_reference(xe, w))
    cfg, params = _moe_layer("llama4-scout-17b-a16e")
    xe = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (cfg.num_experts, 6, cfg.d_model)).astype(np.float32)).to(DTYPES[dtype])
    live = torch.arange(cfg.num_experts) % 2 == 0
    xe[~live] = 0
    cfg = cfg.replace(compute_dtype=dtype)
    got = ops.expert_ffn(params, xe, cfg, live=live)
    assert torch.equal(got, ops.expert_ffn(params, xe, cfg))
    assert not got[~live].any()


def test_live_reaches_every_gmm_call(monkeypatch):
    """A spy on ``ops.gmm``: the gate, up and down products of the MoE FFN
    each get the dispatch's ``live`` mask."""
    from repro_torch.models import moe
    cfg, params = _moe_layer("llama4-scout-17b-a16e")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 1, cfg.d_model)).astype(np.float32))
    calls = []
    real = ops.gmm

    def spy(xe, w, **kw):
        calls.append(kw.get("live"))
        return real(xe, w, **kw)

    monkeypatch.setattr(ops, "gmm", spy)
    y, _ = moe.moe_ffn(params, x, cfg)
    assert len(calls) == 3 and all(live is calls[0] for live in calls)
    assert calls[0].dtype == torch.bool and calls[0].shape == (cfg.num_experts,)
    assert 1 <= int(calls[0].sum()) <= 2 < cfg.num_experts   # 2 tokens, top-1
    want, _ = moe.moe_ffn(params, x, cfg.replace(moe_impl="dropping"))
    torch.testing.assert_close(y, want, rtol=TOL, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_KERNEL, ids=str)
def test_bf16_kernel_tails_match_plain_version(cuda, case):
    xe, w = (torch.from_numpy(a).to(cuda, torch.bfloat16)
             for a in _inputs(*case, seed=3))
    got = ops.gmm(xe, w, impl="kernel")
    want = ref.gmm_reference(xe, w)
    torch.cuda.synchronize()
    assert got.dtype == xe.dtype and got.shape == want.shape
    _close(got, want.float().cpu(), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", [(16, 8, 512, 256), (4, 53, 144, 80)], ids=str)
def test_kernel_skips_empty_groups(cuda, case, dtype):
    """Groups with live False have zero rows: the kernel writes zeros and
    reads none of their weights, which are NaN here to prove it."""
    G = case[0]
    xe, w = (torch.from_numpy(a).to(cuda, DTYPES[dtype])
             for a in _inputs(*case, seed=4))
    live = torch.arange(G, device=cuda) % 3 == 1
    xe[~live] = 0
    want = ref.gmm_reference(xe, w)
    w[~live] = float("nan")
    before = moe_gmm.LAUNCHES
    got = ops.gmm(xe, w, impl="kernel", live=live)
    torch.cuda.synchronize()
    assert moe_gmm.LAUNCHES == before + 1
    assert torch.isfinite(got).all() and not got[~live].any()
    _close(got, want.float().cpu(), DTYPES[dtype])


@pytest.mark.cuda
def test_kernel_refuses_a_bad_live_mask(cuda):
    xe, w = (torch.from_numpy(a).to(cuda) for a in _inputs(2, 8, 64, 32))
    for live in (torch.ones(2, device=cuda), torch.ones(3, dtype=torch.bool,
                                                        device=cuda),
                 torch.ones(2, dtype=torch.bool)):
        with pytest.raises(ValueError, match="live"):
            ops.gmm(xe, w, impl="kernel", live=live)
