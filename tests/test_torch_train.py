"""The port's LM training path against the JAX package's, on reduced dense
archs in f32: the cross-entropy and ``loss_fn``, three train steps from one
carried-across state (``repro_torch.models.convert.train_state_from_numpy``)
with 1 and 2 microbatches, remat, and resume after an interruption.

Each train step starts both packages from the same state: the JAX state
before the step, carried across again (the first from the seeded init).
Tolerances of ``hold_train_steps``: metrics within 1e-5 relative; m and v
within 1e-5 relative plus 5e-5 of the tensor's largest |value|: a moment of
a gradient near zero is noise in both packages, and the f32 gradients of
zamba2's decay parameters (``a_log``, ``dt_bias``) are themselves within
only 1.5e-5 (JAX) and 1.7e-5 (port) of the tensor's largest |value| of a
float64 pass of the port on the same batch; params within 1e-5
relative plus 1e-6 of the tensor's largest |value| plus Adam's term. Adam
moves a weight by lr m_hat / (sqrt(v_hat) + eps), close to lr sign(g): where
a gradient lies within a few eps of zero, its rounding in either package
moves the step by up to 2 lr (a handful of weights an arch). So each weight
may also differ by lr |u - u'|, u and u' the two packages' Adam directions
from their own (held) m and v, and at most one weight in a thousand may
need that term. Carrying the state across before every step keeps such a
weight from feeding the next step's gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShardingConfig as JaxShardingConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.base import get_config as jax_get_config
from repro.launch import steps as jax_steps
from repro.models import api as jax_api
from repro.models import layers as jax_layers
from repro.utils.trees import tree_flatten_with_paths as jax_flatten
from repro_torch.configs.base import ShardingConfig, TrainConfig, get_config
from repro_torch.kernels import dispatch
from repro_torch.launch import steps
from repro_torch.models import api, convert, layers
from repro_torch.utils.trees import tree_flatten_with_paths

F32 = dict(param_dtype="float32", compute_dtype="float32")
RTOL = 1e-5
MOMENT_ATOL = 5e-5      # of the tensor's largest |value|
PARAM_ATOL = 1e-6       # of the tensor's largest |value|
ADAM_SHARE = 1e-3       # most weights that may need Adam's term
B, STEPS = 4, 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are tiny: one torch thread is as fast as many, and
    keeps parallel test workers from oversubscribing the cores (each
    worker's torch would otherwise start a thread per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch, **kw):
    return (jax_get_config(arch, reduced=True).replace(**F32, **kw),
            get_config(arch, reduced=True).replace(**F32, **kw))


def lm_batch(rng, vocab, seq, batch=B):
    toks = rng.integers(0, vocab, size=(batch, seq + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _adam_direction(m, v, step, tc):
    c1 = 1.0 - tc.b1 ** step
    c2 = 1.0 - tc.b2 ** step
    return (m / c1) / (np.sqrt(v / c2) + tc.eps)


def hold_train_steps(arch, microbatches, seq, make=None):
    """STEPS train steps of both packages, each from the JAX state before
    it; every metric, param, m and v held after every step. ``make(rng,
    cfg, seq)`` draws a batch (default: ``lm_batch``)."""
    make = make or (lambda rng, cfg, seq: lm_batch(rng, cfg.vocab_size, seq))
    jcfg, cfg = configs(arch)
    tc = TrainConfig(warmup_steps=0)
    jstate = jax_steps.init_state(jcfg, jax.random.PRNGKey(0))
    jstep = jax.jit(jax_steps.make_train_step(
        jcfg, JaxTrainConfig(warmup_steps=0),
        JaxShardingConfig(microbatches=microbatches)))
    step = steps.make_train_step(cfg, tc,
                                 ShardingConfig(microbatches=microbatches))
    rng = np.random.default_rng(1)
    n_adam = n_params = 0
    for t in range(1, STEPS + 1):
        batch = make(rng, cfg, seq)
        state = convert.train_state_from_numpy(
            jax.tree.map(np.asarray, jstate), cfg, "cpu")
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, to_torch(batch))
        for name, want in jm.items():
            np.testing.assert_allclose(float(m[name]), float(want), rtol=RTOL,
                                       err_msg=f"step {t} metric {name}")
        want = dict(jax_flatten(jstate))
        got = dict(tree_flatten_with_paths(state))
        assert list(got) == list(want)
        assert int(got["opt/.step"]) == int(want["opt/.step"]) == t
        lr = float(jm["lr"])
        for key in want:
            if not key.startswith("params/"):
                continue
            rest = key[len("params"):]
            mv = {}
            for which in (".m", ".v"):
                w = np.asarray(want[f"opt/{which}{rest}"], np.float64)
                g = got[f"opt/{which}{rest}"].double().numpy()
                np.testing.assert_allclose(
                    g, w, rtol=RTOL, atol=MOMENT_ATOL * np.abs(w).max(),
                    err_msg=f"step {t} {which} of {key}")
                mv[which] = (w, g)
            adam = lr * np.abs(
                _adam_direction(mv[".m"][1], mv[".v"][1], t, tc)
                - _adam_direction(mv[".m"][0], mv[".v"][0], t, tc))
            w = np.asarray(want[key], np.float64)
            g = got[key].double().numpy()
            err = np.abs(g - w)
            base = RTOL * np.abs(w) + PARAM_ATOL * np.abs(w).max()
            bad = err > base + adam
            assert not bad.any(), (
                f"step {t} {key}: {int(bad.sum())} weights off by up to "
                f"{err[bad].max():.3e} beyond the tolerance and Adam's term")
            n_adam += int((err > base).sum())
            n_params += w.size
    assert n_adam <= ADAM_SHARE * n_params, (n_adam, n_params)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 16, 50))).astype(np.float32)
    labels = rng.integers(0, 50, size=(2, 16), dtype=np.int32)
    mask = (rng.random((2, 16)) < 0.6).astype(np.float32) if masked else None
    want, wcount = jax_layers.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got, count = layers.softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == count.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(count) == float(wcount)


def test_cross_entropy_of_bf16_logits_is_f32():
    logits = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(0))
    labels = torch.randint(0, 32, (2, 8), dtype=torch.int32)
    got, _ = layers.softmax_cross_entropy(logits.bfloat16(), labels)
    want, _ = layers.softmax_cross_entropy(logits.bfloat16().float(), labels)
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "llama4-scout-17b-a16e"])
def test_loss_fn_matches_jax(arch):
    """The loss and its metrics, with a loss mask; llama4-scout adds its
    load-balance loss times router_aux_coef."""
    jcfg, cfg = configs(arch)
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          cfg, "cpu")
    rng = np.random.default_rng(2)
    batch = lm_batch(rng, cfg.vocab_size, 32)
    batch["loss_mask"] = (rng.random((B, 32)) < 0.7).astype(np.float32)
    want, wm = jax_api.loss_fn(jparams, jcfg, jax.tree.map(jnp.asarray, batch))
    got, m = api.loss_fn(params, cfg, to_torch(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    for name in ("ce", "aux", "tokens"):
        np.testing.assert_allclose(float(m[name]), float(wm[name]), rtol=RTOL,
                                   atol=1e-7)
    if cfg.is_moe:
        assert float(m["aux"]) > 0
        np.testing.assert_allclose(
            float(got), float(m["ce"]) + cfg.router_aux_coef * float(m["aux"]),
            rtol=1e-6)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-8b", "granite-20b"])
def test_train_steps_match_jax(arch, microbatches):
    hold_train_steps(arch, microbatches, seq=32)


def grads_under_remat(arch, remat, seq, make=None):
    """The loss gradients of one seeded batch at remat ``remat``."""
    make = make or (lambda rng, cfg, seq: lm_batch(rng, cfg.vocab_size, seq))
    cfg = get_config(arch, reduced=True).replace(**F32, remat=remat)
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = to_torch(make(np.random.default_rng(3), cfg, seq))
    grads, _ = steps._grads_of(params, cfg, batch)
    return dict(tree_flatten_with_paths(grads))


def hold_remat(arch, remat, seq, make=None):
    """Remat recomputes the same operations on the same inputs: the
    gradients equal those of no remat bit for bit."""
    want = grads_under_remat(arch, "none", seq, make)
    got = grads_under_remat(arch, remat, seq, make)
    assert list(got) == list(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("remat", ["block", "policy"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "llama4-scout-17b-a16e"])
def test_remat_grads_equal(arch, remat):
    hold_remat(arch, remat, seq=32)


def op_counts(arch, remat, seq=32):
    """How often the forward and backward passes of one batch run each
    aten op at remat ``remat``."""
    from collections import Counter
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[func] += 1
            return func(*args, **(kwargs or {}))

    with Count() as mode:
        grads_under_remat(arch, remat, seq)
    return mode.n


def test_remat_recomputes_as_configured():
    """"block" recomputes the activation matmuls (mm) in the backward
    pass; "policy" saves them and recomputes only the rest, the attention
    einsums (bmm) among it."""
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    n = {r: op_counts("internlm2-1.8b", r) for r in ("none", "block", "policy")}
    assert n["block"][mm] > n["none"][mm] and n["block"][bmm] > n["none"][bmm]
    assert n["policy"][mm] == n["none"][mm]
    assert n["policy"][bmm] > n["none"][bmm]


def test_train_step_keeps_grad_dtype_without_microbatches(monkeypatch):
    """Without microbatches the clipped gradients keep the params' dtype
    (bf16 here), as in the JAX step; with microbatches they are f32."""
    cfg = get_config("internlm2-1.8b", reduced=True)
    seen = {}
    adamw_update = steps.adamw.update

    def spy(grads, *args):
        seen["dtypes"] = {g.dtype for _, g in tree_flatten_with_paths(grads)}
        return adamw_update(grads, *args)

    monkeypatch.setattr(steps.adamw, "update", spy)
    batch = to_torch(lm_batch(np.random.default_rng(4), cfg.vocab_size, 16))
    for k, want in ((1, {torch.bfloat16}), (2, {torch.float32})):
        state = steps.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
        steps.make_train_step(cfg, TrainConfig(),
                              ShardingConfig(microbatches=k))(state, batch)
        assert seen["dtypes"] == want


def test_nonfinite_step_zeroes_grads_but_moves_state():
    """A non-finite gradient zeroes every gradient; the step still runs:
    the counter, m, v and weight decay all move (as in the JAX step)."""
    cfg = get_config("internlm2-1.8b", reduced=True).replace(**F32)
    state = steps.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    tc = TrainConfig(warmup_steps=0)
    step = steps.make_train_step(cfg, tc)
    batch = to_torch(lm_batch(np.random.default_rng(5), cfg.vocab_size, 16))
    state, _ = step(state, batch)
    before = {k: v.clone() for k, v in tree_flatten_with_paths(state)}
    state["params"]["final_norm"]["scale"][0] = float("nan")
    state, m = step(state, batch)
    assert float(m["skipped"]) == 1.0 and float(m["grad_norm"]) == 0.0
    after = dict(tree_flatten_with_paths(state))
    assert int(after["opt/.step"]) == 2
    m_old, m_new = before["opt/.m/tok/embed"], after["opt/.m/tok/embed"]
    torch.testing.assert_close(m_new, tc.b1 * m_old, rtol=0, atol=0)
    w_old = before["params/stack/uniform/ffn/wo"]
    w_new = after["params/stack/uniform/ffn/wo"]
    assert not torch.equal(w_new, w_old)      # decayed and moved by m


# ---------------------------------------------------------------------------
# the kernels refuse to take part in a gradient
# ---------------------------------------------------------------------------

REFUSED = "no backward.*impl='ref'"


@pytest.mark.parametrize("arch,impls", [
    ("internlm2-1.8b", {"attn_impl": "kernel"}),
    ("llama4-scout-17b-a16e", {"attn_impl": "kernel", "moe_impl": "gmm"}),
    ("llama4-scout-17b-a16e", {"moe_impl": "gmm"}),
    ("zamba2-1.2b", {"attn_impl": "kernel"}),
    ("rwkv6-3b", {"attn_impl": "kernel"}),
])
def test_train_step_through_a_kernel_raises(arch, impls, monkeypatch):
    """A train step whose config sends attention, a scan or the expert
    products to a kernel raises in the dispatch, before any launch, instead
    of returning gradients that miss the kernel's part. The dispatch is
    made to see the card (``on_card``), as it would there."""
    monkeypatch.setattr(dispatch, "on_card", lambda t: True)
    cfg = get_config(arch, reduced=True).replace(**F32, **impls)
    state = steps.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = to_torch(lm_batch(np.random.default_rng(6), cfg.vocab_size, 64))
    with pytest.raises(RuntimeError, match=REFUSED):
        steps.make_train_step(cfg, TrainConfig())(state, batch)
    with torch.no_grad():                       # serving is unaffected
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            api.forward(state["params"], cfg, batch)


def test_every_kernel_refuses_grad():
    """Each of the six wrappers refuses impl="kernel" on an input that
    requires grad while grad mode is on, and only then."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.mpnn_mp import ops as mp_ops
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)          # noqa: E731
    calls = {
        "flash_attention": lambda x: fa_ops.attention(
            x, r(1, 8, 2, 4), r(1, 8, 2, 4), impl="kernel"),
        "mamba2_ssd": lambda x: ssd_ops.ssd(
            x, r(1, 8, 2), r(1, 8, 1, 4), r(1, 8, 1, 4), impl="kernel"),
        "rwkv6_scan": lambda x: wkv_ops.wkv6(
            x, r(1, 8, 2, 4), r(1, 8, 2, 4), -r(1, 8, 2, 4).abs(), r(2, 4),
            impl="kernel"),
        "moe_gmm": lambda x: gmm_ops.gmm(x, r(2, 4, 4), impl="kernel"),
        "mpnn_mp": lambda x: mp_ops.message_pass(
            x, r(1, 3, 3, 4, 4), r(1, 3, 3), impl="kernel"),
        "mpnn_mp_typed": lambda x: mp_ops.message_pass_typed(
            x, torch.ones(1, 3, 3, dtype=torch.int32), r(1, 2, 16),
            r(1, 3, 3), impl="kernel"),
    }
    shapes = {"flash_attention": (1, 8, 2, 4), "mamba2_ssd": (1, 8, 2, 4),
              "rwkv6_scan": (1, 8, 2, 4), "moe_gmm": (2, 3, 4),
              "mpnn_mp": (1, 3, 4), "mpnn_mp_typed": (1, 3, 4)}
    for name, call in calls.items():
        x = r(*shapes[name]).requires_grad_(True)
        with pytest.raises(RuntimeError, match=f"{name}: .*{REFUSED}"):
            call(x)
        for ctx in (torch.no_grad(), torch.inference_mode()):
            with ctx, pytest.raises(ValueError, match="needs CUDA tensors"):
                call(x)
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            call(x.detach())


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------


def test_train_resume_matches_uninterrupted(tmp_path):
    """Fault tolerance, as tests/test_substrate.py::test_train_resume_bitexact
    holds the JAX trainer: interrupted after 4 of 8 steps and resumed from
    the checkpoint, the run ends where the uninterrupted run ends."""
    from repro_torch.launch.train import train
    kw = dict(reduced=True, batch=2, seq=32, lr=1e-3, log_every=100,
              print_fn=lambda *a: None, device="cpu")
    s_full, _ = train("internlm2-1.8b", steps_total=8, **kw)
    ck = str(tmp_path / "ck")
    train("internlm2-1.8b", steps_total=8, stop_after=4, ckpt_dir=ck,
          ckpt_every=100, **kw)
    s_res, _ = train("internlm2-1.8b", steps_total=8, ckpt_dir=ck,
                     resume=True, **kw)
    for (k, a), (_, b) in zip(tree_flatten_with_paths(s_full),
                              tree_flatten_with_paths(s_res)):
        assert torch.equal(a, b), k
