"""The port's MPNN ensemble against ``repro.models.mpnn`` on parameters
carried across with ``params_from_numpy``; inputs are real molecules from
the synthetic space.

JAX and the JAX package are imported inside the parity tests, so that the
CUDA test also runs on a GPU host that has no JAX:

    python -m pytest -q -m cuda tests/test_torch_mpnn.py
"""
import numpy as np
import pytest
import torch

from repro_torch import observability as obs
from repro_torch.configs import mpnn_surrogate as configs
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.mpnn import MPNNEnsemble, param_shapes, ucb

NAMES = ("reduced", "full")


def _configs(name):
    """(the JAX package's config, the port's) of one name."""
    from repro.configs import mpnn_surrogate as jax_configs
    return {"reduced": (jax_configs.reduced(), configs.reduced()),
            "full": (jax_configs.CONFIG, configs.CONFIG)}[name]


def _jax_params(jax_cfg, seed=0):
    import jax

    from repro.apps.electrolyte import Surrogate as JaxSurrogate
    return jax.tree.map(np.asarray, JaxSurrogate(jax_cfg, seed=seed).params)


def _model(cfg, tree):
    model = MPNNEnsemble(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_numpy(tree, "cpu"))
    return model


def test_configs_match_jax():
    for name in NAMES:
        jax_cfg, cfg = _configs(name)
        assert vars(cfg) == vars(jax_cfg)


def test_params_round_trip():
    jax_cfg, cfg = _configs("reduced")
    tree = _jax_params(jax_cfg)
    back = {n: t.numpy() for n, t in _model(cfg, tree).state_dict().items()}
    assert list(back) == list(param_shapes(cfg))
    assert sorted(back) == sorted(tree)      # JAX keeps dict keys sorted
    for n in tree:
        assert back[n].dtype == tree[n].dtype
        np.testing.assert_array_equal(back[n], tree[n])


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "dtype"])
def test_params_from_numpy_rejects(fault):
    tree = dict(_jax_params(_configs("reduced")[0]))
    if fault == "missing":
        del tree["gru_wr"]
    elif fault == "extra":
        tree["gru_wq"] = tree["gru_wr"]
    elif fault == "shape":
        tree["gru_wh"] = tree["gru_wh"][:, :-1]
    else:
        tree["ro_b1"] = tree["ro_b1"].astype(np.float64)
    with pytest.raises(ValueError):
        params_from_numpy(tree, "cpu")


def test_init_law():
    """Truncated normal on [-2, 2] times InitMaker's scale; zero biases;
    deterministic in the generator's seed."""
    cfg = configs.CONFIG
    a = MPNNEnsemble(cfg, torch.Generator().manual_seed(3)).state_dict()
    b = MPNNEnsemble(cfg, torch.Generator().manual_seed(3)).state_dict()
    scales = {"embed": 1.0, "edge_w": 0.05, "gru_wz": (2 * 64) ** -0.5,
              "gru_wh": (2 * 64) ** -0.5, "ro_w1": 64 ** -0.5,
              "ro_w2": 128 ** -0.5}
    for n, t in a.items():
        assert torch.equal(t, b[n])
    for n in ("ro_b1", "ro_b2"):
        assert not a[n].any()
    for n, s in scales.items():
        t = a[n] / s
        assert t.abs().max() <= 2.0
        # std of a unit normal truncated to [-2, 2] is 0.8796
        assert abs(t.std().item() - 0.8796) < 0.1, n


@pytest.mark.parametrize("name,impl,B", [("reduced", "ref", 8),
                                         ("reduced", "kernel", 8),
                                         ("full", "ref", 2)])
def test_forward_matches_ensemble_apply(name, impl, B):
    import jax
    import jax.numpy as jnp

    from repro.data import molecules
    from repro.models import mpnn as jax_mpnn
    jax_cfg, cfg = _configs(name)
    tree = _jax_params(jax_cfg, seed=1)
    space = molecules.MoleculeSpace(num_molecules=200)
    feats = molecules.featurize(space, range(5, 5 + B))
    want = jax_mpnn.ensemble_apply(
        jax.tree.map(jnp.asarray, tree),
        *(jnp.asarray(feats[k]) for k in ("atoms", "bonds", "mask")),
        jax_cfg, impl=impl)
    with torch.inference_mode():
        got = _model(cfg, tree)(
            *(torch.from_numpy(feats[k]) for k in ("atoms", "bonds", "mask")))
    assert got.shape == (cfg.ensemble, B)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_ucb_matches_jax():
    import jax.numpy as jnp

    from repro.models import mpnn as jax_mpnn
    preds = np.random.default_rng(0).standard_normal((16, 50)).astype(np.float32)
    np.testing.assert_allclose(ucb(torch.from_numpy(preds), 1.5).numpy(),
                               np.asarray(jax_mpnn.ucb(jnp.asarray(preds), 1.5)),
                               rtol=1e-6, atol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("per_member", [False, True])
def test_card_forward_builds_no_edge_tensor(cuda, per_member):
    """On the card, forward with impl=None takes the typed kernel entry once
    a message step: it builds no edge tensor (the ``edge_bytes`` counter
    stands still) and agrees with the plain forward, which builds one."""
    from repro_torch.data import molecules
    from repro_torch.kernels.mpnn_mp import mpnn_mp

    cfg = configs.CONFIG
    model = MPNNEnsemble(cfg, torch.Generator().manual_seed(2)).to(cuda)
    space = molecules.MoleculeSpace(num_molecules=200)
    feats = molecules.featurize(space, range(7, 7 + 40))
    idx = np.random.default_rng(0).integers(0, 40, (cfg.ensemble, 40))
    x = [torch.as_tensor(feats[k][idx] if per_member else feats[k],
                         device=cuda) for k in ("atoms", "bonds", "mask")]
    edge_bytes = obs.counter("edge_bytes")
    with torch.inference_mode():
        before, launches = edge_bytes.value, mpnn_mp.LAUNCHES
        got = model(*x)
        torch.cuda.synchronize()
        assert edge_bytes.value == before
        assert mpnn_mp.LAUNCHES - launches == cfg.message_steps
        want = model(*x, impl="ref")
    assert edge_bytes.value > before
    assert got.shape == (cfg.ensemble, 40)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture
def ring():
    """An empty ring of layer spans for the test, and an empty one after."""
    obs.reset_layers()
    yield
    obs.reset_layers()


def _bytes_a_molecule(cfg, n_atoms):
    """(plain, typed) bytes a molecule of the two chunk rules, f32: the edge
    tensor, E*N*N*Hd*Hd values; ten (E, N, Hd) activations."""
    act = cfg.ensemble * n_atoms * cfg.hidden * 4
    return act * n_atoms * cfg.hidden, 10 * act


def _predict(sur, feats):
    """(predictions, the call's ``mpnn.predict`` attributes, edge-tensor
    bytes counted during the call)."""
    edge_bytes = obs.counter("edge_bytes")
    obs.reset_layers()
    before = edge_bytes.value
    out = sur.predict(feats)
    built = edge_bytes.value - before
    span, = [s for s in obs.layer_spans() if s.name == "mpnn.predict"]
    return out, span.attrs, built


def test_chunk_rule_follows_the_path(monkeypatch):
    """The plain path's chunks bound its edge tensor, the typed path's its
    activations: at full widths 128 molecules against more than the whole
    10,000-molecule space, and under any budget each path's chunk follows
    its own bytes a molecule."""
    from repro_torch.apps import electrolyte

    cfg = configs.CONFIG
    sur = electrolyte.Surrogate(cfg, seed=0, device="cpu")
    plain, typed = _bytes_a_molecule(cfg, 16)
    assert typed == 640 << 10
    assert sur.model.bytes_per_molecule(16, "ref") == plain
    for impl in ("kernel", "meta"):
        assert sur.model.bytes_per_molecule(16, impl) == typed
    assert sur.chunk_size(16) == sur.chunk_size(16, "ref") == 128
    assert sur.chunk_size(16, "kernel") == sur.chunk_size(16, "meta") >= 10_000
    for budget in (7 * typed, 7 * plain, 3 * plain + typed, typed // 2):
        monkeypatch.setattr(electrolyte, "EDGE_BYTES_BUDGET", budget)
        assert sur.chunk_size(16, "ref") == max(1, budget // plain)
        for impl in ("kernel", "meta"):
            assert sur.chunk_size(16, impl) == max(1, budget // typed)


def test_predict_chunks_follow_resolved_path(ring, monkeypatch):
    """predict sizes its chunks by the path that its forward resolves to. On
    the CPU that is the plain path, chunked by the edge tensor's rule. Where
    it resolves to the typed path (here "meta", with the typed step through
    its plain version), the chunks follow the activations' rule, no edge
    tensor is built, and the predictions are the plain path's."""
    from repro_torch.apps import electrolyte
    from repro_torch.data import molecules
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.mpnn_mp import ops as mp_ops
    from repro_torch.kernels.mpnn_mp.ref import message_pass_typed_reference

    cfg = configs.reduced()
    space = molecules.MoleculeSpace(num_molecules=200, seed=3)
    feats = molecules.featurize(space, range(40))
    plain, typed = _bytes_a_molecule(cfg, feats["atoms"].shape[1])
    sur = electrolyte.Surrogate(cfg, seed=0, device="cpu")
    # 7 molecules of edge tensor; the typed rule would take all 40 at once
    monkeypatch.setattr(electrolyte, "EDGE_BYTES_BUDGET", 7 * plain)
    assert sur.chunk_size(16, "kernel") >= 40
    want, attrs, built = _predict(sur, feats)
    assert attrs == {"molecules": 40, "chunks": 6, "edge_bytes": 40 * plain}
    assert built == 40 * plain

    steps = []

    def typed_step(h, bonds, edge_w, adj, *, impl):
        steps.append(impl)
        return message_pass_typed_reference(h, bonds, edge_w, adj)

    monkeypatch.setattr(dispatch, "resolve",
                        lambda impl, name, lead, *inputs: impl or "meta")
    monkeypatch.setattr(mp_ops, "message_pass_typed", typed_step)
    got, attrs, built = _predict(sur, feats)
    assert attrs == {"molecules": 40, "chunks": 1, "edge_bytes": 0}
    assert built == 0 and steps == ["meta"] * cfg.message_steps
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    monkeypatch.setattr(electrolyte, "EDGE_BYTES_BUDGET", 7 * typed)
    steps.clear()
    got, attrs, built = _predict(sur, feats)
    assert attrs == {"molecules": 40, "chunks": 6, "edge_bytes": 0}
    assert built == 0 and len(steps) == 6 * cfg.message_steps
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_card_predict_in_one_chunk(cuda, ring, monkeypatch):
    """On the card, at full widths, predict scores 2,500 molecules in one
    chunk by the typed rule, one kernel launch a message step and no edge
    tensor, and agrees with the same predict forced to 128-molecule chunks
    on the standardized outputs. Its peak memory is what the model reckons
    a molecule on that path, within 20% below and 15% above: a forward that
    holds fewer or more activations than ``bytes_per_molecule`` counts
    fails here."""
    from repro_torch.apps import electrolyte
    from repro_torch.data import molecules
    from repro_torch.kernels.mpnn_mp import mpnn_mp

    cfg, n = configs.CONFIG, 2500
    feats = molecules.featurize(molecules.MoleculeSpace(), range(n))
    sur = electrolyte.Surrogate(cfg, seed=4, device=cuda)
    assert (sur.y_mean, sur.y_std) == (0.0, 1.0)
    launches = mpnn_mp.LAUNCHES
    whole, attrs, built = _predict(sur, feats)
    assert attrs == {"molecules": n, "chunks": 1, "edge_bytes": 0}
    assert built == 0
    assert mpnn_mp.LAUNCHES - launches == cfg.message_steps

    typed = sur.model.bytes_per_molecule(16, "kernel")
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    again, attrs, _ = _predict(sur, feats)
    peak = torch.cuda.max_memory_allocated(cuda) - base
    assert attrs["chunks"] == 1
    assert 0.8 * n * typed <= peak <= 1.15 * n * typed, (peak, n * typed)
    np.testing.assert_array_equal(again, whole)

    monkeypatch.setattr(electrolyte, "EDGE_BYTES_BUDGET", 128 * typed)
    launches = mpnn_mp.LAUNCHES
    chunked, attrs, built = _predict(sur, feats)
    chunks = -(-n // 128)
    assert attrs == {"molecules": n, "chunks": chunks, "edge_bytes": 0}
    assert built == 0
    assert mpnn_mp.LAUNCHES - launches == chunks * cfg.message_steps
    assert np.isfinite(whole).all()
    np.testing.assert_allclose(whole, chunked, rtol=0, atol=1e-6)
