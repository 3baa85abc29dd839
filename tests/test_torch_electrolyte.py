"""The port's surrogate scoring path against ``repro.apps.electrolyte``: the
molecule space, ``Surrogate.predict`` and the ML-Recorder's UCB re-rank, on
parameters trained by the JAX package and carried across."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.apps.electrolyte import Surrogate as JaxSurrogate
from repro.configs import mpnn_surrogate as jax_configs
from repro.core.policies import ucb_scores as jax_ucb_scores
from repro.data import molecules as jax_molecules
from repro_torch.apps import electrolyte
from repro_torch.apps.electrolyte import Surrogate, rank_space
from repro_torch.configs import mpnn_surrogate as configs
from repro_torch.core import policies
from repro_torch.data import molecules

TOL = 1e-4
KAPPA = 2.0


@pytest.mark.parametrize("space", [molecules.MoleculeSpace(),
                                   molecules.MoleculeSpace(num_molecules=200,
                                                           seed=7)])
def test_molecules_bit_identical(space):
    jax_space = jax_molecules.MoleculeSpace(**vars(space))
    ids = [0, 1, 17, 199, 4242 % space.num_molecules]
    got, want = molecules.featurize(space, ids), jax_molecules.featurize(jax_space, ids)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(molecules.oracle_batch(space, ids[:3]),
                                  jax_molecules.oracle_batch(jax_space, ids[:3]))


def test_policies_match():
    preds = np.random.default_rng(0).standard_normal((4, 30))
    np.testing.assert_array_equal(policies.ucb_scores(preds, KAPPA),
                                  jax_ucb_scores(preds, KAPPA))


@pytest.fixture(scope="module")
def trained():
    """A JAX surrogate trained briefly, the same parameters in the port, and
    a 200-molecule space."""
    space = jax_molecules.MoleculeSpace(num_molecules=200)
    ids = list(range(24))
    jax_sur = JaxSurrogate(jax_configs.reduced(), seed=0)
    jax_sur.train(jax.tree.map(jnp.asarray, jax_molecules.featurize(space, ids)),
                  jax_molecules.oracle_batch(space, ids), 5e-3, 10)
    sur = Surrogate(configs.reduced(), seed=0, device="cpu")
    sur.load_numpy(jax.tree.map(np.asarray, jax_sur.params),
                   jax_sur.y_mean, jax_sur.y_std)
    feats = molecules.featurize(molecules.MoleculeSpace(num_molecules=200),
                                range(200))
    return jax_sur, sur, feats


def test_predict_and_rank_match_jax(trained):
    jax_sur, sur, feats = trained
    want = jax_sur.predict(jax.tree.map(jnp.asarray, feats))
    got = sur.predict(feats)
    assert got.shape == want.shape == (4, 200) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    y = jax_molecules.oracle_batch(jax_molecules.MoleculeSpace(200), range(20))
    sub = {k: v[:20] for k, v in feats.items()}
    assert abs(sur.mae(sub, y) - jax_sur.mae(jax.tree.map(jnp.asarray, sub), y)) < TOL

    want_scores = jax_ucb_scores(want, KAPPA)
    want_order = np.argsort(-want_scores)
    scores, order = rank_space(sur, feats, KAPPA)
    np.testing.assert_allclose(scores, want_scores, rtol=0, atol=TOL)
    s = want_scores[want_order]
    for p in range(20):
        # a rank is determined where both neighbours are further than TOL away
        apart = all(abs(s[p] - s[q]) > TOL for q in (p - 1, p + 1) if 0 <= q < len(s))
        if apart:
            assert order[p] == want_order[p], p


def test_chunked_predict_equals_whole(trained, monkeypatch):
    _, sur, feats = trained
    assert sur.chunk_size(16) >= 200           # one chunk under the budget
    whole = sur.predict(feats)
    per_mol = 4 * 16 ** 2 * 16 ** 2 * 4          # E * N^2 * Hd^2 * f32 bytes
    monkeypatch.setattr(electrolyte, "EDGE_BYTES_BUDGET", 7 * per_mol)
    assert sur.chunk_size(16) == 7
    # the GRU and readout matmuls may block differently at another batch size
    np.testing.assert_allclose(sur.predict(feats), whole, rtol=0, atol=1e-6)
