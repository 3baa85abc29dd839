"""The port's surrogate training against ``repro``'s: ``mpnn_loss`` and its
gradients against ``jax.vmap(jax.value_and_grad(mpnn_loss))``, and
``Surrogate.train`` against the JAX ``Surrogate.train``, from the same
parameters (carried across with ``params_from_numpy``) and the JAX package's
own bootstrap indices, at the reduced config in f32.

Tolerances. The loss, its gradients and the parameters after 1 and 5 Adam
epochs differ only by summation order: 1e-5 absolute (measured: loss 7e-7,
gradients 1e-6 at |g| <= 6.6, parameters 1.2e-7 and 1.1e-6). Adam divides
each gradient by its own running scale, so over many epochs a rounding
difference in a gradient near zero moves a weight by up to 2 lr = 1e-2;
after the app's 200 epochs the predictions are held to 2e-2 V at a scale of
about 11 V (measured 4.5e-3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps.electrolyte import Surrogate as JaxSurrogate
from repro.configs import mpnn_surrogate as jax_configs
from repro.data import molecules as jax_molecules
from repro.models import mpnn as jax_mpnn
from repro_torch.apps import electrolyte
from repro_torch.apps.electrolyte import Surrogate
from repro_torch.configs import mpnn_surrogate as configs
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.mpnn import MPNNEnsemble, mpnn_loss

TOL = 1e-5
PRED_TOL = 2e-2
LR = 5e-3
N_TRAIN = 24


def jax_bootstrap(E, n):
    """The indices ``repro.apps.electrolyte.Surrogate.train`` draws."""
    keys = jax.random.split(jax.random.PRNGKey(1), E)
    return np.asarray(jax.vmap(lambda k: jax.random.randint(k, (n,), 0, n))(keys))


@pytest.fixture(scope="module")
def data():
    space = jax_molecules.MoleculeSpace(num_molecules=200)
    ids = list(range(N_TRAIN))
    params = jax.tree.map(np.asarray,
                          JaxSurrogate(jax_configs.reduced(), seed=0).params)
    return {"space": space, "params": params,
            "feats": jax_molecules.featurize(space, ids),
            "y": jax_molecules.oracle_batch(space, ids),
            "idx": jax_bootstrap(configs.reduced().ensemble, N_TRAIN)}


def _model(params):
    model = MPNNEnsemble(configs.reduced(), torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_numpy(params, "cpu"))
    return model


def _jax_trained(data, epochs):
    sur = JaxSurrogate(jax_configs.reduced(), seed=0)
    sur.train(jax.tree.map(jnp.asarray, data["feats"]), data["y"], LR, epochs)
    return sur


def _port(data, epochs):
    sur = Surrogate(configs.reduced(), seed=0, device="cpu")
    sur.load_numpy(data["params"], 0.0, 1.0)
    loss = sur.train(data["feats"], data["y"], LR, epochs, idx=data["idx"])
    return sur, loss


@pytest.mark.parametrize("n", [8, N_TRAIN])
def test_loss_and_grads_match_jax(data, n):
    idx = jax_bootstrap(configs.reduced().ensemble, n)
    y = data["y"][:n]
    batch = {k: v[:n][idx] for k, v in data["feats"].items()}
    batch["y"] = ((y - y.mean()) / y.std()).astype(np.float32)[idx]
    want_loss, want_grads = jax.vmap(jax.value_and_grad(jax_mpnn.mpnn_loss),
                                     in_axes=(0, 0, None))(
        jax.tree.map(jnp.asarray, data["params"]),
        jax.tree.map(jnp.asarray, batch), jax_configs.reduced())
    model = _model(data["params"])
    loss = mpnn_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert loss.shape == (configs.reduced().ensemble,)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want_loss),
                               rtol=0, atol=TOL)
    loss.sum().backward()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grads[name]),
                                   rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("epochs", [1, 5])
def test_train_matches_jax(data, epochs):
    want = _jax_trained(data, epochs)
    sur, loss = _port(data, epochs)
    assert (sur.y_mean, sur.y_std) == (want.y_mean, want.y_std)
    got = params_to_numpy(sur.model)
    for name, w in want.params.items():
        np.testing.assert_allclose(got[name], np.asarray(w), rtol=0, atol=TOL,
                                   err_msg=name)
    # the JAX train returns the mean of the last epoch's losses; recompute
    # it from the parameters before that epoch's update
    before = _jax_trained(data, epochs - 1).params if epochs > 1 else \
        jax.tree.map(jnp.asarray, data["params"])
    y_n = ((data["y"] - want.y_mean) / want.y_std).astype(np.float32)
    sub = {k: v[data["idx"]] for k, v in {**data["feats"], "y": y_n}.items()}
    want_loss = jax.vmap(jax_mpnn.mpnn_loss, in_axes=(0, 0, None))(
        before, jax.tree.map(jnp.asarray, sub), jax_configs.reduced())
    assert abs(loss - float(jnp.mean(want_loss))) < TOL


def test_predictions_after_app_epochs_match_jax(data):
    epochs = electrolyte.AppConfig().train_epochs
    want = _jax_trained(data, epochs)
    sur, _ = _port(data, epochs)
    feats = jax_molecules.featurize(data["space"], range(200))
    np.testing.assert_allclose(
        sur.predict(feats), want.predict(jax.tree.map(jnp.asarray, feats)),
        rtol=0, atol=PRED_TOL)


def test_member_batches_broadcast_like_one_batch(data):
    """One batch that every member scores and the same batch given to each
    member on its own (E,) axis take one code path and agree."""
    model = _model(data["params"])
    x = [torch.from_numpy(data["feats"][k]) for k in electrolyte.FEATURES]
    E = configs.reduced().ensemble
    with torch.no_grad():
        shared = model(*x)
        member = model(*(t.expand(E, *t.shape) for t in x))
    assert shared.shape == member.shape == (E, N_TRAIN)
    np.testing.assert_allclose(member.numpy(), shared.numpy(), rtol=0,
                               atol=1e-6)


def test_params_round_trip(data):
    back = params_to_numpy(_model(data["params"]))
    assert list(back) == list(MPNNEnsemble(configs.reduced(),
                                           torch.Generator()).state_dict())
    assert sorted(back) == sorted(data["params"])
    for name, a in data["params"].items():
        assert back[name].dtype == np.float32 and back[name].flags.writeable
        np.testing.assert_array_equal(back[name], a)
    model = _model(data["params"])
    again = _model(params_to_numpy(model))
    for (name, a), b in zip(model.state_dict().items(),
                            again.state_dict().values()):
        assert torch.equal(a, b), name


def test_train_swaps_weights_only_at_the_end(data, monkeypatch):
    """While train runs, the model that predict reads and its weights stay
    as they were; the trained model replaces it at the end."""
    sur = Surrogate(configs.reduced(), seed=0, device="cpu")
    sur.load_numpy(data["params"], 0.0, 1.0)
    served = sur.model
    before = {n: t.clone() for n, t in served.state_dict().items()}
    feats = {k: v[:8] for k, v in data["feats"].items()}
    preds = sur.predict(feats)
    calls = []

    def watched_loss(model, batch):
        assert model is not served
        assert sur.model is served and (sur.y_mean, sur.y_std) == (0.0, 1.0)
        for n, t in served.state_dict().items():
            assert torch.equal(t, before[n]), n
        np.testing.assert_array_equal(sur.predict(feats), preds)
        calls.append(1)
        return mpnn_loss(model, batch)

    monkeypatch.setattr(electrolyte, "mpnn_loss", watched_loss)
    sur.train(data["feats"], data["y"], LR, 3, idx=data["idx"])
    assert len(calls) == 3
    assert sur.model is not served and sur.y_std != 1.0
    for n, t in served.state_dict().items():
        assert torch.equal(t, before[n]), n


def test_default_bootstrap_is_seeded(data):
    """Without idx, each member draws its sample from the surrogate's seed:
    two surrogates of one seed train alike, another seed differently."""
    def trained(seed):
        sur = Surrogate(configs.reduced(), seed=seed, device="cpu")
        sur.load_numpy(data["params"], 0.0, 1.0)
        sur.train(data["feats"], data["y"], LR, 2)
        return params_to_numpy(sur.model)["ro_w1"]

    a, b, c = trained(3), trained(3), trained(4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
