"""The port's checkpoints against the JAX package's: one on-disk format
(``arrays.npz`` + ``manifest.json``), so a train state written by either
package restores in the other bit for bit, bf16 leaves and the int32 step
included, and both write the same manifest for the same state. Then the
port's manager (rotation, the torn-write fallback, a finished host copy
before ``save`` returns) and the copied ``data`` modules, held to their
originals."""
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jax_store
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.base import get_config as jax_get_config
from repro.launch import steps as jax_steps
from repro.utils.trees import tree_flatten_with_paths as jax_flatten
from repro_torch.checkpoint import store
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import get_config
from repro_torch.launch import steps
from repro_torch.models import convert
from repro_torch.utils.trees import tree_flatten_with_paths

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH = "internlm2-1.8b"       # reduced, bf16 params


@pytest.fixture(scope="module")
def jax_state():
    """A reduced internlm2 train state after one JAX step: bf16 params,
    f32 moments that are not zero, step 1."""
    cfg = jax_get_config(ARCH, reduced=True)
    state = jax_steps.init_state(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 17), dtype=np.int32)
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])}
    step = jax_steps.make_train_step(cfg, JaxTrainConfig(warmup_steps=0))
    state, _ = jax.jit(step)(state, batch)
    return state


def port_like():
    return steps.init_state(get_config(ARCH, reduced=True),
                            torch.Generator().manual_seed(1), "cpu")


def bits(x):
    """The raw bytes of a JAX array or a tensor, with its dtype name."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous()
        name = str(t.dtype).replace("torch.", "")
        return name, tuple(t.shape), t.reshape(-1).view(torch.uint8).numpy().tobytes()
    a = np.array(x, order="C")
    return str(a.dtype), a.shape, a.tobytes()


def test_state_keys_match_jax(jax_state):
    """Named-tuple fields flatten to ".step", ".m", ".v" in field order,
    dict keys in sorted order, as in the JAX package."""
    keys = [k for k, _ in tree_flatten_with_paths(port_like())]
    assert keys == [k for k, _ in jax_flatten(jax_state)]
    assert keys[:2] == ["opt/.step", "opt/.m/final_norm/scale"]


def test_jax_checkpoint_restores_in_port(jax_state, tmp_path):
    path = str(tmp_path / "ck")
    jax_store.save(path, jax_state)
    got = store.restore(path, port_like())
    want = dict(jax_flatten(jax_state))
    flat = dict(tree_flatten_with_paths(got))
    assert list(flat) == list(want)
    dtypes = set()
    for key, w in want.items():
        assert bits(flat[key]) == bits(w), key
        dtypes.add(str(flat[key].dtype))
    assert dtypes == {"torch.bfloat16", "torch.float32", "torch.int32"}
    assert flat["opt/.step"].shape == () and int(flat["opt/.step"]) == 1


def test_port_checkpoint_restores_in_jax(jax_state, tmp_path):
    cfg = get_config(ARCH, reduced=True)
    state = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jax_state), cfg, "cpu")
    path = str(tmp_path / "ck")
    store.save(path, state)
    like = jax.tree.map(jnp.zeros_like, jax_state)
    got = jax_store.restore(path, like)
    for (key, g), (_, w) in zip(jax_flatten(got), tree_flatten_with_paths(state)):
        assert bits(g) == bits(w), key


def test_manifests_identical(jax_state, tmp_path):
    """The same state written by both packages: the manifests are the same
    text (keys, dtypes, checksum over the stored bytes)."""
    state = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jax_state), get_config(ARCH, reduced=True),
        "cpu")
    jax_store.save(str(tmp_path / "jax"), jax_state)
    store.save(str(tmp_path / "port"), state)
    texts = [(tmp_path / d / store.MANIFEST).read_text() for d in ("jax", "port")]
    assert texts[0] == texts[1]
    assert '"opt/.step": "int32"' in texts[0]
    assert '"params/tok/embed": "bfloat16"' in texts[0]


def test_torn_checkpoint_raises(tmp_path):
    state = port_like()
    path = str(tmp_path / "ck")
    store.save(path, state)
    with np.load(os.path.join(path, store.SHARD)) as z:
        arrays = {k: z[k].copy() for k in z.files}
    arrays["params/tok/embed"][0, 0, 0] ^= 1
    np.savez(os.path.join(path, store.SHARD), **arrays)
    with pytest.raises(IOError, match="checksum"):
        store.restore(path, state)


# ---------------------------------------------------------------------------
# manager (the port's counterparts of tests/test_substrate.py's)
# ---------------------------------------------------------------------------


def test_manager_rotation_and_corruption_fallback(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    tree = {"x": torch.arange(10, dtype=torch.float32)}
    for step in (1, 2, 3):
        m.save(step, {"x": tree["x"] * step}, blocking=True)
    assert m.steps() == [2, 3]            # rotated
    shard = os.path.join(str(tmp_path), "step_3", store.SHARD)
    with open(shard, "wb") as f:
        f.write(b"garbage")
    step, back = m.restore(tree)
    assert step == 2                       # fell back to older valid ckpt
    assert torch.equal(back["x"], tree["x"] * 2)
    assert m.restore(tree, step=3) == (None, None)


def test_manager_save_copies_before_returning(tmp_path):
    """The train step updates the state in place: what ``save`` writes is
    the state as it was when ``save`` was called, also for CPU tensors."""
    m = CheckpointManager(str(tmp_path))
    state = port_like()
    want = {k: v.clone() for k, v in tree_flatten_with_paths(state)}
    m.save(5, state)
    for _, v in tree_flatten_with_paths(state):
        v.add_(1)
    m.wait()
    step, back = m.restore(state)
    assert step == 5
    for key, v in tree_flatten_with_paths(back):
        assert torch.equal(v, want[key]), key


# ---------------------------------------------------------------------------
# the copied data modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rel", ["data/tokens.py", "data/loader.py"])
def test_data_copy_matches_original(rel):
    assert (SRC / "repro_torch" / rel).read_text() == \
        (SRC / "repro" / rel).read_text()


def test_batches_match_jax_package():
    from repro.data import tokens as jax_tokens
    from repro_torch.data import tokens
    cfg, jcfg = get_config(ARCH, reduced=True), jax_get_config(ARCH, reduced=True)
    for step in (0, 7):
        want = jax_tokens.make_batch(jcfg, "train", 4, 16, step=step, seed=3)
        got = tokens.make_batch(cfg, "train", 4, 16, step=step, seed=3)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
