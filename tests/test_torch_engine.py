"""The port's serving engine against ``repro.serving.engine.Engine`` on
reduced internlm2 in f32, with the JAX package's parameters carried across:
greedy tokens, slot reuse, the stats counts and the engine's layer spans.
Greedy tokens are held identical, which is safe in f32 (the logits agree to
1e-4; argmax over bf16 logits could tie)."""
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs.base import get_config as jax_get_config
from repro.models import api as jax_api
from repro.serving.engine import Engine as JaxEngine
from repro_torch import observability as obs
from repro_torch.configs.base import get_config
from repro_torch.models import convert
from repro_torch.serving.engine import Engine

ROOT = Path(__file__).resolve().parents[1]
ARCH = "internlm2-1.8b"
B, S, MAX_NEW = 2, 64, 8


@pytest.fixture(scope="module")
def engines():
    kw = dict(param_dtype="float32", compute_dtype="float32",
              attn_impl="kernel")
    jcfg = jax_get_config(ARCH, reduced=True).replace(**kw)
    cfg = get_config(ARCH, reduced=True).replace(**kw)
    jparams = jax_api.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          cfg, "cpu")
    return (JaxEngine(jcfg, jparams, max_new=MAX_NEW),
            Engine(cfg, params, max_new=MAX_NEW))


def _prompts(cfg, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S), dtype=np.int32)


def test_generate_matches_jax(engines):
    jax_engine, engine = engines
    prompts = _prompts(engine.cfg, 0)
    want = jax_engine.generate(prompts)
    got = engine.generate(prompts)
    assert got.shape == want.shape == (B, S + MAX_NEW)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_stats_match_jax(engines):
    """The three counts against the JAX engine's, and one ``engine.*``
    layer span for each call they count, its rows the tokens it gave."""
    jax_engine, engine = engines
    for e in engines:
        e.stats.update(prefill_calls=0, decode_steps=0, tokens_out=0)
    since = time.perf_counter_ns()
    for e in engines:
        for seed in (1, 2):
            e.generate(_prompts(engine.cfg, seed), max_new=4)
    counts = ("prefill_calls", "decode_steps", "tokens_out")
    assert set(engine.stats) == set(counts) <= set(jax_engine.stats)
    for k in counts:
        assert engine.stats[k] == jax_engine.stats[k], k
    assert engine.stats == {"prefill_calls": 2, "decode_steps": 6,
                            "tokens_out": 2 * B * 4}
    spans = [s for s in obs.layer_spans()
             if s.name.startswith("engine.") and s.t0 >= since]
    names = [s.name for s in spans]
    assert names.count("engine.prefill") == engine.stats["prefill_calls"]
    assert names.count("engine.decode") == engine.stats["decode_steps"]
    assert len(spans) == 2 + 6
    assert sum(s.attrs["rows"] for s in spans) == engine.stats["tokens_out"]
    assert all(s.t1 >= s.t0 and s.parent == -1 for s in spans)


def test_gather_rows_then_decode_matches_jax(engines):
    jax_engine, engine = engines
    prompts = np.concatenate([_prompts(engine.cfg, 3), _prompts(engine.cfg, 4)])
    jfirst, jstate = jax_engine.prefill_batch(prompts, reserve=S + 3)
    first, state = engine.prefill_batch(prompts, reserve=S + 3)
    np.testing.assert_array_equal(first, jfirst)
    np.testing.assert_array_equal(engine.decode_batch(state),
                                  jax_engine.decode_batch(jstate))
    rows = [3, 0]
    jstate = jax_engine.gather_rows(jstate, rows)
    state = engine.gather_rows(state, rows)
    assert state.padded_b == 2 and state.pos == jstate.pos == S + 1
    assert tuple(state.cache["k"].shape) == jstate.cache["k"].shape
    for _ in range(2):
        np.testing.assert_array_equal(engine.decode_batch(state),
                                      jax_engine.decode_batch(jstate))
    with pytest.raises(ValueError, match="reserved"):
        engine.decode_batch(state)


def test_serve_cli_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--device", "cpu", "--batch", "2", "--prompt-len", "32",
         "--max-new", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300,
        check=True).stdout
    assert "round 2: in (2, 32) -> out (2, 36)" in out
    assert "steady-state throughput:" in out and "decode_steps=9" in out


def test_profile_cli_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.profile_serve", "--arch",
         ARCH, "--device", "cpu", "--batch", "2", "--prompt-len", "16",
         "--max-new", "3", "--top", "3"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300,
        check=True).stdout
    assert "prefill: wall" in out and "decode: wall" in out
    assert "over 2 call(s)" in out and "aten::mm" in out
