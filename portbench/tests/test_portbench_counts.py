"""The benchmark's arithmetic against hand counts at small shapes: operation
and byte counts, roofline bounds, the traffic generator, the comparisons
that decide ``correct`` and the profiler's reduction."""
import importlib.util

import numpy as np
import pytest

from portbench.drivers import rescore, retrain, serve
from portbench.gen import prompts
from portbench.harness import flops, peaks
from portbench.harness.window import DeviceTrace

MPNN = {"num_atom_types": 8, "num_bond_types": 4, "hidden": 4,
        "message_steps": 2, "readout_hidden": 3, "ensemble": 2}
LM = {"d_model": 8, "num_heads": 2, "num_kv_heads": 1, "head_dim": 4,
      "d_ff": 16, "vocab_size": 10, "num_layers": 3}


def metric(root, name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), root / "portbench" / "metrics"
        / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def two_molecules():
    """A chain of 3 atoms (2 bonds, 4 directed pairs) and a pair of atoms
    (1 bond, 2 pairs), padded to 4 atoms."""
    bonds = np.zeros((2, 4, 4), np.int32)
    bonds[0, 0, 1] = bonds[0, 1, 0] = 1
    bonds[0, 1, 2] = bonds[0, 2, 1] = 3
    bonds[1, 0, 1] = bonds[1, 1, 0] = 2
    mask = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], np.float32)
    return bonds, mask


def test_adjacency_pairs():
    bonds, mask = two_molecules()
    assert flops.adjacency_pairs(bonds, mask).tolist() == [4, 2]
    mask[0, 2] = 0                       # a bond to a padding atom is none
    assert flops.adjacency_pairs(bonds, mask).tolist() == [2, 2]


def test_mpnn_forward_flops_by_hand():
    bonds, mask = two_molecules()
    pairs = flops.adjacency_pairs(bonds, mask)
    hd, r, T, E = 4, 3, 2, 2
    # every member scores both molecules: 6 pairs, 5 atoms, 2 molecules
    want = E * (T * (2 * hd * hd * 6 + 12 * hd * hd * 5)
                + 2 * (2 * hd * r + 2 * r))
    assert flops.mpnn_forward_flops(MPNN, mask, pairs) == want
    # one sample a member: member 0 the first molecule twice, member 1 the
    # second molecule twice
    idx = np.array([[0, 0], [1, 1]])
    m, p = mask[idx], flops.adjacency_pairs(bonds[idx], mask[idx])
    want = (T * (2 * hd * hd * (8 + 4) + 12 * hd * hd * (6 + 4))
            + 4 * (2 * hd * r + 2 * r))
    assert flops.mpnn_forward_flops(MPNN, m, p) == want


def test_lm_call_flops_by_hand():
    d, H, KVH, hd, F, V, L = 8, 2, 1, 4, 16, 10, 3
    per_token = 2 * L * (d * H * hd + 2 * d * KVH * hd + H * hd * d
                         + 3 * d * F)
    assert flops.lm_matmul_flops_per_token(LM) == per_token
    # prefill of prompts of 5 and 3 tokens: 15 and 6 causal pairs a layer
    assert flops.prefill_attention_flops(LM, [5, 3]) == 4 * L * H * hd * 21
    assert flops.lm_call_flops(LM, "prefill", [5, 3]) == (
        8 * per_token + 4 * L * H * hd * 21 + 2 * 2 * d * V)
    # decode of 3 rows with 6, 2 and 4 of their positions cached
    assert flops.lm_call_flops(LM, "decode", [6, 2, 4]) == (
        3 * per_token + 4 * L * H * hd * (7 + 3 + 5) + 3 * 2 * d * V)


class FakeEngine:
    """Returns a state per call, as the engine's stepwise API does."""

    class State:
        def __init__(self, b, pos):
            self.padded_b, self.pos, self.reserve = b, pos, pos + 8

    def prefill_batch(self, tokens, *, reserve=None, frames=None):
        return np.zeros(len(tokens), np.int32), self.State(*tokens.shape)

    def decode_batch(self, state):
        state.pos += 1
        return np.zeros(state.padded_b, np.int32)

    def gather_rows(self, state, rows):
        return self.State(len(rows), state.pos)


class NoWindow:
    def boundary(self):
        pass


def test_proxy_counts_real_rows_and_tokens():
    """Two requests (3 tokens for 2 outputs, 5 tokens for 4) left-padded
    to a bucket of 8 in a batch of 4 rows (rows 2, 3 copy row 0): the
    proxy records the prompts' own lengths, then in decode the rows that
    still owe tokens, through a gather to fewer rows."""
    a, b = [11, 12, 13], [21, 22, 23, 24, 25]
    sizes = {serve.prompt_key(a): (3, 2), serve.prompt_key(b): (5, 4)}
    proxy = serve.Proxy(FakeEngine(), NoWindow(), sizes)
    tokens = np.zeros((4, 8), np.int32)
    tokens[0, 5:], tokens[1, 3:] = a, b
    tokens[2:] = tokens[0]
    _, state = proxy.prefill_batch(tokens)
    proxy.decode_batch(state)                    # both owe a token
    state = proxy.gather_rows(state, [1, 1])     # a has finished
    proxy.decode_batch(state)
    proxy.decode_batch(state)
    proxy.decode_batch(state)                    # b has all 4: none owed
    got = [(c[0], c[3], c[6]) for c in proxy.calls]
    assert got == [("prefill", 4, [3, 5]), ("decode", 4, [3, 5]),
                   ("decode", 2, [6]), ("decode", 2, [7]), ("decode", 2, [])]

def test_bound_is_the_larger_time():
    assert peaks.bound_seconds(67e12, 0, "float32") == pytest.approx(1.0)
    assert peaks.bound_seconds(0, 3.35e12, "bfloat16") == pytest.approx(1.0)
    assert peaks.bound_seconds(989e12, 6.7e12, "bfloat16") == \
        pytest.approx(2.0)


def test_mpnn_mp_step_bound_by_hand(root):
    m = metric(root, "mpnn_mp_roofline")
    bonds, mask = two_molecules()
    E, hd, nb, B, N = 2, 4, 4, 2, 4
    ops = 2 * hd * hd * E * 6
    nbytes = (2 * E * B * N * hd * 4 + bonds.nbytes + E * nb * hd * hd * 4
              + B * N * N * 4)
    want = max(ops / 67e12, nbytes / 3.35e12)
    got = m.step_bound_seconds(MPNN, {"bonds": bonds, "mask": mask})
    assert got == pytest.approx(want)


def test_flash_call_bound_by_hand(root):
    m = metric(root, "flash_roofline")
    # prompts of 4 and 2 tokens: 10 + 3 causal pairs; q,k,v,o = (2 + 2*1)
    # heads of 4 for each of the 6 tokens
    ops = 4 * 2 * 4 * 13
    nbytes = 6 * (2 * 2 + 2 * 1) * 4 * 2
    want = 3 * max(ops / 989e12, nbytes / 3.35e12)
    assert m.call_bound_seconds(LM, [4, 2]) == pytest.approx(want)


def test_prompt_pool_is_the_same_for_every_seed():
    traffic = {"prompt_len": {"dist": "loguniform", "lo": 64, "hi": 1024},
               "max_new": {"dist": "uniform", "lo": 4, "hi": 16}, "pool": 32}
    q = prompts.quantiles(traffic["prompt_len"], 4)
    assert q.tolist() == [int(round(64 * 16 ** f)) for f in
                          (0.125, 0.375, 0.625, 0.875)]
    assert prompts.quantiles(traffic["max_new"], 13).tolist() == list(
        range(4, 17))
    a, b = prompts.Requests(traffic, 50, 1), prompts.Requests(traffic, 50, 2)
    first = sorted(a.sizes(k) for k in range(32))
    assert first == sorted(b.sizes(k) for k in range(32)) == sorted(
        prompts.size_pool(traffic))
    assert [a.sizes(k) for k in range(32)] != [b.sizes(k) for k in range(32)]
    ids, max_new = a[5]
    assert (ids, max_new) == a[5] and len(ids) == a.sizes(5)[0]
    assert all(0 <= t < 50 for t in ids)


def test_order_gap():
    s = np.array([5.0, 4.0, 3.0, 2.0])
    assert rescore.order_gap(np.array([0, 1, 2, 3]), s) == 0.0
    # 2 ahead of 1: the worse (3.0) before the better (4.0)
    assert rescore.order_gap(np.array([0, 2, 1, 3]), s) == 1.0
    assert rescore.order_gap(np.array([3, 2, 1, 0]), s) == 3.0


def test_leaf_gap_uses_the_median_leaf_for_small_leaves():
    want = {"a": np.ones(4), "b": np.full(4, 2.0), "c": np.full(4, 1e-9)}
    prog = {"a": np.ones(4), "b": np.full(4, 2.0), "c": np.full(4, 1e-3)}
    # c's gap 2e-3 is taken over the median norm, 2 (not its own 2e-9)
    assert retrain.leaf_gap(prog, want, want) == pytest.approx(2e-3 / 2.0)


def test_device_trace_reduction():
    ms = 1_000_000
    dev = [("k1", 0, 2 * ms), ("k2", 1 * ms, 3 * ms), ("k1", 5 * ms, 6 * ms)]
    host = [("aten::mm", 0, 4 * ms), ("aten::item", 3 * ms, 5 * ms)]
    t = DeviceTrace(0.010, dev, host)
    assert t.busy_s() == pytest.approx(0.004)
    assert t.seconds_of(lambda n: n == "k1") == pytest.approx(0.003)
    b = t.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(0.003)]
    # the gap 3-5 ms is under aten::item (innermost at 4 ms); the rest of
    # the 10 ms window outside the device's span is the edges
    assert dict(map(tuple, b["idle_gaps"])) == {
        "aten::item": pytest.approx(0.002),
        "window edges": pytest.approx(0.004)}
