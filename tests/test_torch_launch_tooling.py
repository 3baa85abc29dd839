"""The port's launch tooling held against the JAX package's:
``launch/analytic.py``, ``launch/hlo_analysis.py``, ``launch/dryrun.py``
and the dry run's cell table in ``configs/base.py``.

- ``analytic_hbm_bytes`` equals the reference's to 1e-12 relative, every
  term, over the 10 configs x the 4 ``SHAPES`` x both production meshes x
  ``dp_tp``/``fsdp_tp``/``dp_only`` x ZeRO 0/1. The reference runs as this
  file in a subprocess with 512 forced host devices (its dry run's device
  count); it also gives ``SHAPES``, ``shape_applicable``,
  ``default_sharding``, ``probe_configs``, ``param_count`` and
  ``active_param_count``, and its ``collective_stats`` of synthetic HLO
  lines of the ops, bytes and group sizes the port's records carry.
- On a fake (2, 4) world at reduced internlm2: in ``dp_only`` (every op's
  output split over all 8 ranks) the dry run's per-device FLOPs x 8 equal
  ``FlopCounterMode`` of the same train step on plain CPU tensors exactly;
  in ``dp_tp`` they are at least that total / 8; the all-reduce of one TP
  matmul is recorded with the output's bytes and a group of 4.
- Each kernel's meta implementation adds the bound column's operation
  count (``PERF.md`` section 6) at a reduced shape.
- ``run_cell`` on the reduced configs of all 10 archs at the 4 shapes on
  the single-pod mesh (``python -m repro_torch.launch.dryrun --reduced``,
  two subprocesses at once, plain attention in one chunk so that a train
  cell's attention is one block) gives ``status`` ok, or the reference's
  skip reason.
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
MODES = ("dp_tp", "fsdp_tp", "dp_only")
ZEROS = (0, 1)
REL = 1e-12
TIMEOUT_S = 300
LM = "internlm2-1.8b"
# (op, output bytes, group size) records and the HLO line the reference
# parses for each
COLLECTIVES = [
    ("all-reduce", 16 * 1024 * 4, 4,
     "%ar = f32[16,1024]{1,0} all-reduce(%x), replica_groups={{0,1,2,3}}"),
    ("all-gather", 16 * 1024 * 512 * 2, 16,
     "%ag = bf16[16,1024,512]{2,1,0} all-gather(%y), "
     "replica_groups=[16,16]<=[256]"),
    ("reduce-scatter", 64 * 4, 2,
     "%rs = f32[64]{0} reduce-scatter(%z), replica_groups={{0,1},{2,3}}"),
    ("all-to-all", 8 * 128 * 2, 8,
     "%aa = bf16[8,128]{1,0} all-to-all(%w), replica_groups=[32,8]<=[256]"),
    ("all-reduce", 4 * 4, None,
     "%ar2 = (f32[2]{0}, f32[2]{0}) all-reduce-start(%a, %b)"),
    ("collective-permute", 32 * 4, None,
     "%cp = f32[32]{0} collective-permute(%q), source_target_pairs={{0,1}}"),
]
WORLD = 256


# ---------------------------------------------------------------------------
# the reference: this file as a script, with 512 host devices
# ---------------------------------------------------------------------------


def reference(out_path):
    from repro.configs.base import (ARCH_IDS, SHAPES, ShardingConfig,
                                    active_param_count, get_config,
                                    param_count, shape_applicable)
    from repro.launch import analytic, dryrun, hlo_analysis
    from repro.launch.mesh import make_production_mesh

    meshes = {m: make_production_mesh(multi_pod=m) for m in (False, True)}
    out = {"analytic": {}, "cells": {}, "configs": {},
           "shapes": {k: (s.name, s.kind, s.seq_len, s.global_batch)
                      for k, s in SHAPES.items()}}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        c1, c2, n = dryrun.probe_configs(cfg)
        out["configs"][arch] = {
            "params": param_count(cfg), "active": active_param_count(cfg),
            "probes": (c1.num_layers, c1.encoder_layers, c2.num_layers,
                       c2.encoder_layers, n)}
        for name, shape in SHAPES.items():
            ok, reason = shape_applicable(cfg, shape)
            sc = dryrun.default_sharding(cfg, name)
            out["cells"][(arch, name)] = (ok, reason, sc.mode, sc.zero)
            for multi, mesh in meshes.items():
                for mode in MODES:
                    for zero in ZEROS:
                        out["analytic"][(arch, name, multi, mode, zero)] = \
                            analytic.analytic_hbm_bytes(
                                cfg, shape, mesh,
                                ShardingConfig(mode=mode, zero=zero))
    text = "\n".join(line for *_, line in COLLECTIVES)
    out["collectives"] = hlo_analysis.collective_stats(text, WORLD).as_dict()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def _cells_cmd(archs, out_dir):
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--reduced",
            "--arch", ",".join(archs), "--shape", "all", "--mesh", "single",
            "--set", "attn_chunk=4096", "--out", str(out_dir)]


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """The reference subprocess and the port's reduced dry-run cells (two
    subprocesses), all at once."""
    from repro_torch.configs.base import ARCH_IDS

    tmp = tmp_path_factory.mktemp("tooling")
    ref_out = tmp / "reference.pkl"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(ROOT / "src")}
    # the dry runs never touch a card: their fake meshes need none
    port_env = {**env, "CUDA_VISIBLE_DEVICES": ""}
    ref_env = {**env,
               "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    procs = [subprocess.Popen([sys.executable, __file__, str(ref_out)],
                              env=ref_env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    cells = tmp / "cells"
    half = len(ARCH_IDS) // 2
    for archs in (ARCH_IDS[:half], ARCH_IDS[half:]):
        procs.append(subprocess.Popen(
            _cells_cmd(archs, cells), env=port_env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert procs[0].returncode == 0, logs[0][-4000:]
    with open(ref_out, "rb") as f:
        ref = pickle.load(f)
    records = {}
    for path in cells.glob("*.json"):
        with open(path) as f:
            rec = json.load(f)
        records[(rec["arch"], rec["shape"])] = rec
    return {"ref": ref, "cells": records, "cell_logs": logs[1:],
            "cell_rcs": [p.returncode for p in procs[1:]]}


# ---------------------------------------------------------------------------
# the cell table, configs and the analytic model against the reference
# ---------------------------------------------------------------------------


def test_shapes_match_reference(ran):
    from repro_torch.configs.base import SHAPES
    assert {k: (s.name, s.kind, s.seq_len, s.global_batch)
            for k, s in SHAPES.items()} == ran["ref"]["shapes"]


def test_cell_table_matches_reference(ran):
    from repro_torch.configs.base import SHAPES, get_config, shape_applicable
    from repro_torch.launch import dryrun

    for (arch, name), want in ran["ref"]["cells"].items():
        cfg = get_config(arch)
        sc = dryrun.default_sharding(cfg, name)
        assert (*shape_applicable(cfg, SHAPES[name]), sc.mode,
                sc.zero) == want, (arch, name)


def test_params_and_probes_match_reference(ran):
    from repro_torch.configs.base import (active_param_count, get_config,
                                          param_count)
    from repro_torch.launch import dryrun

    for arch, want in ran["ref"]["configs"].items():
        cfg = get_config(arch)
        c1, c2, n = dryrun.probe_configs(cfg)
        assert param_count(cfg) == want["params"]
        assert active_param_count(cfg) == want["active"]
        assert (c1.num_layers, c1.encoder_layers, c2.num_layers,
                c2.encoder_layers, n) == want["probes"]


@pytest.mark.parametrize("mode", MODES)
def test_analytic_hbm_bytes_match_reference(ran, mode):
    from repro_torch.configs.base import SHAPES, ShardingConfig, get_config
    from repro_torch.launch import analytic
    from repro_torch.launch.mesh import make_production_mesh

    n = 0
    for (arch, name, multi, m, zero), want in ran["ref"]["analytic"].items():
        if m != mode:
            continue
        got = analytic.analytic_hbm_bytes(
            get_config(arch), SHAPES[name],
            make_production_mesh(multi_pod=multi),
            ShardingConfig(mode=mode, zero=zero))
        assert set(got) == set(want), (arch, name)
        for term, w in want.items():
            assert abs(got[term] - w) <= REL * abs(w), (arch, name, multi,
                                                        zero, term)
        n += 1
    assert n == 10 * 4 * 2 * 2


def test_collective_stats_match_reference(ran):
    from repro_torch.launch import hlo_analysis

    got = hlo_analysis.collective_stats(
        [(op, nbytes, n) for op, nbytes, n, _ in COLLECTIVES], WORLD)
    assert got.as_dict() == ran["ref"]["collectives"]


def test_roofline_uses_the_h100_figures():
    from repro_torch.launch import hlo_analysis as H

    assert (H.PEAK_FLOPS, H.HBM_BW, H.NVLINK_BW) == (989e12, 3.35e12, 450e9)
    r = H.roofline_terms(flops=2 * 989e12, hbm_bytes=3.35e12,
                         wire_bytes=450e9, chips=2)
    assert (r["compute_s"], r["memory_s"], r["collective_s"]) == (1.0, 0.5,
                                                                   1.0)
    assert r["step_lower_bound_s"] == 1.0


# ---------------------------------------------------------------------------
# the dry run on a fake (2, 4) world
# ---------------------------------------------------------------------------


def _small(mode):
    from repro_torch.configs.base import (ShapeConfig, ShardingConfig,
                                          get_config)
    cfg = get_config(LM, reduced=True).replace(attn_impl="ref")
    return cfg, ShapeConfig("t", "train", 64, 8), ShardingConfig(mode=mode)


def _fake_2x4():
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape
    return dryrun.fake_world(MeshShape((2, 4), ("data", "model")))


def _plain_train_flops():
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import steps

    cfg, shape, sc = _small("dp_only")
    state = steps.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (shape.global_batch,
                                               shape.seq_len + 1))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    step = steps.make_train_step(cfg, TrainConfig(), sc)
    with FlopCounterMode(display=False) as fc:
        step(state, batch)
    return fc.get_total_flops()


def _device_flops(mode):
    from repro_torch.launch import dryrun

    cfg, shape, sc = _small(mode)
    with _fake_2x4() as mesh:
        flops, records, _, _ = dryrun._run_program(cfg, shape, mesh, sc)
    return flops, records


@pytest.fixture(scope="module")
def plain_flops():
    return _plain_train_flops()


def test_dp_only_device_flops_times_ranks_equal_plain_count(plain_flops):
    flops, _ = _device_flops("dp_only")
    assert plain_flops > 0
    assert flops * 8 == plain_flops


def test_dp_tp_device_flops_at_least_an_eighth(plain_flops):
    flops, records = _device_flops("dp_tp")
    assert flops >= plain_flops / 8
    assert any(op == "all-reduce" and n == 4 for op, _, n in records)


def test_tp_matmul_all_reduce_is_recorded():
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch import hlo_analysis

    with _fake_2x4() as mesh:
        x = DTensor.from_local(torch.empty(4, 64, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(16, 32, device="meta"), mesh,
                               [Replicate(), Shard(0)], run_check=False)
        rec = hlo_analysis.CollectiveRecorder()
        with rec:
            y = (x @ w).redistribute(mesh, [Shard(0), Replicate()])
    assert tuple(y.placements) == (Shard(0), Replicate())
    assert rec.records == [("all-reduce", 4 * 32 * 4, 4)]


def test_probes_extrapolate_to_the_full_depth_count():
    """``probes=True``: the full-depth count equals the extrapolation from
    the two shallow configs (every layer counts alike)."""
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell(LM, "decode_32k", False, reduced=True, probes=True)
    detail = rec["collective_probe_detail"]
    assert detail["steps_full"] == 4 and detail["lin_equals_full"], detail
    assert detail["flops_probe2"] > detail["flops_probe1"] > 0


def test_kernel_wrappers_run_on_local_shards():
    """A kernel wrapper given DTensors runs on each rank's shards of its
    independent axes: batch rows over "data", heads over "model" (a
    replicated input takes its local slice); its meta implementation then
    counts one rank's share."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels.flash_attention import ops

    B, S, H, KVH, hd = 4, 64, 8, 4, 32
    with _fake_2x4() as mesh:
        q = DTensor.from_local(_meta(B // 2, S, H // 4, hd), mesh,
                               [Shard(0), Shard(2)], run_check=False)
        kv = DTensor.from_local(_meta(B // 2, S, KVH, hd), mesh,
                                [Shard(0), Replicate()], run_check=False)
        flops, o = _count(lambda: ops.attention(q, kv, kv))
    assert tuple(o.placements) == (Shard(0), Shard(2))
    assert o.shape == (B, S, H, hd)
    assert flops == 4 * hd * (B // 2) * (H // 4) * S * (S + 1) // 2


@pytest.mark.parametrize("placements", ["seq", "partial"])
def test_kernel_wrappers_refuse_other_placements(placements):
    """A placement off the op's independent axes raises with the op's name
    and the placements; nothing is gathered."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.kernels.flash_attention import ops

    other = Shard(1) if placements == "seq" else Partial()
    with _fake_2x4() as mesh:
        q = DTensor.from_local(_meta(2, 64, 8, 32), mesh, [Replicate(), other],
                               run_check=False)
        with pytest.raises(ValueError, match="flash_attention.*placements"):
            ops.attention(q, q, q)


def test_useful_flop_fraction_at_most_one(ran):
    for rec in ran["cells"].values():
        if rec["status"] == "ok":
            assert 0 < rec["useful_flop_frac"] <= 1, rec["arch"]


# ---------------------------------------------------------------------------
# the kernels' meta implementations
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _count(fn):
    from repro_torch.launch import hlo_analysis
    with hlo_analysis.DeviceFlopCounter() as c:
        out = fn()
    return c.flops, out


def test_flash_meta_adds_the_bound_count():
    from repro_torch.kernels.flash_attention import ops

    B, S, H, KVH, hd, W = 2, 96, 4, 2, 32, 40
    q, k = _meta(B, S, H, hd), _meta(B, S, KVH, hd)
    for causal, window in ((True, None), (True, W), (False, None)):
        flops, o = _count(lambda: ops.attention(q, k, k, causal=causal,
                                                window=window))
        pairs = sum(min(i + 1, S) - (max(i - W + 1, 0) if window else 0)
                    for i in range(S)) if causal else S * S
        assert flops == 4 * hd * B * H * pairs
        assert o.shape == q.shape and o.is_meta


def test_ssd_meta_adds_the_bound_count():
    from repro_torch.kernels.mamba2_ssd import ops

    B, L, H, P, G, N, Q = 2, 256, 4, 16, 1, 8, 64
    flops, (y, s) = _count(lambda: ops.ssd(
        _meta(B, L, H, P), _meta(B, L, H), _meta(B, L, G, N),
        _meta(B, L, G, N), chunk=Q))
    assert flops == 2 * B * H * (L // Q) * (Q * (Q + 1) // 2 * (N + P)
                                            + 2 * Q * P * N)
    assert y.shape == (B, L, H, P) and s.shape == (B, H, P, N)
    assert s.dtype == torch.float32


def test_wkv_meta_adds_the_bound_count():
    from repro_torch.kernels.rwkv6_scan import ops

    B, L, H, K, Q = 2, 128, 4, 16, 64
    t = _meta(B, L, H, K)
    flops, (y, s) = _count(lambda: ops.wkv6(t, t, t, t, _meta(H, K),
                                            chunk=Q))
    assert flops == B * H * (L // Q) * (2 * Q * K * K + Q * Q * K
                                        + Q * Q * K + 2 * Q * K * K)
    assert y.shape == (B, L, H, K) and s.shape == (B, H, K, K)


def test_gmm_meta_adds_the_bound_count():
    from repro_torch.kernels.moe_gmm import ops

    G, M, D, F = 4, 24, 32, 48
    flops, y = _count(lambda: ops.gmm(_meta(G, M, D), _meta(G, D, F)))
    assert flops == 2 * G * M * D * F and y.shape == (G, M, F)


def test_mpnn_meta_adds_the_bound_count():
    from repro_torch.kernels.mpnn_mp import ops

    B, N, Hd = 3, 10, 16
    flops, m = _count(lambda: ops.message_pass(
        _meta(B, N, Hd, dtype=torch.float32),
        _meta(B, N, N, Hd, Hd, dtype=torch.float32),
        _meta(B, N, N, dtype=torch.float32)))
    assert flops == 2 * B * N * N * Hd * Hd and m.shape == (B, N, Hd)


@pytest.mark.parametrize("h_dims", [3, 4])
def test_mpnn_typed_meta_count_equals_the_dense_entry(h_dims):
    """The typed entry adds the dense entry's count for the same step."""
    from repro_torch.kernels.mpnn_mp import ops

    E, B, N, Hd, nb = 4, 3, 10, 16, 4
    dense, _ = _count(lambda: ops.message_pass(
        _meta(E * B, N, Hd, dtype=torch.float32),
        _meta(E * B, N, N, Hd, Hd, dtype=torch.float32),
        _meta(E * B, N, N, dtype=torch.float32)))
    h = _meta(*((E * B,) if h_dims == 3 else (E, B)), N, Hd,
              dtype=torch.float32)
    flops, m = _count(lambda: ops.message_pass_typed(
        h, _meta(B, N, N, dtype=torch.int32),
        _meta(E, nb, Hd * Hd, dtype=torch.float32),
        _meta(B, N, N, dtype=torch.float32)))
    assert flops == dense > 0 and m.shape == h.shape


def test_mpnn_typed_runs_on_local_molecules():
    """Sharded, the typed entry runs on each rank's molecules with edge_w
    whole, and counts one rank's share."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels.mpnn_mp import ops

    E, B, N, Hd, nb = 4, 6, 8, 16, 4
    with _fake_2x4() as mesh:
        place = [Shard(0), Replicate()]
        h = DTensor.from_local(_meta(E, B // 2, N, Hd, dtype=torch.float32),
                               mesh, [Shard(1), Replicate()], run_check=False)
        bonds = DTensor.from_local(_meta(B // 2, N, N, dtype=torch.int32),
                                   mesh, place, run_check=False)
        adj = DTensor.from_local(_meta(B // 2, N, N, dtype=torch.float32),
                                 mesh, place, run_check=False)
        w = _meta(E, nb, Hd * Hd, dtype=torch.float32)
        flops, m = _count(lambda: ops.message_pass_typed(h, bonds, w, adj))
    assert tuple(m.placements) == (Shard(1), Replicate())
    assert m.shape == (E, B, N, Hd)
    assert flops == 2 * E * (B // 2) * N * N * Hd * Hd


# ---------------------------------------------------------------------------
# the reduced cells
# ---------------------------------------------------------------------------


def test_reduced_cells_run_or_skip_as_the_reference(ran):
    from repro_torch.configs.base import ARCH_IDS, SHAPES

    assert ran["cell_rcs"] == [0, 0], "\n".join(
        log[-3000:] for log in ran["cell_logs"])
    for arch in ARCH_IDS:
        for name in SHAPES:
            rec = ran["cells"][(arch, name)]
            ok, reason = ran["ref"]["cells"][(arch, name)][:2]
            if ok:
                assert rec["status"] == "ok", (arch, name, rec)
                assert rec["hlo_flops_per_dev"] > 0
                assert rec["hlo_bytes_per_dev"] is None
                assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
            else:
                assert (rec["status"], rec["reason"]) == ("skip", reason)


if __name__ == "__main__":
    reference(sys.argv[1])
