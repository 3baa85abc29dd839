"""The port's sharded train step (``launch/steps.build_program``) held
against the JAX package's own ``build_program`` on a (2, 4) ("data",
"model") mesh: 3 steps of reduced internlm2 in f32 in each of ``dp_tp``,
``fsdp_tp`` and ``dp_only`` (ZeRO-1 on), in one world of 8 spawned gloo CPU
ranks against one reference subprocess with 8 forced host devices on a mesh
of Auto axes (``test_torch_distributed.py`` has the harness and kimi-k2's
expert-parallel step). Loss, grad norm and every param, moment and
placement are held."""
import pytest

from test_torch_distributed import (hold_train, run_both, train_inputs,
                                    train_payloads)

ARCH = "internlm2-1.8b"
MODES = ("dp_tp", "fsdp_tp", "dp_only")
TRAIN = [(ARCH, mode, {}) for mode in MODES]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    inputs = {"train": train_inputs(TRAIN), "train_programs": TRAIN}
    ref, port = run_both(tmp_path_factory.mktemp("train"), inputs, (),
                         train_payloads(inputs, TRAIN))
    return {"ref": ref,
            "train": {(a, m): port[0][i] for i, (a, m, _) in enumerate(TRAIN)},
            "placed": {(a, m): all(r[i]["placed"] for r in port)
                       for i, (a, m, _) in enumerate(TRAIN)}}


@pytest.mark.parametrize("mode", MODES)
def test_sharded_train_steps_match_reference(results, mode):
    hold_train(results, ARCH, mode)

