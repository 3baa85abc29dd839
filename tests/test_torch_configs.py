"""The port's copies of the language-model configs equal the JAX package's
field for field, and its registry refuses the archs it does not run yet."""
import dataclasses

import pytest

from repro.configs import base as jax_base
from repro_torch.configs import base

PORTED = ["internlm2-1.8b", "qwen3-8b", "granite-20b", "zamba2-1.2b",
          "kimi-k2-1t-a32b", "llama4-scout-17b-a16e", "rwkv6-3b"]


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", PORTED)
def test_config_equals_reference(arch, reduced):
    got = base.get_config(arch, reduced=reduced)
    want = jax_base.get_config(arch, reduced=reduced)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.resolved_head_dim == want.resolved_head_dim


def test_model_config_fields_match():
    fields = [(f.name, f.default) for f in dataclasses.fields(base.ModelConfig)]
    want = [(f.name, f.default)
            for f in dataclasses.fields(jax_base.ModelConfig)]
    assert fields == want
    assert base.ARCH_IDS == jax_base.ARCH_IDS


@pytest.mark.parametrize("arch", [a for a in jax_base.ARCH_IDS
                                  if a not in PORTED])
def test_unported_arch_names_its_slice(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        base.get_config(arch)


def test_unknown_arch():
    with pytest.raises(ValueError, match="unknown arch"):
        base.get_config("no-such-arch")
