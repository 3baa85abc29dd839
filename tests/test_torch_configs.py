"""The port's copies of the language-model configs equal the JAX package's
field for field, and its registry takes every arch of the JAX package's."""
import dataclasses

import pytest

from repro.configs import base as jax_base
from repro_torch.configs import base
from repro_torch.models import api
from repro_torch.models.layers import ShapeMaker, dtype_of

PORTED = ["internlm2-1.8b", "qwen3-8b", "granite-20b", "zamba2-1.2b",
          "kimi-k2-1t-a32b", "llama4-scout-17b-a16e", "rwkv6-3b",
          "gemma2-2b", "qwen2-vl-72b", "seamless-m4t-medium"]
# The archs the registry refused until the gemma2, enc-dec and M-RoPE layers
# were ported.
FORMERLY_REFUSED = ["gemma2-2b", "qwen2-vl-72b", "seamless-m4t-medium"]


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


@pytest.mark.parametrize("arch", FORMERLY_REFUSED)
def test_unported_arch_names_its_slice(arch):
    """Every arch of the registry is ported: the three the registry refused
    until the gemma2, enc-dec and M-RoPE layers were ported resolve, and
    their parameter trees at the published widths have the JAX package's
    names, shapes and dtypes (traced, nothing allocated)."""
    import jax
    from repro.models import api as jax_api

    assert set(PORTED) == set(jax_base.ARCH_IDS) == set(base.PORTED)
    cfg = base.get_config(arch)
    got = api.model_params(ShapeMaker(dtype_of(cfg.param_dtype)), cfg)
    want = jax_api.abstract_params(jax_base.get_config(arch))

    def walk(g, w):
        if isinstance(g, dict):
            assert set(g) == set(w)
            return all(walk(g[k], w[k]) for k in g)
        return g[0] == w.shape and str(g[1]).endswith(str(w.dtype))

    assert walk(got, want)


def test_unknown_arch():
    with pytest.raises(ValueError, match="unknown arch"):
        base.get_config("no-such-arch")
