"""The port's grouped matmul against the JAX package's: the Pallas ``gmm``
(interpret mode, as tests/test_kernels.py::test_gmm_kernel runs it, with
its block sizes) and ``gmm_reference``, on the JAX test's shapes, and the
plain version on ragged row counts against ``gmm_reference``. In f32 the
versions differ only in summation order: rtol 1e-5 and an atol of 1e-5 of
the largest |out| (a sum of D products of unit normals is O(sqrt(D)), and
where it nearly cancels its f32 rounding error is that of its terms, not
of itself; at D=256 it reached 1.8e-5 against |out| up to ~70). In bf16 every
version sums exact f32 products of the same bf16 inputs and rounds once, so
they may differ by one bf16 ulp of the largest |out| (``_bf16_ulp``). The
CUDA kernel itself is held against the plain version on a CUDA device
only:

    python -m pytest -q -m cuda tests/test_torch_moe_gmm.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.moe_gmm import moe_gmm, ops, ref

# (G, M, D, F): tests/test_kernels.py::test_gmm_kernel
CASES = [(4, 128, 256, 512), (8, 64, 128, 128)]
# ragged row counts: one slot, reduced kimi-k2's 53 slots per expert
RAGGED = [(4, 1, 128, 64), (8, 53, 128, 64)]
# shapes only the CUDA kernel's tests take: 8 rows (decode at B=8), 80 rows
# over several F tiles, and a D tail of 16 with an F tile of 80 columns
KERNEL_ONLY = [(16, 8, 512, 256), (3, 80, 256, 384), (2, 37, 144, 80)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = 1e-5


def _inputs(G, M, D, F, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((G, M, D)).astype(np.float32),
            rng.standard_normal((G, D, F)).astype(np.float32))


def _bf16_ulp(t) -> float:
    """One bf16 ulp (8 significant bits) at the largest |t|."""
    return 2.0 ** (math.floor(math.log2(float(np.abs(np.asarray(t, np.float32)).max()))) - 7)


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    if dtype == torch.float32:
        rtol, atol = TOL, TOL * float(np.abs(want).max())
    else:
        rtol, atol = 0.0, _bf16_ulp(want)
    np.testing.assert_allclose(got.float().cpu().numpy(), want, rtol=rtol,
                               atol=atol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_gmm_matches_jax(case, dtype):
    import jax.numpy as jnp
    from repro.kernels.moe_gmm.moe_gmm import gmm as jax_gmm
    from repro.kernels.moe_gmm.ref import gmm_reference as jax_ref
    xe, w = _inputs(*case)
    jxe, jw = (jnp.asarray(a).astype(jnp.dtype(dtype)) for a in (xe, w))
    txe, tw = (torch.from_numpy(a).to(DTYPES[dtype]) for a in (xe, w))
    got = ops.gmm(txe, tw)
    assert got.dtype == txe.dtype and got.shape == case[:2] + case[3:]
    assert torch.equal(got, ref.gmm_reference(txe, tw))
    for want in (jax_gmm(jxe, jw, block_c=64, block_f=128, block_d=128),
                 jax_ref(jxe, jw)):
        _close(got, want, DTYPES[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", RAGGED, ids=str)
def test_ragged_rows_match_jax_reference(case, dtype):
    import jax.numpy as jnp
    from repro.kernels.moe_gmm.ref import gmm_reference as jax_ref
    xe, w = _inputs(*case, seed=1)
    got = ops.gmm(*(torch.from_numpy(a).to(DTYPES[dtype]) for a in (xe, w)))
    want = jax_ref(*(jnp.asarray(a).astype(jnp.dtype(dtype)) for a in (xe, w)))
    _close(got, want, DTYPES[dtype])


def test_dispatch_on_cpu():
    xe, w = (torch.from_numpy(a) for a in _inputs(2, 8, 32, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ops.gmm(xe, w, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        moe_gmm.gmm_cuda(xe, w)
    with pytest.raises(ValueError, match="impl"):
        ops.gmm(xe, w, impl="pallas")
    want = ref.gmm_reference(xe, w)
    for impl in (None, "ref"):
        assert torch.equal(ops.gmm(xe, w, impl=impl), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES + RAGGED + KERNEL_ONLY, ids=str)
def test_kernel_matches_plain_version(cuda, case, dtype):
    xe, w = (torch.from_numpy(a).to(cuda, DTYPES[dtype])
             for a in _inputs(*case, seed=2))
    before = moe_gmm.LAUNCHES
    got = ops.gmm(xe, w, impl="kernel")
    want = ref.gmm_reference(xe, w)
    torch.cuda.synchronize()
    assert moe_gmm.LAUNCHES == before + 1
    assert got.dtype == xe.dtype and got.shape == want.shape
    _close(got, want.float().cpu(), DTYPES[dtype])


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    xe, w = (torch.from_numpy(a).to(cuda) for a in _inputs(2, 8, 64, 32))
    with pytest.raises(ValueError, match="multiples of 16"):
        ops.gmm(xe[..., :40], w[:, :40], impl="kernel")
    with pytest.raises(ValueError, match="multiples of 16"):
        ops.gmm(xe, w[..., :24].contiguous(), impl="kernel")
    with pytest.raises(ValueError, match="shapes"):
        ops.gmm(xe, w[:1].contiguous(), impl="kernel")
    with pytest.raises(TypeError, match="dtype"):
        ops.gmm(xe, w.bfloat16(), impl="kernel")
    with pytest.raises(ValueError, match="contiguous"):
        ops.gmm(xe.transpose(1, 2).contiguous().transpose(1, 2), w,
                impl="kernel")
