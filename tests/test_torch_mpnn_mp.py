"""The port's MPNN message step against the JAX package's: the Pallas kernel
(interpret mode, as tests/test_kernels.py runs it) and its jnp oracle. The
CUDA kernel itself is held against the plain version on a CUDA device only.

JAX is imported inside the parity tests, so that the CUDA tests also run on
a GPU host that has no JAX:

    python -m pytest -q -m cuda tests/test_torch_mpnn_mp.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.mpnn_mp import ops
from repro_torch.kernels.mpnn_mp.ref import message_pass_reference

SHAPES = [(3, 16, 32), (2, 8, 64), (2, 16, 64)]
# bf16 results are f32 sums rounded to bf16 in both packages; summation order
# may move a value across a rounding boundary, i.e. by one bf16 ulp
# (<= 2**-7 relative, 8 significant bits).
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-4


def _inputs(B, N, Hd, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, N, Hd)).astype(np.float32)
    e = (0.1 * rng.standard_normal((B, N, N, Hd, Hd))).astype(np.float32)
    adj = (rng.random((B, N, N)) > 0.5).astype(np.float32)
    return h, e, adj


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("B,N,Hd", SHAPES)
def test_reference_matches_jax(B, N, Hd):
    from repro.kernels.mpnn_mp.mpnn_mp import message_pass_pallas
    from repro.kernels.mpnn_mp.ref import message_pass_reference as jax_reference
    h, e, adj = _inputs(B, N, Hd)
    got = message_pass_reference(*map(torch.from_numpy, (h, e, adj))).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_reference(h, e, adj)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(message_pass_pallas(h, e, adj)),
                               rtol=1e-4, atol=1e-4)


def test_reference_matches_jax_bf16():
    import jax.numpy as jnp
    from repro.kernels.mpnn_mp.ref import message_pass_reference as jax_reference
    h, e, adj = _inputs(2, 16, 64, seed=1)
    got = message_pass_reference(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (h, e, adj)))
    want = jax_reference(*(jnp.asarray(a, jnp.bfloat16) for a in (h, e, adj)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=BF16_RTOL, atol=BF16_ATOL)


def test_dispatch_on_cpu():
    h, e, adj = (torch.from_numpy(a) for a in _inputs(2, 8, 32))
    with pytest.raises(ValueError, match="CUDA"):
        ops.message_pass(h, e, adj, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        ops.message_pass(h, e, adj, impl="pallas")
    want = message_pass_reference(h, e, adj)
    assert torch.equal(ops.message_pass(h, e, adj), want)
    assert torch.equal(ops.message_pass(h, e, adj, impl="ref"), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,Hd", SHAPES + [(5, 32, 128), (4, 9, 40)])
def test_kernel_matches_reference(cuda, B, N, Hd, dtype):
    h, e, adj = (torch.from_numpy(a).to(cuda) for a in _inputs(B, N, Hd))
    h, e = h.to(dtype), e.to(dtype)
    got = ops.message_pass(h, e, adj, impl="kernel")
    want = message_pass_reference(h, e, adj)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == h.shape
    tol = (1e-4, 1e-4) if dtype == torch.float32 else (BF16_RTOL, BF16_ATOL)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=tol[0], atol=tol[1])
