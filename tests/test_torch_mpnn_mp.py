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

from repro_torch.kernels.mpnn_mp import mpnn_mp, ops
from repro_torch.kernels.mpnn_mp.ref import (message_pass_reference,
                                             message_pass_typed_reference)

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


def _typed_inputs(E, B, N, Hd, nb, *, per_member=False, masked=False,
                  seed=0):
    """h (E*B,N,Hd), bonds of every type 0..nb-1, edge_w (E,nb,Hd*Hd) and
    an adjacency that is random over all pairs (type 0 included), with
    masked atoms' rows and columns zeroed; bonds and adj (E,B,N,N) if
    per_member, else (B,N,N)."""
    rng = np.random.default_rng(seed)
    lead = (E, B) if per_member else (B,)
    h = rng.standard_normal((E * B, N, Hd)).astype(np.float32)
    bonds = rng.integers(0, nb, (*lead, N, N)).astype(np.int32)
    w = (0.1 * rng.standard_normal((E, nb, Hd * Hd))).astype(np.float32)
    adj = (rng.random((*lead, N, N)) > 0.5).astype(np.float32)
    if masked:
        mask = (rng.random((*lead, N)) > 0.3).astype(np.float32)
        adj *= mask[..., :, None] * mask[..., None, :]
        h *= np.broadcast_to(mask, (E, B, N)).reshape(E * B, N, 1)
    return tuple(map(torch.from_numpy, (h, bonds, w, adj)))


def _dense(h, bonds, w, adj):
    """The same step through ``message_pass_reference``, on the edge tensor
    edge_w[e, bonds] and the adjacency expanded to every member."""
    E, nb = w.shape[:2]
    N, Hd = h.shape[-2:]
    B = h.shape[0] // E
    oh = torch.nn.functional.one_hot(bonds.long(), nb).to(w.dtype)
    edge = torch.matmul(oh.reshape(-1, B * N * N, nb), w)
    edge = edge.reshape(E * B, N, N, Hd, Hd)
    adj = adj.expand(E, B, N, N).reshape(E * B, N, N)
    return message_pass_reference(h, edge, adj)


@pytest.mark.parametrize("N", [8, 16, 32])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("per_member", [False, True])
def test_typed_reference_matches_dense(N, masked, per_member):
    h, bonds, w, adj = _typed_inputs(3, 4, N, 24, 4, per_member=per_member,
                                     masked=masked)
    got = message_pass_typed_reference(h, bonds, w, adj)
    assert got.shape == h.shape and got.dtype == h.dtype
    np.testing.assert_allclose(got.numpy(), _dense(h, bonds, w, adj).numpy(),
                               rtol=1e-5, atol=1e-5)
    E, B = w.shape[0], h.shape[0] // w.shape[0]
    got4 = message_pass_typed_reference(h.reshape(E, B, N, 24), bonds, w, adj)
    assert torch.equal(got4.reshape(h.shape), got)


def test_typed_dispatch_on_cpu():
    h, bonds, w, adj = _typed_inputs(2, 3, 8, 16, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ops.message_pass_typed(h, bonds, w, adj, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        ops.message_pass_typed(h, bonds, w, adj, impl="pallas")
    want = message_pass_typed_reference(h, bonds, w, adj)
    assert torch.equal(ops.message_pass_typed(h, bonds, w, adj), want)
    assert torch.equal(ops.message_pass_typed(h, bonds, w, adj, impl="ref"),
                       want)


# (E, B, N, Hd, nb): every atom count and width the kernel takes at its
# edges (N 32, Hd 128 in two column tiles, Hd 40 and 72 off the 64-column
# tile, 3 bond types, 9 atoms leaving a row of the 64-row sub-tile empty),
# and enough molecules (600) that a block walks several sub-tiles.
TYPED_SHAPES = [(3, 5, 8, 32, 4), (2, 7, 16, 64, 4), (2, 3, 32, 128, 4),
                (2, 9, 9, 40, 3), (2, 5, 12, 72, 2), (2, 600, 16, 16, 4),
                (16, 20, 16, 64, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_member", [False, True])
@pytest.mark.parametrize("E,B,N,Hd,nb", TYPED_SHAPES)
def test_typed_kernel_matches_reference(cuda, E, B, N, Hd, nb, per_member,
                                        dtype):
    h, bonds, w, adj = (t.to(cuda) for t in _typed_inputs(
        E, B, N, Hd, nb, per_member=per_member, masked=True))
    h, w = h.to(dtype), w.to(dtype)
    got = ops.message_pass_typed(h, bonds, w, adj, impl="kernel")
    got4 = ops.message_pass_typed(h.reshape(E, B, N, Hd), bonds, w, adj,
                                  impl="kernel")
    want = _dense(h, bonds, w, adj)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == h.shape
    assert torch.equal(got4.reshape(h.shape), got)
    tol = (1e-5, 1e-5) if dtype == torch.float32 else (BF16_RTOL, BF16_ATOL)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=tol[0], atol=tol[1])


@pytest.mark.cuda
def test_typed_kernel_refuses_what_it_does_not_take(cuda):
    h, bonds, w, adj = (t.to(cuda) for t in _typed_inputs(2, 3, 8, 16, 4))
    for args, err in [((h, bonds.long(), w, adj), TypeError),
                      ((h, bonds, w.double(), adj), TypeError),
                      ((h, bonds, w[:, :, :-1].contiguous(), adj), ValueError),
                      ((h[1:], bonds, w, adj), ValueError),
                      ((h.transpose(1, 2).contiguous().transpose(1, 2),
                        bonds, w, adj), ValueError),
                      ((h, bonds, w.repeat(1, 2, 1), adj), ValueError)]:
        with pytest.raises(err):
            mpnn_mp.message_pass_typed_cuda(*args)
