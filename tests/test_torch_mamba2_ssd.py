"""The port's Mamba2 SSD scan against the JAX package's: the Pallas kernel
(interpret mode, as tests/test_kernels.py runs it) and its jnp oracles, on
the sweep of tests/test_kernels.py::test_mamba2_ssd_kernel plus a second
G=2 case. In f32 the port's plain versions agree with the JAX ones to
rtol = atol = 1e-4 (sums in other orders); in bf16 to the JAX test's 1e-1
(the Pallas body rounds the decayed scores to bf16 before the second
product, the plain versions do not). The CUDA kernel itself is held against
the plain version on a CUDA device only:

    python -m pytest -q -m cuda tests/test_torch_mamba2_ssd.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.mamba2_ssd import mamba2_ssd, ops, ref

# (B, L, H, P, G, N, Q)
CASES = [
    (2, 256, 4, 32, 1, 16, 64),
    (1, 128, 8, 64, 2, 32, 128),
    (2, 256, 4, 32, 4, 16, 64),
    (2, 128, 4, 64, 2, 16, 64),
]
# Shapes only the CUDA kernel's tests take: a prompt shorter than one tile
# (Q = L = 37), the reduced zamba2 layer (P=64, N=16, Q=64), and N=64 at
# the serving chunk.
KERNEL_ONLY = [
    (2, 37, 4, 64, 1, 16, 64),
    (2, 128, 4, 64, 1, 16, 64),
    (1, 256, 8, 64, 1, 64, 128),
]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-1}
KERNEL_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-1}   # tests/test_kernels.py


def _inputs(B, L, H, P, G, N, seed=0):
    """x, log_a (<= 0, f32), b, c, initial state, as numpy f32."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, L, H, P)).astype(np.float32),
            (-np.abs(rng.standard_normal((B, L, H))) * 0.3).astype(np.float32),
            rng.standard_normal((B, L, G, N)).astype(np.float32),
            rng.standard_normal((B, L, G, N)).astype(np.float32),
            rng.standard_normal((B, H, P, N)).astype(np.float32))


def _torch(arrays, dtype, device="cpu"):
    """x, b and c in ``dtype``; log_a and the state stay f32."""
    x, la, b, c, s0 = (torch.from_numpy(a).to(device) for a in arrays)
    return x.to(dtype), la, b.to(dtype), c.to(dtype), s0


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_versions_match_jax(case, dtype):
    import jax.numpy as jnp
    from repro.kernels.mamba2_ssd import ref as jax_ref
    from repro.kernels.mamba2_ssd.mamba2_ssd import ssd_pallas
    *shape, Q = case
    arrays = _inputs(*shape)
    jx, jla, jb, jc, js0 = (jnp.asarray(a) for a in arrays)
    jx, jb, jc = (t.astype(jnp.dtype(dtype)) for t in (jx, jb, jc))
    x, la, b, c, s0 = _torch(arrays, DTYPES[dtype])
    tol = TOL[DTYPES[dtype]]
    got_c = ref.ssd_chunked(x, la, b, c, s0, chunk=Q)
    got_n = ref.ssd_naive(x, la, b, c, s0)
    for got in (got_c, got_n):
        assert got[0].dtype == x.dtype and got[0].shape == x.shape
        assert got[1].dtype == torch.float32 and got[1].shape == s0.shape
    for want in (jax_ref.ssd_chunked(jx, jla, jb, jc, js0, chunk=Q),
                 jax_ref.ssd_naive(jx, jla, jb, jc, js0),
                 ssd_pallas(jx, jla, jb, jc, js0, chunk=Q)):
        for got in (got_c, got_n):
            _close(got[0], want[0], tol)
            _close(got[1], want[1], tol)


def test_plain_versions_agree_over_many_chunks():
    """Strong decay and eight chunks of 32: the chunked carry against the
    step-by-step scan (tests/test_kernels.py::test_mamba2_chunked_ref_matches_naive)."""
    x, la, b, c, s0 = _torch(_inputs(2, 256, 4, 16, 2, 8, seed=1), torch.float32)
    y1, s1 = ref.ssd_chunked(x, la * 3.0, b, c, s0, chunk=32)
    y2, s2 = ref.ssd_naive(x, la * 3.0, b, c, s0)
    torch.testing.assert_close(y1, y2, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s1, s2, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_step_matches_jax(G):
    import jax.numpy as jnp
    from repro.kernels.mamba2_ssd import ref as jax_ref
    x, la, b, c, s0 = _inputs(3, 1, 4, 32, G, 16, seed=2)
    want = jax_ref.ssd_step(*(jnp.asarray(a[:, 0]) for a in (x, la, b, c)),
                            jnp.asarray(s0))
    got = ops.ssd_step(*(torch.from_numpy(a[:, 0]) for a in (x, la, b, c)),
                       torch.from_numpy(s0))
    _close(got[0], want[0], 1e-5)
    _close(got[1], want[1], 1e-5)
    # one step of the scan is the decode step
    y, s = ref.ssd_naive(*(torch.from_numpy(a) for a in (x, la, b, c, s0)))
    torch.testing.assert_close(got[0], y[:, 0])
    torch.testing.assert_close(got[1], s)


def test_dispatch_on_cpu():
    x, la, b, c, s0 = _torch(_inputs(1, 128, 4, 32, 1, 16), torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd(x, la, b, c, s0, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        mamba2_ssd.ssd_cuda(x, la, b, c, s0)
    with pytest.raises(ValueError, match="impl"):
        ops.ssd(x, la, b, c, s0, impl="pallas")
    want = ref.ssd_chunked(x, la, b, c, s0, chunk=64)
    for impl in (None, "ref"):
        got = ops.ssd(x, la, b, c, s0, impl=impl, chunk=64)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = ops.ssd(x, la, b, c, s0, impl="naive")
    assert all(torch.equal(g, w) for g, w in zip(got, ref.ssd_naive(x, la, b, c, s0)))
    # no initial state: zeros
    got = ops.ssd(x, la, b, c, chunk=64)
    want = ref.ssd_chunked(x, la, b, c, torch.zeros_like(s0), chunk=64)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("la_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES + KERNEL_ONLY, ids=str)
def test_kernel_matches_plain_version(cuda, case, dtype, la_dtype):
    *shape, Q = case
    x, la, b, c, s0 = _torch(_inputs(*shape), DTYPES[dtype], cuda)
    la = la.to(DTYPES[la_dtype])
    before = mamba2_ssd.LAUNCHES
    y, s = ops.ssd(x, la, b, c, s0, impl="kernel", chunk=Q)
    y_want, s_want = ref.ssd_chunked(x, la, b, c, s0, chunk=Q)
    torch.cuda.synchronize()
    assert mamba2_ssd.LAUNCHES == before + 1
    assert y.dtype == x.dtype and y.shape == x.shape
    assert s.dtype == torch.float32 and s.shape == s0.shape
    tol = KERNEL_TOL[DTYPES[dtype]]
    torch.testing.assert_close(y.float(), y_want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(s, s_want, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_kernel_reads_strided_inputs(cuda):
    """x, b and c as slices of one packed (B,L,H*P+2N) projection, log_a as a
    column slice, as the Mamba2 block could hand them over."""
    B, L, H, P, N = 2, 256, 4, 64, 32
    gen = torch.Generator(cuda).manual_seed(0)
    packed = torch.randn(B, L, H * P + 2 * N + 3, device=cuda, generator=gen)
    x = packed[..., :H * P].unflatten(-1, (H, P))
    b = packed[..., H * P:H * P + N].unflatten(-1, (1, N))
    c = packed[..., H * P + N:H * P + 2 * N].unflatten(-1, (1, N))
    la = torch.rand(B, L, H + 2, device=cuda, generator=gen).neg_()[..., 1:H + 1]
    assert not (x.is_contiguous() or b.is_contiguous() or la.is_contiguous())
    y, s = mamba2_ssd.ssd_cuda(x, la, b, c, chunk=128)
    y_want, s_want = ref.ssd_chunked(x, la, b, c, chunk=128)
    torch.testing.assert_close(y, y_want, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(s, s_want, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    x, la, b, c, s0 = _torch(_inputs(1, 256, 2, 32, 1, 16), torch.float32, cuda)
    with pytest.raises(ValueError, match="divide"):
        ops.ssd(x[:, :96], la[:, :96], b[:, :96], c[:, :96], s0, impl="kernel",
                chunk=64)
    with pytest.raises(ValueError, match="divide"):
        ops.ssd(x, la, b, c, s0, impl="kernel", chunk=256)
    with pytest.raises(ValueError, match="P in"):
        ops.ssd(x[..., :16], la, b, c, s0[:, :, :16], impl="kernel")
    with pytest.raises(TypeError, match="dtype"):
        ops.ssd(x.half(), la, b.half(), c.half(), s0, impl="kernel")


# The bf16 tensor-core kernel: every (P, N) it takes with G in {1, 2, 4} at
# the serving chunk, a prompt shorter than one chunk (L = Q = 37), and
# L = 1000 in chunks of 125 (the kernel works in its own 64-step chunks
# whatever Q is, so its last chunk holds 40 steps and the rows past L are
# masked out).
BF16_SWEEP = [(2, 256, 4, P, G, N, 128) for P in (32, 64) for N in (16, 32, 64)
              for G in (1, 2, 4)]
BF16_RAGGED = [(2, 37, 4, 64, 1, 64, 128), (1, 1000, 4, 64, 2, 64, 125),
               (1, 1000, 2, 32, 1, 16, 125)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_SWEEP + BF16_RAGGED, ids=str)
def test_bf16_kernel_matches_plain_version(cuda, case):
    """The wgmma kernel with a random initial state and a bf16 log decay, as
    the model passes it; it must be the kernel that ran."""
    *shape, Q = case
    x, la, b, c, s0 = _torch(_inputs(*shape, seed=3), torch.bfloat16, cuda)
    la = la.bfloat16()
    before = dict(mamba2_ssd.LAUNCHES_BY_DESIGN)
    y, s = ops.ssd(x, la, b, c, s0, impl="kernel", chunk=Q)
    y_want, s_want = ref.ssd_chunked(x, la, b, c, s0, chunk=Q)
    torch.cuda.synchronize()
    assert mamba2_ssd.LAUNCHES_BY_DESIGN["wgmma+tma"] == before["wgmma+tma"] + 1
    assert mamba2_ssd.LAUNCHES_BY_DESIGN["fma"] == before["fma"]
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    tol = KERNEL_TOL[torch.bfloat16]
    torch.testing.assert_close(y.float(), y_want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(s, s_want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_design_follows_dtype(cuda, dtype):
    """Dispatch is by dtype alone: bf16 reaches the wgmma kernel, f32 the
    CUDA-core one, and nothing else runs."""
    x, la, b, c, s0 = _torch(_inputs(1, 128, 2, 64, 1, 64), DTYPES[dtype], cuda)
    before = dict(mamba2_ssd.LAUNCHES_BY_DESIGN)
    ops.ssd(x, la, b, c, s0, impl="kernel", chunk=128)
    torch.cuda.synchronize()
    want = "wgmma+tma" if dtype == "bfloat16" else "fma"
    assert {k: v - before[k] for k, v in mamba2_ssd.LAUNCHES_BY_DESIGN.items()} \
        == {d: int(d == want) for d in mamba2_ssd.DESIGNS}


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 3])
def test_bf16_kernel_reads_packed_strided_inputs(cuda, offset):
    """bf16 x, b and c as slices of one packed (B,L,offset+H*P+2N) tensor:
    at offset 0 TMA reads them in place, at offset 3 (bases and strides off
    16 bytes) the binding copies them first."""
    B, L, H, P, N = 2, 256, 4, 64, 32
    gen = torch.Generator(cuda).manual_seed(1)
    width = offset + H * P + 2 * N + (8 if offset == 0 else 3)
    packed = torch.randn(B, L, width, device=cuda, generator=gen).bfloat16()
    x = packed[..., offset:offset + H * P].unflatten(-1, (H, P))
    b = packed[..., offset + H * P:offset + H * P + N].unflatten(-1, (1, N))
    c = packed[..., offset + H * P + N:offset + H * P + 2 * N].unflatten(-1, (1, N))
    la = torch.rand(B, L, H + 2, device=cuda, generator=gen).neg_()[..., 1:H + 1]
    s0 = torch.randn(B, H, P, N, device=cuda, generator=gen)
    assert not (x.is_contiguous() or b.is_contiguous() or la.is_contiguous())
    y, s = mamba2_ssd.ssd_cuda(x, la, b, c, s0, chunk=128)
    y_want, s_want = ref.ssd_chunked(x, la, b, c, s0, chunk=128)
    tol = KERNEL_TOL[torch.bfloat16]
    torch.testing.assert_close(y.float(), y_want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(s, s_want, rtol=tol, atol=tol)
