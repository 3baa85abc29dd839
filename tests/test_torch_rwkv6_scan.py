"""The port's RWKV6 WKV scan against the JAX package's: the Pallas kernel
(interpret mode, as tests/test_kernels.py runs it) and its jnp oracles, on
the sweep of tests/test_kernels.py::test_rwkv6_kernel plus a three-chunk
case, with a random initial state and a random bonus u. In f32 the port's
plain versions agree with the JAX ones to rtol = atol = 1e-4, the JAX
test's tolerance (sums in other orders). In bf16 (r, k, v and log_w in
bf16, as serving prefill passes them) every version computes in f32 from
the same bf16 inputs and rounds y once to bf16, so y may differ by one bf16
ulp of the largest |y| (``_bf16_ulp``); the f32 state keeps 1e-4. The CUDA
kernel itself is held against the plain version on a CUDA device only:

    python -m pytest -q -m cuda tests/test_torch_rwkv6_scan.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.rwkv6_scan import ops, ref, rwkv6_scan

# (B, L, H, K, V, Q)
CASES = [
    (2, 128, 4, 32, 32, 64),
    (1, 128, 2, 64, 64, 32),
    (2, 192, 2, 32, 32, 64),
]
# Shapes only the CUDA kernel's tests take: a prompt shorter than one chunk
# (Q = L = 37), the reduced rwkv6 layer (H=4, K=32, Q=64) and a chunk of 16.
KERNEL_ONLY = [
    (2, 37, 4, 64, 64, 64),
    (2, 128, 4, 32, 32, 64),
    (1, 256, 3, 64, 64, 16),
]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = 1e-4


def _inputs(B, L, H, K, V, seed=0, decay=2.0):
    """r, k, v, log_w = -decay |normal|, u = 0.5 normal, initial state, as
    numpy f32 (the JAX kernel test's draws)."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal
    return (n((B, L, H, K)).astype(np.float32),
            n((B, L, H, K)).astype(np.float32),
            n((B, L, H, V)).astype(np.float32),
            (-np.abs(n((B, L, H, K))) * decay).astype(np.float32),
            (n((H, K)) * 0.5).astype(np.float32),
            n((B, H, K, V)).astype(np.float32))


def _torch(arrays, dtype, device="cpu"):
    """r, k, v and log_w in ``dtype``; u and the state stay f32."""
    r, k, v, lw, u, s0 = (torch.from_numpy(a).to(device) for a in arrays)
    return r.to(dtype), k.to(dtype), v.to(dtype), lw.to(dtype), u, s0


def _bf16_ulp(t) -> float:
    """One bf16 ulp (8 significant bits) at the largest |t|."""
    return 2.0 ** (math.floor(math.log2(float(np.abs(np.asarray(t, np.float32)).max()))) - 7)


def _close_y(got, want, dtype):
    want = np.asarray(want, np.float32)
    tol = TOL if dtype == torch.float32 else _bf16_ulp(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL, atol=tol)


def _close(got, want, tol=TOL):
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
    from repro.kernels.rwkv6_scan import ref as jax_ref
    from repro.kernels.rwkv6_scan.rwkv6_scan import wkv6_pallas
    *shape, Q = case
    arrays = _inputs(*shape)
    jr, jk, jv, jlw, ju, js0 = (jnp.asarray(a) for a in arrays)
    jr, jk, jv, jlw = (t.astype(jnp.dtype(dtype)) for t in (jr, jk, jv, jlw))
    r, k, v, lw, u, s0 = _torch(arrays, DTYPES[dtype])
    got_c = ref.wkv6_chunked(r, k, v, lw, u, s0, chunk=Q)
    got_n = ref.wkv6_naive(r, k, v, lw, u, s0)
    for got in (got_c, got_n):
        assert got[0].dtype == r.dtype and got[0].shape == v.shape
        assert got[1].dtype == torch.float32 and got[1].shape == s0.shape
    for want in (jax_ref.wkv6_chunked(jr, jk, jv, jlw, ju, js0, chunk=Q),
                 jax_ref.wkv6_naive(jr, jk, jv, jlw, ju, js0),
                 wkv6_pallas(jr, jk, jv, jlw, ju, js0, chunk=Q)):
        for got in (got_c, got_n):
            _close_y(got[0], want[0], DTYPES[dtype])
            _close(got[1], want[1])


def test_strong_decay_stays_finite_and_exact():
    """log_w = -11.9 |normal| over four chunks of 64: the chunked carry
    against the step-by-step scan, in both packages
    (tests/test_kernels.py::test_rwkv6_chunked_ref_strong_decay_stable)."""
    import jax.numpy as jnp
    from repro.kernels.rwkv6_scan import ref as jax_ref
    arrays = _inputs(1, 256, 2, 16, 16, seed=1, decay=11.9)
    r, k, v, lw, u, _ = _torch(arrays, torch.float32)
    y1, s1 = ref.wkv6_chunked(r, k, v, lw, u, chunk=64)
    y2, s2 = ref.wkv6_naive(r, k, v, lw, u)
    assert bool(torch.isfinite(y1).all()) and bool(torch.isfinite(s1).all())
    torch.testing.assert_close(y1, y2, rtol=TOL, atol=TOL)
    torch.testing.assert_close(s1, s2, rtol=TOL, atol=TOL)
    want = jax_ref.wkv6_naive(*(jnp.asarray(a) for a in arrays[:5]))
    _close(y1, want[0])
    _close(s1, want[1])


@pytest.mark.parametrize("chunk_sub", [None, (32, 8)], ids=["Q-16", "32-8"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_subchunked_matches_jax(case, chunk_sub):
    """The chunked arrangement of the bf16 kernel (sub-chunks, factored
    off-diagonal decays, exact diagonal blocks), in f32, against the JAX
    Pallas kernel and ``wkv6_chunked``: with the case's chunk in 16-step
    sub-chunks, and in the kernel's own 32-step chunks of 8-step blocks."""
    import jax.numpy as jnp
    from repro.kernels.rwkv6_scan import ref as jax_ref
    from repro.kernels.rwkv6_scan.rwkv6_scan import wkv6_pallas
    *shape, Q = case
    arrays = _inputs(*shape)
    chunk, sub = chunk_sub or (Q, 16)
    got = ref.wkv6_subchunked(*_torch(arrays, torch.float32), chunk=chunk, sub=sub)
    assert bool(torch.isfinite(got[0]).all()) and bool(torch.isfinite(got[1]).all())
    jargs = [jnp.asarray(a) for a in arrays]
    for want in (wkv6_pallas(*jargs, chunk=Q),
                 jax_ref.wkv6_chunked(*jargs, chunk=Q)):
        _close(got[0], want[0])
        _close(got[1], want[1])


def test_subchunked_strong_decay_matches_jax():
    """log_w = -11.9 |normal|, whose per-step logs reach below -40: every
    value finite and within 1e-4 of both JAX versions."""
    import jax.numpy as jnp
    from repro.kernels.rwkv6_scan import ref as jax_ref
    from repro.kernels.rwkv6_scan.rwkv6_scan import wkv6_pallas
    arrays = _inputs(1, 256, 2, 16, 16, seed=1, decay=11.9)
    assert arrays[3].min() < -40
    got = ref.wkv6_subchunked(*_torch(arrays, torch.float32), chunk=64)
    assert bool(torch.isfinite(got[0]).all()) and bool(torch.isfinite(got[1]).all())
    jargs = [jnp.asarray(a) for a in arrays]
    for want in (wkv6_pallas(*jargs, chunk=64),
                 jax_ref.wkv6_chunked(*jargs, chunk=64)):
        _close(got[0], want[0])
        _close(got[1], want[1])


@pytest.mark.parametrize("K", [32, 64])
def test_wkv6_step_matches_jax(K):
    import jax.numpy as jnp
    from repro.kernels.rwkv6_scan import ref as jax_ref
    r, k, v, lw, u, s0 = _inputs(3, 1, 4, K, K, seed=2)
    want = jax_ref.wkv6_step(*(jnp.asarray(a[:, 0]) for a in (r, k, v, lw)),
                             jnp.asarray(u), jnp.asarray(s0))
    got = ops.wkv6_step(*(torch.from_numpy(a[:, 0]) for a in (r, k, v, lw)),
                        torch.from_numpy(u), torch.from_numpy(s0))
    _close(got[0], want[0], 1e-5)
    _close(got[1], want[1], 1e-5)
    # one step of the scan is the decode step
    y, s = ref.wkv6_naive(*(torch.from_numpy(a) for a in (r, k, v, lw, u, s0)))
    torch.testing.assert_close(got[0], y[:, 0])
    torch.testing.assert_close(got[1], s)


def test_dispatch_on_cpu():
    r, k, v, lw, u, s0 = _torch(_inputs(1, 128, 2, 32, 32), torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.wkv6(r, k, v, lw, u, s0, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_scan.wkv6_cuda(r, k, v, lw, u, s0)
    with pytest.raises(ValueError, match="impl"):
        ops.wkv6(r, k, v, lw, u, s0, impl="pallas")
    want = ref.wkv6_chunked(r, k, v, lw, u, s0, chunk=64)
    for impl in (None, "ref"):
        got = ops.wkv6(r, k, v, lw, u, s0, impl=impl, chunk=64)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = ops.wkv6(r, k, v, lw, u, s0, impl="naive")
    assert all(torch.equal(g, w)
               for g, w in zip(got, ref.wkv6_naive(r, k, v, lw, u, s0)))
    # no initial state: zeros
    got = ops.wkv6(r, k, v, lw, u, chunk=64)
    want = ref.wkv6_chunked(r, k, v, lw, u, torch.zeros_like(s0), chunk=64)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("lw_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES + KERNEL_ONLY, ids=str)
def test_kernel_matches_plain_version(cuda, case, dtype, lw_dtype):
    *shape, Q = case
    r, k, v, lw, u, s0 = _torch(_inputs(*shape), DTYPES[dtype], cuda)
    lw = lw.to(DTYPES[lw_dtype])
    before = rwkv6_scan.LAUNCHES
    y, s = ops.wkv6(r, k, v, lw, u, s0, impl="kernel", chunk=Q)
    y_want, s_want = ref.wkv6_chunked(r, k, v, lw, u, s0, chunk=Q)
    torch.cuda.synchronize()
    assert rwkv6_scan.LAUNCHES == before + 1
    assert y.dtype == r.dtype and y.shape == v.shape
    assert s.dtype == torch.float32 and s.shape == s0.shape
    atol = TOL if y.dtype == torch.float32 else _bf16_ulp(y_want.float().cpu())
    torch.testing.assert_close(y.float(), y_want.float(), rtol=TOL, atol=atol)
    torch.testing.assert_close(s, s_want, rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_kernel_strong_decay_and_no_initial_state(cuda):
    r, k, v, lw, u, _ = _torch(_inputs(1, 256, 2, 32, 32, seed=1, decay=11.9),
                               torch.float32, cuda)
    y, s = ops.wkv6(r, k, v, lw, u, impl="kernel")
    y_want, s_want = ref.wkv6_naive(r, k, v, lw, u)
    assert bool(torch.isfinite(y).all())
    torch.testing.assert_close(y, y_want, rtol=TOL, atol=TOL)
    torch.testing.assert_close(s, s_want, rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_kernel_reads_strided_inputs(cuda):
    """r, k, v and log_w as slices of one packed (B,L,4*H*K+3) tensor, and u
    in bf16, as a fused projection could hand them over."""
    B, L, H, K = 2, 128, 4, 64
    gen = torch.Generator(cuda).manual_seed(0)
    packed = torch.randn(B, L, 4 * H * K + 3, device=cuda, generator=gen)
    r, k, v, lw = (packed[..., i * H * K:(i + 1) * H * K].unflatten(-1, (H, K))
                   for i in range(4))
    lw = -lw.abs()
    assert not any(t.is_contiguous() for t in (r, k, v))
    u = torch.randn(H, K, device=cuda, generator=gen).bfloat16()
    s0 = torch.randn(B, H, K, K, device=cuda, generator=gen)
    y, s = rwkv6_scan.wkv6_cuda(r, k, v, lw, u, s0, chunk=64)
    y_want, s_want = ref.wkv6_chunked(r, k, v, lw, u, s0, chunk=64)
    torch.testing.assert_close(y, y_want, rtol=TOL, atol=TOL)
    torch.testing.assert_close(s, s_want, rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    r, k, v, lw, u, s0 = _torch(_inputs(1, 128, 2, 32, 32), torch.float32, cuda)
    with pytest.raises(ValueError, match="divide"):
        ops.wkv6(r[:, :96], k[:, :96], v[:, :96], lw[:, :96], u, s0,
                 impl="kernel", chunk=64)
    with pytest.raises(ValueError, match="divide"):
        ops.wkv6(r, k, v, lw, u, s0, impl="kernel", chunk=128)
    with pytest.raises(ValueError, match="K = V"):
        ops.wkv6(r[..., :16], k[..., :16], v[..., :16], lw[..., :16],
                 u[:, :16], s0[:, :, :16, :16], impl="kernel")
    with pytest.raises(ValueError, match="K = V"):
        ops.wkv6(r, k, v[..., :16], lw, u, s0[..., :16], impl="kernel")
    with pytest.raises(TypeError, match="dtype"):
        ops.wkv6(r.half(), k.half(), v.half(), lw, u, s0, impl="kernel")
    strided = r.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.wkv6(strided, k, v, lw, u, s0, impl="kernel")


# The bf16 tensor-core kernel off its 32-step chunks: L = 1000 in the
# contract's chunks of 8 (the kernel's last chunk holds 8 steps), L = 37,
# and K = 32.
BF16_CASES = [(1, 1000, 3, 64, 64, 8), (2, 37, 2, 64, 64, 64),
              (2, 100, 4, 32, 32, 50)]


def _hold_bf16(y, s, y_want, s_want):
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    torch.testing.assert_close(y.float(), y_want.float(), rtol=TOL,
                               atol=_bf16_ulp(y_want.float().cpu()))
    torch.testing.assert_close(s, s_want, rtol=TOL, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("lw_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BF16_CASES, ids=str)
def test_bf16_kernel_matches_plain_version(cuda, case, lw_dtype):
    *shape, Q = case
    r, k, v, lw, u, s0 = _torch(_inputs(*shape, seed=4), torch.bfloat16, cuda)
    lw = lw.to(DTYPES[lw_dtype])
    before = dict(rwkv6_scan.LAUNCHES_BY_DESIGN)
    y, s = ops.wkv6(r, k, v, lw, u, s0, impl="kernel", chunk=Q)
    y_want, s_want = ref.wkv6_chunked(r, k, v, lw, u, s0, chunk=Q)
    torch.cuda.synchronize()
    assert rwkv6_scan.LAUNCHES_BY_DESIGN["mma"] == before["mma"] + 1
    _hold_bf16(y, s, y_want, s_want)


@pytest.mark.cuda
@pytest.mark.parametrize("lw_dtype", ["float32", "bfloat16"])
def test_bf16_kernel_strong_decay(cuda, lw_dtype):
    """log_w = -11.9 |normal| (steps below -40) through the tensor-core
    kernel, with a random initial state: finite, and at the bf16 holds."""
    r, k, v, lw, u, s0 = _torch(_inputs(1, 256, 2, 64, 64, seed=1, decay=11.9),
                                torch.bfloat16, cuda)
    lw = lw.to(DTYPES[lw_dtype])
    assert float(lw.min()) < -40
    y, s = ops.wkv6(r, k, v, lw, u, s0, impl="kernel")
    y_want, s_want = ref.wkv6_naive(r, k, v, lw, u, s0)
    _hold_bf16(y, s, y_want, s_want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_design_follows_dtype(cuda, dtype):
    """Dispatch is by dtype alone: bf16 reaches the tensor-core kernel, f32
    the step kernel, and nothing else runs."""
    r, k, v, lw, u, s0 = _torch(_inputs(1, 128, 2, 64, 64), DTYPES[dtype], cuda)
    before = dict(rwkv6_scan.LAUNCHES_BY_DESIGN)
    ops.wkv6(r, k, v, lw, u, s0, impl="kernel")
    torch.cuda.synchronize()
    want = "mma" if dtype == "bfloat16" else "fma"
    assert {d: n - before[d] for d, n in rwkv6_scan.LAUNCHES_BY_DESIGN.items()} \
        == {d: int(d == want) for d in rwkv6_scan.DESIGNS}


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 3])
def test_bf16_kernel_reads_packed_strided_inputs(cuda, offset):
    """bf16 r, k, v and log_w as slices of one packed (B,L,offset+4*H*K+pad)
    tensor: at offset 0 the kernel reads them in place, at offset 3 (bases
    and strides off 16 bytes) the binding copies them first."""
    B, L, H, K = 2, 128, 4, 64
    gen = torch.Generator(cuda).manual_seed(0)
    width = offset + 4 * H * K + (8 if offset == 0 else 3)
    packed = torch.randn(B, L, width, device=cuda, generator=gen).bfloat16()
    packed[..., offset + 3 * H * K:offset + 4 * H * K].abs_().neg_()  # log_w <= 0
    r, k, v, lw = (packed[..., offset + i * H * K:offset + (i + 1) * H * K]
                   .unflatten(-1, (H, K)) for i in range(4))
    assert not any(t.is_contiguous() for t in (r, k, v, lw))
    u = torch.randn(H, K, device=cuda, generator=gen).bfloat16()
    s0 = torch.randn(B, H, K, K, device=cuda, generator=gen)
    y, s = rwkv6_scan.wkv6_cuda(r, k, v, lw, u, s0, chunk=64)
    y_want, s_want = ref.wkv6_chunked(r, k, v, lw, u, s0, chunk=64)
    _hold_bf16(y, s, y_want, s_want)
