"""The port's flash attention against the JAX package's: the Pallas kernel
(interpret mode, block 64 x 64, as tests/test_kernels.py runs it) and its
jnp oracle, on the six cases of tests/test_kernels.py::test_flash_attention,
in f32 and bf16, at that test's tolerances. The CUDA kernel itself is held
against the plain version on a CUDA device only:

    python -m pytest -q -m cuda tests/test_torch_flash_attention.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention, ops
from repro_torch.kernels.flash_attention.ref import attention_reference

# (B, Sq, Sk, H, KVH, hd, causal, window, softcap, q_offset)
CASES = [
    (2, 128, 128, 4, 2, 32, True, None, None, 0),
    (1, 256, 256, 4, 4, 64, True, 64, None, 0),
    (2, 128, 128, 8, 2, 32, True, None, 50.0, 0),
    (1, 128, 256, 4, 2, 32, True, None, None, 128),
    (2, 128, 128, 4, 1, 32, False, None, None, 0),
    (1, 64, 64, 2, 2, 128, True, 32, 30.0, 0),
]
SERVING = (8, 2048, 2048, 16, 8, 128, True, None, None, 0)   # internlm2-1.8b
# Ragged tiles, a prompt shorter than one tile, decode-like offsets and a
# window that starts inside a tile: shapes the TPU kernel refuses
# (Sq % block_q != 0) but the CUDA kernel masks.
RAGGED = [
    (2, 100, 100, 4, 2, 64, True, None, None, 0),
    (1, 7, 300, 4, 4, 128, True, None, None, 293),
    (3, 200, 200, 8, 1, 128, True, 50, None, 0),
    (1, 65, 130, 2, 1, 32, False, 33, 20.0, 0),
]
# Head dim 256 (gemma2-2b: GQA 8/4, window, softcap 50) off the tiles: a
# window that starts inside a KV tile, a ragged last tile, a decode-like
# offset, and a cap of 2, which moves these scores by O(1). Then the
# cross-attention shape of an enc-dec decoder at hd 64: non-causal, Sq != Sk.
HD256 = [
    (2, 300, 300, 8, 4, 256, True, 100, 50.0, 0),
    (1, 256, 256, 8, 4, 256, True, None, None, 0),
    (1, 37, 333, 8, 4, 256, True, None, None, 296),
    (1, 200, 200, 8, 4, 256, True, 70, 2.0, 0),
]
CROSS = [
    (2, 300, 200, 16, 16, 64, False, None, None, 0),
    (2, 128, 384, 4, 4, 64, False, None, None, 0),
]
# Head dim 112 (kimi-k2-1t-a32b), which the binding zero-pads to 128: the
# six cases of tests/test_kernels.py at hd 112, off the tiles (Sq = Sk =
# 1000; Sq = 37 at an offset), a window with a cap of 2, GQA 8, and a
# non-causal Sq != Sk.
HD112 = [(B, Sq, Sk, H, KVH, 112, c, w, cap, off)
         for (B, Sq, Sk, H, KVH, _, c, w, cap, off) in CASES] + [
    (1, 1000, 1000, 8, 1, 112, True, None, None, 0),
    (1, 37, 333, 8, 8, 112, True, None, None, 296),
    (1, 300, 300, 8, 4, 112, True, 70, 2.0, 0),
    (2, 200, 300, 4, 4, 112, False, None, None, 0),
]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py


def _inputs(B, Sq, Sk, H, KVH, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KVH, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KVH, hd)).astype(np.float32))


def _kw(case):
    causal, window, softcap, off = case[6:]
    return dict(causal=causal, window=window, softcap=softcap, q_offset=off)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_version_matches_jax_kernel(case, dtype):
    import jax.numpy as jnp
    from repro.kernels.flash_attention.flash_attention import \
        flash_attention as jax_flash
    from repro.kernels.flash_attention.ref import \
        attention_reference as jax_reference
    arrays = _inputs(*case[:6])
    jq, jk, jv = (jnp.asarray(a, jnp.dtype(dtype)) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(DTYPES[dtype]) for a in arrays)
    want = jax_flash(jq, jk, jv, block_q=64, block_k=64, **_kw(case))
    got = attention_reference(tq, tk, tv, **_kw(case))
    assert got.dtype == DTYPES[dtype] and got.shape == tq.shape
    assert torch.equal(ops.attention(tq, tk, tv, **_kw(case)), got)
    tol = TOL[DTYPES[dtype]]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(jax_reference(jq, jk, jv, **_kw(case)), np.float32),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", [HD256[1], (1, 128, 256, 8, 4, 256, True, 64,
                                            50.0, 128), CROSS[1]], ids=str)
def test_plain_version_matches_jax_kernel_at_new_shapes(case, dtype):
    """Head dim 256 with a window and gemma2's softcap, and the non-causal
    Sq != Sk cross shape, against the Pallas kernel in interpret mode (the
    shapes it takes: Sq and Sk multiples of its 128 blocks)."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention.flash_attention import \
        flash_attention as jax_flash
    arrays = _inputs(*case[:6], seed=2)
    jq, jk, jv = (jnp.asarray(a, jnp.dtype(dtype)) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(DTYPES[dtype]) for a in arrays)
    want = jax_flash(jq, jk, jv, **_kw(case))
    got = ops.attention(tq, tk, tv, **_kw(case))
    tol = TOL[DTYPES[dtype]]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_binding_takes_head_dim_256_only_beside_32_64_128():
    """The binding checks the head dim before the device: on CPU tensors the
    kernel's head dims 32-256, and the multiples of 8 it pads to one of
    them (96, 112), pass it and are refused for the device; hd 100, 264 or
    512 is refused for the head dim."""
    assert flash_attention.HEAD_DIMS == (32, 64, 128, 256)
    for hd in (32, 64, 96, 112, 128, 256):
        q = torch.zeros(1, 8, 2, hd)
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention.flash_attention_cuda(q, q, q)
    for hd in (100, 264, 512):
        q = torch.zeros(1, 8, 2, hd)
        with pytest.raises(ValueError, match="head_dim"):
            flash_attention.flash_attention_cuda(q, q, q)


@pytest.mark.parametrize("case", HD112, ids=str)
def test_zero_pad_to_128_is_exact(case):
    """The binding's route for hd 112: zero-pad q, k and v to the kernel's
    128 and scale by 112 ** -0.5. In the plain version that gives the
    unpadded attention in its first 112 columns and zeros after them."""
    hd = case[5]
    q, k, v = (torch.from_numpy(a) for a in _inputs(*case[:6]))
    causal, window, softcap, q_offset = case[6:]
    want = attention_reference(q, k, v, **_kw(case))
    pq, pk, pv = (torch.nn.functional.pad(t, (0, 128 - hd)) for t in (q, k, v))
    # the plain version scales by its input's head dim: undo 128 ** -0.5
    got = attention_reference(pq * (128 / hd) ** 0.5, pk, pv, **_kw(case))
    torch.testing.assert_close(got[..., :hd], want, rtol=2e-6, atol=2e-6)
    assert torch.equal(got[..., hd:], torch.zeros_like(got[..., hd:]))


def test_dispatch_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 64, 64, 2, 1, 32))
    with pytest.raises(ValueError, match="CUDA"):
        ops.attention(q, k, v, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="impl"):
        ops.attention(q, k, v, impl="pallas")
    assert torch.equal(ops.attention(q, k, v, impl="ref"),
                       attention_reference(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES + RAGGED + [SERVING] + HD256 + CROSS
                         + HD112, ids=str)
def test_kernel_matches_plain_version(cuda, case, dtype):
    q, k, v = (torch.from_numpy(a).to(cuda, DTYPES[dtype])
               for a in _inputs(*case[:6]))
    before = flash_attention.LAUNCHES
    got = ops.attention(q, k, v, impl="kernel", **_kw(case))
    want = attention_reference(q, k, v, **_kw(case))
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = TOL[DTYPES[dtype]]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_kernel_reads_strided_inputs(cuda):
    """q, k, v as head slices of one packed (B,S,H+2KVH,hd) projection."""
    B, S, H, KVH, hd = 2, 192, 8, 2, 128
    packed = torch.randn(B, S, H + 2 * KVH, hd, device=cuda,
                         generator=torch.Generator(cuda).manual_seed(0))
    q, k, v = packed[:, :, :H], packed[:, :, H:H + KVH], packed[:, :, H + KVH:]
    got = flash_attention.flash_attention_cuda(q, k, v, causal=True)
    want = attention_reference(q, k, v, causal=True)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 64, 2, 100, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention.flash_attention_cuda(q, q, q)
    q = torch.zeros(1, 64, 2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention.flash_attention_cuda(q, q, q)


# Shapes for the Hopper bf16 kernel (128-row query tiles, 128-key tiles):
# Sq/Sk off the tile (1000, 37, 1), q_offset with Sk > Sq, GQA groups 1, 2
# and 5, window with softcap at hd 64 and 128, hd 32 non-causal, and a
# decode-like offset with a ragged cache. The scores of these inputs have a
# standard deviation near 1: a cap of 30 or 50 moves them by about 1e-2, a
# cap of 2 or 3 by O(1), so the last three cases fail a kernel that skips
# the cap.
BF16_KERNEL = [
    (1, 1000, 1000, 4, 2, 128, True, None, None, 0),
    (2, 37, 37, 4, 4, 64, True, None, None, 0),
    (2, 1, 1, 2, 1, 32, True, None, None, 0),
    (1, 128, 256, 4, 2, 128, True, None, None, 128),
    (2, 300, 300, 10, 2, 128, True, None, None, 0),
    (1, 256, 256, 8, 8, 64, True, 100, 30.0, 0),
    (1, 300, 300, 4, 2, 128, True, 70, 50.0, 0),
    (2, 200, 200, 4, 4, 32, False, None, None, 0),
    (1, 37, 333, 4, 1, 64, True, None, None, 296),
    (1, 256, 256, 4, 2, 128, True, None, 2.0, 0),
    (1, 300, 300, 8, 8, 64, True, 100, 2.0, 0),
    (2, 200, 200, 4, 4, 32, True, None, 3.0, 0),
    (1, 1000, 1000, 8, 4, 256, True, None, None, 0),
    (2, 2048, 2048, 8, 4, 256, True, 1000, 50.0, 0),
    (2, 300, 200, 16, 16, 64, False, None, None, 0),
] + HD112


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_KERNEL, ids=str)
def test_bf16_kernel_matches_plain_version(cuda, case):
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16)
               for a in _inputs(*case[:6], seed=1))
    before = flash_attention.LAUNCHES
    got = ops.attention(q, k, v, impl="kernel", **_kw(case))
    want = attention_reference(q, k, v, **_kw(case))
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 112, 128, 256])
def test_bf16_kernel_reads_packed_strided_inputs(cuda, hd):
    """bf16 q, k, v as head slices of one packed (B,S,H+2KVH,hd) projection,
    read in place through the tensor maps."""
    B, S, H, KVH = 2, 200, 8, 2
    packed = torch.randn(B, S, H + 2 * KVH, hd, device=cuda,
                         generator=torch.Generator(cuda).manual_seed(hd)
                         ).bfloat16()
    q, k, v = packed[:, :, :H], packed[:, :, H:H + KVH], packed[:, :, H + KVH:]
    got = flash_attention.flash_attention_cuda(q, k, v, causal=True)
    want = attention_reference(q, k, v, causal=True)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_bf16_kernel_refuses_strides_tma_cannot_take(cuda):
    """A bf16 stride that is not a multiple of 8 elements (16 bytes) is
    refused, not copied."""
    q = torch.zeros(1, 64, 2, 68, device=cuda, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_attention.flash_attention_cuda(q, q, q)
