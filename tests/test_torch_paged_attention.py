"""Port parity: paged decode attention.

On the CPU the port's ``ops.paged_attention`` runs its plain version
(``ref.paged_attention_reference``); it must agree with the JAX package's
Pallas kernel in interpret mode and with its reference on the
``tests/test_kernels.py`` shapes, within 2e-5 in f32 and 2e-2 in bf16.
Lengths are drawn >= 1 there; a sequence of length 0 gives 0 in the
kernels (JAX's and the port's) and NaN in the plain versions (JAX's and the
port's), each pinned below.

The CUDA kernel is held against the plain version on the card by the tests
marked ``gpu`` (``pytest -m gpu`` there); this file imports without JAX for
them."""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from repro.kernels.paged_attention.ops import paged_attention as jpaged
    from repro.kernels.paged_attention.ref import paged_attention_reference as jref
except ImportError:  # the card's machine has no JAX; its gpu tests need none
    jnp = None
from repro_torch.kernels.paged_attention import ops as tops
from repro_torch.kernels.paged_attention import ref as tref

SHAPES = [  # B, H, Hk, D, page, P, N (tests/test_kernels.py:156-163)
    (2, 4, 2, 64, 16, 4, 32),
    (1, 8, 8, 32, 8, 8, 64),
    (3, 4, 1, 64, 16, 3, 16),
]
# head dims 112 (zamba2_7b G = 1, kimi_k2_1t_a32b G = 8) and 16 (every
# reduced config)
NEW_DIM_SHAPES = [
    (2, 8, 1, 112, 16, 4, 24),
    (2, 4, 4, 112, 8, 5, 20),
    (3, 4, 2, 16, 16, 4, 32),
    (2, 8, 1, 16, 8, 6, 40),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, seed, *, min_len=1):
    B, H, Hk, D, page, P, N = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, D)).astype(np.float32),
            rng.standard_normal((N, page, Hk, D)).astype(np.float32),
            rng.standard_normal((N, page, Hk, D)).astype(np.float32),
            rng.integers(0, N, (B, P)).astype(np.int32),
            rng.integers(min_len, P * page + 1, (B,)).astype(np.int32))


def _torch(arrays, dtype, device="cpu"):
    q, kp, vp, pt, ln = (torch.from_numpy(x).to(device) for x in arrays)
    return (q.to(TORCH_DTYPES[dtype]), kp.to(TORCH_DTYPES[dtype]),
            vp.to(TORCH_DTYPES[dtype]), pt, ln)


def _jax(arrays, dtype):
    q, kp, vp, pt, ln = arrays
    jd = getattr(jnp, dtype)
    return (jnp.asarray(q).astype(jd), jnp.asarray(kp).astype(jd), jnp.asarray(vp).astype(jd),
            jnp.asarray(pt), jnp.asarray(ln))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES + NEW_DIM_SHAPES)
def test_plain_matches_pallas_interpret_and_reference(shape, dtype):
    arrays = _inputs(shape, seed=sum(shape))
    j = _jax(arrays, dtype)
    want_kernel = np.asarray(jpaged(*j, interpret=True, use_pallas=True), np.float32)
    want_ref = np.asarray(jref(*j), np.float32)
    got = tops.paged_attention(*_torch(arrays, dtype))
    assert got.dtype == TORCH_DTYPES[dtype] and tuple(got.shape) == arrays[0].shape
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want_kernel, atol=tol, rtol=tol)
    np.testing.assert_allclose(got.float().numpy(), want_ref, atol=tol, rtol=tol)


def test_page_ids_out_of_range_are_clipped():
    """As the JAX reference clips them.  The JAX kernel does not promise
    that (its page table feeds a BlockSpec index map; in interpret mode an
    out-of-range id reads another page), so it is not compared here."""
    arrays = list(_inputs(SHAPES[0], seed=5))
    N = SHAPES[0][-1]
    arrays[3] = np.array([[-3, 0, N + 4, 7], [N - 1, N, 2, -1]], np.int32)
    j = _jax(arrays, "float32")
    got = tops.paged_attention(*_torch(arrays, "float32")).numpy()
    np.testing.assert_allclose(got, np.asarray(jref(*j)), atol=2e-5, rtol=2e-5)


def test_length_zero_plain_gives_nan_as_the_jax_reference_does():
    arrays = list(_inputs(SHAPES[0], seed=6))
    arrays[4] = np.array([0, 17], np.int32)
    got = tops.paged_attention(*_torch(arrays, "float32")).numpy()
    want = np.asarray(jref(*_jax(arrays, "float32")))
    assert np.isnan(want[0]).all() and np.isnan(got[0]).all()
    np.testing.assert_allclose(got[1], want[1], atol=2e-5, rtol=2e-5)


def test_length_zero_jax_kernel_gives_zero():
    """The behaviour the port's kernel follows (held on the card by
    ``test_kernel_gives_zero_for_length_zero_on_card``)."""
    arrays = list(_inputs(SHAPES[0], seed=6))
    arrays[4] = np.array([0, 17], np.int32)
    want = np.asarray(jpaged(*_jax(arrays, "float32"), interpret=True, use_pallas=True))
    assert (want[0] == 0).all()


def test_cuda_tensor_never_runs_the_plain_version(monkeypatch):
    monkeypatch.setattr(tops, "_on_cuda", lambda t: True)

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(tops, "paged_attention_reference", no_plain)
    before = tops.paged_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        tops.paged_attention(*_torch(_inputs(SHAPES[0], seed=1), "float32"))
    assert tops.paged_attention.launches == before


# ------------------------------ on the card ---------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with pytest -m gpu")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES + NEW_DIM_SHAPES + [(4, 16, 8, 128, 16, 33, 140),
                                            (4, 64, 8, 112, 16, 33, 140),
                                            (2, 32, 32, 112, 16, 9, 20),
                                            (4, 4, 2, 16, 16, 33, 140),
                                            (2, 16, 2, 128, 16, 5, 12)])
def test_kernel_matches_plain_on_card(shape, dtype):
    _card()
    args = _torch(_inputs(shape, seed=sum(shape)), dtype, "cuda")
    before = tops.paged_attention.launches
    got = tops.paged_attention(*args)
    assert tops.paged_attention.launches == before + 1
    want = tref.paged_attention_reference(*args)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_kernel_gives_zero_for_length_zero_on_card():
    _card()
    arrays = list(_inputs(SHAPES[0], seed=6))
    arrays[4] = np.array([0, 17], np.int32)
    args = _torch(arrays, "float32", "cuda")
    got = tops.paged_attention(*args)
    want = tref.paged_attention_reference(*args)
    assert (got[0] == 0).all()
    torch.testing.assert_close(got[1], want[1], atol=2e-5, rtol=2e-5)
