"""Port parity: ssd_scan, the Mamba2 SSD chunked scan.

On the CPU the port's ``ops.ssd_scan`` runs its plain version
(``ref.ssd_chunked_batched``); it must agree with the JAX package's
``ssd_chunked_batched`` and with its Pallas kernel in interpret mode on the
``tests/test_kernels.py`` shapes, within 1e-4 absolute and relative (the
JAX package's own tolerance: the cumulative sums and products are taken in
another order).  The chunked and the sequential recurrence agree in both
packages.

The CUDA kernel is held against the plain version on the card by the tests
marked ``gpu`` (``pytest -m gpu`` there); this file imports without JAX for
them."""

import functools

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from repro.kernels.ssd_scan.ops import ssd_scan as jssd
    from repro.kernels.ssd_scan.ref import ssd_chunked as jchunked
    from repro.kernels.ssd_scan.ref import ssd_chunked_batched as jbatched
    from repro.kernels.ssd_scan.ref import ssd_sequential as jsequential
except ImportError:  # the card's machine has no JAX; its gpu tests need none
    jnp = None
from repro_torch.kernels.ssd_scan import kernel as tkernel
from repro_torch.kernels.ssd_scan import ops as tops
from repro_torch.kernels.ssd_scan import ref as tref

SHAPES = [(2, 256, 3, 32, 16), (1, 128, 2, 64, 64)]  # Bt, L, H, dh, N (test_kernels.py:188)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, seed):
    """The distributions of tests/test_kernels.py's ssd test."""
    Bt, L, H, dh, N = shape
    rng = np.random.default_rng(seed)
    return (
        (rng.standard_normal((Bt, L, H, dh)) * 0.5).astype(np.float32),
        rng.uniform(0.01, 0.2, (Bt, L, H)).astype(np.float32),
        rng.uniform(-1.0, -0.1, (H,)).astype(np.float32),
        (rng.standard_normal((Bt, L, N)) * 0.5).astype(np.float32),
        (rng.standard_normal((Bt, L, N)) * 0.5).astype(np.float32),
    )


def _torch(arrays, device="cpu", x_dtype="float32"):
    x, *rest = (torch.from_numpy(a).to(device) for a in arrays)
    return (x.to(TORCH_DTYPES[x_dtype]), *rest)


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.float().cpu().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _spy(monkeypatch, module, name):
    """Count the calls of ``module.name``; returns the list of calls."""
    calls, real = [], getattr(module, name)

    def spy(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


def _same_f32(got, want):
    """Two f32 evaluations of one function agree within f32 rounding: 1e-6
    of the largest magnitude (a CPU GEMM does not promise bit-equal results
    from call to call when other processes compete for the cores)."""
    tol = 1e-6 * max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret_and_reference(shape, chunk, monkeypatch):
    arrays = _inputs(shape, seed=sum(shape) + chunk)
    jargs = [jnp.asarray(a) for a in arrays]
    jy_ref, jS_ref = jbatched(*jargs, chunk=chunk)
    jy_k, jS_k = jssd(*jargs, chunk=chunk, interpret=True, use_pallas=True)
    plain_calls = _spy(monkeypatch, tops, "ssd_chunked_batched")
    before = tops.ssd_scan.launches
    ty, tS = tops.ssd_scan(*_torch(arrays), chunk=chunk)
    assert len(plain_calls) == 1 and tops.ssd_scan.launches == before  # the plain version ran
    assert ty.dtype == torch.float32 and tuple(ty.shape) == shape[:4]
    assert tS.dtype == torch.float32 and tuple(tS.shape) == (shape[0], shape[2], shape[4], shape[3])
    for got, want in ((ty, jy_ref), (ty, jy_k), (tS, jS_ref), (tS, jS_k)):
        _close(got, want)
    by, bS = tref.ssd_chunked_batched(*_torch(arrays), chunk=chunk)
    _same_f32(ty, by)
    _same_f32(tS, bS)


@functools.lru_cache(maxsize=None)
def _sequential(shape):
    """Inputs of ``shape`` and the per-token recurrence's (y, S) over every
    (batch, head); once per shape (the chunk does not enter it)."""
    x, dt, A, B, C = args = _torch(_inputs(shape, seed=sum(shape) + 1))
    Bt, _, H, _, _ = shape
    seq = [[tref.ssd_sequential(x[b, :, h], dt[b, :, h], A[h], B[b], C[b]) for h in range(H)]
           for b in range(Bt)]
    return (args, torch.stack([torch.stack([yh for yh, _ in row], dim=1) for row in seq]),
            torch.stack([torch.stack([Sh for _, Sh in row]) for row in seq]))


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("shape", SHAPES)
def test_chunk_parallel_order_matches_chunked_and_sequential(shape, chunk):
    """The CUDA kernels' order of work (each chunk's own state, the state
    pass, each chunk's output with ``C Bᵀ`` once per chunk), in plain torch,
    against the chunk loop and the per-token recurrence: within 1e-4 of the
    largest magnitude (f32 sums in another order)."""
    args, sy, sS = _sequential(shape)
    y, S = tref.ssd_chunk_parallel(*args, chunk=chunk)
    wy, wS = tref.ssd_chunked_batched(*args, chunk=chunk)
    for got, want in ((y, wy), (S, wS), (y, sy), (S, sS)):
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=0, atol=tol)


def test_chunked_equals_sequential_recurrence():
    """test_kernels.py's recurrence check, in both packages, with a carried
    initial state as well."""
    x, dt, A, B, C = _inputs((1, 256, 1, 32, 16), seed=11)
    x, dt, B, C, A = x[0, :, 0], dt[0, :, 0], B[0], C[0], float(A[0])
    S0 = np.random.default_rng(12).standard_normal((16, 32)).astype(np.float32)
    for init in (None, S0):
        ti = None if init is None else torch.from_numpy(init)
        ji = None if init is None else jnp.asarray(init)
        targs = [torch.from_numpy(a) for a in (x, dt)] + [A] + [torch.from_numpy(a) for a in (B, C)]
        jargs = [jnp.asarray(a) for a in (x, dt)] + [jnp.float32(A)] + [jnp.asarray(a) for a in (B, C)]
        y1, S1 = tref.ssd_sequential(*targs, init_state=ti)
        y2, S2 = tref.ssd_chunked(*targs, chunk=64, init_state=ti)
        jy1, jS1 = jsequential(*jargs, init_state=ji)
        jy2, jS2 = jchunked(*jargs, chunk=64, init_state=ji)
        for got, want in ((y1, y2), (S1, S2)):
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        for got, want in ((y1, jy1), (S1, jS1), (y2, jy2), (S2, jS2)):
            _close(got, want)


def test_plain_is_nan_free_when_decays_overflow():
    """Masking before the exp: with a steep decay the positive differences
    above the diagonal would overflow to inf, and inf * 0 is NaN."""
    x, dt, A, B, C = _inputs((1, 64, 2, 16, 16), seed=5)
    A = np.array([-60.0, -200.0], np.float32)
    y, S = tops.ssd_scan(*_torch((x, dt, A, B, C)), chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(S).all()
    jy, jS = jbatched(*(jnp.asarray(a) for a in (x, dt, A, B, C)), chunk=64)
    _close(y, jy)
    _close(S, jS)


@pytest.mark.parametrize("L,chunk", [(100, 64), (128, 96), (10, 4)])
def test_lengths_that_do_not_divide_raise(L, chunk):
    args = _torch(_inputs((1, L, 2, 16, 16), seed=L))
    with pytest.raises(ValueError, match="divide"):
        tops.ssd_scan(*args, chunk=chunk)
    with pytest.raises(ValueError, match="divide"):  # the JAX kernel raises the same
        jssd(*(jnp.asarray(t.numpy()) for t in args), chunk=chunk, interpret=True,
             use_pallas=True)


def test_cpu_keeps_x_dtype_like_the_kernel():
    """bf16 x gives bf16 y on every device, as the JAX Pallas kernel does;
    the plain version computes in f32."""
    arrays = _inputs((1, 64, 2, 16, 16), seed=3)
    y, S = tops.ssd_scan(*_torch(arrays, x_dtype="bfloat16"), chunk=32)
    assert y.dtype == torch.bfloat16 and S.dtype == torch.float32
    jargs = [jnp.asarray(arrays[0]).astype(jnp.bfloat16)] + [jnp.asarray(a) for a in arrays[1:]]
    jy, jS = jssd(*jargs, chunk=32, interpret=True, use_pallas=True)
    assert jy.dtype == jnp.bfloat16
    _close(y, np.asarray(jy, np.float32), TOL["bfloat16"])
    _close(S, jS, TOL["bfloat16"])


def test_cuda_tensor_never_runs_the_plain_version(monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel or raises (checked
    with a fake CUDA test, no card): here the launch refuses the CPU tensor,
    and neither the plain version nor the launch count moves."""
    monkeypatch.setattr(tops, "_on_cuda", lambda t: True)

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(tops, "ssd_chunked_batched", no_plain)
    args = _torch(_inputs((1, 64, 2, 16, 16), seed=1))
    before = tops.ssd_scan.launches
    with pytest.raises(ValueError, match="CUDA"):
        tops.ssd_scan(*args, chunk=64)
    assert tops.ssd_scan.launches == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No card-side compiler, no kernel: the build raises, nothing falls
    back to the plain version."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tkernel.SOURCE.build()
    assert not (tmp_path / "kernels").exists()


def test_rows_the_kernels_cannot_copy_16_bytes_at_a_time_are_copied_first():
    """The kernels move rows with 16-byte cp.async: an aligned view (the
    column slices ssm_apply hands over) goes as it is, a misaligned one as
    an aligned copy with the same values."""
    base = torch.arange(2 * 4 * 160, dtype=torch.float32).reshape(2, 4, 160)
    view = base[..., 32:48]  # B of (Bt, L, N): 128-byte offset, rows 640 bytes apart
    assert tkernel._aligned(view, 2) is view
    odd = base[..., 1:17]  # 4-byte offset
    got = tkernel._aligned(odd, 2)
    assert got is not odd and got.data_ptr() % 16 == 0 and torch.equal(got, odd)


def test_kernel_source_is_its_own_build():
    assert tkernel.SOURCE.source.name == "ssd_scan.cu"
    assert "arch=compute_90a,code=sm_90a" in tkernel.SOURCE.flags
    assert tkernel.SOURCE.library_path().name.startswith("ssd_scan_")


# ------------------------------ on the card ---------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with pytest -m gpu")


CARD_CASES = [  # Bt, L, H, dh, N, chunk
    *[(*s, c) for s in SHAPES for c in (1, 32, 64, 128)],
    (2, 5, 8, 16, 16, 5),  # the reduced mamba2_780m: chunk = prompt length
    (2, 100, 8, 16, 16, 100),
    (2, 256, 8, 16, 16, 128),
    (1, 96, 4, 32, 64, 48),
    (2, 256, 4, 64, 128, 128),  # mamba2_780m's widths
    (4, 512, 48, 64, 128, 128),  # its serve shape
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_matches_plain_on_card(case, dtype):
    _card()
    *shape, chunk = case
    args = _torch(_inputs(tuple(shape), seed=sum(case)), "cuda", dtype)
    before = tops.ssd_scan.launches
    y, S = tops.ssd_scan(*args, chunk=chunk)
    assert tops.ssd_scan.launches == before + 1
    wy, wS = tref.ssd_chunked_batched(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert y.dtype == args[0].dtype and y.is_cuda and S.dtype == torch.float32
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), wy, atol=tol, rtol=tol)
    torch.testing.assert_close(S, wS, atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("heads_per_block", [1, 2, 5, 8])
def test_heads_sharing_one_chunk_product_on_card(heads_per_block):
    """One block forms a chunk's C Bᵀ once and runs it over its heads, the
    next head's operands copied while this one computes; any number of
    heads per block (ragged last tile included) gives the plain result."""
    _card()
    args = _torch(_inputs((2, 256, 8, 64, 128), seed=heads_per_block), "cuda")
    y, S = tkernel.launch(*args, chunk=128, heads_per_block=heads_per_block)
    wy, wS = tref.ssd_chunked_batched(*args, chunk=128)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, wy, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(S, wS, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_kernel_takes_strided_views_on_card():
    """ssm_apply hands the kernel x, B and C as column slices of one
    (Bt, L, d_inner + 2N) tensor."""
    _card()
    Bt, L, H, dh, N = 2, 128, 4, 32, 16
    x, dt, A, B, C = _torch(_inputs((Bt, L, H, dh, N), seed=4), "cuda")
    xbc = torch.cat([x.reshape(Bt, L, H * dh), B, C], dim=-1)
    xv = xbc[..., :H * dh].reshape(Bt, L, H, dh)
    Bv, Cv = xbc[..., H * dh:H * dh + N], xbc[..., H * dh + N:]
    assert not xv.is_contiguous() and not Bv.is_contiguous()
    y, S = tops.ssd_scan(xv, dt, A, Bv, Cv, chunk=64)
    wy, wS = tref.ssd_chunked_batched(x, dt, A, B, C, chunk=64)
    torch.testing.assert_close(y, wy, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(S, wS, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,chunk,match", [
    ((1, 64, 2, 16, 8), 64, "state dim"),
    ((1, 64, 2, 16, 32), 64, "state dim"),
    ((1, 64, 2, 128, 16), 64, "head dim"),
    ((1, 256, 2, 16, 16), 256, "chunk"),
])
def test_kernel_refuses_unsupported_shapes_on_card(shape, chunk, match):
    _card()
    with pytest.raises(ValueError, match=match):
        tops.ssd_scan(*_torch(_inputs(shape, seed=0), "cuda"), chunk=chunk)
