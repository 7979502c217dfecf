"""Port parity: flash_attention.

On the CPU the port's ``ops.flash_attention`` runs its plain version
(``ref.mha_reference``); it must agree with the JAX package's Pallas kernel
in interpret mode and with its ``mha_reference`` on the
``tests/test_kernels.py`` shapes, within 2e-5 in f32 and 2e-2 in bf16 (the
JAX package's own tolerances: the sums are taken in another order).

The CUDA kernel is held against the plain version on the card by the tests
marked ``gpu`` (``pytest -m gpu`` there); this file imports without JAX for
them."""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.kernels.flash_attention.ops import flash_attention as jflash
    from repro.kernels.flash_attention.ref import mha_reference as jref
    from repro.models import attention as jattention
except ImportError:  # the card's machine has no JAX; its gpu tests need none
    jnp = None
from repro_torch.kernels.flash_attention import kernel as tkernel
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import ref as tref

SHAPES = [  # B, H, Hk, Lq, Lk, D, causal (tests/test_kernels.py:113-122)
    (2, 4, 2, 128, 128, 64, True),
    (1, 4, 4, 256, 256, 32, True),
    (2, 2, 1, 128, 256, 64, True),  # decode-style Lq < Lk
    (1, 4, 2, 128, 128, 64, False),  # bidirectional (encoder)
]
# head dims 112 (zamba2_7b, kimi_k2_1t_a32b) and 16 (every reduced config)
NEW_DIM_SHAPES = [
    (1, 8, 1, 64, 64, 112, True),  # kimi's G = 8
    (1, 2, 2, 64, 128, 112, False),  # zamba2's G = 1
    (2, 4, 2, 64, 64, 16, True),
    (1, 4, 4, 64, 128, 16, True),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, seed):
    B, H, Hk, Lq, Lk, D, _ = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Lq, D)).astype(np.float32),
            rng.standard_normal((B, Hk, Lk, D)).astype(np.float32),
            rng.standard_normal((B, Hk, Lk, D)).astype(np.float32))


def _torch(x, dtype, device="cpu"):
    return torch.from_numpy(x).to(device=device, dtype=TORCH_DTYPES[dtype])


def _np(t):
    return t.float().cpu().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES + NEW_DIM_SHAPES)
def test_plain_matches_pallas_interpret_and_reference(shape, dtype):
    causal = shape[-1]
    q, k, v = _inputs(shape, seed=sum(shape[:6]))
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(x).astype(jd) for x in (q, k, v))
    want_kernel = np.asarray(jflash(jq, jk, jv, causal, 64, 64, True, True), np.float32)
    want_ref = np.asarray(jref(jq, jk, jv, causal=causal), np.float32)
    got = tops.flash_attention(*(_torch(x, dtype) for x in (q, k, v)), causal, 64, 64)
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == q.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), want_kernel, atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), want_ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("Lq,Lk,bq,bk", [(100, 128, 64, 64), (128, 96, 64, 64),
                                         (130, 130, 128, 128)])
def test_lengths_that_do_not_divide_raise(Lq, Lk, bq, bk):
    q = torch.zeros((1, 2, Lq, 32))
    k = torch.zeros((1, 2, Lk, 32))
    with pytest.raises(ValueError, match="divide"):
        tops.flash_attention(q, k, k, True, bq, bk)
    with pytest.raises(ValueError, match="divide"):  # the JAX kernel raises the same
        jflash(*(jnp.asarray(t.numpy()) for t in (q, k, k)), True, bq, bk, True, True)


# lengths 128 does not divide: square causal, Lq < Lk causal (q_offset = 200
# meets a partial tile), cross non-causal at Lq != Lk
RAGGED = [(1, 4, 2, 200, 200, 32, True), (1, 4, 4, 100, 300, 16, True),
          (2, 4, 4, 100, 300, 64, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RAGGED)
def test_no_blocks_take_any_length_as_jax_chunked(shape, dtype):
    """No blocks (the default), the kernel route of ``attention_apply``,
    refuses no length: the CPU tensor's plain version against the JAX
    ``mha_reference`` and the JAX default route's ``chunked_attention``
    (causal queries aligned to the end of the keys, ``q_offset = Lk - Lq``),
    where the JAX Pallas launcher raises."""
    B, H, Hk, Lq, Lk, D, causal = shape
    q, k, v = _inputs(shape, seed=sum(shape[:6]))
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(x).astype(jd) for x in (q, k, v))
    got = tops.flash_attention(*(_torch(x, dtype) for x in (q, k, v)), causal)
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == q.shape
    want_ref = np.asarray(jref(jq, jk, jv, causal=causal), np.float32)
    want_chunked = np.asarray(jattention.chunked_attention(
        jq.swapaxes(1, 2), jk.swapaxes(1, 2), jv.swapaxes(1, 2), causal=causal, chunk=128,
        q_offset=Lk - Lq if causal else 0).swapaxes(1, 2), np.float32)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), want_ref, atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), want_chunked, atol=tol, rtol=tol)
    with pytest.raises(ValueError, match="divide"):
        jflash(jq, jk, jv, causal, 128, 128, True, True)


@pytest.mark.parametrize("arch,cross", [("qwen3_0_6b", False), ("whisper_large_v3", False),
                                        ("whisper_large_v3", True)])
def test_attention_apply_kernel_route_at_lengths_128_does_not_divide(arch, cross):
    """``attention_apply`` on the kernel route against the JAX default
    route, with the JAX init's weights: causal self-attention over 200
    tokens (qk-norm and rope; QKV bias, no rope), and Whisper's
    cross-attention, 100 queries over 300 frames, non-causal."""
    from repro.configs import get_reduced_config as jget
    from repro_torch.configs import get_reduced_config as tget
    from repro_torch.models import attention as tattention

    jcfg, tcfg = jget(arch), tget(arch).replace(attn_backend="kernel")
    jp = jattention.attention_init(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(3)
    jp = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)
                                            * 0.2), jp)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    rope = arch != "whisper_large_v3"
    x = rng.standard_normal((2, 100 if cross else 200, jcfg.d_model)).astype(np.float32)
    kv_x = rng.standard_normal((2, 300, jcfg.d_model)).astype(np.float32) if cross else None
    want, (wk, _) = jattention.attention_apply(
        jp, jcfg, jnp.asarray(x), causal=not cross, rope=rope,
        kv_x=None if kv_x is None else jnp.asarray(kv_x))
    got, (gk, _) = tattention.attention_apply(
        tp, tcfg, torch.from_numpy(x), causal=not cross, rope=rope,
        kv_x=None if kv_x is None else torch.from_numpy(kv_x))
    assert tuple(gk.shape) == (2, 300 if cross else 200, tcfg.n_kv_heads, tcfg.hd)
    want = np.asarray(want)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-5 * max(1.0, float(np.abs(want).max())))


def test_no_blocks_launch_once_on_a_cuda_tensor(monkeypatch):
    """With no blocks (the default) a CUDA tensor at a ragged length goes to
    the kernel, counted once (checked with a fake launch, no card); given
    blocks, the same length raises before any launch, and so does one
    block alone that does not divide its length."""
    monkeypatch.setattr(tops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(tops._kernel, "launch", lambda q, k, v, **kw: torch.zeros_like(q))
    q, k = torch.zeros((1, 2, 100, 32)), torch.zeros((1, 2, 300, 32))
    before = tops.flash_attention.launches
    tops.flash_attention(q, k, k, True)
    assert tops.flash_attention.launches == before + 1
    with pytest.raises(ValueError, match="divide"):
        tops.flash_attention(q, k, k, True, 128, 128)
    with pytest.raises(ValueError, match="divide"):
        tops.flash_attention(q, k, k, True, None, 128)
    assert tops.flash_attention.launches == before + 1


def test_blocks_are_cut_to_short_lengths(monkeypatch):
    """Blocks of 128 over length 8 are cut, and the CPU tensor goes to the
    plain version; two f32 evaluations agree within f32 rounding (1e-6 of
    the largest magnitude): a CPU GEMM does not promise bit-equal results
    from call to call when other processes compete for the cores."""
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 2, 1, 8, 8, 16, True), 3))
    calls, real = [], tops.mha_reference
    monkeypatch.setattr(tops, "mha_reference", lambda *a, **kw: calls.append(a) or real(*a, **kw))
    before = tops.flash_attention.launches
    got = tops.flash_attention(q, k, v, True, 128, 128)
    assert len(calls) == 1 and tops.flash_attention.launches == before
    want = tref.mha_reference(q, k, v, causal=True)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * max(1.0, float(want.abs().max())))


def test_cuda_tensor_never_runs_the_plain_version(monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel or raises (checked
    with a fake CUDA test, no card): here the launch refuses the CPU tensor,
    and neither the plain version nor the launch count moves."""
    monkeypatch.setattr(tops, "_on_cuda", lambda t: True)

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(tops, "mha_reference", no_plain)
    q = torch.zeros((1, 2, 64, 32))
    before = tops.flash_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_attention(q, q, q, True, 64, 64)
    assert tops.flash_attention.launches == before


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


def test_kernel_source_is_its_own_build():
    assert tkernel.SOURCE.source.name == "flash_attention.cu"
    assert "arch=compute_90a,code=sm_90a" in tkernel.SOURCE.flags
    assert tkernel.SOURCE.library_path().name.startswith("flash_attention_")


# ------------------------------ on the card ---------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with pytest -m gpu")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES + NEW_DIM_SHAPES + [(1, 16, 8, 192, 192, 128, True),
                                            (2, 64, 8, 256, 256, 112, True),
                                            (1, 32, 32, 136, 136, 112, True),
                                            (2, 4, 2, 200, 200, 16, False),
                                            (1, 4, 2, 8, 40, 64, True),
                                            (1, 16, 8, 200, 200, 128, False),
                                            (4, 16, 8, 512, 512, 128, True)])  # serve shape
def test_kernel_matches_plain_on_card(shape, dtype):
    _card()
    causal = shape[-1]
    q, k, v = (_torch(x, dtype, "cuda") for x in _inputs(shape, seed=sum(shape[:6])))
    before = tops.flash_attention.launches
    got = tops.flash_attention(q, k, v, causal, 8, 8)
    assert tops.flash_attention.launches == before + 1
    want = tref.mha_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.is_cuda
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RAGGED + [(1, 4, 4, 128, 1500, 64, False),  # Whisper's cross
                                            (1, 4, 4, 1500, 1500, 64, False),  # its encoder
                                            (1, 8, 8, 100, 300, 64, True),
                                            (2, 16, 8, 200, 200, 128, True)])
def test_kernel_matches_plain_at_any_length_on_card(shape, dtype):
    """The ragged last tiles (rows past Lq, keys past Lk, a causal offset
    inside a tile) against the plain version."""
    _card()
    causal = shape[-1]
    q, k, v = (_torch(x, dtype, "cuda") for x in _inputs(shape, seed=sum(shape[:6])))
    before = tops.flash_attention.launches
    got = tops.flash_attention(q, k, v, causal)
    assert tops.flash_attention.launches == before + 1
    want = tref.mha_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_long_causal_rows_keep_f32_accuracy_on_card():
    """Rows of up to 16,384 keys against an f64 evaluation: the last 4,096
    rows within 1e-6.  Each tile's P V is summed in accumulators of its
    own and added to the running sum in f32; carried through every tile's
    products in the tensor core's accumulators, the sum drifted with the
    number of tiles (2e-5 at row 32,768 of Qwen3-0.6B's first layer)."""
    _card()
    shape = (1, 2, 1, 16384, 16384, 128, True)
    q, k, v = (torch.from_numpy(x).cuda() for x in _inputs(shape, seed=5))
    got = tops.flash_attention(q, k, v, True)
    qd, kd, vd = (x.double() for x in (q, k.repeat_interleave(2, 1), v.repeat_interleave(2, 1)))
    s = torch.einsum("bhqd,bhkd->bhqk", qd, kd) * 128 ** -0.5
    mask = torch.ones((16384, 16384), dtype=torch.bool, device="cuda").tril()
    want = torch.einsum("bhqk,bhkd->bhqd",
                        torch.softmax(torch.where(mask, s, float("-inf")), dim=-1), vd)
    err = (got.double() - want)[:, :, -4096:].abs().max().item()
    assert err <= 1e-6, err


@pytest.mark.gpu
def test_kernel_takes_strided_views_on_card():
    """attention_apply hands the kernel (B, L, H, D) tensors transposed to
    (B, H, L, D) without a copy."""
    _card()
    q, k, v = (torch.from_numpy(x).cuda() for x in _inputs((2, 4, 2, 64, 64, 64, True), 9))
    qt, kt, vt = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    assert not qt.is_contiguous()
    got = tops.flash_attention(qt, kt, vt, True, 64, 64)
    torch.testing.assert_close(got, tref.mha_reference(q, k, v, causal=True),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
def test_kernel_refuses_unsupported_head_dims_on_card():
    _card()
    q = torch.zeros((1, 2, 64, 20), device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        tops.flash_attention(q, q, q, True, 64, 64)


def test_head_dims_cover_every_config():
    """Both attention kernels take the head dim of every config the JAX
    package serves, full and reduced, and refuse others."""
    from repro.configs import ARCH_IDS, get_config, get_reduced_config
    from repro_torch.kernels.paged_attention import kernel as paged_kernel

    dims = {get(a).hd for a in ARCH_IDS if a != "pulse_paper"
            for get in (get_config, get_reduced_config)}
    assert {16, 112} <= dims
    assert dims <= set(tkernel.HEAD_DIMS) and dims <= set(paged_kernel.HEAD_DIMS)
    assert 20 not in tkernel.HEAD_DIMS and 20 not in paged_kernel.HEAD_DIMS
