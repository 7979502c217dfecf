"""Port parity: paged decode attention.

On the CPU the port's ``ops.paged_attention`` runs its plain version
(``ref.paged_attention_reference``); it must agree with the JAX package's
Pallas kernel in interpret mode and with its reference on the
``tests/test_kernels.py`` shapes, within 2e-5 in f32 and 2e-2 in bf16.
Lengths are drawn >= 1 there; a sequence of length 0 gives 0 in the
kernels (JAX's and the port's) and NaN in the plain versions (JAX's and the
port's), each pinned below.

The CUDA kernel is a split-K flash-decode: ``S`` blocks per (sequence, KV
head) each take a range of the sequence's pages, and a second kernel merges
their partial softmaxes.  What of that runs on the host is checked here
(``kernel.split_plan``, ``kernel.split_ranges``), and the merge arithmetic
through its plain version ``ref.paged_attention_split_reference``.  The
CUDA kernels are held against the plain version on the card by the tests
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
from repro_torch.kernels.paged_attention import kernel as tkernel
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
# G = H/Hk of 3 and 6: any G with H % Hk == 0, as the Pallas launcher takes
GROUP_SHAPES = [
    (2, 6, 2, 64, 16, 4, 24),
    (3, 12, 2, 32, 8, 5, 30),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, seed, *, min_len=1):
    """Seeded inputs of ``shape`` = (B, H, Hk, D, page, P, N[, lengths]):
    lengths drawn in [min_len, P*page] unless the shape names them."""
    B, H, Hk, D, page, P, N = shape[:7]
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, H, D)).astype(np.float32),
              rng.standard_normal((N, page, Hk, D)).astype(np.float32),
              rng.standard_normal((N, page, Hk, D)).astype(np.float32),
              rng.integers(0, N, (B, P)).astype(np.int32),
              rng.integers(min_len, P * page + 1, (B,)).astype(np.int32))
    if len(shape) > 7:
        arrays = arrays[:4] + (np.asarray(shape[7], np.int32),)
    return arrays


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
@pytest.mark.parametrize("shape", SHAPES + NEW_DIM_SHAPES + GROUP_SHAPES)
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


# ------------------------- the split-K plan (host) ---------------------------

PLANS = [  # B, Hk, P, SMs
    (4, 8, 33, 132),  # Qwen3-0.6B's widths, 512-528 tokens of page 16
    (1, 8, 512, 132),  # one sequence of 8,192 tokens
    (1, 1, 0, 132),  # no page slots
    (1, 1, 1, 132),
    (64, 8, 33, 132),  # a batch that fills the card without splitting
    (1, 8, 2000, 132),  # more page slots than one split's table holds
    (3, 2, 5, 16),
]


@pytest.mark.parametrize("plan", PLANS)
def test_split_plan_bounds_and_target(plan):
    B, Hk, P, n_sm = plan
    S = tkernel.split_plan(B, Hk, P, n_sm)
    target = n_sm * tkernel.BLOCKS_PER_SM
    assert 1 <= S <= max(P, 1)
    assert -(-P // S) <= tkernel.MAX_SPLIT_PAGES  # a split's page ids fit the kernel's table
    if P == 0:
        assert S == 1
        return
    cap = -(-P // tkernel.MAX_SPLIT_PAGES)
    if S > cap:  # the table does not force the count: one wave of blocks
        assert B * Hk * S <= target
    if S < P and S >= cap:  # the target, as far as P allows
        assert B * Hk * (S + 1) > target


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("page", [8, 16])
def test_split_ranges_cover_every_valid_page_once(plan, page):
    """Every page slot below the length of a sequence falls in exactly one
    split's range, the ranges are contiguous and in order, none is longer
    than ceil(P/S), and a range past the last valid page is empty."""
    B, Hk, P, n_sm = plan
    S = tkernel.split_plan(B, Hk, P, n_sm)
    lengths = sorted({0, 1, page - 1, page, page + 1, P * page // 2, P * page - 1, P * page,
                      P * page + 5, -3})
    for length in lengths:
        ranges = tkernel.split_ranges(length, page, P, S)
        n = -(-min(max(length, 0), P * page) // page)
        assert len(ranges) == S
        covered = [p for p0, p1 in ranges for p in range(p0, p1)]
        assert covered == list(range(n)), (length, ranges)
        assert all(p1 - p0 <= -(-P // S) for p0, p1 in ranges)
        assert all(p0 == p1 or p0 * page < length for p0, p1 in ranges)
    # at the full length every page slot is covered
    full = tkernel.split_ranges(P * page, page, P, S)
    assert [p for p0, p1 in full for p in range(p0, p1)] == list(range(P))


# lengths for B = 6, page 8, P = 6 (48 slots): 0; 1; 16, which ends the
# first split at S = 3 (2 pages a split); 24, which ends it at S = 2 (3
# pages a split); 48, every slot; 13, inside a page.  With S > 1 and
# lengths 1 or 13, some splits lie wholly past the length.
SPLIT_CASE = (6, 4, 2, 32, 8, 6, 20, (0, 1, 16, 24, 48, 13))


@pytest.mark.parametrize("splits", [1, 2, 3, 6])
def test_split_merge_matches_reference_and_pallas_interpret(splits):
    arrays = _inputs(SPLIT_CASE, seed=11)
    B, H, Hk, D, page, P, N = SPLIT_CASE[:7]
    lengths = arrays[4]
    # the edge cases the S values give: empty splits, and a split ending at the length
    ranges = {int(n): tkernel.split_ranges(int(n), page, P, splits) for n in lengths}
    if splits > 1:
        assert any(p0 == p1 for p0, p1 in ranges[1])
    if splits == 2:
        assert ranges[24] == [(0, 3), (3, 3)]
    if splits == 3:
        assert ranges[16] == [(0, 2), (2, 2), (2, 2)]
    got = tref.paged_attention_split_reference(*_torch(arrays, "float32"), splits=splits)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, D)
    j = _jax(arrays, "float32")
    want_kernel = np.asarray(jpaged(*j, interpret=True, use_pallas=True), np.float32)
    want_ref = np.asarray(jref(*j), np.float32)
    np.testing.assert_allclose(got.numpy(), want_kernel, atol=2e-5, rtol=2e-5)
    live = lengths > 0  # the plain versions give NaN at length 0, the kernels 0
    assert (got[~torch.from_numpy(live)] == 0).all()
    np.testing.assert_allclose(got.numpy()[live], want_ref[live], atol=2e-5, rtol=2e-5)
    plain = tops.paged_attention(*_torch(arrays, "float32")).numpy()
    np.testing.assert_allclose(got.numpy()[live], plain[live], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("H,Hk,G", [(6, 2, 3), (12, 2, 6), (16, 1, 16), (17, 1, None),
                                     (64, 2, None), (6, 4, None)])
def test_query_group_takes_any_whole_group_up_to_the_limit(H, Hk, G):
    """Any G = H/Hk up to MAX_GROUP, as the Pallas launcher takes any; a
    larger G or a remainder is refused with a ValueError that says why."""
    if G is not None:
        assert tkernel.query_group(H, Hk) == G
    elif H % Hk:
        with pytest.raises(ValueError, match="not a multiple"):
            tkernel.query_group(H, Hk)
    else:
        with pytest.raises(ValueError, match=f"at most {tkernel.MAX_GROUP}"):
            tkernel.query_group(H, Hk)


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
                                            (2, 16, 2, 128, 16, 5, 12),
                                            # one sequence, 512 page slots: many splits
                                            (1, 16, 8, 128, 16, 512, 520),
                                            (2, 6, 2, 64, 16, 9, 40),  # G = 3
                                            (2, 48, 8, 112, 16, 9, 40),  # G = 6
                                            # page 8, lengths on split boundaries
                                            (4, 8, 2, 64, 8, 12, 60, (8, 16, 40, 96)),
                                            # a length of 0 among long sequences
                                            (4, 16, 8, 128, 16, 64, 300,
                                             (1024, 0, 1000, 517))])
def test_kernel_matches_plain_on_card(shape, dtype):
    _card()
    args = _torch(_inputs(shape, seed=sum(shape[:7])), dtype, "cuda")
    before = tops.paged_attention.launches
    got = tops.paged_attention(*args)
    assert tops.paged_attention.launches == before + 1
    want = tref.paged_attention_reference(*args)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    live = args[4] > 0  # length 0: the kernel gives 0, the plain version NaN
    assert (got[~live] == 0).all()
    torch.testing.assert_close(got[live].float(), want[live].float(), atol=tol, rtol=tol)


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


@pytest.mark.gpu
def test_kernel_call_makes_no_host_sync():
    """A call reads no length or page id on the host: under
    ``set_sync_debug_mode("error")`` any device-to-host sync raises.  It
    splits (S > 1: two kernels), and the launch count rises by one a
    call."""
    _card()
    shape = (1, 16, 8, 128, 16, 64, 80)
    args = _torch(_inputs(shape, seed=3), "float32", "cuda")
    assert tkernel.launch_plan(args[0].device, 1, 16, 8, 128, 64, torch.float32) > 1
    want = tops.paged_attention(*args)  # builds the library, caches the plan
    torch.cuda.synchronize()
    before = tops.paged_attention.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [tops.paged_attention(*args) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tops.paged_attention.launches == before + 3
    for got in outs:
        torch.testing.assert_close(got, want, atol=0, rtol=0)
