"""Why the tensor-core kernels split their f32 operands (3xTF32).

``ssd_scan`` and ``flash_attention`` run their f32 products on the TF32
tensor cores.  One TF32 pass keeps 10 bits of mantissa, ~3 decimal digits;
the kernels split each operand into ``big = tf32(a)`` and
``small = tf32(a - big)`` and form ``small·big + big·small + big·big`` with
f32 accumulation (``csrc/mma_tf32x3.cuh``).  This file emulates that on the
CPU, rounding to TF32 by masking the low 13 mantissa bits: at the serve
shapes' inner dimensions the three-term product agrees with a float64
product within 1e-6 of the largest magnitude, as an f32 product does, and
one TF32 pass does not.  bf16 ``flash_attention`` splits P into bf16 hi +
lo the same way.  No card and no JAX: products of TF32 values are exact in
f32, so the CPU's f32 matmul emulates the tensor core's products."""

import numpy as np
import pytest
import torch

TOL = 1e-6  # of the largest magnitude: what an f32 product keeps

PRODUCTS = {  # (m, k, n) of the kernels' products at the serve shapes
    "ssd C B^T (Q x N x Q)": (128, 128, 128),
    "ssd C S (Q x N x dh)": (128, 128, 64),
    "ssd B^T x (N x Q x dh)": (128, 128, 64),
    "flash Q K^T (rows x D x keys)": (64, 128, 64),
    "flash P V (rows x keys x D)": (64, 64, 128),
}


def tf32(a: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 by keeping its top 19 bits (sign, 8 of exponent,
    10 of mantissa)."""
    return (a.view(torch.int32) & -8192).view(torch.float32)


def split(a: torch.Tensor):
    big = tf32(a)
    return big, tf32(a - big)


def mm_3xtf32(a, b):
    (ab, as_), (bb, bs) = split(a), split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)))


def _err(got, want64):
    return float((got.double() - want64).abs().max() / want64.abs().max())


def test_split_keeps_f32_accuracy():
    a = _operands(256, 256, 1, 0)[0]
    big, small = split(a)
    assert torch.equal(tf32(big), big) and torch.equal(tf32(small), small)
    # what the split drops is below f32's own rounding of a (2^-24 relative)
    assert float(((big.double() + small.double()) - a.double()).abs().max()
                 / a.abs().max()) < 2.0 ** -20
    assert float((big - a).abs().max() / a.abs().max()) > 2.0 ** -13  # one TF32 pass does not


@pytest.mark.parametrize("name", sorted(PRODUCTS))
def test_3xtf32_matches_f32_and_one_tf32_pass_does_not(name):
    m, k, n = PRODUCTS[name]
    a, b = _operands(m, k, n, seed=m + k + n)
    want = a.double() @ b.double()
    err_3x = _err(mm_3xtf32(a, b), want)
    err_f32 = _err(a @ b, want)
    err_1x = _err(tf32(a) @ tf32(b), want)
    assert err_3x < TOL and err_f32 < TOL
    assert err_1x > 10 * TOL


def test_bf16_hi_lo_split_of_p_keeps_f32_accuracy():
    """bf16 flash_attention: P (softmax weights in [0, 1]) as bf16 hi + lo
    against bf16 V, two exact bf16 products with f32 accumulation, agrees
    with the f32 product within 1e-5; P rounded once to bf16 does not."""
    rng = np.random.default_rng(7)
    p = torch.from_numpy(rng.uniform(0, 1, (64, 64)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32)).bfloat16().float()
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    want = p.double() @ v.double()
    assert _err(lo @ v + hi @ v, want) < 1e-5
    assert _err(hi @ v, want) > 1e-4
