"""Port parity: the two float kernels' ``autograd.Function``s.

  * ``flash_attention``'s gradients on the CPU (the Function over
    ``mha_reference``) against ``jax.grad`` through the JAX package's
    ``custom_vjp`` (``use_pallas=False``: its reference forward, its
    recompute backward), GQA causal, full and causal Lq < Lk;
  * ``ssd_scan``'s against ``jax.grad`` of the JAX ``ssd_chunked_batched``
    (its Pallas scan has no VJP), with a cotangent on y and the final state,
    and on y alone (the final state's gradient None, as training gives),
    and through ``A = -exp(A_log)`` and ``dt = softplus(.)``;
  * the wrappers: a call needing grad goes through the Function, one launch
    a forward and none in the backward (a fake launch on a fake CUDA
    tensor); one that needs none does not record a graph;
  * ``gpu``: the Function on the card against plain autograd on the same
    inputs: the forward within the kernels' tolerances (2e-5 / 1e-4 f32),
    the gradients bit for bit (the backward is the same recompute).

Tolerances on the CPU: 1e-5 of each gradient's largest magnitude for
flash, 1e-4 for ``ssd_scan`` (the ssm forward's: a chunk's cumsum of
dt*A reaches ~-40 here, and f32 keeps the exp of it to ~1e-5 relative).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

try:
    import jax
    import jax.numpy as jnp

    from repro.kernels.flash_attention.ops import flash_attention as jflash
    from repro.kernels.ssd_scan.ref import ssd_chunked_batched as jbatched
except ImportError:  # the card's machine has no JAX; its gpu tests need none
    jax = None
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.ssd_scan import ops as sops
from repro_torch.kernels.ssd_scan import ref as sref

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")
FLASH = [(2, 4, 2, 16, 16, 16, True), (1, 4, 4, 12, 12, 32, False),
         (2, 4, 1, 8, 24, 16, True)]  # B, H, Hk, Lq, Lk, D, causal
SSD = [(2, 32, 3, 16, 16, 16), (1, 64, 2, 32, 16, 32)]  # Bt, L, H, dh, N, chunk


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _flash_inputs(shape, seed):
    B, H, Hk, Lq, Lk, D, _ = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Lq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Hk, Lk, D)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((B, H, Lq, D)).astype(np.float32)
    return q, k, v, g


def _ssd_inputs(shape, seed):
    Bt, L, H, dh, N, _ = shape
    rng = np.random.default_rng(seed)
    return dict(
        x=(rng.standard_normal((Bt, L, H, dh)) * 0.5).astype(np.float32),
        dt_raw=rng.standard_normal((Bt, L, H)).astype(np.float32),
        A_log=np.log(rng.uniform(1.0, 4.0, (H,))).astype(np.float32),
        B=(rng.standard_normal((Bt, L, N)) * 0.5).astype(np.float32),
        C=(rng.standard_normal((Bt, L, N)) * 0.5).astype(np.float32),
        gy=rng.standard_normal((Bt, L, H, dh)).astype(np.float32),
        gS=rng.standard_normal((Bt, H, N, dh)).astype(np.float32),
    )


# --------------------------- against the JAX package -------------------------


@needs_jax
@pytest.mark.parametrize("shape", FLASH)
def test_flash_grads_match_jax_custom_vjp(shape):
    causal = shape[-1]
    q, k, v, g = _flash_inputs(shape, sum(shape[:6]))

    def jloss(q, k, v):
        out = jflash(q, k, v, causal, 128, 128, True, False)
        return jnp.sum(out * g)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fops.flash_attention(tq, tk, tv, causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(g))
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        _close(got.numpy(), want, 1e-5)


def _jax_ssd_loss(inp, chunk, with_state):
    def loss(x, dt_raw, A_log, B, C):
        dt = jax.nn.softplus(dt_raw)
        y, S = jbatched(x, dt, -jnp.exp(A_log), B, C, chunk=chunk)
        out = jnp.sum(y * inp["gy"])
        return out + jnp.sum(S * inp["gS"]) if with_state else out

    return loss


@needs_jax
@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("shape", SSD)
def test_ssd_grads_match_jax(shape, with_state):
    chunk = shape[-1]
    inp = _ssd_inputs(shape, sum(shape))
    names = ("x", "dt_raw", "A_log", "B", "C")
    jgrads = jax.grad(_jax_ssd_loss(inp, chunk, with_state), argnums=tuple(range(5)))(
        *(jnp.asarray(inp[n]) for n in names))
    t = {n: torch.from_numpy(inp[n]).requires_grad_() for n in names}
    y, S = sops.ssd_scan(t["x"], F.softplus(t["dt_raw"]), -torch.exp(t["A_log"]), t["B"], t["C"],
                         chunk=chunk)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    loss = (y * torch.from_numpy(inp["gy"])).sum()
    if with_state:
        loss = loss + (S * torch.from_numpy(inp["gS"])).sum()
    loss.backward()
    for n, want in zip(names, jgrads):
        _close(t[n].grad.numpy(), want, 1e-4)


# ------------------------------- the wrappers ---------------------------------


def test_flash_function_launches_once_a_forward_and_never_in_the_backward(monkeypatch):
    """A fake CUDA tensor: the forward launches (counted once), the backward
    recomputes the plain version with no launch."""
    monkeypatch.setattr(fops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(fops._kernel, "launch",
                        lambda q, k, v, causal, scale: fref.mha_reference(q, k, v, causal=causal))
    q, k, v, g = (torch.from_numpy(a) for a in _flash_inputs(FLASH[0], 1))
    q.requires_grad_()
    before = fops.flash_attention.launches
    out = fops.flash_attention(q, k, v, True)
    assert fops.flash_attention.launches == before + 1
    out.backward(g)
    assert fops.flash_attention.launches == before + 1
    assert q.grad is not None and k.grad is None


def test_ssd_function_launches_once_a_forward_and_never_in_the_backward(monkeypatch):
    monkeypatch.setattr(sops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(sops._kernel, "launch", lambda *a, chunk: sref.ssd_chunked_batched(
        *a, chunk=chunk))
    inp = _ssd_inputs(SSD[0], 2)
    x = torch.from_numpy(inp["x"]).requires_grad_()
    dt = F.softplus(torch.from_numpy(inp["dt_raw"]))
    A = -torch.exp(torch.from_numpy(inp["A_log"]))
    before = sops.ssd_scan.launches
    y, _ = sops.ssd_scan(x, dt, A, torch.from_numpy(inp["B"]), torch.from_numpy(inp["C"]),
                         chunk=16)
    assert sops.ssd_scan.launches == before + 1
    y.sum().backward()
    assert sops.ssd_scan.launches == before + 1
    assert x.grad is not None


def test_no_graph_without_grad():
    q, k, v, _ = (torch.from_numpy(a) for a in _flash_inputs(FLASH[0], 3))
    assert fops.flash_attention(q, k, v, True).grad_fn is None
    with torch.no_grad():
        assert fops.flash_attention(q.requires_grad_(), k, v, True).grad_fn is None
    inp = _ssd_inputs(SSD[0], 4)
    args = [torch.from_numpy(inp[n]) for n in ("x", "dt_raw", "A_log", "B", "C")]
    args[1], args[2] = F.softplus(args[1]), -torch.exp(args[2])
    y, S = sops.ssd_scan(*args, chunk=16)
    assert y.grad_fn is None and S.grad_fn is None


def test_ssd_backward_with_the_state_gradient_only():
    """Only the final state reaches the loss (y's gradient None): the
    backward differentiates the state alone, as plain autograd does."""
    inp = _ssd_inputs(SSD[0], 5)
    names = ("x", "dt_raw", "A_log", "B", "C")

    def grads(fn):
        t = {n: torch.from_numpy(inp[n]).requires_grad_() for n in names}
        _, S = fn(t["x"], F.softplus(t["dt_raw"]), -torch.exp(t["A_log"]), t["B"], t["C"],
                  chunk=16)
        (S * torch.from_numpy(inp["gS"])).sum().backward()
        return [t[n].grad for n in names]

    got, want = grads(sops.ssd_scan), grads(sref.ssd_chunked_batched)
    assert got[4] is None and want[4] is None  # C reaches y only
    for g, w in zip(got[:4], want[:4]):
        _close(g.numpy(), w.numpy(), 1e-6)


# --------------------------------- on the card ---------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with pytest -m gpu")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FLASH + [(2, 16, 8, 512, 512, 128, True)])
def test_flash_function_matches_plain_autograd_on_card(shape):
    _card()
    causal = shape[-1]
    q, k, v, g = (torch.from_numpy(a).cuda() for a in _flash_inputs(shape, 7))
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    before = fops.flash_attention.launches
    out = fops.flash_attention(*a, causal)
    assert fops.flash_attention.launches == before + 1
    want = fref.mha_reference(*b, causal=causal)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
    out.backward(g)
    want.backward(g)
    for x, y in zip(a, b):
        assert torch.equal(x.grad, y.grad)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SSD + [(2, 512, 48, 64, 128, 128)])
def test_ssd_function_matches_plain_autograd_on_card(shape):
    _card()
    chunk = shape[-1]
    inp = {k: torch.from_numpy(v).cuda() for k, v in _ssd_inputs(shape, 8).items()}
    names = ("x", "dt_raw", "A_log", "B", "C")

    def run(fn):
        t = {n: inp[n].clone().requires_grad_() for n in names}
        y, S = fn(t["x"], F.softplus(t["dt_raw"]), -torch.exp(t["A_log"]), t["B"], t["C"],
                  chunk=chunk)
        ((y * inp["gy"]).sum()).backward()
        return y.detach(), S.detach(), [t[n].grad for n in names]

    before = sops.ssd_scan.launches
    y, S, grads = run(sops.ssd_scan)
    assert sops.ssd_scan.launches == before + 1
    wy, wS, wgrads = run(sref.ssd_chunked_batched)
    torch.testing.assert_close(y, wy, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(S, wS, atol=1e-4, rtol=1e-4)
    for got, want in zip(grads, wgrads):
        assert torch.equal(got, want)
