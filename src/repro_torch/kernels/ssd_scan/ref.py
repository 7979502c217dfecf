"""Plain torch versions of the Mamba2 SSD (state-space duality) scan, the
JAX package's ``ref.py``.

  * ``ssd_sequential``: the exact per-token recurrence
        S_t = a_t * S_{t-1} + dt_t * B_t x_t^T ;  y_t = C_t @ S_t
    with a_t = exp(dt_t * A) (A < 0 per head).  Ground truth.
  * ``ssd_chunked``: the SSD chunked algorithm (arXiv:2405.21060 S6):
    intra-chunk quadratic part + inter-chunk state passing, which the CUDA
    kernel computes.
  * ``ssd_chunked_batched``: the same over (batch, heads), written out as
    batch dimensions (the JAX package vmaps ``ssd_chunked``).
  * ``ssd_chunk_parallel``: the same result in the CUDA kernels' order of
    work, with the chunk axis parallel; for the tests only.

All arithmetic is f32; y and the state come back in f32.
"""

from __future__ import annotations

import torch


def ssd_sequential(x, dt, A, B, C, *, init_state=None):
    """x: (L, dh); dt: (L,); A: scalar < 0; B, C: (L, N).  Returns (y, S)."""
    L, dh = x.shape
    N = B.shape[1]
    x, dt, B, C = x.float(), dt.float(), B.float(), C.float()
    A = torch.as_tensor(A, dtype=torch.float32, device=x.device)
    S = (torch.zeros((N, dh), dtype=torch.float32, device=x.device)
         if init_state is None else init_state)
    ys = []
    for t in range(L):
        S = torch.exp(dt[t] * A) * S + dt[t] * torch.outer(B[t], x[t])
        ys.append(C[t] @ S)
    return torch.stack(ys), S


def _chunked(x, dt, A, B, C, chunk: int, S):
    """The chunked scan over leading batch dims: x (..., L, dh), dt (..., L),
    A broadcastable to dt's batch dims, B/C (..., L, N) broadcastable to
    x's, S (..., N, dh).  The chunk axis is a loop."""
    L = x.shape[-2]
    if L % chunk:
        raise ValueError(f"L={L} must divide chunk={chunk}")
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    A = A[..., None]
    ys = []
    for c0 in range(0, L, chunk):
        xq, dtq = x[..., c0:c0 + chunk, :], dt[..., c0:c0 + chunk]
        Bq, Cq = B[..., c0:c0 + chunk, :], C[..., c0:c0 + chunk, :]
        cs = torch.cumsum(dtq * A, dim=-1)  # (..., Q) log-decay
        # intra-chunk: Lmat[i, j] = exp(cs_i - cs_j) for j <= i.  Mask BEFORE
        # the exp: for j > i the difference is positive and can overflow to
        # inf, and inf * 0 is NaN.
        diff = cs[..., :, None] - cs[..., None, :]
        Lmat = torch.exp(torch.where(tri, diff, torch.full_like(diff, -1e9)))
        scores = (Cq @ Bq.transpose(-1, -2)) * Lmat  # (..., Q, Q)
        xbar = xq * dtq[..., None]  # (..., Q, dh)
        ys.append(scores @ xbar + torch.exp(cs)[..., None] * (Cq @ S))
        # state passing
        decay_out = torch.exp(cs[..., -1:] - cs)  # (..., Q)
        S = (torch.exp(cs[..., -1])[..., None, None] * S
             + Bq.transpose(-1, -2) @ (decay_out[..., None] * xbar))
    return torch.cat(ys, dim=-2), S


def ssd_chunked(x, dt, A, B, C, *, chunk: int, init_state=None):
    """Chunked SSD, mathematically identical to ``ssd_sequential``."""
    L, dh = x.shape
    N = B.shape[1]
    A = torch.as_tensor(A, dtype=torch.float32, device=x.device)
    S = (torch.zeros((N, dh), dtype=torch.float32, device=x.device)
         if init_state is None else init_state)
    return _chunked(x.float(), dt.float(), A, B.float(), C.float(), chunk, S)


def ssd_chunked_batched(x, dt, A, B, C, *, chunk: int):
    """Over (batch, heads): x (Bt, L, H, dh), dt (Bt, L, H), A (H,), B/C
    (Bt, L, N) shared across heads (single group).  Returns y (Bt, L, H, dh)
    and the final state (Bt, H, N, dh), both f32.  ``C Bᵀ`` is computed once
    per (batch, chunk) and broadcast over the heads."""
    Bt, L, H, dh = x.shape
    N = B.shape[2]
    S = torch.zeros((Bt, H, N, dh), dtype=torch.float32, device=x.device)
    y, S = _chunked(
        x.float().permute(0, 2, 1, 3), dt.float().permute(0, 2, 1), A.float()[None, :],
        B.float()[:, None], C.float()[:, None], chunk, S,
    )
    return y.permute(0, 2, 1, 3), S


def ssd_chunk_parallel(x, dt, A, B, C, *, chunk: int):
    """``ssd_chunked_batched`` in the order of work of the CUDA kernels, for
    the tests: (a) per (batch, chunk) each head's cs and the chunk's own
    state s_c = B^T (exp(cs_last - cs) dt x); (b) the state pass S_{c+1} =
    exp(cs_last,c) S_c + s_c from S_0 = 0, keeping the state that enters
    each chunk; (c) per (batch, chunk) ``C Bᵀ`` once for all heads, then
    y = exp(cs) (C S_c) + (C Bᵀ o Lmat o dt) x.  Same arguments and results."""
    Bt, L, H, dh = x.shape
    N = B.shape[2]
    if L % chunk:
        raise ValueError(f"L={L} must divide chunk={chunk}")
    nc, Q = L // chunk, chunk
    xc = x.float().reshape(Bt, nc, Q, H, dh)
    dtc = dt.float().reshape(Bt, nc, Q, H)
    Bc, Cc = B.float().reshape(Bt, nc, Q, N), C.float().reshape(Bt, nc, Q, N)
    cs = torch.cumsum(dtc * A.float(), dim=2)  # (Bt, nc, Q, H)
    # (a) the chunks' own states
    w = torch.exp(cs[:, :, -1:] - cs) * dtc
    s = torch.einsum("bcjn,bcjhd->bchnd", Bc, w[..., None] * xc)
    # (b) the state pass
    S = torch.zeros((Bt, H, N, dh), dtype=torch.float32, device=x.device)
    S_in = []
    for c in range(nc):
        S_in.append(S)
        S = torch.exp(cs[:, c, -1])[..., None, None] * S + s[:, c]
    S_in = torch.stack(S_in, dim=1)  # (Bt, nc, H, N, dh)
    # (c) the chunks' outputs; masked before the exp, as in _chunked
    G = Cc @ Bc.transpose(-1, -2)  # (Bt, nc, Q, Q), shared by the heads
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()[..., None]
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # (Bt, nc, Q_i, Q_j, H)
    Lmat = torch.exp(torch.where(tri, diff, torch.full_like(diff, -1e9)))
    M = G[..., None] * Lmat * dtc[:, :, None]
    y = (torch.einsum("bcijh,bcjhd->bcihd", M, xc)
         + torch.exp(cs)[..., None] * torch.einsum("bcin,bchnd->bcihd", Cc, S_in))
    return y.reshape(Bt, L, H, dh), S
