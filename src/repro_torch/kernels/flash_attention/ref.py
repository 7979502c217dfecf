"""Plain torch version of flash attention: GQA multi-head attention,
causal or full (the JAX package's ``mha_reference``)."""

from __future__ import annotations

import torch


def mha_reference(q, k, v, *, causal: bool = True, scale: float | None = None):
    """q: (B, H, Lq, D); k, v: (B, Hk, Lk, D) with H % Hk == 0.  Causal
    queries are aligned to the end of the keys (query i sees keys
    <= i + Lk - Lq)."""
    B, H, Lq, D = q.shape
    Hk = k.shape[1]
    G = H // Hk
    scale = (D ** -0.5) if scale is None else scale
    kq = k.repeat_interleave(G, dim=1).float()
    vq = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) * scale
    if causal:
        Lk = k.shape[2]
        mask = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device).tril(Lk - Lq)
        s = torch.where(mask[None, None], s, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vq).to(q.dtype)
