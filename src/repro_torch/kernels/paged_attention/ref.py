"""Plain torch version of paged decode attention (the JAX package's
``paged_attention_reference``).

Gathers each sequence's KV pages in page-table order, masks positions at or
past ``lengths`` with -inf, and runs exact softmax attention for the one
new token of each sequence.  A sequence of length 0 gives NaN, as the JAX
reference does (the kernel gives 0 there, as the JAX kernel does).
"""

from __future__ import annotations

import torch


def paged_attention_reference(q, k_pages, v_pages, page_table, lengths, *, scale=None):
    """q: (B, H, D); k_pages, v_pages: (N, page, Hk, D); page_table: (B, P)
    int32 page ids (anything past ``lengths``; clipped to [0, N-1]);
    lengths: (B,) int32 valid tokens per sequence."""
    B, H, D = q.shape
    N, page, Hk, _ = k_pages.shape
    P = page_table.shape[1]
    G = H // Hk
    scale = (D ** -0.5) if scale is None else scale
    safe = page_table.long().clamp(0, N - 1)
    k = k_pages[safe].reshape(B, P * page, Hk, D)
    v = v_pages[safe].reshape(B, P * page, Hk, D)
    kq = k.repeat_interleave(G, dim=2).float()  # (B, L, H, D)
    vq = v.repeat_interleave(G, dim=2).float()
    s = torch.einsum("bhd,blhd->bhl", q.float(), kq) * scale
    mask = torch.arange(P * page, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(mask[:, None, :], s, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhl,blhd->bhd", p, vq).to(q.dtype)
