"""Plain torch version of paged decode attention (the JAX package's
``paged_attention_reference``).

Gathers each sequence's KV pages in page-table order, masks positions at or
past ``lengths`` with -inf, and runs exact softmax attention for the one
new token of each sequence.  A sequence of length 0 gives NaN, as the JAX
reference does (the kernel gives 0 there, as the JAX kernel does).

``paged_attention_split_reference`` repeats the CUDA kernel's split-K
arithmetic (partial softmaxes over the splits' page ranges, then the merge)
for the tests; the port's entry points do not call it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.kernel import split_ranges


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


def paged_attention_split_reference(q, k_pages, v_pages, page_table, lengths, *, splits,
                                    scale=None):
    """The kernel's arithmetic with ``splits`` splits per (sequence, KV
    head): each split's partial (m, l, acc) over its pages
    (``kernel.split_ranges``), then M = max m_s, L = sum l_s e^(m_s - M),
    A = sum acc_s e^(m_s - M), o = A / (L if L else 1).  A sequence of
    length 0 gives 0, as the kernel does.  Same arguments as
    ``paged_attention_reference``."""
    B, H, D = q.shape
    N, page, Hk, _ = k_pages.shape
    P = page_table.shape[1]
    G = H // Hk
    scale = (D ** -0.5) if scale is None else scale
    out = torch.zeros((B, H, D), dtype=torch.float32)
    for b in range(B):
        length = min(max(int(lengths[b]), 0), P * page)
        parts = []  # (m, l, acc) per split that holds a page, each (H,), (H,), (H, D)
        for p0, p1 in split_ranges(length, page, P, splits):
            if p0 >= p1:
                continue
            ids = page_table[b, p0:p1].long().clamp(0, N - 1)
            n = min(p1 * page, length) - p0 * page  # valid tokens of the split
            k = k_pages[ids].reshape(-1, Hk, D)[:n].float().repeat_interleave(G, dim=1)
            v = v_pages[ids].reshape(-1, Hk, D)[:n].float().repeat_interleave(G, dim=1)
            s = torch.einsum("hd,lhd->hl", q[b].float() * scale, k)
            m = s.amax(dim=-1)
            p = torch.exp(s - m[:, None])
            parts.append((m, p.sum(dim=-1), torch.einsum("hl,lhd->hd", p, v)))
        if not parts:
            continue
        M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        L = sum(l * torch.exp(m - M) for m, l, _ in parts)
        A = sum(a * torch.exp(m - M)[:, None] for m, _, a in parts)
        out[b] = A / torch.where(L == 0, torch.ones_like(L), L)[:, None]
    return out.to(q.dtype)
