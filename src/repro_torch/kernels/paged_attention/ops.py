"""paged_attention: the CUDA kernel for CUDA tensors, the plain version
(``ref.paged_attention_reference``) for CPU tensors; never one in place of
the other.  ``paged_attention.launches`` counts kernel launches."""

from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import kernel as _kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_reference


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def paged_attention(q, k_pages, v_pages, page_table, lengths):
    """q: (B, H, D) one token per sequence; k_pages, v_pages: (N, page, Hk,
    D); page_table: (B, P) int32; lengths: (B,) int32 -> (B, H, D)."""
    if not _on_cuda(q):
        return paged_attention_reference(q, k_pages, v_pages, page_table, lengths)
    out = _kernel.launch(q, k_pages, v_pages, page_table, lengths, scale=q.shape[-1] ** -0.5)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
