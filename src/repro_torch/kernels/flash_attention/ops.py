"""flash_attention: the CUDA kernel for CUDA tensors, the plain version
(``ref.mha_reference``) for CPU tensors; never one in place of the other.
``flash_attention.launches`` counts kernel launches.

Forward only: the training slice brings the ``autograd.Function`` (the JAX
package's ``custom_vjp`` recomputes through the reference).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention.ref import mha_reference


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def flash_attention(q, k, v, causal=True, block_q=None, block_k=None):
    """q: (B, H, Lq, D); k, v: (B, Hk, Lk, D) -> (B, H, Lq, D) in q's dtype.

    By default any lengths: the CUDA kernel tiles by its own sizes and
    masks the ragged last tiles.  ``block_q``/``block_k``, where given, are
    the JAX kernel's blocks: each is cut to its length, and a length that
    its block does not divide raises ``ValueError`` on every device, as the
    JAX kernel does; they decide only what to refuse.
    """
    B, H, Lq, D = q.shape
    Hk, Lk = k.shape[1], k.shape[2]
    if H % Hk:
        raise ValueError(f"H={H} not a multiple of Hk={Hk}")
    for length, block in ((Lq, block_q), (Lk, block_k)):
        if block is not None and length % min(block, length):
            raise ValueError("sequence lengths must divide block sizes")
    if not _on_cuda(q):
        return mha_reference(q, k, v, causal=causal)
    out = _kernel.launch(q, k, v, causal=causal, scale=D ** -0.5)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
