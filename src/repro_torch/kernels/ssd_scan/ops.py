"""ssd_scan: the CUDA kernel for CUDA tensors, the plain version
(``ref.ssd_chunked_batched``) for CPU tensors; never one in place of the
other.  ``ssd_scan.launches`` counts the calls that launched the kernels
(each call launches the three CUDA kernels of one scan: one per layer on the
prefill path).

Forward only: the training slice brings the ``autograd.Function``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan import kernel as _kernel
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_batched


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def ssd_scan(x, dt, A, B, C, *, chunk=128):
    """x (Bt, L, H, dh), dt (Bt, L, H), A (H,), B/C (Bt, L, N) -> y
    (Bt, L, H, dh) in x's dtype, final state (Bt, H, N, dh) in f32.

    A length that ``chunk`` does not divide raises ``ValueError`` on every
    device, as the JAX kernel does."""
    L = x.shape[1]
    if L % chunk:
        raise ValueError(f"L={L} must divide chunk={chunk}")
    if not _on_cuda(x):
        y, S = ssd_chunked_batched(x, dt, A, B, C, chunk=chunk)
        return y.to(x.dtype), S
    out = _kernel.launch(x, dt, A, B, C, chunk=chunk)
    ssd_scan.launches += 1
    return out


ssd_scan.launches = 0
