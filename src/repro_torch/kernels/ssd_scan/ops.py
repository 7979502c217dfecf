"""ssd_scan: the CUDA kernel for CUDA tensors, the plain version
(``ref.ssd_chunked_batched``) for CPU tensors; never one in place of the
other.  ``ssd_scan.launches`` counts the calls that launched the kernels
(each call launches the three CUDA kernels of one scan: one per layer on the
prefill path).  Meta tensors (the launch tooling's dry run) take a third
route: outputs of the right shapes, the function's own work
(``work.ssd_work``) reported to the active counters, nothing computed.

Where an input requires grad, the call goes through ``SSDScan``, a
``torch.autograd.Function``: its forward is the same kernel (or plain
version), and its backward is the vector-Jacobian product of
``ssd_chunked_batched`` recomputed on the saved inputs.  The JAX package's
Pallas scan has no VJP; it trains through its chunked reference,
differentiated by XLA, which is what this backward computes.  The
backward runs inside an ``ssd_scan.backward`` profiler span.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import work
from repro_torch.kernels.ssd_scan import kernel as _kernel
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_batched


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def _plain(x, dt, A, B, C, chunk):
    y, S = ssd_chunked_batched(x, dt, A, B, C, chunk=chunk)
    return y.to(x.dtype), S


def _meta(x, B, chunk):
    Bt, L, H, dh = x.shape
    N = B.shape[-1]
    work.report("ssd_scan", *work.ssd_work(Bt, L, H, dh, N, chunk, x.element_size()))
    return torch.empty_like(x), x.new_empty((Bt, H, N, dh), dtype=torch.float32)


def _forward(x, dt, A, B, C, chunk):
    if x.is_meta:
        return _meta(x, B, chunk)
    if not _on_cuda(x):
        return _plain(x, dt, A, B, C, chunk)
    out = _kernel.launch(x, dt, A, B, C, chunk=chunk)
    ssd_scan.launches += 1
    return out


class SSDScan(torch.autograd.Function):
    """Forward: the kernel (CUDA) or ``ssd_chunked_batched`` (CPU), keeping
    x, dt, A, B and C.  Backward: the plain version recomputed and
    differentiated; a missing gradient (the final state's, in training) is
    left out of the product."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C)
        with torch.no_grad():
            return _forward(x, dt, A, B, C, chunk)

    @staticmethod
    def backward(ctx, gy, gS):
        if (gy is None and gS is None) or not any(ctx.needs_input_grad):
            return (None,) * 6
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.profiler.record_function("ssd_scan.backward"), torch.enable_grad():
            outs, grads = zip(*((out, g) for out, g in zip(_plain(*inputs, ctx.chunk), (gy, gS))
                                if g is not None))
            got = iter(torch.autograd.grad(outs, wanted, grads, allow_unused=True))
        return tuple(next(got) if t.requires_grad else None for t in inputs) + (None,)


def ssd_scan(x, dt, A, B, C, *, chunk=128):
    """x (Bt, L, H, dh), dt (Bt, L, H), A (H,), B/C (Bt, L, N) -> y
    (Bt, L, H, dh) in x's dtype, final state (Bt, H, N, dh) in f32.

    A length that ``chunk`` does not divide raises ``ValueError`` on every
    device, as the JAX kernel does."""
    L = x.shape[1]
    if L % chunk:
        raise ValueError(f"L={L} must divide chunk={chunk}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B, C)):
        return SSDScan.apply(x, dt, A, B, C, chunk)
    return _forward(x, dt, A, B, C, chunk)


ssd_scan.launches = 0
