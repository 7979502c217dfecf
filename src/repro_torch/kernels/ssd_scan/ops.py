"""ssd_scan: the CUDA kernel for CUDA tensors, the plain version
(``ref.ssd_chunked_batched``) for CPU tensors; never one in place of the
other.  ``ssd_scan.launches`` counts the calls that launched the kernels
(each call launches the three CUDA kernels of one scan: one per layer on the
prefill path).  Meta tensors (the launch tooling's dry run) take a third
route: outputs of the right shapes, the function's own work
(``work.ssd_work``) reported to the active counters, nothing computed.
DTensors run each rank's local shards through these routes
(``_on_shards``), as the caller placed them: a meta shard reports a
shard's work.

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
from repro_torch.kernels.shards import is_dtensor, local_of, placed_as
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


def _on_shards(x, dt, A, B, C, chunk):
    """``ssd_scan`` of DTensors on each rank's local shards.  Each mesh dim
    shards x's batch (dim 0) or its heads (dim 2), or neither; dt is placed
    as x, A by x's heads, B and C by x's batch (an input whole on a dim
    that shards x takes a partial sum of its gradient there).  y is placed
    as x, the state (Bt, H, N, dh) by x's batch and heads.  Any other
    placement raises."""
    from torch.distributed.tensor import Replicate, Shard

    R = Replicate()
    # x's (and dt's) placement on a mesh dim -> A's, B's and C's, the state's
    rules = ((R, R, R, R), (Shard(0), R, Shard(0), Shard(0)), (Shard(2), Shard(0), R, Shard(1)))
    per_dim = [next((r[1:] for r in rules if r[0] == p), None) for p in x.placements]
    if None in per_dim:
        raise ValueError(f"ssd_scan: x placed {tuple(x.placements)} does not run on local "
                         f"shards")
    a_want, bc_want = [d[0] for d in per_dim], [d[1] for d in per_dim]
    for name, t, want in (("dt", dt, list(x.placements)), ("A", A, a_want), ("B", B, bc_want),
                          ("C", C, bc_want)):
        if not is_dtensor(t) or t.device_mesh != x.device_mesh or list(t.placements) != want:
            got = tuple(t.placements) if is_dtensor(t) else "a plain tensor"
            raise ValueError(f"ssd_scan: {name} placed {got}, not {tuple(want)}, beside x "
                             f"placed {tuple(x.placements)}")
    y, S = ssd_scan(*(local_of(t, x) for t in (x, dt, A, B, C)), chunk=chunk)
    return placed_as(y, x, x.placements), placed_as(S, x, [d[2] for d in per_dim])


def ssd_scan(x, dt, A, B, C, *, chunk=128):
    """x (Bt, L, H, dh), dt (Bt, L, H), A (H,), B/C (Bt, L, N) -> y
    (Bt, L, H, dh) in x's dtype, final state (Bt, H, N, dh) in f32.

    A length that ``chunk`` does not divide raises ``ValueError`` on every
    device, as the JAX kernel does."""
    L = x.shape[1]
    if L % chunk:
        raise ValueError(f"L={L} must divide chunk={chunk}")
    if is_dtensor(x):
        return _on_shards(x, dt, A, B, C, chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B, C)):
        return SSDScan.apply(x, dt, A, B, C, chunk)
    return _forward(x, dt, A, B, C, chunk)


ssd_scan.launches = 0
