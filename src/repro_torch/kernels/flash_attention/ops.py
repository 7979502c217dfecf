"""flash_attention: the CUDA kernel for CUDA tensors, the plain version
(``ref.mha_reference``) for CPU tensors; never one in place of the other.
``flash_attention.launches`` counts kernel launches.  Meta tensors (the
launch tooling's dry run) take a third route: an output of the right shape,
the function's own work (``work.flash_work``, the causal pairs only)
reported to the active counters, and nothing computed.  DTensors run each
rank's local shards through these routes (``_on_shards``).

Where an input requires grad, the call goes through ``FlashAttention``, a
``torch.autograd.Function``: its forward is the same kernel (or plain
version), and its backward recomputes ``mha_reference`` and returns that
recompute's vector-Jacobian product, as the JAX package's ``custom_vjp``
does (``_bwd`` is ``jax.vjp`` of its reference): neither package has a
backward kernel.  The backward runs inside a ``flash_attention.backward``
profiler span.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import work
from repro_torch.kernels.shards import is_dtensor, local_of, placed_as
from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention.ref import mha_reference


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def _meta(q, k, v, causal):
    B, H, Lq, D = q.shape
    work.report("flash_attention", *work.flash_work(B, H, k.shape[1], Lq, k.shape[2], D, causal,
                                                    q.element_size()))
    return torch.empty_like(q)


def _forward(q, k, v, causal):
    if q.is_meta:
        return _meta(q, k, v, causal)
    if not _on_cuda(q):
        return mha_reference(q, k, v, causal=causal)
    out = _kernel.launch(q, k, v, causal=causal, scale=q.shape[-1] ** -0.5)
    flash_attention.launches += 1
    return out


class FlashAttention(torch.autograd.Function):
    """Forward: the kernel (CUDA) or ``mha_reference`` (CPU), keeping q, k
    and v.  Backward: ``mha_reference`` recomputed and differentiated."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        with torch.no_grad():
            return _forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.profiler.record_function("flash_attention.backward"), torch.enable_grad():
            out = mha_reference(q, k, v, causal=ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None


def _on_shards(q, k, v, causal):
    """``flash_attention`` of DTensors on each rank's local shards, the
    output placed as ``q``.  Each mesh dim places q, k and v alike on the
    batch or the heads (or on neither), or shards q's rows with k and v
    whole on it: a rank's query rows then see every key, and causal rows
    the keys up to their own (the end-aligned mask over the keys cut after
    the rank's last row), and k's and v's gradients are partial sums over
    its ranks.  Any other placement raises."""
    from torch.distributed.tensor import Shard

    mesh, qp, kp = q.device_mesh, tuple(q.placements), tuple(k.placements)
    bad = tuple(v.placements) != kp or k.device_mesh != mesh or v.device_mesh != mesh
    rows = None  # the mesh dim sharding q's rows, k and v whole on it
    for m, (a, b) in enumerate(zip(qp, kp)):
        n = mesh.size(m)
        if a == b and (a.is_replicate() or a == Shard(0)
                       or (a == Shard(1) and q.shape[1] % n == 0 and k.shape[1] % n == 0)):
            continue
        if a == Shard(2) and b.is_replicate() and rows is None and q.shape[2] % n == 0:
            rows = m
        else:
            bad = True
    if bad:
        raise ValueError(f"flash_attention: DTensors placed q {qp}, k {kp}, v "
                         f"{tuple(v.placements)} do not run on local shards")
    ql, kl, vl = (local_of(t, q) for t in (q, k, v))
    if rows is not None and causal:
        end = k.shape[2] - q.shape[2] + (mesh.get_coordinate()[rows] + 1) * ql.shape[2]
        kl, vl = kl[:, :, :end], vl[:, :, :end]
    return placed_as(flash_attention(ql, kl, vl, causal), q, qp)


def flash_attention(q, k, v, causal=True, block_q=None, block_k=None):
    """q: (B, H, Lq, D); k, v: (B, Hk, Lk, D) -> (B, H, Lq, D) in q's dtype.

    By default any lengths: the CUDA kernel tiles by its own sizes and
    masks the ragged last tiles.  ``block_q``/``block_k``, where given, are
    the JAX kernel's blocks: each is cut to its length, and a length that
    its block does not divide raises ``ValueError`` on every device, as the
    JAX kernel does; they decide only what to refuse.
    """
    H, Lq = q.shape[1], q.shape[2]
    Hk, Lk = k.shape[1], k.shape[2]
    if H % Hk:
        raise ValueError(f"H={H} not a multiple of Hk={Hk}")
    for length, block in ((Lq, block_q), (Lk, block_k)):
        if block is not None and length % min(block, length):
            raise ValueError("sequence lengths must divide block sizes")
    if is_dtensor(q):
        return _on_shards(q, k, v, causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal)


flash_attention.launches = 0
