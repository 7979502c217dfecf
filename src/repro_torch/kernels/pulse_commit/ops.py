"""pulse_commit: the CUDA kernel for CUDA tensors, the plain version
(``ref.pulse_commit_reference``) for CPU tensors; never one in place of the
other.  ``pulse_commit.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.pulse_commit import kernel as _kernel
from repro_torch.kernels.pulse_commit.ref import pulse_commit_reference


def pulse_commit(pools: torch.Tensor, data: torch.Tensor, heap: torch.Tensor,
                 bounds: torch.Tensor, perms: torch.Tensor, *, scratch_words: int):
    """Every shard's commit phase (the JAX package's ``_commit_phase`` for
    each shard at once), in place: ``pools`` (P, L, R) int32 records with
    their mutation payload, ``data`` (cap, W) the whole arena, ``heap`` (P,
    HEAP_WORDS), ``bounds`` (P + 1,), ``perms`` (P,).  Updates in place, so a
    superstep moves no copy of the arena; returns ``(pools, data, heap)``.

    On CUDA tensors: the canonical order in torch ops, then one launch for
    all P shards, with nothing read on the host.  A pool of no records
    launches nothing."""
    if not pools.is_cuda:
        return pulse_commit_reference(pools, data, heap, bounds, perms,
                                      scratch_words=scratch_words)
    if pools.numel() == 0:
        return pools, data, heap
    order, n = _kernel.commit_order(pools, bounds, scratch_words=scratch_words,
                                    capacity=data.shape[0])
    _kernel.launch(pools, data, heap, bounds, perms, order, n, scratch_words=scratch_words)
    pulse_commit.launches += 1
    return pools, data, heap


pulse_commit.launches = 0
