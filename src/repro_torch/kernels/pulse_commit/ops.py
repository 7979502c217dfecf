"""pulse_commit: the CUDA kernels for CUDA tensors, the plain version of
their stages (``ref.pulse_commit_staged``) for CPU tensors; never one in
place of the other.  ``pulse_commit.launches`` counts the commit phases run
on the kernels (one for all P shards).  ``ref.pulse_commit_reference`` is
the serial oracle both are held against.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.pulse_commit import kernel as _kernel
from repro_torch.kernels.pulse_commit.ref import pulse_commit_staged


def pulse_commit(pools: torch.Tensor, data: torch.Tensor, heap: torch.Tensor,
                 bounds: torch.Tensor, perms: torch.Tensor, *, scratch_words: int,
                 shard0: int = 0, row0: int = 0):
    """Every shard's commit phase (the JAX package's ``_commit_phase`` for
    each shard at once), in place: ``pools`` (P, L, R) int32 records with
    their mutation payload, ``data`` (cap, W) the whole arena, ``heap`` (P,
    HEAP_WORDS), ``bounds`` (P + 1,), ``perms`` (P,).  Updates in place, so a
    superstep moves no copy of the arena; returns ``(pools, data, heap)``.

    ``shard0`` and ``row0`` take one shard of a launch (a memory node that
    holds only its own rows): ``pools`` and ``heap`` are then shards
    ``shard0 ..`` of the ``perms.shape[0]`` that ``bounds`` and ``perms``
    describe, and ``data``'s first row is global row ``row0``; the defaults
    are every shard over the whole arena.

    On CUDA tensors: the ``commit_key`` kernel, one ``torch.sort``, then
    the ``commit_apply`` and ``commit_tail`` kernels, all on the current
    stream with nothing read on the host.  A pool of no records launches
    nothing."""
    if not pools.is_cuda:
        return pulse_commit_staged(pools, data, heap, bounds, perms,
                                   scratch_words=scratch_words, shard0=shard0, row0=row0)
    if pools.numel() == 0:
        return pools, data, heap
    _kernel.launch(pools, data, heap, bounds, perms, scratch_words=scratch_words,
                   shard0=shard0, row0=row0)
    pulse_commit.launches += 1
    return pools, data, heap


pulse_commit.launches = 0
