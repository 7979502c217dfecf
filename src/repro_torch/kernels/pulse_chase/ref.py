"""Plain torch versions of the pulse_chase kernel: K traversal steps for a
batch of lanes over an arena, with the kernel's masked-update semantics
(``chase_reference``), a whole traversal with the wave scheduler's fault
semantics (``chase_run_reference``), and the local chase of one routing
superstep over every shard's pool of request records
(``chase_superstep_reference``).

The kernel's body is ``logic_fn`` here: an ISA program's is the batched VM
(``core.isa.run_iteration``), and a native body's is the structure's own
iterator that the body computes (``ops.ChaseLogic`` of it, see
``kernel.NATIVE_BODIES``): ``list_find``, ``list_sum``, ``hash_find``,
``bst_find``, ``btree_find``, ``btree_range_agg`` and ``skiplist_find``
(``core.structures.skiplist.find_iterator``)."""

from __future__ import annotations

import torch

from repro_torch.core.arena import NULL, PERM_READ
from repro_torch.core.iterator import (
    STATUS_ACTIVE,
    STATUS_DONE,
    STATUS_FAULT,
    STATUS_MAXED,
)
from repro_torch.core.routing import F_ITERS, F_PTR, F_SCRATCH, F_STATUS, replica_windows


def chase_reference(arena, ptr, scratch, status, iters, logic_fn, num_steps: int):
    """``logic_fn(nodes (B,W), ptr (B,), scratch (B,S)) -> (done, new_ptr,
    new_scratch)`` batched over lanes.  status: 0 active, 1 done.
    ``iters`` accumulates exact per-lane iteration counts: every step an
    active lane executes counts, including the one that discovers done.
    Returns new ``(ptr, scratch, status, iters)`` tensors."""
    cap = arena.shape[0]
    for _ in range(num_steps):
        active = status == 0
        safe = ptr.clamp(0, cap - 1)
        nodes = arena[torch.where(active, safe, 0).long()]
        done, nptr, nscr = logic_fn(nodes, ptr, scratch)
        ptr = torch.where(active & ~done, nptr, ptr).to(torch.int32)
        scratch = torch.where(active[:, None], nscr, scratch).to(torch.int32)
        status = torch.where(active & done, 1, status).to(torch.int32)
        # walking off the structure (NULL) terminates too
        status = torch.where((status == 0) & (ptr < 0), 1, status).to(torch.int32)
        iters = torch.where(active, iters + 1, iters).to(torch.int32)
    return ptr, scratch, status, iters


def chase_run_reference(arena, ptr, scratch, status, logic_fn, max_steps: int,
                        quantum: int, fault_fn=None):
    """Every lane to its end within ``max_steps`` iterations, with the
    semantics of the JAX package's ``pulse_chase_waves`` at depth quantum
    ``quantum``: a lane entering with status 0 and a negative pointer
    faults (status 1, no iteration); a live lane is checked by ``fault_fn``
    (``(ptrs) -> bool``; True retires it as a fault, status 1) whenever its
    iteration count is a multiple of ``quantum`` and once more if it is live
    at ``max_steps``; a step retires a lane on done or on a negative pointer,
    the latter a fault; a lane live at ``max_steps`` keeps status 0.

    Every live lane has run the same number of steps, so the step number is
    each live lane's iteration count.  Returns new ``(ptr, scratch, status,
    iters, faulted)``."""
    faulted = (status == 0) & (ptr < 0)
    status = torch.where(faulted, 1, status).to(torch.int32)
    iters = torch.zeros_like(ptr)
    for n in range(max_steps + 1):
        live = status == 0
        if fault_fn is not None and (n % quantum == 0 or n == max_steps):
            bad = live & fault_fn(ptr).to(torch.bool)
            faulted = faulted | bad
            status = torch.where(bad, 1, status).to(torch.int32)
            live = live & ~bad
        if n == max_steps or not bool(live.any()):
            break
        ptr, scratch, status, iters = chase_reference(arena, ptr, scratch, status, iters,
                                                      logic_fn, 1)
        faulted = faulted | (live & (status == 1) & (ptr < 0))
    return ptr, scratch, status, iters, faulted


def chase_superstep_reference(arena, pool, bounds, perms, logic_fn, k_local: int, *,
                              scratch_words: int, max_iters, elide: bool = False,
                              rep=None, shard0: int = 0, row0: int = 0):
    """The local chase of one routing superstep over every shard at once.

    ``pool`` is ``(P, L, R)`` request records (``core.routing``'s format);
    shard ``s`` serves the rows ``[bounds[s], bounds[s + 1])`` of ``arena``
    (global rows) and reads them when ``perms[s]`` grants PERM_READ
    (always, with ``elide``).  With ``shard0``, the pools are those of
    shards ``shard0 .. shard0 + P - 1`` of the ``perms.shape[0]`` that
    ``bounds`` and ``perms`` describe, and ``arena``'s first row is global
    row ``row0`` (a memory node's own rows: ``row0 = bounds[shard0]``);
    the defaults are the whole arena and every shard.  ``k_local`` times, for every record as
    ``iterator.step_batch`` treats it: an ACTIVE record whose pointer lies
    in its shard's range steps (a fault instead when the shard does not
    grant the read); then a record still ACTIVE goes MAXED at
    ``max_iters`` (an int, or a 0-d int32 tensor the kernel reads on the
    card), and one that was ACTIVE with a NULL pointer faults.
    Records of other shards' ranges are left as they are.  Returns the new
    pool; every other word of a record is copied through.

    ``rep = (rep_rows, primary_map, dead_mask, policy)`` (replicated
    reads): shard ``s`` also serves the range of ``p = primary_map[s]``
    while ``policy`` is ``"spread"`` or ``p`` is marked dead (never while
    ``s`` is), reading global row ``bounds[s] + (ptr - bounds[p])`` of
    ``rep_rows`` under ``p``'s read grant (never elided); a dead shard's
    own range is empty.  ``rep_rows`` has ``arena``'s rows: from global row
    ``row0`` on (a memory node's holder slice with a shard offset)."""
    P, L, R = pool.shape
    S = scratch_words
    flat = pool.reshape(P * L, R)
    shard = shard0 + torch.arange(P * L, device=pool.device) // L
    lo, hi = bounds[shard], bounds[shard + 1]
    probe = (perms & PERM_READ) == PERM_READ
    granted = torch.ones_like(shard, dtype=torch.bool) if elide else probe[shard]
    on = torch.zeros_like(granted)
    rep_lo = rep_hi = lo
    if rep is not None:
        rep_rows = rep[0]
        hi, rep_lo, rep_hi, on, rep_ok = (w[shard] for w in replica_windows(rep, bounds, perms))
    ptr, status, iters = flat[:, F_PTR], flat[:, F_STATUS], flat[:, F_ITERS]
    scratch = flat[:, F_SCRATCH:F_SCRATCH + S]
    cap = arena.shape[0]
    for _ in range(k_local):
        active = status == STATUS_ACTIVE
        in_rep = on & (ptr >= rep_lo) & (ptr < rep_hi)
        local = in_rep | ((ptr >= lo) & (ptr < hi))
        null = ptr == NULL
        grant = torch.where(in_rep, rep_ok, granted) if rep is not None else granted
        fault = active & local & ~grant & ~null
        runnable = active & local & ~fault & ~null
        nodes = arena[torch.where(runnable & ~in_rep, (ptr - row0).clamp(0, cap - 1), 0).long()]
        if rep is not None:
            at = (ptr - rep_lo + lo - row0).clamp(0, rep_rows.shape[0] - 1)
            nodes = torch.where(in_rep[:, None],
                                rep_rows[torch.where(runnable & in_rep, at, 0).long()], nodes)
        done, nptr, nscr = logic_fn(nodes, ptr, scratch)
        nptr = torch.where(done, ptr, nptr)
        ptr = torch.where(runnable, nptr, ptr).to(torch.int32)
        scratch = torch.where(runnable[:, None], nscr, scratch).to(torch.int32)
        iters = torch.where(runnable, iters + 1, iters).to(torch.int32)
        status = torch.where(runnable & done, STATUS_DONE, status)
        status = torch.where(fault, STATUS_FAULT, status)
        status = torch.where((status == STATUS_ACTIVE) & (iters >= max_iters), STATUS_MAXED,
                             status)
        status = torch.where(active & null, STATUS_FAULT, status).to(torch.int32)
    out = flat.clone()
    out[:, F_PTR], out[:, F_STATUS], out[:, F_ITERS] = ptr, status, iters
    out[:, F_SCRATCH:F_SCRATCH + S] = scratch
    return out.reshape(P, L, R)
