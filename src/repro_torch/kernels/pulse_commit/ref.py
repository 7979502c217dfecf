"""pulse_commit's plain version: every shard's commit phase, one staged
mutation at a time in the canonical (class, slot, id) order.

``commit_shard`` is the port's one canonical-order commit: the sequential
executor (``core.commit``) runs it on its host mirror of ``data`` and
``heap``, and ``pulse_commit_reference`` runs it shard by shard on CPU
tensors (through numpy views, so in place) as the kernel's plain version.
It computes what the JAX package's ``_commit_phase``
(``src/repro/core/routing.py:407``) computes for one shard.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.arena import (
    H_BUMP,
    H_COMMITS,
    H_EPOCH,
    H_FREE,
    M_ALLOC,
    M_CAS,
    M_FREE,
    M_NONE,
    M_STORE,
    NULL,
    PERM_WRITE,
)
from repro_torch.core.iterator import STATUS_EMPTY, STATUS_FAULT
from repro_torch.core.routing import F_HOME, F_ID, F_SCRATCH, F_STATUS


def commit_shard(pool, data, heap, s, lo, hi, perm_w, written, *, S, W):
    """Apply shard ``s``'s eligible commits one at a time, in the canonical
    (class, slot, id) order, on numpy arrays: ``pool`` (L, R) the shard's
    records, ``data`` (cap, W) the whole arena (global rows), ``heap``
    (P, HEAP_WORDS).  Mutates them in place and appends the rows it writes
    to ``written``; returns the number of commit slots consumed (CAS misses
    and exhausted ALLOCs included)."""
    MB = F_SCRATCH + S
    m_op = pool[:, MB]
    m_tgt = pool[:, MB + 1]
    pend = (m_op != M_NONE) & (pool[:, F_STATUS] != STATUS_EMPTY)
    is_alloc = m_op == M_ALLOC
    eligible = pend & np.where(
        is_alloc, pool[:, F_HOME] == s, (m_tgt >= lo) & (m_tgt < hi)
    )
    idx = np.flatnonzero(eligible)
    if not len(idx):
        return 0
    if not perm_w:
        pool[idx, F_STATUS] = STATUS_FAULT
        pool[idx, MB] = M_NONE
        return 0
    klass = np.where(is_alloc, 2, np.where(m_op == M_FREE, 1, 0))[idx]
    slot_key = np.where(is_alloc, 0, m_tgt)[idx]
    order = idx[np.lexsort((pool[idx, F_ID], slot_key, klass))]
    applied = 0
    for r in order:
        op = int(pool[r, MB])
        tgt = int(pool[r, MB + 1])
        # a Python int from the int32 word: widened by sign, so a mask with
        # bit 31 set also selects words 32..W-1 (the JAX package's commit)
        mask = int(pool[r, MB + 2])
        expect = int(pool[r, MB + 3])
        mdata = pool[r, MB + 4 : MB + 4 + W]
        maskb = ((mask >> np.arange(W)) & 1).astype(bool)
        if op in (M_STORE, M_CAS):
            old = data[tgt]
            if op == M_STORE or int(old[int(np.argmax(maskb))]) == expect:
                data[tgt] = np.where(maskb, mdata, old)
                written.append(tgt)
        elif op == M_FREE:
            row = np.zeros(W, np.int32)
            row[0] = heap[s, H_FREE]
            data[tgt] = row
            heap[s, H_FREE] = tgt
            written.append(tgt)
        elif op == M_ALLOC:
            popped = heap[s, H_FREE] != NULL
            if popped:
                slot = int(heap[s, H_FREE])
            elif heap[s, H_BUMP] < hi:
                slot = int(heap[s, H_BUMP])
                heap[s, H_BUMP] += 1
            else:
                pool[r, F_STATUS] = STATUS_FAULT
                pool[r, MB] = M_NONE
                applied += 1
                continue
            # the row is clamped to the shard's, as the JAX package's commit
            # clamps it: a free list threaded through a twice-freed row can
            # hand out a slot outside [lo, hi)
            row = lo + min(max(slot - lo, 0), hi - lo - 1)
            if popped:
                heap[s, H_FREE] = data[row, 0]
            data[row] = np.where(maskb, mdata, 0)
            written.append(row)
            pool[r, F_SCRATCH + min(max(tgt, 0), S - 1)] = slot
        pool[r, MB] = M_NONE
        applied += 1
    heap[s, H_EPOCH] += int(applied > 0)
    heap[s, H_COMMITS] += applied
    return applied


def pulse_commit_reference(pools, data, heap, bounds, perms, *, scratch_words: int):
    """Every shard's commit phase on CPU tensors, in place: ``pools`` (P, L,
    R), ``data`` (cap, W) and ``heap`` (P, HEAP_WORDS), all int32 and
    contiguous.  Returns them."""
    P = pools.shape[0]
    edges = bounds.tolist()
    writable = ((perms & PERM_WRITE) == PERM_WRITE).tolist()
    d, h = data.numpy(), heap.numpy()
    for s in range(P):
        commit_shard(pools[s].numpy(), d, h, s, int(edges[s]), int(edges[s + 1]),
                     bool(writable[s]), [], S=scratch_words, W=data.shape[1])
    return pools, data, heap

