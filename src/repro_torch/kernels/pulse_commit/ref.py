"""pulse_commit's plain versions: every shard's commit phase in the
canonical (class, slot, id) order, serially and by the kernel's stages.

``commit_shard`` is the port's one canonical-order commit, one staged
mutation at a time: the sequential executor (``core.commit``) runs it on
its host mirror of ``data`` and ``heap``, and ``pulse_commit_reference``
runs it shard by shard on CPU tensors (through numpy views, so in place).
It computes what the JAX package's ``_commit_phase``
(``src/repro/core/routing.py:407``) computes for one shard, and it is the
oracle the other two are held against.

``pulse_commit_staged`` is the CUDA kernel's stages in torch ops, and
``ops.pulse_commit``'s route for CPU tensors: the order key
(``commit_key``), one sort, the stores and CASes applied round by round
(the r-th record of every same-slot run at once), the FREEs' links by a
shift, and the ALLOCs popped serially from the free list, then claimed
from the bump pointer all at once.
"""

from __future__ import annotations

import numpy as np
import torch

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

_I64_KEY_LIMIT = 1 << 62


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



def key_top(capacity: int, L: int) -> int:
    """The order key of a record no shard commits, past every eligible
    key; raises when it would not fit an int64 (a check on shapes alone)."""
    top = 3 * capacity * L
    if top >= _I64_KEY_LIMIT:
        raise ValueError(f"pulse_commit: the order key 3 * {capacity} * {L} overflows int64")
    return top


def commit_key(pools, bounds, *, scratch_words: int, capacity: int, shard0: int = 0,
               row0: int = 0):
    """Each record's int64 order key, ``(P, L)``: the ``commit_key``
    kernel's plain version.  The pools are shards ``shard0 ..`` of
    ``bounds``; ``capacity`` counts the rows held from global row ``row0``
    (a memory node's own: ``row0 = bounds[shard0]``), and a slot is a
    row's index among them.

    A record is eligible at shard ``s`` when it stages a mutation, is not
    EMPTY, and either its target lies in ``s``'s rows (STORE, CAS, FREE) or
    ``s`` is its home (ALLOC).  Its key is ``(class * capacity + slot) * L +
    id`` (class 0 STORE/CAS, 1 FREE, 2 ALLOC; slot 0 for an ALLOC); every
    other record's is ``key_top``.  One sort by it is the JAX package's
    four-pass lexsort (eligible first, then class, slot, id) whenever the
    ids lie in ``[0, L)``, as placement gives them."""
    P, L, _ = pools.shape
    top = key_top(capacity, L)
    MB = F_SCRATCH + scratch_words
    m_op = pools[..., MB]
    tgt = pools[..., MB + 1]
    me = shard0 + torch.arange(P, dtype=torch.int32, device=pools.device)[:, None]
    pend = (m_op != M_NONE) & (pools[..., F_STATUS] != STATUS_EMPTY)
    is_alloc = m_op == M_ALLOC
    edges = bounds[shard0 : shard0 + P + 1]
    local = (tgt >= edges[:-1, None]) & (tgt < edges[1:, None])
    eligible = pend & torch.where(is_alloc, pools[..., F_HOME] == me, local)
    klass = torch.where(is_alloc, 2, torch.where(m_op == M_FREE, 1, 0)).long()
    slot = torch.where(is_alloc, 0, tgt - row0).long()
    key = (klass * capacity + slot) * L + pools[..., F_ID].long()
    return torch.where(eligible, key, top)


def _mask_bits(mask, W: int):
    """``(n, W)`` bool: word ``w`` of each int32 mask, widened by sign past
    bit 31 as the JAX package's commit widens it."""
    shift = torch.arange(W, device=mask.device).clamp(max=31)
    return ((mask[:, None].long() >> shift) & 1) == 1


def pulse_commit_staged(pools, data, heap, bounds, perms, *, scratch_words: int,
                        shard0: int = 0, row0: int = 0):
    """Every shard's commit phase by the kernel's stages, in torch ops, in
    place on ``pools`` (P, L, R), ``data`` (cap, W) and ``heap`` (P,
    HEAP_WORDS), all int32 and contiguous.  Bit-equal to the serial
    ``commit_shard`` on every shard.  Returns them.

    With ``shard0`` the pools and heap rows are those of shards ``shard0
    .. shard0 + P - 1`` of the ``perms.shape[0]`` that ``bounds`` and
    ``perms`` describe, and ``data``'s first row is global row ``row0`` (a
    memory node's own rows: ``row0 = bounds[shard0]``); targets, free-list
    links and claimed slots stay global addresses.

      1. the order key of every record (``commit_key``);
      2. one stable sort of each shard's keys: STOREs/CASes by slot, then
         FREEs, then ALLOCs;
      3. the STOREs and CASes: records to distinct slots touch distinct
         rows, so round r applies the r-th record of every same-slot run at
         once (a CAS reads what the run's earlier records wrote); a shard
         without PERM_WRITE instead faults every eligible record;
      4. per writable shard: the j-th FREE links its row to the (j-1)-th
         FREE's target (the free head for j = 0), the last FREE of a
         same-slot run writing; the ALLOCs pop the free list serially while
         it lasts, and the rest take ``bump, bump + 1, ...`` below ``hi``
         at once (the others fault); then the heap registers."""
    P, L, R = pools.shape
    cap, W = data.shape
    S = scratch_words
    if P * L == 0:
        return pools, data, heap
    MB = F_SCRATCH + S
    top = key_top(cap, L)
    cl = cap * L  # the first FREE key
    sk, idx = torch.sort(commit_key(pools, bounds, scratch_words=S, capacity=cap,
                                    shard0=shard0, row0=row0), dim=1, stable=True)
    flat = pools.view(P * L, R)
    rec = idx + torch.arange(P, device=idx.device)[:, None] * L  # (P, L) rows of ``flat``
    writable = (perms[shard0 : shard0 + P] & PERM_WRITE) == PERM_WRITE
    eligible = sk < top
    denied = rec[eligible & ~writable[:, None]]
    flat[denied, F_STATUS] = STATUS_FAULT
    flat[denied, MB] = M_NONE

    # stage 3: the STOREs and CASes, round by round through the same-slot runs
    slot = torch.div(sk, L, rounding_mode="floor")
    store = (sk < cl) & writable[:, None]
    pos = torch.arange(L, device=sk.device).expand(P, L)
    head = store.clone()
    head[:, 1:] &= slot[:, 1:] != slot[:, :-1]
    rank = pos - torch.where(head, pos, -1).cummax(dim=1).values
    rounds = int(rank[store].max()) + 1 if bool(store.any()) else 0
    for r in range(rounds):
        sel = store & (rank == r)
        g, rows = rec[sel], slot[sel]
        hdr = flat[g]
        bits = _mask_bits(hdr[:, MB + 2], W)
        old = data[rows]
        guard = old.gather(1, bits.int().argmax(1, keepdim=True))[:, 0]  # word 0 if none
        hit = (hdr[:, MB] == M_STORE) | (guard == hdr[:, MB + 3])
        data[rows] = torch.where(bits & hit[:, None], hdr[:, MB + 4 : MB + 4 + W], old)
        flat[g, MB] = M_NONE

    # stage 4: the FREEs, the ALLOCs and the heap registers of each writable shard
    n1 = (sk < cl).sum(1).tolist()
    n2 = (sk < 2 * cl).sum(1).tolist()
    n3 = eligible.sum(1).tolist()
    edges = bounds.tolist()
    ok = writable.tolist()
    for s in range(P):
        b1, b2, n = n1[s], n2[s], n3[s]
        if not ok[s] or n == 0:
            continue
        lo, hi = int(edges[shard0 + s]), int(edges[shard0 + s + 1])
        free_head = int(heap[s, H_FREE])
        if b2 > b1:
            tgt = slot[s, b1:b2] - cap  # local rows
            link = torch.cat([tgt.new_tensor([free_head]), tgt[:-1] + row0])
            last = torch.ones_like(tgt, dtype=torch.bool)
            last[:-1] = tgt[1:] != tgt[:-1]
            rows = torch.zeros(int(last.sum()), W, dtype=data.dtype, device=data.device)
            rows[:, 0] = link[last].to(data.dtype)
            data[tgt[last]] = rows
            flat[rec[s, b1:b2], MB] = M_NONE
            free_head = int(tgt[-1]) + row0
        allocs = rec[s, b2:n]
        hdr = flat[allocs]
        bits = _mask_bits(hdr[:, MB + 2], W)
        fresh = torch.where(bits, hdr[:, MB + 4 : MB + 4 + W], 0).to(data.dtype)
        scratch_col = F_SCRATCH + hdr[:, MB + 1].clamp(0, S - 1)
        k = 0
        while k < len(allocs) and free_head != NULL:  # the serial residue
            row = lo + min(max(free_head - lo, 0), hi - lo - 1) - row0
            nxt = int(data[row, 0])
            data[row] = fresh[k]
            flat[allocs[k], scratch_col[k]] = free_head
            free_head = nxt
            k += 1
        bump = int(heap[s, H_BUMP])
        rest = torch.arange(len(allocs) - k, device=sk.device)
        slots = bump + rest
        claim = slots < hi
        n_claim = int(claim.sum())
        # a slot below ``lo`` clamps to ``lo``: only the last ALLOC writing
        # that row (the first at ``lo``, or the last claimed) writes it
        write = claim & ((slots >= lo) | (rest == n_claim - 1))
        rows = lo + (slots - lo).clamp(0, hi - lo - 1) - row0
        data[rows[write]] = fresh[k:][write]
        flat[allocs[k:][claim], scratch_col[k:][claim]] = slots[claim].to(flat.dtype)
        flat[allocs[k:][~claim], F_STATUS] = STATUS_FAULT
        flat[allocs, MB] = M_NONE
        heap[s, H_FREE] = free_head
        heap[s, H_BUMP] = bump + n_claim
        heap[s, H_EPOCH] += 1
        heap[s, H_COMMITS] += n
    return pools, data, heap
