"""STL ``std::find`` over list/forward_list (paper Listings 4-5).

Node layout (W=4): ``[key, value, next, pad]``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.arena import M_ALLOC, M_CAS, M_FREE, M_NONE, NULL, ArenaBuilder, wrap32
from repro_torch.core.iterator import PulseIterator

NODE_WORDS = 4
KEY, VALUE, NEXT = 0, 1, 2

# scratch layout for find: [search_key, result_value, found_flag]
SCRATCH_WORDS = 3
KEY_NOT_FOUND = -(2**31) + 1

# the dispatch model's instruction count N of each iterator body below (the
# weighted critical path of its traced next/end, or of its mutating step,
# see core.dispatch)
FIND_INSTRUCTIONS = 6
SUM_INSTRUCTIONS = 4
RW_INSTRUCTIONS = 14

# ---------------------------------------------------------------------------
# Write path (chain structures): optimistic tail-insert and unlink-delete.
#
# One scratch layout serves find/insert/delete so a single mutating iterator
# (``rw_iterator``) serves a *mixed* read/write batch -- finds race inserts
# and deletes inside the same supersteps, and the commit phase serializes
# the writers:
#   [op, key, value, state, result, aux_prev, aux_victim, aux_vnext]
# op: 0 find / 1 insert / 2 delete.
RW_OP, RW_KEY, RW_VAL, RW_STATE, RW_RES, RW_A, RW_B, RW_C = range(8)
RW_WORDS = 8
OP_FIND, OP_INSERT, OP_DELETE = 0, 1, 2


def build_into(b: ArenaBuilder, keys: np.ndarray, values: np.ndarray) -> int:
    """Builds a singly linked list into a (possibly shared) heap; returns the
    head pointer."""
    keys = np.asarray(keys, np.int32)
    values = np.asarray(values, np.int32)
    n = len(keys)
    ptrs = b.alloc(n)
    rec = np.zeros((n, NODE_WORDS), np.int32)
    rec[:, KEY] = keys
    rec[:, VALUE] = values
    rec[:-1, NEXT] = ptrs[1:]
    rec[-1, NEXT] = NULL
    b.write(ptrs, rec)
    return int(ptrs[0])


def build(
    keys: np.ndarray,
    values: np.ndarray,
    num_shards: int = 1,
    policy: str = "sequential",
    capacity: int | None = None,
    *,
    device="cuda",
):
    """Builds a singly linked list in list order; returns (arena, head_ptr)."""
    n = len(keys)
    cap = capacity or max(num_shards, ((n + num_shards - 1) // num_shards) * num_shards)
    b = ArenaBuilder(cap, NODE_WORDS, num_shards=num_shards, policy=policy)
    head = build_into(b, keys, values)
    return b.finish(device=device), head


def find_iterator() -> PulseIterator:
    """``std::find(first, last, value)`` -> PULSE (Listing 5)."""

    def init(search_keys, head_ptr):
        sk = torch.as_tensor(search_keys, dtype=torch.int32)
        B = sk.shape[0]
        ptr0 = torch.full((B,), int(head_ptr), dtype=torch.int32, device=sk.device)
        scratch0 = torch.zeros((B, SCRATCH_WORDS), dtype=torch.int32, device=sk.device)
        scratch0[:, 0] = sk
        return ptr0, scratch0

    def next_fn(node, ptr, scratch):
        return node[:, NEXT], scratch

    def end_fn(node, ptr, scratch):
        hit = node[:, KEY] == scratch[:, 0]
        tail = node[:, NEXT] == NULL
        scratch = scratch.clone()
        scratch[:, 1] = torch.where(hit, node[:, VALUE], KEY_NOT_FOUND)
        scratch[:, 2] = hit.to(torch.int32)
        return hit | tail, scratch

    return PulseIterator(
        scratch_words=SCRATCH_WORDS,
        next_fn=next_fn,
        end_fn=end_fn,
        init_fn=init,
        name="list_find",
        n_instructions=FIND_INSTRUCTIONS,
    )


def sum_iterator() -> PulseIterator:
    """Stateful aggregation: sum all values along the chain (scratch carries
    the running sum -- the paper's 'continuation' use of the scratch pad)."""
    S = 2  # [running_sum, count]

    def init(head_ptrs):
        heads = torch.as_tensor(head_ptrs, dtype=torch.int32)
        return heads, torch.zeros((heads.shape[0], S), dtype=torch.int32,
                                  device=heads.device)

    def next_fn(node, ptr, scratch):
        return node[:, NEXT], scratch

    def end_fn(node, ptr, scratch):
        scratch = scratch.clone()
        scratch[:, 0] = wrap32(scratch[:, 0].long() + node[:, VALUE])
        scratch[:, 1] = scratch[:, 1] + 1
        return node[:, NEXT] == NULL, scratch

    return PulseIterator(
        S, next_fn, end_fn, init, name="list_sum", n_instructions=SUM_INSTRUCTIONS
    )


# ------------------------------ write path ---------------------------------


def chain_rw_step(node, ptr, scratch):
    """One iteration of the chain read/write state machine for a batch of
    lanes (shared by linked_list and hash_table: the node layout is the
    same).

    Insert appends at the tail: walk to NEXT == NULL, stage ALLOC of the new
    node (the commit deposits its address into scratch[RW_RES]), then CAS
    the tail's NEXT from NULL to the new address; a lost CAS is observed on
    the next iteration (NEXT neither NULL nor ours) and the walk resumes
    toward the new tail.  Delete walks with a carried prev pointer, CASes
    prev.NEXT from victim to victim.NEXT, validates at prev, then FREEs the
    victim's slot.  The first node of a chain acts as a sentinel and is
    never deleted.

    Known limitation (per-node locks are future work): a concurrent delete
    of the same victim, or an ABA on a freed-and-reused slot, is not
    detected -- a workload must not race two deletes of one key.
    """
    op = scratch[:, RW_OP]
    key = scratch[:, RW_KEY]
    val = scratch[:, RW_VAL]
    st = scratch[:, RW_STATE]
    nkey, nval, nnext = node[:, KEY], node[:, VALUE], node[:, NEXT]
    zeros = torch.zeros_like(node)

    is_find = op == OP_FIND
    is_ins = op == OP_INSERT
    is_del = op == OP_DELETE

    # ---- find -------------------------------------------------------------
    f_hit = nkey == key
    f_done = f_hit | (nnext == NULL)
    f_scratch = scratch.clone()
    f_scratch[:, RW_VAL] = torch.where(f_hit, nval, KEY_NOT_FOUND)
    f_scratch[:, RW_RES] = f_hit.to(torch.int32)

    # ---- insert -----------------------------------------------------------
    at_tail = nnext == NULL
    linked = nnext == scratch[:, RW_RES]
    i0, i1 = st == 0, st == 1
    ins_done = i1 & linked
    ins_stage_alloc = i0 & at_tail
    ins_stage_cas = i1 & at_tail
    ins_advance = ~at_tail & ~ins_done
    i_scratch = scratch.clone()
    i_scratch[:, RW_STATE] = torch.where(ins_stage_alloc, 1, st)
    alloc_data = zeros.clone()
    alloc_data[:, KEY], alloc_data[:, VALUE], alloc_data[:, NEXT] = key, val, NULL
    alloc_mask = (1 << KEY) | (1 << VALUE) | (1 << NEXT)
    ins_cas_data = zeros.clone()
    ins_cas_data[:, NEXT] = scratch[:, RW_RES]

    # ---- delete -----------------------------------------------------------
    prev, victim, vnext = scratch[:, RW_A], scratch[:, RW_B], scratch[:, RW_C]
    d0, d1, d2 = st == 0, st == 1, st == 2
    d_hit = nkey == key
    d_hasprev = prev != NULL
    del_stage_cas = d0 & d_hit & d_hasprev
    del_miss = d0 & ((d_hit & ~d_hasprev) | (~d_hit & (nnext == NULL)))
    del_ok = d1 & (nnext == vnext)  # the swing took; free the victim
    del_refind = d1 & ~del_ok  # lost the CAS: walk again from prev
    del_done = d2  # the free committed
    d_advance = d0 & ~d_hit & (nnext != NULL)
    d_scratch = scratch.clone()
    d_scratch[:, RW_A] = torch.where(d_advance, ptr, prev)
    d_scratch[:, RW_B] = torch.where(del_stage_cas, ptr, victim)
    d_scratch[:, RW_C] = torch.where(del_stage_cas, nnext, vnext)
    d_scratch[:, RW_STATE] = torch.where(
        del_stage_cas, 1,
        torch.where(del_ok, 2, torch.where(del_refind, 0, st)))
    d_scratch[:, RW_RES] = torch.where(del_done, 1, scratch[:, RW_RES])
    # the CAS is staged on the iteration that finds the victim, so its
    # payload takes the live values (ptr, nnext), not the scratch copies
    del_cas_data = zeros.clone()
    del_cas_data[:, NEXT] = nnext

    # ---- combine ----------------------------------------------------------
    done = (
        (is_find & f_done)
        | (is_ins & ins_done)
        | (is_del & (del_miss | del_done))
    )
    new_ptr = torch.where(
        is_find,
        nnext,
        torch.where(
            is_ins,
            torch.where(ins_advance, nnext, ptr),
            torch.where(d_advance, nnext, torch.where(del_stage_cas, prev, ptr)),
        ),
    )
    new_scratch = torch.where(
        is_find[:, None], f_scratch, torch.where(is_ins[:, None], i_scratch, d_scratch)
    )

    stage_alloc = is_ins & ins_stage_alloc
    stage_cas = (is_ins & ins_stage_cas) | (is_del & del_stage_cas)
    m_op = torch.where(
        stage_alloc, M_ALLOC,
        torch.where(stage_cas, M_CAS, torch.where(is_del & del_ok, M_FREE, M_NONE)),
    )
    m_tgt = torch.where(
        stage_alloc,
        RW_RES,
        torch.where(
            is_ins & ins_stage_cas, ptr,
            torch.where(is_del & del_stage_cas, prev, victim)),
    )
    m_mask = torch.where(stage_alloc, alloc_mask, torch.where(stage_cas, 1 << NEXT, 0))
    m_expect = torch.where(
        is_ins & ins_stage_cas, NULL,
        torch.where(is_del & del_stage_cas, ptr, 0),
    )
    m_data = torch.where(
        stage_alloc[:, None],
        alloc_data,
        torch.where(
            (is_ins & ins_stage_cas)[:, None],
            ins_cas_data,
            torch.where((is_del & del_stage_cas)[:, None], del_cas_data, zeros),
        ),
    )
    return done, new_ptr, new_scratch, (m_op, m_tgt, m_mask, m_expect, m_data)


def _device_of(*xs):
    return next((x.device for x in xs if isinstance(x, torch.Tensor)), torch.device("cpu"))


def _rw_init(ops, keys, values, head_ptr):
    dev = _device_of(keys, ops, values, head_ptr)
    ops = torch.as_tensor(ops, dtype=torch.int32).to(dev)
    B = ops.shape[0]
    scratch = torch.zeros((B, RW_WORDS), dtype=torch.int32, device=dev)
    scratch[:, RW_OP] = ops
    scratch[:, RW_KEY] = torch.as_tensor(keys, dtype=torch.int32).to(dev)
    scratch[:, RW_VAL] = torch.as_tensor(values, dtype=torch.int32).to(dev)
    scratch[:, RW_A] = NULL  # delete's prev pointer
    ptr0 = torch.as_tensor(head_ptr, dtype=torch.int32).to(dev).expand(B).clone()
    return ptr0, scratch


def rw_iterator() -> PulseIterator:
    """Mixed read/write chain iterator: each record's scratch[RW_OP] selects
    find, tail-insert, or delete -- all racing in the same batch, serialized
    only by the commit phases.  ``init(ops, keys, values, head)``."""
    return PulseIterator(
        scratch_words=RW_WORDS,
        next_fn=lambda node, ptr, scratch: (node[:, NEXT], scratch),
        end_fn=lambda node, ptr, scratch: (node[:, NEXT] == NULL, scratch),
        init_fn=_rw_init,
        mut_fn=chain_rw_step,
        name="list_rw",
        n_instructions=RW_INSTRUCTIONS,
    )


def insert_iterator() -> PulseIterator:
    """Tail-insert: ``init(keys, values, head)``; the committed node's global
    address lands in scratch[RW_RES]."""

    def init(keys, values, head_ptr):
        keys = torch.as_tensor(keys, dtype=torch.int32)
        return _rw_init(torch.full_like(keys, OP_INSERT), keys, values, head_ptr)

    return dataclasses.replace(rw_iterator(), init_fn=init, name="list_insert")


def delete_iterator() -> PulseIterator:
    """Unlink + free by key: ``init(keys, head)``; scratch[RW_RES] reports
    success.  The chain's first node is a sentinel and is never deleted."""

    def init(keys, head_ptr):
        keys = torch.as_tensor(keys, dtype=torch.int32)
        return _rw_init(torch.full_like(keys, OP_DELETE), keys, torch.zeros_like(keys),
                        head_ptr)

    return dataclasses.replace(rw_iterator(), init_fn=init, name="list_delete")


# ------------------------------- references --------------------------------


def ref_find(keys, values, search_keys):
    """Pure-python oracle for find_iterator results (value, found, hops)."""
    keys = list(map(int, keys))
    out = []
    for sk in map(int, search_keys):
        hops = 0
        val, found = KEY_NOT_FOUND, 0
        for i, k in enumerate(keys):
            hops += 1
            if k == sk:
                val, found = int(values[i]), 1
                break
        else:
            hops = len(keys)
        out.append((val, found, hops))
    return out
