"""Skip list with PULSE-friendly fat pointers (beyond-paper structure).

A classic skip-list search compares the *successor's* key before advancing,
which would need two loads per hop.  PULSE's single-aggregated-LOAD rule
(S4.1) motivates a layout that caches each successor's key next to its
pointer ("fat pointers"), the co-design trick of the disaggregated-native
structures the paper cites (Sherman/ROLEX, S2.2):

  node (W=12): [key, value, (next_ptr[l], next_key[l]) for l in 0..3, pad, pad]

One load per hop then suffices: pick the highest level whose cached successor
key does not overshoot the target.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.arena import (
    M_ALLOC,
    M_CAS,
    M_FREE,
    M_NONE,
    M_STORE,
    NULL,
    ArenaBuilder,
)
from repro_torch.core.iterator import PulseIterator

LEVELS = 4
NODE_WORDS = 12
KEY, VALUE = 0, 1
NPTR0 = 2  # next ptrs at words 2,4,6,8 ; next keys at 3,5,7,9
KEY_NOT_FOUND = -(2**31) + 1
INT_MAX = 2**31 - 1
SCRATCH_WORDS = 3  # [target, value, found]

# the dispatch model's instruction count N of each iterator body below
FIND_INSTRUCTIONS = 10
INSERT_INSTRUCTIONS = 14
DELETE_INSTRUCTIONS = 14


def _level_of(i):
    """Deterministic geometric(1/4) level from a hashed index (an int or an
    integer array)."""
    h = (np.asarray(i, np.int64) * 2654435761) & 0xFFFFFFFF
    lvl = np.zeros(h.shape, np.int64)
    rising = np.ones(h.shape, bool)
    for _ in range(LEVELS - 1):
        rising &= (h & 3) == 3
        lvl += rising
        h >>= 2
    return lvl if lvl.ndim else int(lvl)


def build_into(b: ArenaBuilder, keys: np.ndarray, values: np.ndarray) -> int:
    """Builds the skip list into a (possibly shared) heap; returns head_ptr."""
    keys = np.asarray(keys, np.int32)
    values = np.asarray(values, np.int32)
    order = np.argsort(keys, kind="stable")
    keys, values = keys[order], values[order]
    n = len(keys)
    total = n + 1  # + head
    ptrs = b.alloc(total)  # ptrs[0] = head, ptrs[1+i] = i-th key
    levels = np.concatenate([[LEVELS - 1], _level_of(np.arange(n))])
    rec = np.zeros((total, NODE_WORDS), np.int32)
    rec[0, KEY] = -(2**31)
    rec[1:, KEY] = keys
    rec[1:, VALUE] = values
    for lv in range(LEVELS):
        # default: no successor; then link the level's chain in key order
        rec[:, NPTR0 + 2 * lv] = NULL
        rec[:, NPTR0 + 2 * lv + 1] = INT_MAX
        chain = np.flatnonzero(levels >= lv)  # the head (0) first
        rec[chain[:-1], NPTR0 + 2 * lv] = ptrs[chain[1:]]
        rec[chain[:-1], NPTR0 + 2 * lv + 1] = rec[chain[1:], KEY]
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
    """Builds from sorted keys; returns (arena, head_ptr)."""
    total = len(keys) + 1  # + head
    cap = capacity or max(
        num_shards, ((total + num_shards - 1) // num_shards) * num_shards
    )
    b = ArenaBuilder(cap, NODE_WORDS, num_shards=num_shards, policy=policy)
    head = build_into(b, keys, values)
    return b.finish(device=device), head


def _levels(node):
    """(next keys, next ptrs), each (B, LEVELS), of a batch of nodes."""
    return (node[:, NPTR0 + 1 : NPTR0 + 2 * LEVELS : 2],
            node[:, NPTR0 : NPTR0 + 2 * LEVELS : 2])


def _jump(ok, nptrs):
    """(any level ok, the pointer of the highest ok level or NULL)."""
    lvl = torch.arange(LEVELS, device=ok.device)
    top = torch.where(ok, lvl, -1).amax(dim=1)
    can = top >= 0
    nxt = nptrs.gather(1, top.clamp(min=0).long()[:, None])[:, 0]
    return can, torch.where(can, nxt, NULL)


def _advance(node, target):
    """Longest jump to a node with key at most ``target``."""
    nkeys, nptrs = _levels(node)
    return _jump(nkeys <= target[:, None], nptrs)


def _advance_strict(node, key):
    """Pred walk: longest jump to a node with key strictly below ``key``."""
    nkeys, nptrs = _levels(node)
    return _jump(nkeys < key[:, None], nptrs)


def _start(head_ptr, keys):
    return torch.full((keys.shape[0],), int(head_ptr), dtype=torch.int32, device=keys.device)


def find_iterator() -> PulseIterator:
    def init(search_keys, head_ptr):
        sk = torch.as_tensor(search_keys, dtype=torch.int32)
        scratch = torch.zeros((sk.shape[0], SCRATCH_WORDS), dtype=torch.int32,
                              device=sk.device)
        scratch[:, 0] = sk
        scratch[:, 1] = KEY_NOT_FOUND
        return _start(head_ptr, sk), scratch

    def next_fn(node, ptr, scratch):
        return _advance(node, scratch[:, 0])[1], scratch

    def end_fn(node, ptr, scratch):
        target = scratch[:, 0]
        hit = node[:, KEY] == target
        can, _ = _advance(node, target)
        scratch = scratch.clone()
        scratch[:, 1] = torch.where(hit, node[:, VALUE], KEY_NOT_FOUND)
        scratch[:, 2] = hit.to(torch.int32)
        return hit | ~can, scratch  # found, or stuck (no successor <= target)

    return PulseIterator(SCRATCH_WORDS, next_fn, end_fn, init, name="skiplist_find",
                         n_instructions=FIND_INSTRUCTIONS)


def ref_find(keys, values, search_keys):
    d = {int(k): int(v) for k, v in zip(keys, values)}
    return [(d.get(int(k), KEY_NOT_FOUND), int(int(k) in d)) for k in search_keys]


# ------------------------------ write path ---------------------------------
#
# Runtime inserts link at level 0 only: the new node is a full tower record
# (upper levels empty), reachable through every search path because level 0
# is the ground-truth list; upper levels merely shortcut.  Runtime deletes
# are therefore valid for level-0 nodes (everything inserted at runtime);
# deleting a build-time node with a taller tower would leave stale tower
# links -- per-node locks and tower repair are future work.

# insert scratch: [key, value, state, new_ptr, succ_ptr]
SI_KEY, SI_VAL, SI_ST, SI_RES, SI_SUCC = range(5)
SI_WORDS = 5
# delete scratch: [key, state, prev, victim, victim_next0, result]
SD_KEY, SD_ST, SD_PREV, SD_VICTIM, SD_VNEXT, SD_RES = range(6)
SD_WORDS = 6

_LINK_MASK = (1 << NPTR0) | (1 << (NPTR0 + 1))  # (next_ptr0, next_key0)


def _link(zeros, ptr, key):
    """A payload whose level-0 fat pointer is (ptr, key)."""
    out = zeros.clone()
    out[:, NPTR0], out[:, NPTR0 + 1] = ptr, key
    return out


def insert_iterator() -> PulseIterator:
    """Optimistic level-0 insert with fat-pointer maintenance: descend to the
    strict predecessor, ALLOC the new tower (level-0 links copied from the
    pred's cached fat pointer), then CAS the pred's (next_ptr0, next_key0)
    pair; a lost race is observed at the pred and repaired by re-fixing the
    new node's own links (blind STORE -- it is unreachable until linked) and
    re-CASing.  Duplicate keys free the allocated node and report found=0.
    ``init(keys, values, head)``."""

    def init(keys, values, head_ptr):
        keys = torch.as_tensor(keys, dtype=torch.int32)
        scratch = torch.zeros((keys.shape[0], SI_WORDS), dtype=torch.int32,
                              device=keys.device)
        scratch[:, SI_KEY] = keys
        scratch[:, SI_VAL] = torch.as_tensor(values, dtype=torch.int32).to(keys.device)
        return _start(head_ptr, keys), scratch

    def mut_fn(node, ptr, scratch):
        key, val, st = scratch[:, SI_KEY], scratch[:, SI_VAL], scratch[:, SI_ST]
        res, succ = scratch[:, SI_RES], scratch[:, SI_SUCC]
        zeros = torch.zeros_like(node)
        can_adv, nxt = _advance_strict(node, key)
        next0, nkey0 = node[:, NPTR0], node[:, NPTR0 + 1]
        at_pred = ~can_adv
        dup = at_pred & (nkey0 == key)
        s0, s1, s3 = st == 0, st == 1, st == 3

        # state 0: descend; at the pred, ALLOC the tower (or bail on dup)
        stage_alloc = s0 & at_pred & ~dup
        tower = _link(zeros, next0, nkey0)
        tower[:, KEY], tower[:, VALUE] = key, val
        for lv in range(1, LEVELS):
            tower[:, NPTR0 + 2 * lv] = NULL
            tower[:, NPTR0 + 2 * lv + 1] = INT_MAX
        tower_mask = (1 << (2 + 2 * LEVELS)) - 1  # words 0 .. 1+2*LEVELS

        # state 1: at the pred with an allocated node
        linked = s1 & (next0 == res)
        open_ = s1 & at_pred & ~linked
        stage_free = open_ & dup  # someone linked our key: give the slot back
        stage_fix = open_ & ~dup & (next0 != succ)  # blind STORE: still unreachable
        stage_cas = open_ & ~dup & (next0 == succ)
        done = (s0 & dup) | linked | s3

        advance = (s0 | s1) & can_adv & ~done
        new_ptr = torch.where(advance, nxt, ptr)
        new_scratch = scratch.clone()
        new_scratch[:, SI_ST] = torch.where(stage_alloc, 1, torch.where(stage_free, 3, st))
        new_scratch[:, SI_SUCC] = torch.where(stage_alloc | stage_fix, next0, succ)

        m_op = torch.where(
            stage_alloc, M_ALLOC,
            torch.where(stage_cas, M_CAS,
                        torch.where(stage_fix, M_STORE,
                                    torch.where(stage_free, M_FREE, M_NONE))))
        m_tgt = torch.where(
            stage_alloc, SI_RES,
            torch.where(stage_cas, ptr, torch.where(stage_fix | stage_free, res, 0)))
        m_mask = torch.where(
            stage_alloc, tower_mask, torch.where(stage_cas | stage_fix, _LINK_MASK, 0))
        m_expect = torch.where(stage_cas, succ, 0)
        m_data = torch.where(
            stage_alloc[:, None], tower,
            torch.where(stage_cas[:, None], _link(zeros, res, key),
                        torch.where(stage_fix[:, None], _link(zeros, next0, nkey0), zeros)))
        return done, new_ptr, new_scratch, (m_op, m_tgt, m_mask, m_expect, m_data)

    return PulseIterator(
        scratch_words=SI_WORDS,
        next_fn=lambda node, ptr, scratch: (
            _advance_strict(node, scratch[:, SI_KEY])[1], scratch),
        end_fn=lambda node, ptr, scratch: (
            ~_advance_strict(node, scratch[:, SI_KEY])[0], scratch),
        init_fn=init,
        mut_fn=mut_fn,
        name="skiplist_insert",
        n_instructions=INSERT_INSTRUCTIONS,
    )


def delete_iterator() -> PulseIterator:
    """Unlink a level-0 node: descend to the strict pred, hop to the victim
    to read its level-0 links, CAS the pred's fat pointer past it, validate,
    then FREE the slot.  ``init(keys, head_ptr)``; scratch[SD_RES] reports
    success (absent keys report 0)."""

    def init(keys, head_ptr):
        keys = torch.as_tensor(keys, dtype=torch.int32)
        scratch = torch.zeros((keys.shape[0], SD_WORDS), dtype=torch.int32,
                              device=keys.device)
        scratch[:, SD_KEY] = keys
        return _start(head_ptr, keys), scratch

    def mut_fn(node, ptr, scratch):
        key, st = scratch[:, SD_KEY], scratch[:, SD_ST]
        prev, victim = scratch[:, SD_PREV], scratch[:, SD_VICTIM]
        zeros = torch.zeros_like(node)
        can_adv, nxt = _advance_strict(node, key)
        next0, nkey0 = node[:, NPTR0], node[:, NPTR0 + 1]
        at_pred = ~can_adv
        s0, s1, s2, s3 = st == 0, st == 1, st == 2, st == 3

        # state 0: descend to the pred; hop to the victim (or miss)
        found = s0 & at_pred & (nkey0 == key)
        miss = s0 & at_pred & (nkey0 != key)
        # state 1: at the victim -- read its links, CAS the pred past it
        stage_cas = s1
        # state 2: back at the pred -- validate the swing
        swung = s2 & (next0 == scratch[:, SD_VNEXT])
        refind = s2 & ~swung  # lost the race: walk again from the pred
        stage_free = swung
        done = miss | s3

        advance = s0 & can_adv
        new_ptr = torch.where(
            advance, nxt,
            torch.where(found, next0,  # hop to the victim
                        torch.where(stage_cas, prev, ptr)))
        new_scratch = scratch.clone()
        new_scratch[:, SD_PREV] = torch.where(found, ptr, prev)
        new_scratch[:, SD_VICTIM] = torch.where(found, next0, victim)
        new_scratch[:, SD_VNEXT] = torch.where(stage_cas, next0, scratch[:, SD_VNEXT])
        new_scratch[:, SD_ST] = torch.where(
            found, 1,
            torch.where(stage_cas, 2, torch.where(swung, 3, torch.where(refind, 0, st))))
        new_scratch[:, SD_RES] = torch.where(s3, 1, scratch[:, SD_RES])

        m_op = torch.where(stage_cas, M_CAS, torch.where(stage_free, M_FREE, M_NONE))
        m_tgt = torch.where(stage_cas, prev, torch.where(stage_free, victim, 0))
        m_mask = torch.where(stage_cas, _LINK_MASK, 0)
        m_expect = torch.where(stage_cas, victim, 0)
        m_data = torch.where(stage_cas[:, None], _link(zeros, next0, nkey0), zeros)
        return done, new_ptr, new_scratch, (m_op, m_tgt, m_mask, m_expect, m_data)

    return PulseIterator(
        scratch_words=SD_WORDS,
        next_fn=lambda node, ptr, scratch: (
            _advance_strict(node, scratch[:, SD_KEY])[1], scratch),
        end_fn=lambda node, ptr, scratch: (
            ~_advance_strict(node, scratch[:, SD_KEY])[0], scratch),
        init_fn=init,
        mut_fn=mut_fn,
        name="skiplist_delete",
        n_instructions=DELETE_INSTRUCTIONS,
    )
