"""Google-BTree descent (paper Listings 8-9) + B+tree leaf-chain range
aggregation (the WiredTiger / BTrDB workload shape, paper S6).

Node layout (W=20, one 80 B record -> single aggregated LOAD):
  word 0      is_leaf
  word 1      num_keys (<= FANOUT)
  words 2..9  keys[FANOUT]
  internal:   words 10..18 children[FANOUT+1]
  leaf:       words 10..17 values[FANOUT], word 18 next_leaf
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.arena import M_NONE, M_STORE, NULL, ArenaBuilder, bit32, wrap32
from repro_torch.core.iterator import PulseIterator

FANOUT = 8  # kNodeValues in Listing 8
NODE_WORDS = 20
IS_LEAF, NUM_KEYS, KEYS0, CHILD0, VAL0, NEXT_LEAF = 0, 1, 2, 10, 10, 18
KEY_NOT_FOUND = -(2**31) + 1
INT_MIN = -(2**31)
INT_MAX = 2**31 - 1

# the dispatch model's instruction count N of each iterator body below
FIND_INSTRUCTIONS = 14
RANGE_AGGREGATE_INSTRUCTIONS = 14
UPDATE_INSTRUCTIONS = 16


def node_estimate(n: int) -> int:
    """Upper bound on node count: leaves + internals (geometric series)."""
    n_leaves = max(1, (n + FANOUT - 1) // FANOUT)
    total, level = n_leaves, n_leaves
    while level > 1:
        level = (level + FANOUT) // (FANOUT + 1)
        total += level
    return total


def build_into(b: ArenaBuilder, keys: np.ndarray, values: np.ndarray):
    """Bulk-loads a B+tree into a (possibly shared) heap; returns
    (root_ptr, height).  Each level is laid out with whole-array numpy ops,
    node for node the same records as a per-node loop."""
    keys = np.asarray(keys, np.int32)
    values = np.asarray(values, np.int32)
    order = np.argsort(keys, kind="stable")
    keys, values = keys[order], values[order]
    n = len(keys)
    n_leaves = max(1, (n + FANOUT - 1) // FANOUT)

    # --- leaves ---
    leaf_ptrs = b.alloc(n_leaves)
    kpad = np.full(n_leaves * FANOUT, INT_MAX, np.int32)  # pad keys high
    kpad[:n] = keys
    vpad = np.zeros(n_leaves * FANOUT, np.int32)
    vpad[:n] = values
    kpad, vpad = kpad.reshape(n_leaves, FANOUT), vpad.reshape(n_leaves, FANOUT)
    nk = np.clip(n - np.arange(n_leaves) * FANOUT, 0, FANOUT).astype(np.int32)
    recs = np.zeros((n_leaves, NODE_WORDS), np.int32)
    recs[:, IS_LEAF] = 1
    recs[:, NUM_KEYS] = nk
    recs[:, KEYS0 : KEYS0 + FANOUT] = kpad
    recs[:, VAL0 : VAL0 + FANOUT] = vpad
    recs[:-1, NEXT_LEAF] = leaf_ptrs[1:]
    recs[-1, NEXT_LEAF] = NULL
    maxkeys = np.where(
        nk > 0, kpad[np.arange(n_leaves), np.maximum(nk - 1, 0)], INT_MAX
    ).astype(np.int32)
    b.write(leaf_ptrs, recs)

    # --- internal levels ---
    height = 1
    child_ptrs, child_max = leaf_ptrs, maxkeys
    while len(child_ptrs) > 1:
        height += 1
        L = len(child_ptrs)
        n_nodes = (L + FANOUT) // (FANOUT + 1)
        ptrs = b.alloc(n_nodes)
        cp = np.zeros(n_nodes * (FANOUT + 1), np.int32)
        cp[:L] = child_ptrs
        cm = np.full(n_nodes * (FANOUT + 1), INT_MAX, np.int32)
        cm[:L] = child_max
        cp, cm = cp.reshape(n_nodes, FANOUT + 1), cm.reshape(n_nodes, FANOUT + 1)
        c = np.clip(L - np.arange(n_nodes) * (FANOUT + 1), 1, FANOUT + 1)
        # separator keys = max key of each child subtree except the last
        seps = np.where(
            np.arange(FANOUT)[None, :] < (c - 1)[:, None], cm[:, :FANOUT], INT_MAX
        )
        recs = np.zeros((n_nodes, NODE_WORDS), np.int32)
        recs[:, NUM_KEYS] = c - 1
        recs[:, KEYS0 : KEYS0 + FANOUT] = seps
        recs[:, CHILD0 : CHILD0 + FANOUT + 1] = cp
        new_max = cm[np.arange(n_nodes), c - 1].astype(np.int32)
        b.write(ptrs, recs)
        child_ptrs, child_max = ptrs, new_max
    root = int(child_ptrs[0])
    return root, height


def build(
    keys: np.ndarray,
    values: np.ndarray,
    num_shards: int = 1,
    policy: str = "sequential",
    capacity: int | None = None,
    *,
    device="cuda",
):
    """Bulk-loads a B+tree from sorted keys. Returns (arena, root_ptr, height)."""
    total = node_estimate(len(keys))
    cap = capacity or max(
        num_shards, ((total + num_shards - 1) // num_shards) * num_shards
    )
    b = ArenaBuilder(cap, NODE_WORDS, num_shards=num_shards, policy=policy)
    root, height = build_into(b, keys, values)
    return b.finish(device=device), root, height


def _take(row: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``row[b, i[b]]`` with out-of-range indices wrapped once from the end
    and then clamped, as an array index is resolved in the JAX package."""
    n = row.shape[1]
    i = torch.where(i < 0, i + n, i).clamp(0, n - 1)
    return row.gather(1, i.long()[:, None])[:, 0]


def _descend_index(node, key):
    """First i with key <= keys[i] (Listing 8's inner loop), else num_keys."""
    nk = node[:, NUM_KEYS]
    keys = node[:, KEYS0 : KEYS0 + FANOUT]
    idx = torch.arange(FANOUT, device=node.device)
    ok = (idx[None, :] < nk[:, None]) & (key[:, None] <= keys)
    first = ok.to(torch.int32).argmax(dim=1).to(torch.int32)
    return torch.where(ok.any(dim=1), first, nk)


def _child(node, i):
    return _take(node[:, CHILD0 : CHILD0 + FANOUT + 1], i)


def find_iterator() -> PulseIterator:
    """``btree::internal_locate_plain_compare`` (Listing 9) + leaf probe."""
    S = 3  # [search_key, result_value, found]

    def init(search_keys, root_ptr):
        sk = torch.as_tensor(search_keys, dtype=torch.int32)
        scratch = torch.zeros((sk.shape[0], S), dtype=torch.int32, device=sk.device)
        scratch[:, 0] = sk
        return torch.full((sk.shape[0],), int(root_ptr), dtype=torch.int32,
                          device=sk.device), scratch

    def next_fn(node, ptr, scratch):
        return _child(node, _descend_index(node, scratch[:, 0])), scratch

    def end_fn(node, ptr, scratch):
        key = scratch[:, 0]
        leaf = node[:, IS_LEAF] == 1
        keys = node[:, KEYS0 : KEYS0 + FANOUT]
        vals = node[:, VAL0 : VAL0 + FANOUT]
        nk = node[:, NUM_KEYS]
        idx = torch.arange(FANOUT, device=node.device)
        hitvec = (idx[None, :] < nk[:, None]) & (keys == key[:, None])
        hit = hitvec.any(dim=1) & leaf
        slot = hitvec.to(torch.int32).argmax(dim=1)
        val = torch.where(hit, _take(vals, slot), KEY_NOT_FOUND)
        scratch = scratch.clone()
        scratch[:, 1] = torch.where(leaf, val, scratch[:, 1])
        scratch[:, 2] = torch.where(leaf, hit.to(torch.int32), scratch[:, 2])
        return leaf, scratch

    return PulseIterator(
        S, next_fn, end_fn, init, name="btree_find", n_instructions=FIND_INSTRUCTIONS
    )


# ------------------------------ write path ---------------------------------

# update scratch: [key, new_value, state, found]
U_KEY, U_VAL, U_ST, U_FOUND = range(4)
U_WORDS = 4


def update_iterator() -> PulseIterator:
    """Leaf-slot update in place: the ``internal_locate`` descent to the
    leaf, a masked STORE of the matching slot's value word, then post-commit
    validation (racing writers to one slot serialize through the commit
    phase; the last committed write wins and the losers restage).
    ``init(keys, values, root)``; scratch[U_FOUND] reports whether the key
    existed."""

    def init(keys, values, root_ptr):
        keys = torch.as_tensor(keys, dtype=torch.int32)
        B = keys.shape[0]
        scratch = torch.zeros((B, U_WORDS), dtype=torch.int32, device=keys.device)
        scratch[:, U_KEY] = keys
        scratch[:, U_VAL] = torch.as_tensor(values, dtype=torch.int32).to(keys.device)
        return torch.full((B,), int(root_ptr), dtype=torch.int32, device=keys.device), scratch

    def mut_fn(node, ptr, scratch):
        key, val, st = scratch[:, U_KEY], scratch[:, U_VAL], scratch[:, U_ST]
        zeros = torch.zeros_like(node)
        leaf = node[:, IS_LEAF] == 1
        child = _child(node, _descend_index(node, key))
        keys = node[:, KEYS0 : KEYS0 + FANOUT]
        vals = node[:, VAL0 : VAL0 + FANOUT]
        idx = torch.arange(FANOUT, device=node.device)
        hitvec = (idx[None, :] < node[:, NUM_KEYS, None]) & (keys == key[:, None])
        hit = hitvec.any(dim=1)
        slot = hitvec.to(torch.int32).argmax(dim=1).to(torch.int32)
        slot_val = _take(vals, slot)
        s0, s1 = st == 0, st == 1
        stage = (s0 & leaf & hit) | (s1 & (slot_val != val))
        updated = s1 & (slot_val == val)
        miss = s0 & leaf & ~hit
        done = miss | updated
        advance = s0 & ~leaf
        new_ptr = torch.where(advance, child, ptr)
        new_scratch = scratch.clone()
        new_scratch[:, U_ST] = torch.where(stage & s0, 1, st)
        new_scratch[:, U_FOUND] = torch.where(
            updated, 1, torch.where(miss, 0, scratch[:, U_FOUND]))
        word = VAL0 + slot
        m_op = torch.where(stage, M_STORE, M_NONE)
        m_tgt = torch.where(stage, ptr, 0)
        m_mask = torch.where(stage, bit32(word), 0)
        data = torch.where(
            torch.arange(node.shape[1], device=node.device)[None, :] == word[:, None],
            val[:, None], zeros)
        m_data = torch.where(stage[:, None], data, zeros)
        return done, new_ptr, new_scratch, (m_op, m_tgt, m_mask, torch.zeros_like(ptr), m_data)

    return PulseIterator(
        scratch_words=U_WORDS,
        next_fn=lambda node, ptr, scratch: (
            _child(node, _descend_index(node, scratch[:, U_KEY])), scratch),
        end_fn=lambda node, ptr, scratch: (node[:, IS_LEAF] == 1, scratch),
        init_fn=init,
        mut_fn=mut_fn,
        name="btree_update",
        n_instructions=UPDATE_INSTRUCTIONS,
    )


# scratch layout for range aggregation (the BTrDB workload: stateful
# sum/min/max/count over a key window, paper S6 "stateful aggregations").
RA_LO, RA_HI, RA_SUM, RA_MIN, RA_MAX, RA_COUNT = 0, 1, 2, 3, 4, 5
RA_WORDS = 6


def range_aggregate_iterator() -> PulseIterator:
    """Descend to the first leaf >= lo, then walk the leaf chain accumulating
    sum/min/max/count of values with key in [lo, hi] (sum and count wrap in
    int32)."""

    def init(lo, hi, root_ptr):
        lo = torch.as_tensor(lo, dtype=torch.int32)
        hi = torch.as_tensor(hi, dtype=torch.int32).to(lo.device)
        B = lo.shape[0]
        scratch = torch.zeros((B, RA_WORDS), dtype=torch.int32, device=lo.device)
        scratch[:, RA_LO] = lo
        scratch[:, RA_HI] = hi
        scratch[:, RA_MIN] = INT_MAX
        scratch[:, RA_MAX] = INT_MIN
        return torch.full((B,), int(root_ptr), dtype=torch.int32, device=lo.device), scratch

    def next_fn(node, ptr, scratch):
        leaf = node[:, IS_LEAF] == 1
        child = _child(node, _descend_index(node, scratch[:, RA_LO]))
        return torch.where(leaf, node[:, NEXT_LEAF], child), scratch

    def end_fn(node, ptr, scratch):
        leaf = node[:, IS_LEAF] == 1
        nk = node[:, NUM_KEYS]
        keys = node[:, KEYS0 : KEYS0 + FANOUT]
        vals = node[:, VAL0 : VAL0 + FANOUT]
        idx = torch.arange(FANOUT, device=node.device)
        in_rng = (
            (idx[None, :] < nk[:, None])
            & (keys >= scratch[:, RA_LO, None])
            & (keys <= scratch[:, RA_HI, None])
            & leaf[:, None]
        )
        s = torch.where(in_rng, vals.long(), 0).sum(dim=1)
        mn = torch.where(in_rng, vals, INT_MAX).amin(dim=1)
        mx = torch.where(in_rng, vals, INT_MIN).amax(dim=1)
        c = in_rng.sum(dim=1)
        scratch = scratch.clone()
        scratch[:, RA_SUM] = wrap32(scratch[:, RA_SUM].long() + wrap32(s))
        scratch[:, RA_MIN] = torch.minimum(scratch[:, RA_MIN], mn)
        scratch[:, RA_MAX] = torch.maximum(scratch[:, RA_MAX], mx)
        scratch[:, RA_COUNT] = wrap32(scratch[:, RA_COUNT].long() + c)
        # done: last key in this leaf already past hi, or end of chain
        lastkey = torch.where(nk > 0, _take(keys, (nk - 1).clamp(min=0)), INT_MAX)
        done = leaf & ((lastkey > scratch[:, RA_HI]) | (node[:, NEXT_LEAF] == NULL))
        return done, scratch

    return PulseIterator(
        RA_WORDS, next_fn, end_fn, init, name="btree_range_agg",
        n_instructions=RANGE_AGGREGATE_INSTRUCTIONS,
    )


# ------------------------------- references --------------------------------


def ref_find(keys, values, search_keys):
    """Oracle: (value, found) per query.  A sorted-array lookup; for a key
    stored twice the later value wins, as in a dict built in input order."""
    keys = np.asarray(keys, np.int64)
    values = np.asarray(values, np.int64)
    q = np.asarray(search_keys, np.int64)
    order = np.argsort(keys, kind="stable")
    sk, sv = keys[order], values[order]
    i = np.searchsorted(sk, q, side="right") - 1
    found = (i >= 0) & (sk[np.maximum(i, 0)] == q) if len(sk) else np.zeros(len(q), bool)
    val = np.where(found, sv[np.maximum(i, 0)] if len(sk) else 0, KEY_NOT_FOUND)
    return [(int(v), int(f)) for v, f in zip(val, found)]


def ref_range_aggregate(keys, values, los, his):
    keys = np.asarray(keys, np.int64)
    values = np.asarray(values, np.int64)
    order = np.argsort(keys)
    keys, values = keys[order], values[order]
    out = []
    for lo, hi in zip(los, his):
        m = (keys >= lo) & (keys <= hi)
        v = values[m]
        out.append(
            (
                int(v.sum() % (2**32) if len(v) else 0),
                int(v.min()) if len(v) else INT_MAX,
                int(v.max()) if len(v) else INT_MIN,
                int(len(v)),
            )
        )
    return out
