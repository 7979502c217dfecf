"""STL ``map::find`` via ``_M_lower_bound`` (paper Listings 10-11).

The identical traversal shape covers Boost AVL / splay / scapegoat trees;
only the balancing differs, which is invisible to the read path.  Node
layout (W=4): [key, value, left, right].  The lower-bound candidate ``y``
lives in the scratch pad (a pointer carried as traversal state).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.core.arena import M_NONE, M_STORE, NULL, ArenaBuilder
from repro_torch.core.iterator import PulseIterator

NODE_WORDS = 4
KEY, VALUE, LEFT, RIGHT = 0, 1, 2, 3
KEY_NOT_FOUND = -(2**31) + 1

# scratch: [search_key, y_ptr, y_key, y_value]
S_KEY, S_Y, S_YKEY, S_YVAL = 0, 1, 2, 3
SCRATCH_WORDS = 4

# the dispatch model's instruction count N of each iterator body below
FIND_INSTRUCTIONS = 9
UPDATE_INSTRUCTIONS = 9

# update scratch: [key, new_value, state, found] (the write path's layout)
U_KEY, U_VAL, U_ST, U_FOUND = range(4)
U_WORDS = 4


def build_into(b: ArenaBuilder, keys: np.ndarray, values: np.ndarray):
    """Builds a balanced BST into a (possibly shared) heap; returns
    (root_ptr, height)."""
    keys = np.asarray(keys, np.int32)
    values = np.asarray(values, np.int32)
    order = np.argsort(keys, kind="stable")
    keys, values = keys[order], values[order]
    n = len(keys)
    ptrs = b.alloc(n)
    rec = np.zeros((n, NODE_WORDS), np.int32)

    # pre-order slot numbering of a median-split build
    slot = [0]
    height = [0]

    def place(lo, hi, depth):  # returns ptr of subtree root over keys[lo:hi)
        if lo >= hi:
            return NULL
        height[0] = max(height[0], depth + 1)
        mid = (lo + hi) // 2
        my = slot[0]
        slot[0] += 1
        rec[my, KEY] = keys[mid]
        rec[my, VALUE] = values[mid]
        rec[my, LEFT] = place(lo, mid, depth + 1)
        rec[my, RIGHT] = place(mid + 1, hi, depth + 1)
        return int(ptrs[my])

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * (n.bit_length() + 2) * 64 + 10_000))
    try:
        root = place(0, n, 0)
    finally:
        sys.setrecursionlimit(old)
    b.write(ptrs, rec)
    return root, height[0]


def build(
    keys: np.ndarray,
    values: np.ndarray,
    num_shards: int = 1,
    policy: str = "sequential",
    capacity: int | None = None,
    *,
    device="cuda",
):
    """Builds a balanced BST (median split). Returns (arena, root_ptr, height)."""
    n = len(keys)
    cap = capacity or max(num_shards, ((n + num_shards - 1) // num_shards) * num_shards)
    b = ArenaBuilder(cap, NODE_WORDS, num_shards=num_shards, policy=policy)
    root, height = build_into(b, keys, values)
    return b.finish(device=device), root, height


def find_iterator() -> PulseIterator:
    """``map::find`` as lower-bound descent (Listing 11): walk to NULL while
    tracking the smallest node with key >= search key, then compare."""

    def init(search_keys, root_ptr):
        sk = torch.as_tensor(search_keys, dtype=torch.int32)
        B = sk.shape[0]
        scratch = torch.zeros((B, SCRATCH_WORDS), dtype=torch.int32, device=sk.device)
        scratch[:, S_KEY] = sk
        scratch[:, S_Y] = NULL
        scratch[:, S_YVAL] = KEY_NOT_FOUND
        return torch.full((B,), int(root_ptr), dtype=torch.int32, device=sk.device), scratch

    def _remember(node, ptr, scratch, goes_left):
        upd = scratch.clone()
        upd[:, S_Y] = torch.where(goes_left, ptr, scratch[:, S_Y])
        upd[:, S_YKEY] = torch.where(goes_left, node[:, KEY], scratch[:, S_YKEY])
        upd[:, S_YVAL] = torch.where(goes_left, node[:, VALUE], scratch[:, S_YVAL])
        return upd

    def next_fn(node, ptr, scratch):
        # Listing 11: if key <= node.key -> remember y, go left; else right.
        goes_left = scratch[:, S_KEY] <= node[:, KEY]
        nxt = torch.where(goes_left, node[:, LEFT], node[:, RIGHT])
        return nxt, _remember(node, ptr, scratch, goes_left)

    def end_fn(node, ptr, scratch):
        # terminate when the *next* hop would be NULL (``while (x != 0)``)
        goes_left = scratch[:, S_KEY] <= node[:, KEY]
        nxt = torch.where(goes_left, node[:, LEFT], node[:, RIGHT])
        upd = _remember(node, ptr, scratch, goes_left)
        done = nxt == NULL
        return done, torch.where(done[:, None], upd, scratch)

    return PulseIterator(
        SCRATCH_WORDS, next_fn, end_fn, init, name="bst_find",
        n_instructions=FIND_INSTRUCTIONS,
    )


# ------------------------------ write path ---------------------------------


def update_iterator() -> PulseIterator:
    """``map::operator[]``-style update in place: the BST search descent; on
    the matching node, stage a masked STORE of the VALUE word, then validate
    on the post-commit iteration (a racing writer to the same node
    serializes through the commit phase's (slot, id) order -- the loser
    observes the foreign value and restages, so the last committed write
    wins deterministically).  ``init(keys, values, root)``; scratch[U_FOUND]
    reports whether the key existed."""

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
        hit = node[:, KEY] == key
        nxt = torch.where(key < node[:, KEY], node[:, LEFT], node[:, RIGHT])
        s0, s1 = st == 0, st == 1
        stage = (s0 & hit) | (s1 & (node[:, VALUE] != val))  # write or restage
        updated = s1 & (node[:, VALUE] == val)
        miss = s0 & ~hit & (nxt == NULL)
        done = miss | updated
        advance = s0 & ~hit & ~miss
        new_ptr = torch.where(advance, nxt, ptr)
        new_scratch = scratch.clone()
        new_scratch[:, U_ST] = torch.where(stage & s0, 1, st)
        new_scratch[:, U_FOUND] = torch.where(
            updated, 1, torch.where(miss, 0, scratch[:, U_FOUND]))
        m_op = torch.where(stage, M_STORE, M_NONE)
        m_tgt = torch.where(stage, ptr, 0)
        m_mask = torch.where(stage, 1 << VALUE, 0)
        data = zeros.clone()
        data[:, VALUE] = val
        m_data = torch.where(stage[:, None], data, zeros)
        return done, new_ptr, new_scratch, (m_op, m_tgt, m_mask, torch.zeros_like(ptr), m_data)

    return PulseIterator(
        scratch_words=U_WORDS,
        next_fn=lambda node, ptr, scratch: (
            torch.where(scratch[:, U_KEY] < node[:, KEY], node[:, LEFT], node[:, RIGHT]),
            scratch,
        ),
        end_fn=lambda node, ptr, scratch: (node[:, KEY] == scratch[:, U_KEY], scratch),
        init_fn=init,
        mut_fn=mut_fn,
        name="bst_update",
        n_instructions=UPDATE_INSTRUCTIONS,
    )


def result(scratch: torch.Tensor):
    """CPU-node finalize: found iff lower-bound key equals the search key."""
    found = (scratch[..., S_Y] != NULL) & (scratch[..., S_YKEY] == scratch[..., S_KEY])
    value = torch.where(found, scratch[..., S_YVAL], KEY_NOT_FOUND)
    return value, found


# ------------------------------- references --------------------------------


def ref_find(keys, values, search_keys):
    d = {int(k): int(v) for k, v in zip(keys, values)}
    return [(d.get(int(k), KEY_NOT_FOUND), int(int(k) in d)) for k in search_keys]
