"""STL ``std::find`` over list/forward_list (paper Listings 4-5).

Node layout (W=4): ``[key, value, next, pad]``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.arena import NULL, ArenaBuilder, wrap32
from repro_torch.core.iterator import PulseIterator

NODE_WORDS = 4
KEY, VALUE, NEXT = 0, 1, 2

# scratch layout for find: [search_key, result_value, found_flag]
SCRATCH_WORDS = 3
KEY_NOT_FOUND = -(2**31) + 1

# the dispatch model's instruction count N of each iterator body below (the
# weighted critical path of its traced next/end, see core.dispatch)
FIND_INSTRUCTIONS = 6
SUM_INSTRUCTIONS = 4


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
