"""Bucket-chained hash table: ``unordered_map::find`` (paper Listings 2-3).

``init()`` runs on the CPU node: it hashes the key and resolves the bucket
head pointer.  The chain walk is the offloaded traversal.  Node layout
(W=4): ``[key, value, next, pad]``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.arena import NULL, ArenaBuilder
from repro_torch.core.iterator import PulseIterator
from repro_torch.core.structures import linked_list

NODE_WORDS = 4
KEY, VALUE, NEXT = 0, 1, 2
SCRATCH_WORDS = 3  # [search_key, result_value, found]
KEY_NOT_FOUND = -(2**31) + 1

# the dispatch model's instruction count N of find_iterator's body
FIND_INSTRUCTIONS = 6

_MULT = 2654435761  # Knuth multiplicative hash


def hash_fn(key, n_buckets: int):
    """32-bit multiplicative hash; identical for numpy and torch inputs.

    The product is taken in int64 (it cannot overflow for an int32 key) and
    masked to 31 bits, which equals the uint32 product masked the same way."""
    if isinstance(key, torch.Tensor):
        h = (key.long() * _MULT) & 0x7FFFFFFF
        return (h % n_buckets).to(torch.int32)
    if isinstance(key, (int, np.integer)) or isinstance(key, np.ndarray):
        h = (np.int64(key) * np.int64(_MULT)) & np.int64(0x7FFFFFFF)
        return (h % n_buckets).astype(np.int32) if isinstance(h, np.ndarray) else np.int32(h % n_buckets)
    raise TypeError(f"hash_fn takes an int, a numpy array or a tensor, got {type(key)}")


def _np_hash(keys: np.ndarray, n_buckets: int) -> np.ndarray:
    h = (keys.astype(np.uint32) * np.uint32(2654435761)) & np.uint32(0x7FFFFFFF)
    return (h % np.uint32(n_buckets)).astype(np.int32)


def _push_front(buckets: np.ndarray, ptrs: np.ndarray, heads: np.ndarray) -> np.ndarray:
    """Push-front insertion per bucket, in input order: each node links to
    the previous node of its bucket (the bucket's entry in ``heads`` for
    the first), and ``heads`` is updated in place to each bucket's last
    node.  Returns the nodes' NEXT words."""
    n = len(ptrs)
    order = np.argsort(buckets, kind="stable")
    sb = buckets[order]
    first = np.ones(n, bool)
    first[1:] = sb[1:] != sb[:-1]
    prev = np.empty(n, np.int32)
    prev[1:] = ptrs[order[:-1]]
    nxt = np.empty(n, np.int32)
    nxt[order] = np.where(first, heads[sb], prev)
    last = np.ones(n, bool)
    last[:-1] = first[1:]
    heads[sb[last]] = ptrs[order[last]]
    return nxt


def build_into(
    b: ArenaBuilder, keys: np.ndarray, values: np.ndarray, n_buckets: int
) -> np.ndarray:
    """Builds the bucket chains into a (possibly shared) heap; returns the
    bucket-head pointer array (n_buckets,) int32."""
    keys = np.asarray(keys, np.int32)
    values = np.asarray(values, np.int32)
    n = len(keys)
    ptrs = b.alloc(n)
    heads = np.full(n_buckets, NULL, np.int32)
    rec = np.zeros((n, NODE_WORDS), np.int32)
    rec[:, KEY] = keys
    rec[:, VALUE] = values
    rec[:, NEXT] = _push_front(_np_hash(keys, n_buckets), ptrs, heads)
    b.write(ptrs, rec)
    return heads


def build(
    keys: np.ndarray,
    values: np.ndarray,
    n_buckets: int,
    num_shards: int = 1,
    policy: str = "sequential",
    capacity: int | None = None,
    *,
    device="cuda",
):
    """Returns (arena, bucket_heads (n_buckets,) int32 np array)."""
    n = len(keys)
    cap = capacity or max(num_shards, ((n + num_shards - 1) // num_shards) * num_shards)
    b = ArenaBuilder(cap, NODE_WORDS, num_shards=num_shards, policy=policy)
    heads = build_into(b, keys, values, n_buckets)
    return b.finish(device=device), heads


def find_iterator(n_buckets: int) -> PulseIterator:
    """``unordered_map::find`` (Listing 3)."""

    def init(search_keys, bucket_heads):
        sk = torch.as_tensor(search_keys, dtype=torch.int32)
        heads = torch.as_tensor(bucket_heads).to(device=sk.device, dtype=torch.int32)
        ptr0 = heads[hash_fn(sk, n_buckets).long()]
        scratch0 = torch.zeros((sk.shape[0], SCRATCH_WORDS), dtype=torch.int32,
                               device=sk.device)
        scratch0[:, 0] = sk
        # empty bucket: ptr0 == NULL faults at once; mark the result up-front
        scratch0[:, 1] = KEY_NOT_FOUND
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
        name="hash_find",
        n_instructions=FIND_INSTRUCTIONS,
    )


# ------------------------------ write path ---------------------------------

# sentinel bucket-head key: never matches a real key (real keys are >= 0 in
# the write-path workloads); the sentinel gives every chain a stable first
# node, so inserts into empty buckets and deletes of the first real node
# both have a predecessor to CAS.
SENTINEL_KEY = -(2**31)


def build_writable(
    b: ArenaBuilder, keys: np.ndarray, values: np.ndarray, n_buckets: int
) -> np.ndarray:
    """Writable-table build: every bucket head is an arena-resident sentinel
    node (key = SENTINEL_KEY) whose NEXT starts the chain.  Returns the
    sentinel addresses (n_buckets,) -- these never move, so the host-side
    bucket table stays valid across inserts and deletes."""
    sent = b.alloc(n_buckets)
    rec = np.zeros((n_buckets, NODE_WORDS), np.int32)
    rec[:, KEY] = SENTINEL_KEY
    rec[:, NEXT] = NULL
    b.write(sent, rec)
    keys = np.asarray(keys, np.int32)
    values = np.asarray(values, np.int32)
    n = len(keys)
    if n:
        ptrs = b.alloc(n)
        recs = np.zeros((n, NODE_WORDS), np.int32)
        recs[:, KEY] = keys
        recs[:, VALUE] = values
        heads = np.asarray(b.data[sent, NEXT])
        recs[:, NEXT] = _push_front(_np_hash(keys, n_buckets), ptrs, heads)
        b.write(ptrs, recs)
        b.data[sent, NEXT] = heads
    return sent.astype(np.int32)


def _bucket_init(n_buckets, ops, keys, values, sentinels):
    keys = torch.as_tensor(keys, dtype=torch.int32)
    sent = torch.as_tensor(sentinels, dtype=torch.int32).to(keys.device)
    ptr0 = sent[hash_fn(keys, n_buckets).long()]
    _, scratch = linked_list._rw_init(ops, keys, values, 0)
    return ptr0, scratch


def rw_iterator(n_buckets: int) -> PulseIterator:
    """Mixed find/insert/delete over the writable (sentinel-headed) table:
    one batch, one iterator program, per-record op in scratch[RW_OP].
    ``init(ops, keys, values, sentinels)``."""
    def init(ops, keys, values, sentinels):
        return _bucket_init(n_buckets, ops, keys, values, sentinels)

    return dataclasses.replace(
        linked_list.rw_iterator(), init_fn=init, name="hash_rw"
    )


def insert_iterator(n_buckets: int) -> PulseIterator:
    """``unordered_map::insert`` as chain tail-append under the bucket's
    sentinel.  ``init(keys, values, sentinels)``."""
    def init(keys, values, sentinels):
        keys = torch.as_tensor(keys, dtype=torch.int32)
        ops = torch.full_like(keys, linked_list.OP_INSERT)
        return _bucket_init(n_buckets, ops, keys, values, sentinels)

    return dataclasses.replace(
        linked_list.rw_iterator(), init_fn=init, name="hash_insert"
    )


def delete_iterator(n_buckets: int) -> PulseIterator:
    """``unordered_map::erase``: unlink under the sentinel + FREE the slot.
    ``init(keys, sentinels)``."""
    def init(keys, sentinels):
        keys = torch.as_tensor(keys, dtype=torch.int32)
        ops = torch.full_like(keys, linked_list.OP_DELETE)
        return _bucket_init(n_buckets, ops, keys, torch.zeros_like(keys), sentinels)

    return dataclasses.replace(
        linked_list.rw_iterator(), init_fn=init, name="hash_delete"
    )


# ------------------------------- references --------------------------------


def ref_find(keys, values, n_buckets, search_keys):
    """Oracle: (value, found, hops) per query, matching chain order."""
    keys = np.asarray(keys, np.int32)
    values = np.asarray(values, np.int32)
    buckets = _np_hash(keys, n_buckets)
    chains: dict[int, list[int]] = {}
    for i in range(len(keys)):
        chains.setdefault(int(buckets[i]), []).append(i)
    out = []
    for sk in np.asarray(search_keys, np.int32):
        b = int(_np_hash(np.asarray([sk], np.int32), n_buckets)[0])
        chain = chains.get(b, [])
        val, found, hops = KEY_NOT_FOUND, 0, 0
        for idx in reversed(chain):  # push-front: newest key first
            hops += 1
            if int(keys[idx]) == int(sk):
                val, found = int(values[idx]), 1
                break
        else:
            hops = len(chain)
        out.append((val, found, hops))
    return out
