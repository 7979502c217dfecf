"""Paged KV cache backed by a PULSE arena.

Physical layout:
  * ``k_pages`` / ``v_pages``: (layers, n_pages, page_size, Hk, hd) page
    pools on ``device``.  One physical page id indexes every layer's pool
    (the vLLM block-table convention).
  * page tables: per-sequence linked lists in a PULSE arena -- node
    ``[phys_page, next, seq_id, pad]``.  Walking a sequence's chain is a
    pointer traversal, run by the PULSE batched executor
    (``core.iterator.execute_batched``) on the arena's device.

The walked table feeds ``kernels.paged_attention`` (decode), the paged
fetch fused with flash-decode.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import arena as arena_mod
from repro_torch.core.iterator import PulseIterator, execute_batched

NODE_WORDS = 4
PHYS, NEXT, SEQ = 0, 1, 2
# the dispatch model's instruction count of the reference's page walk
# (its jaxpr critical path; the same for every max_pages)
PAGE_WALK_INSTRUCTIONS = 9


def page_walk_iterator(max_pages: int) -> PulseIterator:
    """Collect the chain's physical page ids into the scratch pad.

    scratch: [count, pages[0..max_pages-1]]
    """
    S = 1 + max_pages

    def init(head_ptrs):
        ptr = torch.as_tensor(head_ptrs, dtype=torch.int32)
        scratch = torch.full((ptr.shape[0], S), -1, dtype=torch.int32, device=ptr.device)
        scratch[:, 0] = 0
        return ptr, scratch

    def next_fn(node, ptr, scratch):
        return node[:, NEXT], scratch

    def end_fn(node, ptr, scratch):
        cnt = scratch[:, 0]
        rows = torch.arange(scratch.shape[0], device=scratch.device)
        scratch = scratch.clone()
        scratch[rows, (cnt + 1).clamp(1, S - 1).long()] = node[:, PHYS]
        scratch[:, 0] = cnt + 1
        done = (node[:, NEXT] == arena_mod.NULL) | (cnt + 1 >= max_pages)
        return done, scratch

    return PulseIterator(S, next_fn, end_fn, init, name="page_walk",
                         n_instructions=PAGE_WALK_INSTRUCTIONS)


class PagedKVCache:
    """Host-managed page allocator + device page pools."""

    def __init__(self, cfg, *, n_pages: int, page_size: int, max_batch: int,
                 arena_capacity: int | None = None, dtype=None, device="cuda"):
        self.cfg = cfg
        self.page_size = page_size
        self.n_pages = n_pages
        self.max_batch = max_batch
        self.device = torch.device(device)
        L, Hk, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
        dtype = dtype or cfg.compute_dtype
        shape = (L, n_pages, page_size, Hk, hd)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        cap = arena_capacity or (n_pages + 8)
        self.builder = arena_mod.ArenaBuilder(cap, NODE_WORDS)
        # page 0 is reserved as the trash page (inactive-slot writes land
        # there), so it is never handed out
        self.free_pages = list(range(n_pages - 1, 0, -1))
        self.heads = np.full(max_batch, arena_mod.NULL, np.int32)
        self.tails = np.full(max_batch, arena_mod.NULL, np.int32)
        self.lengths = np.zeros(max_batch, np.int64)

    # --------------------------- host management ----------------------------

    def reset_seq(self, slot: int):
        """Frees a sequence's pages + chain (host-side, between steps)."""
        ptr = int(self.heads[slot])
        while ptr != arena_mod.NULL:
            node = self.builder.data[ptr]
            self.free_pages.append(int(node[PHYS]))
            nxt = int(node[NEXT])
            node[:] = 0
            ptr = nxt
        self.heads[slot] = self.tails[slot] = arena_mod.NULL
        self.lengths[slot] = 0

    def _append_page(self, slot: int) -> int:
        if not self.free_pages:
            raise MemoryError("KV page pool exhausted")
        phys = self.free_pages.pop()
        node_ptr = int(self.builder.alloc(1)[0])
        self.builder.data[node_ptr] = [phys, arena_mod.NULL, slot, 0]
        if self.tails[slot] == arena_mod.NULL:
            self.heads[slot] = node_ptr
        else:
            self.builder.data[self.tails[slot], NEXT] = node_ptr
        self.tails[slot] = node_ptr
        return phys

    def ensure_capacity(self, slot: int, new_len: int):
        """Appends pages until the sequence fits ``new_len`` tokens."""
        needed = -(-new_len // self.page_size)
        while self.n_alloc_pages(slot) < needed:
            self._append_page(slot)

    def n_alloc_pages(self, slot: int) -> int:
        n, ptr = 0, int(self.heads[slot])
        while ptr != arena_mod.NULL:
            n += 1
            ptr = int(self.builder.data[ptr, NEXT])
        return n

    # ------------------------- PULSE page-table walk -------------------------

    def walk_page_tables(self, max_pages: int):
        """Batched PULSE traversal of every chain, on the cache's device.

        Returns (page_table (B, max_pages) int32, lengths (B,) int32); slots
        past a chain's end read page 0.  Empty chains (NULL head) fault on
        the first step and keep a table of zeros.
        """
        ar = self.builder.finish(device=self.device)
        it = page_walk_iterator(max_pages)
        ptr0, scr0 = it.init(torch.as_tensor(self.heads, device=self.device))
        _, scratch, _, _ = execute_batched(it, ar, ptr0, scr0, max_iters=max_pages + 1)
        table = scratch[:, 1:1 + max_pages]
        return (
            table.clamp_min(0).to(torch.int32),
            torch.as_tensor(self.lengths.astype(np.int32), device=self.device),
        )

    # ----------------------------- device writes ----------------------------

    def write_token(self, layer_kv, active=None):
        """Writes one new token's K/V for every active slot.

        ``layer_kv``: (k, v) each (L, B, Hk, hd) -- from the decode step.
        Must be called AFTER ensure_capacity; position = lengths[slot].
        Inactive slots write to the reserved trash page 0.
        """
        k_new, v_new = layer_kv
        B = k_new.shape[1]
        if active is None:
            active = np.ones(B, bool)
        phys = np.zeros(B, np.int64)
        offs = np.zeros(B, np.int64)
        for b in range(B):
            if not active[b] or self.heads[b] == arena_mod.NULL:
                continue  # trash page 0, offset 0
            lp = int(self.lengths[b]) // self.page_size  # logical page index
            ptr = int(self.heads[b])
            for _ in range(lp):
                ptr = int(self.builder.data[ptr, NEXT])
            phys[b] = int(self.builder.data[ptr, PHYS])
            offs[b] = int(self.lengths[b]) % self.page_size
        phys_t = torch.from_numpy(phys).to(self.device)
        offs_t = torch.from_numpy(offs).to(self.device)
        # adjacent advanced indices (axes 1, 2) keep the broadcast (B,) dim in
        # place: the value's shape is (L, B, Hk, hd).  As in the JAX package,
        # inactive slots all write page 0, offset 0, and which one lands there
        # is left open.
        self.k_pages[:, phys_t, offs_t] = k_new.to(self.k_pages.dtype)
        self.v_pages[:, phys_t, offs_t] = v_new.to(self.v_pages.dtype)
        self.lengths[:B] += np.asarray(active, np.int64)

    def advance(self, slots):
        for s in slots:
            self.ensure_capacity(s, int(self.lengths[s]) + 1)
