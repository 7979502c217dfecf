"""Arena: the disaggregated-memory heap PULSE traverses, as torch tensors.

The rack's pooled memory is one flat *arena* of fixed-width node records:

  * ``data``    -- ``(capacity, node_words)`` int32.  One row == one node
                   record, ``node_words <= MAX_NODE_WORDS`` (64) so a whole
                   record fits the paper's single aggregated <=256 B LOAD.
  * pointer     -- int32 row index (a *global address*).  ``NULL == -1``.
  * partition   -- shard ``s`` owns rows ``[bounds[s], bounds[s+1])``;
                   ``bounds`` is the switch's translation base table (S5).

Values are int32 words; floats are carried bitcast (``f2i``/``i2f``).

Construction runs on the host in numpy (``ArenaBuilder``) and lands on one
device in a single copy.  Every entry point that creates an arena places it
on the card unless the caller passes ``device="cpu"``; everything downstream
follows the arena's device.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

NULL = -1
MAX_NODE_WORDS = 64  # 256 B of int32 words: the paper's max aggregated LOAD.

# Protection bits (per shard / translation range).
PERM_READ = 1
PERM_WRITE = 2

# Staged-mutation opcodes of the write path (the modification iterators).
M_NONE = 0  # no pending mutation
M_STORE = 1  # blind masked store
M_CAS = 2  # conditional store (link swing)
M_ALLOC = 3  # claim a free-list slot on the record's home shard
M_FREE = 4  # push a node onto its owning shard's free list

MUT_EXTRA = 4  # payload words beyond node data: [m_op, m_tgt, m_mask, m_expect]

# Per-shard heap registers: [free_head, bump, epoch, commits]
HEAP_WORDS = 4
H_FREE, H_BUMP, H_EPOCH, H_COMMITS = 0, 1, 2, 3


def mut_width(node_words: int) -> int:
    """Mutation-payload words a write-capable record carries."""
    return MUT_EXTRA + node_words


def f2i(x: torch.Tensor) -> torch.Tensor:
    """Bitcast float32 -> int32 (store a float in an int32 arena/scratch word)."""
    return torch.as_tensor(x, dtype=torch.float32).view(torch.int32)


def i2f(x: torch.Tensor) -> torch.Tensor:
    """Bitcast int32 -> float32 (read a float out of an int32 word)."""
    return torch.as_tensor(x, dtype=torch.int32).view(torch.float32)


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> int32 with two's-complement wrap-around (int32
    arithmetic is carried out in int64 and wrapped back explicitly)."""
    return (((x.long() + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def bit32(k: torch.Tensor) -> torch.Tensor:
    """``1 << k`` as an int32 tensor, as XLA's int32 ``shift_left`` gives it:
    bit 31 is INT_MIN, and a shift of 32 or more (or below 0) gives 0.  It is
    computed in int64 and wrapped, so it does not rest on what a device's
    int32 shift does past the word."""
    k = k.long()
    inside = (k >= 0) & (k < 32)
    return wrap32(torch.where(inside, torch.ones_like(k) << k.clamp(0, 31), 0))


def nf2i(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def ni2f(x) -> np.ndarray:
    return np.asarray(x, np.int32).view(np.float32)


@dataclasses.dataclass(frozen=True)
class Arena:
    """A (possibly sharded) flat heap of fixed-width int32 node records.

    All four tensors live on one device."""

    data: torch.Tensor  # (capacity, node_words) int32
    bounds: torch.Tensor  # (num_shards + 1,) int32, sorted; switch base table
    perms: torch.Tensor  # (num_shards,) int32 permission bitmask
    heap: torch.Tensor  # (num_shards, HEAP_WORDS) int32 allocator/commit state

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def node_words(self) -> int:
        return self.data.shape[1]

    @property
    def num_shards(self) -> int:
        return self.bounds.shape[0] - 1


def _int32(x, device) -> torch.Tensor:
    # a copy: the arena never shares memory with the caller's arrays
    return torch.tensor(np.ascontiguousarray(x, np.int32), device=device)


def make_arena(
    data,
    num_shards: int = 1,
    bounds: Sequence[int] | None = None,
    perms: Sequence[int] | None = None,
    heap=None,
    *,
    device="cuda",
) -> Arena:
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    data = np.asarray(data, np.int32)
    if data.ndim != 2:
        raise ValueError(f"arena data must be (capacity, node_words), got {data.shape}")
    if data.shape[1] > MAX_NODE_WORDS:
        raise ValueError(
            f"node_words={data.shape[1]} exceeds the {MAX_NODE_WORDS}-word "
            f"(256 B) single-LOAD limit (PULSE S4.1)"
        )
    cap = data.shape[0]
    if bounds is None:
        if cap % num_shards != 0:
            raise ValueError(f"capacity {cap} not divisible by num_shards {num_shards}")
        per = cap // num_shards
        bounds = [i * per for i in range(num_shards)] + [cap]
    if perms is None:
        perms = [PERM_READ | PERM_WRITE] * (len(bounds) - 1)
    if heap is None:
        # raw arenas are treated as fully occupied: no free list, bump at the
        # shard end, so ALLOC commits fault instead of clobbering live rows
        heap = np.zeros((len(bounds) - 1, HEAP_WORDS), np.int32)
        heap[:, H_FREE] = NULL
        heap[:, H_BUMP] = np.asarray(bounds[1:], np.int32)
    return arena_from_numpy(data, bounds, perms, heap, device=device)


def arena_from_numpy(data, bounds, perms, heap, *, device="cuda") -> Arena:
    """An Arena from the four host arrays of an arena built elsewhere (for
    instance another package's ``Arena`` fields as numpy arrays)."""
    return Arena(
        data=_int32(data, device),
        bounds=_int32(bounds, device),
        perms=_int32(perms, device),
        heap=_int32(heap, device),
    )


def remap_shards(arena: Arena, new_num_shards: int) -> Arena:
    """Re-partition an arena to ``new_num_shards`` (an exact 2x grow or
    shrink), as the JAX package's ``remap_shards`` does.

    Pointers are global rows and the partition is by address range, so no
    pointer is rewritten: growing splits every shard's range at its
    midpoint and shrinking merges adjacent pairs; ``bounds``, ``perms`` and
    the allocator registers change, and the only rows written are links of
    free slots (a parent's free chain is split between its children, pop
    order kept; a merge chains the left's then the right's, plus any bump
    hole of the left below the midpoint when the right has allocated).  A
    split copies the epoch and commit registers, a merge takes their max,
    so a grow then a shrink gives the arena back.

    Host surgery in numpy; returns a new Arena on the input's device (the
    input is never modified)."""
    P = arena.num_shards
    Q = int(new_num_shards)
    if Q == P:
        return arena
    if Q != 2 * P and P != 2 * Q:
        raise ValueError(f"remap_shards supports exact 2x changes, {P} -> {Q}")
    bounds = arena.bounds.cpu().numpy().astype(np.int64)
    data = arena.data.cpu().numpy().copy()  # free-chain links may move
    heap_old = arena.heap.cpu().numpy()
    perms_old = arena.perms.cpu().numpy()

    def walk(head: int) -> list[int]:
        out, p = [], int(head)
        while p != NULL:
            out.append(p)
            p = int(data[p, 0])
        return out

    def relink(slots: list[int]) -> int:
        for i, p in enumerate(slots):
            data[p, 0] = slots[i + 1] if i + 1 < len(slots) else NULL
        return slots[0] if slots else NULL

    new_bounds = np.zeros(Q + 1, np.int64)
    new_bounds[-1] = bounds[-1]
    new_perms = np.zeros(Q, np.int32)
    new_heap = np.zeros((Q, HEAP_WORDS), np.int32)
    if Q == 2 * P:  # grow: split each range at its midpoint
        for s in range(P):
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            if (hi - lo) % 2:
                raise ValueError(f"shard {s} range has odd size {hi - lo}")
            mid = (lo + hi) // 2
            new_bounds[2 * s], new_bounds[2 * s + 1] = lo, mid
            new_perms[2 * s] = new_perms[2 * s + 1] = perms_old[s]
            slots = walk(heap_old[s, H_FREE])
            new_heap[2 * s, H_FREE] = relink([p for p in slots if p < mid])
            new_heap[2 * s + 1, H_FREE] = relink([p for p in slots if p >= mid])
            b = int(heap_old[s, H_BUMP])
            new_heap[2 * s, H_BUMP] = min(b, mid)
            new_heap[2 * s + 1, H_BUMP] = max(b, mid)
            for w in (H_EPOCH, H_COMMITS):
                new_heap[2 * s, w] = new_heap[2 * s + 1, w] = heap_old[s, w]
    else:  # shrink: merge adjacent pairs
        for t in range(Q):
            s0, s1 = 2 * t, 2 * t + 1
            lo, mid = int(bounds[s0]), int(bounds[s1])
            if perms_old[s0] != perms_old[s1]:
                raise ValueError(f"cannot merge shards {s0}/{s1}: permission mismatch")
            new_bounds[t] = lo
            new_perms[t] = perms_old[s0]
            b0, b1 = int(heap_old[s0, H_BUMP]), int(heap_old[s1, H_BUMP])
            slots = walk(heap_old[s0, H_FREE]) + walk(heap_old[s1, H_FREE])
            if b1 > mid:
                if b0 < mid:  # a hole below the midpoint: only free-chain slots say so
                    data[b0:mid] = 0
                    slots = slots + list(range(b0, mid))
                nb = b1
            else:
                nb = b0
            new_heap[t, H_FREE] = relink(slots)
            new_heap[t, H_BUMP] = nb
            for w in (H_EPOCH, H_COMMITS):
                new_heap[t, w] = max(heap_old[s0, w], heap_old[s1, w])
    return arena_from_numpy(data, new_bounds, new_perms, new_heap, device=arena.data.device)


def load_node(arena_data: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """The single aggregated LOAD of one iteration (PULSE S4.1).

    ``ptr`` may be NULL/out-of-range (a request that already terminated or
    faulted); the row index is clamped so the gather stays in bounds and
    fault detection is left to the translation layer."""
    safe = ptr.clamp(0, arena_data.shape[0] - 1).long()
    return arena_data[safe]


def store_node(
    arena_data: torch.Tensor, ptr: torch.Tensor, record: torch.Tensor
) -> torch.Tensor:
    """STORE counterpart; returns a new arena tensor (the input is kept)."""
    safe = ptr.clamp(0, arena_data.shape[0] - 1).long()
    out = arena_data.clone()
    out[safe] = record.to(out.dtype)
    return out


class ArenaBuilder:
    """Host-side numpy allocator for building linked structures fast.

    Allocation policies (Appendix Fig. 5):
      * ``sequential``  -- bump allocator (the paper's *partitioned* layout).
      * ``interleaved`` -- round-robins consecutive allocations across shards.
    """

    def __init__(
        self,
        capacity: int,
        node_words: int,
        num_shards: int = 1,
        policy: str = "sequential",
    ):
        if node_words > MAX_NODE_WORDS:
            raise ValueError(f"node_words > {MAX_NODE_WORDS}")
        if capacity % num_shards != 0:
            raise ValueError("capacity must divide evenly across shards")
        self.capacity = capacity
        self.node_words = node_words
        self.num_shards = num_shards
        self.policy = policy
        self.data = np.zeros((capacity, node_words), np.int32)
        self.per_shard = capacity // num_shards
        self._free: list[int] = []  # LIFO free list (host twin of M_FREE)
        if policy == "sequential":
            self._next = 0
        elif policy == "interleaved":
            self._cursor = np.array(
                [s * self.per_shard for s in range(num_shards)], np.int64
            )
            self._rr = 0
        else:
            raise ValueError(f"unknown allocation policy {policy!r}")

    def free(self, ptrs) -> None:
        """Zero the slots and push them onto the LIFO free list, so a later
        ``alloc`` reuses them before touching never-used capacity."""
        for p in np.atleast_1d(np.asarray(ptrs, np.int64)):
            p = int(p)
            if not (0 <= p < self.capacity):
                raise ValueError(f"free of out-of-range slot {p}")
            self.data[p] = 0
            self._free.append(p)

    def alloc(self, n: int = 1) -> np.ndarray:
        """Returns the global addresses of ``n`` new nodes."""
        if self._free:
            take = min(n, len(self._free))
            out = np.asarray([self._free.pop() for _ in range(take)], np.int32)
            if take == n:
                return out
            return np.concatenate([out, self.alloc(n - take)])
        if self.policy == "sequential":
            if self._next + n > self.capacity:
                raise MemoryError("arena exhausted")
            out = np.arange(self._next, self._next + n, dtype=np.int32)
            self._next += n
            return out
        out = np.empty(n, np.int32)
        for i in range(n):
            s = self._rr
            tried = 0
            while self._cursor[s] >= (s + 1) * self.per_shard:
                s = (s + 1) % self.num_shards
                tried += 1
                if tried > self.num_shards:
                    raise MemoryError("arena exhausted")
            out[i] = self._cursor[s]
            self._cursor[s] += 1
            self._rr = (s + 1) % self.num_shards
        return out

    def write(self, ptrs: np.ndarray, records: np.ndarray) -> None:
        """Write node records; narrower records are zero-padded."""
        records = np.asarray(records, np.int32)
        w = records.shape[-1]
        if w > self.node_words:
            raise ValueError(f"record width {w} > arena node_words {self.node_words}")
        self.data[np.asarray(ptrs), :w] = records
        if w < self.node_words:
            self.data[np.asarray(ptrs), w:] = 0

    def finish(self, perms: Sequence[int] | None = None, *, device="cuda") -> Arena:
        """Freeze into an Arena on ``device``, threading the allocator state
        into the per-shard heap registers."""
        heap = np.zeros((self.num_shards, HEAP_WORDS), np.int32)
        heap[:, H_FREE] = NULL
        for s in range(self.num_shards):
            lo, hi = s * self.per_shard, (s + 1) * self.per_shard
            if self.policy == "sequential":
                heap[s, H_BUMP] = min(max(self._next, lo), hi)
            else:
                heap[s, H_BUMP] = int(self._cursor[s])
        # thread outstanding host frees into the intrusive per-shard chains
        # (word 0 of a freed slot is the next-free link), LIFO order kept
        for p in self._free:
            s = p // self.per_shard
            self.data[p] = 0
            self.data[p, 0] = heap[s, H_FREE]
            heap[s, H_FREE] = p
        return make_arena(
            self.data, num_shards=self.num_shards, perms=perms, heap=heap,
            device=device,
        )
