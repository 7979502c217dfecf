"""In-network switch routing (paper S5): the part the single-node path and
the sequential commit use.

The access-check elision predicate, and the request record format with the
run accounting (``RoutingStats``) that the write path's executor
(``core.commit``) shares with the multi-shard supersteps.  The supersteps
and fabrics themselves come with the multi-shard slice (ROADMAP queue 1,
item 6).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.arena import PERM_READ, Arena
from repro_torch.core.iterator import PulseIterator

# request record words: [id, home shard, ptr, status, iters, hops,
# scratch (S), mutation payload (mut_width(W), write path only)]
F_ID, F_HOME, F_PTR, F_STATUS, F_ITERS, F_HOPS, F_SCRATCH = 0, 1, 2, 3, 4, 5, 6


def record_width(scratch_words: int, mut_words: int = 0) -> int:
    return F_SCRATCH + scratch_words + mut_words


@dataclasses.dataclass
class RoutingStats:
    """Accounting of one multi-superstep run (the JAX package's fields)."""

    supersteps: int
    crossings: np.ndarray  # (B,) network crossings per request
    routed_per_step: list  # valid records exchanged per superstep
    active_per_step: list = dataclasses.field(default_factory=list)
    # int32 words shipped across off-shard links per superstep (the BSP
    # all_to_all payload: P * (P - 1) * link_capacity * R; 0 for a
    # local-only superstep that skips the fabric)
    wire_words_per_step: list = dataclasses.field(default_factory=list)
    capacity_per_step: list = dataclasses.field(default_factory=list)
    local_only_steps: int = 0  # supersteps that skipped the all_to_all
    wire_words_total: int | None = None  # fused schedules: the aggregate only
    fused: bool = False
    schedule: str = "dispatched"  # the superstep schedule of the run
    fabric: str = "dense"  # the collective that carried the records
    # write path: mutations applied by the commit phases (CAS misses
    # included: they took a serialized commit slot), and commit epochs
    # advanced (one per shard and superstep that applied >= 1 mutation)
    commits: int = 0
    epochs: int = 0

    @property
    def total_wire_words(self) -> int:
        if self.wire_words_total is not None:
            return int(self.wire_words_total)
        return int(sum(self.wire_words_per_step))

    @property
    def ring_hops(self) -> int:
        """Physical ppermute hops a ring fabric executed (P-1 distance
        classes per routed superstep; 0 on the dense fabric)."""
        if self.fabric != "ring":
            return 0
        routed = self.supersteps - self.local_only_steps
        return routed * max(0, self._num_shards - 1) if self._num_shards else 0

    _num_shards: int = 0


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def can_elide_access_check(it: PulseIterator, arena: Arena) -> bool:
    """True when the per-hop PERM_READ probe is statically constant-true.

    Two proofs combine: the iterator's pulse-verify certificate
    (``it.facts``) shows the traversal only ever reads, and a host-side
    scan shows every shard of ``arena.perms`` grants PERM_READ.  Under
    both, ``check_access`` would return True for every pointer the
    traversal can present, so replacing the probe with the constant is
    bit-identical.  Unverified iterators (``facts is None``) never qualify.
    """
    facts = it.facts
    if facts is None or not getattr(facts, "read_only", False) or it.mutates:
        return False
    return bool(((arena.perms & PERM_READ) == PERM_READ).all())
