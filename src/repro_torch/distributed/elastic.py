"""The live reshard of traversal serving: an online 2x change of the
shard count, driven by ``PulseService``.

The protocol (the range partition makes it free of pointer rewrites):

  1. ``request`` pins the target shard count (an exact 2x grow or shrink);
  2. drain: admission pauses and every in-flight quantum retires, the
     barrier the write path already uses, so no record is in flight
     across the change;
  3. cutover: the arena is re-partitioned (``arena.remap_shards``), the
     mesh rebuilt at the new width and per-shard serving state forwarded
     through a new ``VersionedOwnerMap`` epoch;
  4. ``complete`` resumes admission.

The result is bit-identical to a cold rebuild at the new shard count: the
remap is deterministic and nothing routes during the swap.  The failure
detectors of fault tolerance (``ShardFailureDetector``,
``HeartbeatMonitor``) come with ROADMAP item 8.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class ReshardEvent:
    """One completed live reshard."""

    requested_round: int
    cutover_round: int
    old_shards: int
    new_shards: int
    owner_epoch: int  # forwarding epoch installed at cutover
    drain_rounds: int  # rounds spent waiting on the barrier
    wall_s: float


class ReshardPlanner:
    """The phases (``idle``, ``draining``, ``cutover``) and accounting of
    one live reshard at a time; ``PulseService.step`` drives it, asking
    ``should_cutover`` each round until the barrier clears."""

    def __init__(self):
        self.phase = "idle"  # idle | draining | cutover
        self.target: int | None = None
        self._requested_round = 0
        self._drain_rounds = 0
        self._t0 = 0.0
        self.events: list[ReshardEvent] = []

    def request(self, new_num_shards: int, *, current: int, rnd: int) -> None:
        if self.phase != "idle":
            raise RuntimeError(f"reshard already in progress ({self.phase})")
        new_num_shards = int(new_num_shards)
        if new_num_shards != 2 * current and current != 2 * new_num_shards:
            raise ValueError(
                f"live reshard supports exact 2x changes, {current} -> {new_num_shards}")
        self.phase = "draining"
        self.target = new_num_shards
        self._requested_round = rnd
        self._drain_rounds = 0
        self._t0 = time.perf_counter()

    def should_cutover(self, in_flight: int) -> bool:
        """Called once a round while draining; True exactly once, when the
        barrier has cleared."""
        if self.phase != "draining":
            return False
        if in_flight > 0:
            self._drain_rounds += 1
            return False
        self.phase = "cutover"
        return True

    def complete(self, *, rnd: int, old_shards: int, owner_epoch: int) -> ReshardEvent:
        if self.phase != "cutover":
            raise RuntimeError(f"complete() in phase {self.phase}")
        ev = ReshardEvent(
            requested_round=self._requested_round, cutover_round=rnd, old_shards=old_shards,
            new_shards=self.target, owner_epoch=owner_epoch, drain_rounds=self._drain_rounds,
            wall_s=time.perf_counter() - self._t0)
        self.events.append(ev)
        self.phase = "idle"
        self.target = None
        return ev
