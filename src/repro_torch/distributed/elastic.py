"""Failure detection and elastic re-planning.

Failure detection (``PulseService(..., fault_tolerance=)``):
  * ``HeartbeatMonitor`` marks hosts dead after ``timeout`` without a beat;
  * ``ShardFailureDetector`` runs it on the serving loop's round clock: a
    ``ShardFailure`` is a targeted suspicion, a missed beat a death;
  * ``plan_mesh_shape`` and ``ElasticCoordinator`` re-plan a mesh from the
    surviving hosts, keeping the model axis.

The live reshard of traversal serving is an online 2x change of the shard
count, driven by ``PulseService``.  The protocol (the range partition
makes it free of pointer rewrites):

  1. ``request`` pins the target shard count (an exact 2x grow or shrink);
  2. drain: admission pauses and every in-flight quantum retires, the
     barrier the write path already uses, so no record is in flight
     across the change;
  3. cutover: the arena is re-partitioned (``arena.remap_shards``), the
     mesh rebuilt at the new width and per-shard serving state forwarded
     through a new ``VersionedOwnerMap`` epoch;
  4. ``complete`` resumes admission.

The result is bit-identical to a cold rebuild at the new shard count: the
remap is deterministic and nothing routes during the swap.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class HostState:
    host_id: int
    last_beat: float
    healthy: bool = True


class HeartbeatMonitor:
    def __init__(self, num_hosts: int, timeout_s: float = 60.0, clock=time.monotonic):
        self.clock = clock
        self.timeout = timeout_s
        now = clock()
        self.hosts = {h: HostState(h, now) for h in range(num_hosts)}

    def beat(self, host_id: int):
        self.hosts[host_id].last_beat = self.clock()
        self.hosts[host_id].healthy = True

    def sweep(self):
        """The hosts newly marked dead."""
        now = self.clock()
        newly_dead = []
        for h in self.hosts.values():
            if h.healthy and now - h.last_beat > self.timeout:
                h.healthy = False
                newly_dead.append(h.host_id)
        return newly_dead

    def healthy_hosts(self):
        return [h.host_id for h in self.hosts.values() if h.healthy]


class ShardFailureDetector:
    """A ``HeartbeatMonitor`` on the serving loop's round clock, for memory
    shards.

    Every shard that completed its work in a round beats (``beat_all``), a
    death is reported through ``suspect``, and ``sweep`` turns missed beats
    into dead shards as the host monitor does.  ``timeout_rounds=0`` (the
    default) declares a suspected shard dead at the next sweep: a
    ``ShardFailure`` is a positive signal, not a missed beat."""

    def __init__(self, num_shards: int, timeout_rounds: int = 0):
        self._round = 0
        self._suspected: set[int] = set()
        self.monitor = HeartbeatMonitor(num_shards, timeout_s=timeout_rounds,
                                        clock=lambda: self._round)

    def beat_all(self, rnd: int):
        """Every shard healthy through round ``rnd`` (a round's end)."""
        self._round = rnd
        for h in self.monitor.hosts.values():
            if h.healthy and h.host_id not in self._suspected:
                self.monitor.beat(h.host_id)

    def suspect(self, shard: int, rnd: int):
        """A failure signal names ``shard``: freeze its beat so the next
        sweep declares it dead.  The signal is targeted: every other
        healthy, unsuspected shard beats at the (maybe advanced) clock
        first, so a sweep mid-round takes no shard whose round-end
        ``beat_all`` has not come yet, and one suspicion never erases
        another."""
        self._round = max(self._round, rnd)
        self._suspected.add(shard)
        for h in self.monitor.hosts.values():
            if h.healthy and h.host_id not in self._suspected:
                self.monitor.beat(h.host_id)
        for s in self._suspected:
            self.monitor.hosts[s].last_beat = self._round - self.monitor.timeout - 1

    def sweep(self) -> list[int]:
        dead = self.monitor.sweep()
        self._suspected.difference_update(dead)
        return dead

    def revive(self, shard: int):
        """Recovery finished: the shard serves again."""
        self._suspected.discard(shard)
        self.monitor.beat(shard)

    def dead_shards(self) -> list[int]:
        return [h.host_id for h in self.monitor.hosts.values() if not h.healthy]


def plan_mesh_shape(n_devices: int, *, model_parallel: int, prefer_pods: int = 1,
                    devices_per_host: int = 1):
    """The largest (pod, data, model) grid of ``n_devices`` devices that
    keeps the ``model`` axis (the parameters' layout), with fewer pods or a
    smaller data axis as capacity shrinks.  Returns (shape, axis names,
    devices used)."""
    if n_devices < model_parallel:
        raise ValueError(f"cannot keep model axis {model_parallel} with {n_devices} devices")
    rows = n_devices // model_parallel  # the data x pod extent
    pods = prefer_pods
    while pods > 1 and rows % pods:
        pods -= 1
    data = rows // pods
    used = pods * data * model_parallel
    if pods > 1:
        return (pods, data, model_parallel), ("pod", "data", "model"), used
    return (data, model_parallel), ("data", "model"), used


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


@dataclasses.dataclass
class ElasticEvent:
    step: int
    kind: str  # shrink | grow
    old_shape: tuple
    new_shape: tuple
    lost_hosts: list


class ElasticCoordinator:
    """The monitor's deaths turned into a re-planned mesh (the caller
    restores the checkpoint onto it)."""

    def __init__(self, monitor: HeartbeatMonitor, *, model_parallel: int,
                 devices_per_host: int = 1, prefer_pods: int = 1):
        self.monitor = monitor
        self.model_parallel = model_parallel
        self.devices_per_host = devices_per_host
        self.prefer_pods = prefer_pods
        self.events: list[ElasticEvent] = []

    def check(self, step: int, current_shape: tuple):
        dead = self.monitor.sweep()
        if not dead:
            return None
        n = len(self.monitor.healthy_hosts()) * self.devices_per_host
        shape, _, _ = plan_mesh_shape(n, model_parallel=self.model_parallel,
                                      prefer_pods=self.prefer_pods,
                                      devices_per_host=self.devices_per_host)
        ev = ElasticEvent(step, "shrink", current_shape, shape, dead)
        self.events.append(ev)
        return ev
