"""PulseService: the continuous-batching front end for pointer traversals.

``PulseEngine.execute`` is one-shot; this module turns it into a serving
system for the paper's workload: heterogeneous traversal requests (list
walk, BST / B+tree lookup, skip-list search, hash-chain probe) from many
tenants.  It plays PULSE's CPU node:

  * **slot groups**: a batch runs one iterator program, so each registered
    structure owns a fixed group of slots; all groups share one admission
    queue;
  * **continuous batching via continuations**: each round runs every
    occupied group for a ``quantum`` of iterations; a finished request
    retires and frees its slot at once (backfilled the next round), an
    unfinished one comes back MAXED, its ``(cur_ptr, scratch_pad)`` the
    whole traversal state (paper S3/S5), and resumes next round;
  * **admission**: per-tenant queues, deadline-aware (EDF) selection,
    fairness credits, optional shedding and rate limits
    (``serving/admission.py``), EDF preemption of continuations, and
    SLO-aware quantum sizing;
  * **write tenants**: a spec whose iterator mutates is admitted under a
    per-group barrier (``admission.apply_write_barriers``); the engine
    swaps its arena after every write quantum, so the next reads see it;
  * **live resharding**: ``request_reshard`` drains in-flight quanta, then
    cuts the arena over (``arena.remap_shards``, owner-epoch forwarding, a
    mesh of the new width);
  * **accounting**: latency percentiles, throughput, deadlines, and the
    engine's supersteps, wire words and commits (``ServiceMetrics``).

The service runs over the engine's one-node path (the ``pulse_chase``
kernel, or the plain executor) and over a mesh (``EmulatedMesh``), on any
schedule: admission sits above the dispatch decision, like the paper's CPU
node.  ``pipeline="async"`` issues every engine call from a
``DeviceRunner`` thread while this thread admits the next round.

On a ``routing.ProcessGroupMesh`` (memory nodes as processes) the service
runs on rank 0, which is also memory node 0, and every other rank of the
world runs ``serving.memory_node.follow``: every engine call, probe and
replay the service makes is announced to them first, and ``close`` ends
them.  It serves reads, writes, replication, the watchdog and durable
recovery as on an ``EmulatedMesh``, on the dispatched schedule.  The mesh
may be the world's first P ranks of a world of 2P (``distributed.world.
first_ranks``): a live reshard to 2P then cuts over to the whole world, and
one from 2P to P back to the first P ranks.

**Fault tolerance** (``fault_tolerance=distributed.arena_ft.
FaultToleranceConfig``): a write quantum is acknowledged only once its
inputs are in an fsynced commit log, and the arena is snapshotted every
``snapshot_every`` logged quanta.  A ``ShardFailure`` marks the shard dead
(``ShardFailureDetector``), the arena is recovered from the snapshot and
the replayed log and checked against the resident one bit for bit, and
the failed group is parked for a seeded, jittered backoff, each occupant
charged a retry.  Optionally a log-shipped hot standby (R = 2) serves a
dead primary's reads with no retry, and a per-round watchdog probes every
shard (a one-record PULSE ISA traversal on the same superstep launch as
real traffic) and suspects stragglers that never raise.  Without it a
``ShardFailure`` propagates to the caller.
"""

from __future__ import annotations

import dataclasses
import random
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core import isa, routing
from repro_torch.core.arena import NULL, remap_shards
from repro_torch.core.engine import BACKENDS, PulseEngine
from repro_torch.core.faults import ShardFailure
from repro_torch.core.iterator import (
    STATUS_DONE,
    STATUS_FAULT,
    STATUS_MAXED,
    STATUS_RETRY,
    STATUS_SHED,
    PulseIterator,
)
from repro_torch.distributed.elastic import (
    HeartbeatMonitor,
    ReshardPlanner,
    ShardFailureDetector,
)
from repro_torch.distributed.sharding import VersionedOwnerMap
from repro_torch.serving.admission import (
    AdmissionController,
    TenantRateLimiter,
    TraversalRequest,
    apply_write_barriers,
)
from repro_torch.serving import memory_node
from repro_torch.serving.batching import DeviceRunner, QuantumWork

__all__ = ["PulseService", "StructureSpec", "ServiceMetrics", "STATUS_SHED", "STATUS_RETRY"]


@dataclasses.dataclass(frozen=True)
class StructureSpec:
    """A servable structure: the iterator program and its fixed init
    arguments (root pointer, bucket heads, ...); ``init`` runs per
    admission batch with the admitted queries.

    ``group`` names the structure family the spec operates on (default: its
    registered name): a mutating spec and the read spec over the same heap
    region share a group, and the admission barrier gives writers the group
    exclusively.  ``takes_value`` marks specs whose ``init`` takes ``(keys,
    values, ...)``: inserts and updates consume ``TraversalRequest.value``."""

    iterator: PulseIterator
    init_args: tuple = ()
    group: str | None = None
    takes_value: bool = False

    @property
    def writes(self) -> bool:
        return self.iterator.mutates


@dataclasses.dataclass
class ServiceMetrics:
    rounds: int = 0
    engine_calls: int = 0
    retired: int = 0  # every request that left its slot, any status
    completed: int = 0  # retired DONE
    faulted: int = 0
    timed_out: int = 0  # retired at max_request_iters
    wall_s: float = 0.0
    lane_iters: int = 0  # productive iterations executed
    slot_rounds: int = 0  # occupied slot-rounds (for utilization)
    capacity_rounds: int = 0  # slot-rounds available
    latencies_ms: list = dataclasses.field(default_factory=list)
    per_tenant: dict = dataclasses.field(default_factory=dict)
    deadlines_met: int = 0
    deadlines_missed: int = 0
    # the engine's aggregates (routed and write quanta)
    supersteps: int = 0
    wire_words: int = 0
    commits: int = 0
    writes_retired: int = 0
    # overload and pipeline accounting
    shed: int = 0  # arrivals rejected (rate limit or bounded queue)
    preempted: int = 0  # continuations evicted for an urgent deadline
    queue_depth_max: int = 0
    quantum_min_used: int = 0
    quantum_max_used: int = 0
    # fault tolerance: shard deaths recovered from, commits replayed out of
    # the log, requests re-queued off dead shards
    recoveries: int = 0
    replayed_commits: int = 0
    retries: int = 0
    retry_exhausted: int = 0
    recovery_ms_total: float = 0.0
    # replication: read quanta that fanned out to a replica while a primary
    # was dead, write quanta shipped to the standby; the watchdog's probes
    failover_quanta: int = 0
    replica_quanta: int = 0
    watchdog_probes: int = 0
    watchdog_suspects: int = 0
    # live resharding
    reshards: int = 0
    reshard_drain_rounds: int = 0

    def _pct(self, p: float) -> float:
        if not self.latencies_ms:
            return float("nan")
        return float(np.percentile(np.asarray(self.latencies_ms), p))

    @property
    def p50_ms(self) -> float:
        return self._pct(50)

    @property
    def p99_ms(self) -> float:
        return self._pct(99)

    @property
    def p999_ms(self) -> float:
        return self._pct(99.9)

    @property
    def throughput_rps(self) -> float:
        return self.completed / self.wall_s if self.wall_s else 0.0

    @property
    def utilization(self) -> float:
        return self.slot_rounds / self.capacity_rounds if self.capacity_rounds else 0.0

    @property
    def mean_recovery_ms(self) -> float:
        return self.recovery_ms_total / self.recoveries if self.recoveries else float("nan")

    @property
    def deadline_hit_rate(self) -> float:
        n = self.deadlines_met + self.deadlines_missed
        return self.deadlines_met / n if n else float("nan")

    def summary(self) -> str:
        return (
            f"retired={self.retired} completed={self.completed} faulted={self.faulted} "
            f"timed_out={self.timed_out} rounds={self.rounds} "
            f"p50={self.p50_ms:.2f}ms p99={self.p99_ms:.2f}ms "
            f"throughput={self.throughput_rps:.0f} req/s "
            f"util={self.utilization:.0%} shed={self.shed}"
        )


def _host(x):
    """An init argument as the main thread uses it: a tensor's copy on the
    host, anything else as it is."""
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


def _make_probe_iterator() -> PulseIterator:
    """The shard watchdog's one-touch read: load one node of a chosen
    shard's range, keep its first word and finish.  A PULSE ISA program,
    so on the card it runs on ``pulse_chase``'s superstep launch like real
    traffic, and a delayed straggler stalls the probe by its whole delay,
    the signal the watchdog escalates (a straggler never raises
    ``ShardFailure``).  ``n_instructions`` is the JAX package's count of
    its probe."""
    a = isa.Asm(scratch_words=1, node_words=1, name="shard_probe")
    a.loadn(1, 0)
    a.stores(0, 1)
    a.ret()
    it = isa.as_pulse_iterator(a.finish())
    return dataclasses.replace(it, n_instructions=3)


_PROBE_IT = _make_probe_iterator()


class _SlotGroup:
    """The fixed-width slot block of one structure (one batch shape)."""

    def __init__(self, name: str, spec: StructureSpec, n_slots: int):
        self.name = name
        self.spec = spec
        self.n_slots = n_slots
        S = spec.iterator.scratch_words
        self.req: list[TraversalRequest | None] = [None] * n_slots
        self.ptr = np.full(n_slots, NULL, np.int32)
        self.scratch = np.zeros((n_slots, S), np.int32)
        self.iters = np.zeros(n_slots, np.int64)
        # admission runs init on the host, so its arguments live there
        self.host_init_args = tuple(_host(a) for a in spec.init_args)
        # fault tolerance: a group whose quantum hit a dead shard is parked
        # (occupants kept, admission blocked) until this round; failures in
        # a row drive the exponential backoff
        self.backoff_until = -1
        self.fail_streak = 0

    def free_slots(self) -> int:
        return sum(r is None for r in self.req)

    def occupied(self) -> np.ndarray:
        return np.array([r is not None for r in self.req])


class PulseService:
    """Continuous-batching traversal server over a ``PulseEngine``.

    ``backend`` is the engine's: ``None`` (the kernel for an arena on the
    card, the plain executor on the CPU), ``"kernel"`` or ``"reference"``.
    The JAX package's ``"xla"`` raises: its counterpart is
    ``"reference"``."""

    def __init__(
        self,
        engine: PulseEngine,
        structures: dict[str, StructureSpec],
        *,
        slots_per_structure: int = 32,
        quantum: int = 16,
        max_request_iters: int = 1 << 16,
        backend: str | None = None,
        compact: bool = True,
        fused: bool = True,
        schedule: str = "auto",
        fabric: str = "dense",
        pipeline: str = "sync",
        runner_depth: int = 2,
        min_quantum: int | None = None,
        max_quantum: int | None = None,
        slo_safety: float = 0.5,
        preempt: bool = False,
        max_pending: int | None = None,
        rate_limit_rps: float | None = None,
        rate_limit_burst: float | None = None,
        fault_tolerance=None,
    ):
        if backend == "xla":
            raise ValueError("backend 'xla' is the JAX package's plain executor; the port's "
                             "is backend='reference' (or None: the kernel on the card)")
        if backend not in (None, *BACKENDS):
            raise ValueError(f"unknown backend {backend!r}; choose None or one of {BACKENDS}")
        if quantum < 1:
            raise ValueError("quantum must be >= 1")
        if pipeline not in ("sync", "async"):
            raise ValueError(f"pipeline must be 'sync' or 'async', got {pipeline!r}")
        if isinstance(engine.mesh, routing.ProcessGroupMesh):
            # rank 0 serves; every engine call it makes is announced to the
            # ranks that follow it (serving.memory_node.follow)
            engine.mesh = memory_node.lead(engine.mesh, engine.arena, structures)
        self.engine = engine
        self.backend = backend
        self.compact = compact
        self.fused = fused
        # "auto" resolves per iterator through the dispatch engine's overlap
        # model: on a mesh normally the pipelined schedule
        self.schedule = schedule
        self.fabric = fabric
        self.quantum = quantum
        self.max_request_iters = max_request_iters
        # "async": a DeviceRunner thread keeps the quantum in flight while
        # this thread drains retirements and books the next round; engine
        # calls stay FIFO on it, so every result equals the sync loop's
        self.pipeline = pipeline
        self.runner_depth = runner_depth
        self._runner: DeviceRunner | None = None
        # SLO-aware quantum sizing within [min_quantum, max_quantum]; both
        # default to ``quantum`` (a fixed quantum)
        self.min_quantum = min_quantum if min_quantum is not None else quantum
        self.max_quantum = max_quantum if max_quantum is not None else quantum
        if not 1 <= self.min_quantum <= self.max_quantum:
            raise ValueError("need 1 <= min_quantum <= max_quantum")
        self.slo_safety = slo_safety
        self._cur_quantum = min(max(quantum, self.min_quantum), self.max_quantum)
        self._ms_per_iter: float | None = None
        self.preempt = preempt
        # admission-time verification: an ISA spec without a certificate is
        # verified before any slot group exists
        for name, spec in structures.items():
            self._verify_spec(name, spec)
        self.groups = {name: _SlotGroup(name, spec, slots_per_structure)
                       for name, spec in structures.items()}
        limiter = (TenantRateLimiter(rate_limit_rps, rate_limit_burst)
                   if rate_limit_rps is not None else None)
        self.admission = AdmissionController(max_pending=max_pending, rate_limiter=limiter)
        self.metrics = ServiceMetrics()
        # fault tolerance (arena_ft.FaultToleranceConfig): the snapshot and
        # the commit log of write quanta, shard-failure detection, and
        # serving while recovering (backoff and a retry budget)
        self.ft = fault_tolerance
        self._detector: ShardFailureDetector | None = None
        self._dead_until: dict[int, int] = {}  # shard -> revive round
        self._ft_rng: random.Random | None = None
        self._writes_since_snapshot = 0
        # the log-shipped standby (arena_ft.ReplicaSet), and the per-round
        # shard watchdog on a logical round clock
        self._replicas = None
        self._watchdog: HeartbeatMonitor | None = None
        self._wd_round = -1
        if self.ft is not None:
            from repro_torch.distributed.arena_ft import ReplicaSet

            P = engine.arena.num_shards
            on_mesh = engine.mesh is not None and P >= 2
            rep = self.ft.replication
            if rep is not None and not on_mesh:
                raise ValueError("replication needs a distributed engine (mesh) with >= 2 shards")
            if self.ft.watchdog_timeout_s > 0 and not on_mesh:
                raise ValueError("the shard watchdog needs a distributed engine (mesh)")
            for name, spec in structures.items():
                if spec.writes:
                    self.ft.store.register_iterator(name, spec.iterator)
            # recovery always needs a state to replay from
            self.ft.store.ensure_baseline(engine.arena)
            self._detector = ShardFailureDetector(P)
            self._ft_rng = random.Random(self.ft.seed)
            if rep is not None:
                plan = routing.make_replica_plan(P, rep.primaries, policy=rep.policy)
                self._replicas = ReplicaSet(plan, engine.arena, mesh=engine.mesh)
            if self.ft.watchdog_timeout_s > 0:
                # a timeout of one round on the logical clock: a shard is
                # suspected only after two slow probes in a row
                self._watchdog = HeartbeatMonitor(P, timeout_s=1, clock=lambda: self._wd_round)
        # live resharding: owner-function epochs and the drain/cutover planner
        self._owner_map = VersionedOwnerMap(engine.arena.bounds.tolist())
        self._reshard = ReshardPlanner()
        self._pending_arrivals: list[TraversalRequest] = []
        # retirement events (writes?, request), pushed by whichever thread
        # retires and drained for accounting on the main thread
        self._emit: deque = deque()
        if self._watchdog is not None:
            # build and warm the probe's path, so the first timed round does
            # not read a build as a stall
            for s in range(engine.arena.num_shards):
                self._probe_shard(s, warm=True)

    # ------------------------------ intake -----------------------------------

    @staticmethod
    def _verify_spec(name: str, spec: StructureSpec) -> None:
        """Reject before enqueueing: an ISA iterator built without its
        certificate (``facts`` is None, a ``__wrapped_program__`` on its
        step) is verified now; a rejection raises the verifier's
        ``VerifyError`` naming the structure.  Certified iterators and ones
        written in torch (no program) pass as they are."""
        it = spec.iterator
        if it.facts is not None:
            return
        prog = None
        for fn in (it.step_fn, it.mut_fn):
            prog = getattr(fn, "__wrapped_program__", None)
            if prog is not None:
                break
        if prog is None:
            return
        from repro_torch.core.verify import VerifyError, verify_program

        try:
            verify_program(prog)
        except VerifyError as e:
            raise VerifyError(f"{e.name} (registered as structure {name!r})",
                              e.diagnostics) from None

    def submit(self, req: TraversalRequest) -> None:
        """Queue a request for admission (``arrive_round`` gates logical time)."""
        if req.structure not in self.groups:
            raise KeyError(f"unknown structure {req.structure!r}")
        self._pending_arrivals.append(req)

    # ------------------------------ serving ----------------------------------

    def _intake(self, now_s: float, rnd: int) -> None:
        arrivals = [r for r in self._pending_arrivals if r.arrive_round <= rnd]
        self._pending_arrivals = [r for r in self._pending_arrivals if r.arrive_round > rnd]
        m = self.metrics
        for r in arrivals:
            if not self.admission.submit(r, now_s):
                r.status = STATUS_SHED
                m.shed += 1
        m.queue_depth_max = max(m.queue_depth_max, self.admission.pending())

    def _maybe_preempt(self, now_s: float) -> None:
        """EDF slot stealing: when the most urgent queued deadline targets
        a full read group holding a strictly less urgent continuation,
        evict it (its ``(cur_ptr, scratch_pad)`` is the whole traversal
        state) and requeue it at its original arrival order.  At most one
        eviction a round."""
        peek = self.admission.peek_earliest_deadline()
        if peek is None:
            return
        urgent_dl, urgent = peek
        g = self.groups.get(urgent.structure)
        if g is None or g.spec.writes or g.free_slots() > 0:
            return
        victim, victim_dl = -1, -1.0
        for s, r in enumerate(g.req):
            if r is None or g.iters[s] <= 0:
                continue  # only continuations that already ran a quantum
            dl = float("inf") if r.deadline_ms is None else r.arrival_s + r.deadline_ms / 1e3
            if victim < 0 or dl > victim_dl:
                victim, victim_dl = s, dl
        if victim < 0 or victim_dl <= urgent_dl:
            return
        v = g.req[victim]
        if v.tenant == urgent.tenant and getattr(v, "_seq", 0) < getattr(urgent, "_seq", 0):
            return  # per-tenant FIFO: the requeued victim would sit ahead of the urgent one
        v.cont_ptr = int(g.ptr[victim])
        v.cont_scratch = g.scratch[victim].copy()
        v.iters = int(g.iters[victim])
        v.preemptions += 1
        g.req[victim] = None
        g.ptr[victim] = NULL
        self.admission.requeue(v)
        self.metrics.preempted += 1

    def _admit(self, now_s: float, rnd: int) -> None:
        """Admit into free slots; a fresh request's ``init`` runs on the
        host (its queries and the group's host copies of the init
        arguments), so this thread makes no CUDA call."""
        self._intake(now_s, rnd)
        if self.preempt:
            self._maybe_preempt(now_s)
        free = {name: g.free_slots() for name, g in self.groups.items()}
        # a group parked on a dead shard admits no one until its backoff
        # ends: the retried batch re-runs as it was (the same batch, the
        # same allocation order, the same arena after recovery)
        for name, g in self.groups.items():
            if g.backoff_until > rnd:
                free[name] = 0
        free = apply_write_barriers(
            free,
            {n: g.spec.group or n for n, g in self.groups.items()},
            {n: g.spec.writes for n, g in self.groups.items()},
            {n: bool(g.occupied().any()) for n, g in self.groups.items()},
            # queue heads only: a writer buried behind its tenant's reads
            # must not block those reads
            self.admission.head_pending_by_structure(),
        )
        admitted = self.admission.admit(free)
        by_group: dict[str, list[TraversalRequest]] = {}
        for r in admitted:
            by_group.setdefault(r.structure, []).append(r)
        for name, reqs in by_group.items():
            g = self.groups[name]
            fresh = [r for r in reqs if r.cont_ptr is None]
            if fresh:
                queries = torch.from_numpy(np.array([r.query for r in fresh], np.int32))
                if g.spec.takes_value:
                    values = torch.from_numpy(np.array([r.value for r in fresh], np.int32))
                    ptr0, scr0 = g.spec.iterator.init(queries, values, *g.host_init_args)
                else:
                    ptr0, scr0 = g.spec.iterator.init(queries, *g.host_init_args)
                ptr0 = ptr0.numpy().astype(np.int32)
                scr0 = scr0.numpy().astype(np.int32)
            free_idx = [i for i, r in enumerate(g.req) if r is None]
            fi = 0
            for j, r in enumerate(reqs):
                s = free_idx[j]
                g.req[s] = r
                if r.cont_ptr is None:
                    g.ptr[s] = ptr0[fi]
                    g.scratch[s] = scr0[fi]
                    g.iters[s] = 0
                    fi += 1
                else:  # a preempted continuation resumes its saved state
                    g.ptr[s] = r.cont_ptr
                    g.scratch[s] = r.cont_scratch
                    g.iters[s] = r.iters
                    r.cont_ptr = None
                    r.cont_scratch = None
                if r.admit_s < 0:
                    r.admit_s = now_s
                    r.admit_round = rnd

    def _fast_retire(self, g: _SlotGroup, slot: int, status: int, now_s: float,
                     rnd: int) -> None:
        """Free the slot and keep the result (safe on the runner thread);
        the accounting happens when ``_drain_emit`` takes the event."""
        r = g.req[slot]
        r.status = int(status)
        r.iters = int(g.iters[slot])
        r.result = g.scratch[slot].copy()
        r.finish_s = now_s
        r.finish_round = rnd
        g.req[slot] = None
        g.ptr[slot] = NULL
        self._emit.append((g.spec.writes, r))

    def _drain_emit(self) -> None:
        """Account the retirement events (in async mode while the device
        runs the current quantum)."""
        m = self.metrics
        while True:
            try:
                writes, r = self._emit.popleft()
            except IndexError:
                return
            m.retired += 1
            m.writes_retired += int(writes)
            m.completed += int(r.status == STATUS_DONE)
            m.faulted += int(r.status == STATUS_FAULT)
            m.timed_out += int(r.status == STATUS_MAXED)
            m.retry_exhausted += int(r.status == STATUS_RETRY)
            m.latencies_ms.append(r.latency_ms)
            t = m.per_tenant.setdefault(r.tenant, {"completed": 0, "latencies_ms": []})
            t["completed"] += int(r.status == STATUS_DONE)
            t["latencies_ms"].append(r.latency_ms)
            met = r.deadline_met
            if met is not None:
                if met:
                    m.deadlines_met += 1
                else:
                    m.deadlines_missed += 1

    def _apply_result(self, g: _SlotGroup, occ, host, stats, dt_s: float, rnd: int) -> None:
        """Scatter one quantum's results (``host``: ``(ptr, scratch,
        status, iters)`` as numpy, copied from the device once) into the
        group's slots, retiring what finished."""
        now_s = time.perf_counter()
        m = self.metrics
        m.engine_calls += 1
        g.fail_streak = 0  # a quantum landed: the group is healthy again
        if stats is not None and hasattr(stats, "supersteps"):
            m.supersteps += stats.supersteps
            m.wire_words += stats.total_wire_words
            m.commits += getattr(stats, "commits", 0)
        ptr, scratch, status, iters = host
        iters_done = 0
        for s in np.flatnonzero(occ):
            g.ptr[s] = ptr[s]
            g.scratch[s] = scratch[s]
            lane = int(iters[s])
            g.iters[s] += lane
            m.lane_iters += lane
            iters_done = max(iters_done, lane)
            st = int(status[s])
            if st == STATUS_MAXED and g.iters[s] < self.max_request_iters:
                continue  # a continuation: stays in its slot, resumes next round
            self._fast_retire(g, int(s), st, now_s, rnd)
        if iters_done > 0 and dt_s > 0:
            est = dt_s * 1e3 / iters_done  # ms per iteration, EWMA-smoothed
            self._ms_per_iter = (est if self._ms_per_iter is None
                                 else 0.7 * self._ms_per_iter + 0.3 * est)

    def _make_work(self, g: _SlotGroup, rnd: int, quantum: int) -> QuantumWork:
        # NULL pointers in free slots fault on their first iteration, so a
        # fixed-width batch is one batch shape per group
        occ = g.occupied()
        log_writes = self.ft is not None and g.spec.writes
        rep = self._replicas

        def run():
            t0 = time.perf_counter()
            dev = self.engine.arena.data.device
            p0 = g.ptr.copy()
            s0 = g.scratch.copy()
            rep_ctx = None if g.spec.writes else self._replica_ctx()
            res = self.engine.execute(
                g.spec.iterator,
                torch.from_numpy(p0).to(dev),
                torch.from_numpy(s0).to(dev),
                max_iters=quantum,
                backend=self.backend,
                compact=self.compact,
                fused=self.fused,
                schedule=self.schedule,
                fabric=self.fabric,
                replication=rep_ctx,
            )
            fanned_out = rep_ctx is not None and bool(rep_ctx.dead_mask.any())
            shipped = False
            if log_writes:
                # the durability point: the quantum is acknowledged once its
                # inputs are in the fsynced log (their replay on the same
                # executor rebuilds the arena bit for bit); a crash
                # before this line loses an unacknowledged quantum only.
                # k_local is engine.execute's default, logged so the replay
                # chases as deep
                store = self.ft.store
                seq = store.log_quantum(g.name, p0, s0, max_iters=quantum, k_local=4,
                                        compact=self.compact, commits=res.stats.commits,
                                        epochs=res.stats.epochs)
                self._writes_since_snapshot += 1
                if self._writes_since_snapshot >= self.ft.snapshot_every:
                    store.snapshot(res.arena, seq)
                    self._writes_since_snapshot = 0
                if rep is not None:
                    # ship the quantum's inputs to the standby: both copies
                    # apply the same serialized commit stream
                    rep.apply_quantum(g.spec.iterator, p0, s0, max_iters=quantum, k_local=4,
                                      compact=self.compact)
                    if self.ft.replication.verify_every_quantum:
                        rep.verify(res.arena)
                    shipped = True
            S = g.spec.iterator.scratch_words
            # one copy to the host a quantum, not a read per slot
            flat = torch.cat([res.ptr[:, None], res.status[:, None], res.iters[:, None],
                              res.scratch.reshape(-1, S)], 1).to(torch.int32).cpu().numpy()
            host = (flat[:, 0], flat[:, 3:], flat[:, 1], flat[:, 2])
            return host, res.stats, time.perf_counter() - t0, fanned_out, shipped

        def apply(out):
            host, stats, dt_s, fanned_out, shipped = out
            self.metrics.failover_quanta += int(fanned_out)
            self.metrics.replica_quanta += int(shipped)
            self._apply_result(g, occ, host, stats, dt_s, rnd)

        return QuantumWork(label=g.name, run=run, apply=apply)

    # --------------------------- fault tolerance ------------------------------

    def _verify_recovery(self, recovered) -> None:
        """No acknowledged commit lost: the snapshot and the replayed log
        must rebuild the engine's resident arena exactly.  The engine swaps
        its arena only after a quantum succeeds, and a successful write
        quantum is logged before it is acknowledged, so any difference
        means the durable state lost an acknowledged commit."""
        cur = self.engine.arena
        for field in ("data", "bounds", "perms", "heap"):
            a, b = getattr(cur, field), getattr(recovered, field)
            if not torch.equal(a, b.to(a.device)):
                raise RuntimeError(f"recovery lost acknowledged commits: arena.{field} diverged")

    def _register_retry(self, g: _SlotGroup, rnd: int) -> None:
        """Park the failed group under a jittered exponential backoff and
        charge each occupant one retry; a request past its budget retires
        STATUS_RETRY (the client resubmits after recovery)."""
        ft = self.ft
        m = self.metrics
        g.fail_streak += 1
        backoff = min(ft.backoff_cap, ft.backoff_base * (1 << (g.fail_streak - 1)))
        jitter = 1.0 + ft.backoff_jitter * (2.0 * self._ft_rng.random() - 1.0)
        g.backoff_until = rnd + 1 + max(1, int(round(backoff * jitter)))
        now_s = time.perf_counter()
        for s, r in enumerate(g.req):
            if r is None:
                continue
            r.retries += 1
            m.retries += 1
            if r.retries > ft.retry_budget:
                self._fast_retire(g, s, STATUS_RETRY, now_s, rnd)

    def _on_shard_failure(self, e: ShardFailure, rnd: int) -> None:
        """Fail over: mark the shard dead, recover the arena from the
        latest snapshot and the log onto the engine's device, check it
        against the resident arena, and park the failed group for a
        backed-off retry.  Runs on the main thread once the runner is idle
        (it fails fast, and its error surfaced here; quanta queued behind
        a failure raised at a submit are waited for), so swapping the arena
        races nothing and, on a process group, every collective is issued
        from one thread at a time."""
        m = self.metrics
        if self._runner is not None:
            # a failure raised at a submit may leave quanta queued behind it:
            # the recovery's replays must not run beside them
            self._runner.wait_idle()
        self._detector.suspect(e.shard, rnd)
        self._detector.sweep()
        t0 = time.perf_counter()
        eng = self.engine
        # replay on the executor that wrote the log: the mesh's on a mesh
        mesh = eng.mesh if eng.mesh is not None and eng.arena.num_shards > 1 else None
        recovered, info = self.ft.store.recover(device=eng.arena.data.device, mesh=mesh)
        self._verify_recovery(recovered)
        self.engine.arena = recovered
        m.recoveries += 1
        m.replayed_commits += info.replayed_commits
        m.recovery_ms_total += (time.perf_counter() - t0) * 1e3
        self._dead_until[e.shard] = rnd + 1 + self.ft.dead_rounds
        g = self.groups.get(e.label) if e.label else None
        if g is None:
            return
        if not g.spec.writes and self._has_live_replica(e.shard):
            # the failed call mutated nothing, so the group's slots are
            # intact and re-run next round, reading from the replica: read
            # tenants ride through the death with no retry and no backoff
            return
        self._register_retry(g, rnd)

    def _has_live_replica(self, shard: int) -> bool:
        """True when ``shard``'s range can be served by a replica holder
        that is alive (policy "primary" never redirects)."""
        if self._replicas is None or self._replicas.plan.policy == "primary":
            return False
        rm = self._replicas.plan.replica_map
        if not 0 <= shard < len(rm):
            return False
        holder = int(rm[shard])
        return holder >= 0 and holder not in self._detector.dead_shards()

    def _replica_ctx(self) -> routing.ReplicaContext | None:
        """This quantum's read fan-out operands; None when replication is
        off or nothing would redirect (policy "failover" with every primary
        alive keeps the device-resident schedule; "spread" always fans
        out).  The dead mask is built on the host."""
        if self._replicas is None:
            return None
        P = self.engine.arena.num_shards
        rm = self._replicas.plan.replica_map
        down = {s for s in self._detector.dead_shards() if 0 <= s < P}
        dead = np.zeros(P, bool)
        for s in down:
            # fan out only ranges whose holder is alive: a primary marked
            # dead with a dead holder would leave its range unservable
            holder = int(rm[s]) if s < len(rm) else -1
            if holder >= 0 and holder not in down:
                dead[s] = True
        if not dead.any() and self._replicas.plan.policy != "spread":
            return None
        return routing.ReplicaContext(plan=self._replicas.plan,
                                      rep_rows=self._replicas.rep_rows(), dead_mask=dead)

    def _probe_shard(self, shard: int, *, warm: bool = False) -> float:
        """Seconds of one single-record read of ``shard`` through the
        dispatched superstep path.  ``warm=True`` only builds and warms (no
        fault injection, no failure handling).  Live probes share the
        engine's fault-injector calls: ``kill_call`` counts them too."""
        arena = self.engine.arena
        bounds = arena.bounds.tolist()
        if bounds[shard + 1] - bounds[shard] <= 0:
            return 0.0  # an empty range: nothing to probe
        dev = arena.data.device
        ptr0 = torch.tensor([bounds[shard]], dtype=torch.int32, device=dev)
        scr0 = torch.zeros((1, 1), dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        try:
            routing.distributed_execute(
                _PROBE_IT, arena, ptr0, scr0, mesh=self.engine.mesh,
                axis_name=self.engine.axis_name, max_iters=2, k_local=1, compact=True,
                schedule="dispatched",
                fault_injector=None if warm else self.engine.fault_injector)
        except ShardFailure as e:
            if e.label is None:
                e.label = "watchdog"
            self._on_shard_failure(e, max(self._wd_round, 0))
            return float("inf")
        return time.perf_counter() - t0

    def _run_watchdog(self, rnd: int) -> None:
        """The per-round shard watchdog: probe every live shard, beat those
        that answered within ``ft.watchdog_timeout_s``, and turn missed
        beats into suspected deaths.  It catches stragglers (delay faults)
        that stall supersteps without raising: the next round's reads fan
        out to the replica."""
        m = self.metrics
        if self._wd_round < 0:
            # the first round (or just resharded): every shard as if beaten
            # last round, so the two-misses window counts from here
            self._wd_round = rnd - 1
            for s in self._watchdog.hosts:
                self._watchdog.beat(s)
        self._wd_round = rnd
        dead_now = set(self._detector.dead_shards())
        for s in range(self.engine.arena.num_shards):
            if s in dead_now:
                continue  # already degraded: do not stall on it
            dt = self._probe_shard(s)
            m.watchdog_probes += 1
            if dt <= self.ft.watchdog_timeout_s:
                self._watchdog.beat(s)
        for s in self._watchdog.sweep():
            if s in dead_now or s in self._detector.dead_shards():
                continue
            m.watchdog_suspects += 1
            self._detector.suspect(s, rnd)
            self._detector.sweep()
            self._dead_until[s] = rnd + 1 + self.ft.dead_rounds

    def _revive_dead_shards(self, rnd: int) -> None:
        for k in [k for k, until in self._dead_until.items() if until <= rnd]:
            self._detector.revive(k)
            if self._watchdog is not None and k in self._watchdog.hosts:
                # re-arm the beat, so a revived shard that is still slow is
                # suspected again (a sweep reports new misses only)
                self._watchdog.beat(k)
            del self._dead_until[k]

    # ------------------------------ elasticity --------------------------------

    def request_reshard(self, new_num_shards: int) -> None:
        """Begin an online 2x change of the shard count: admission pauses,
        every in-flight quantum drains through the write barrier's
        machinery, then the arena cuts over (``remap_shards``, an owner
        epoch, a mesh of the new width) and admission resumes.  The result
        equals a cold rebuild at the new count bit for bit.

        On a ``ProcessGroupMesh`` the new mesh is the world's first
        ``new_num_shards`` ranks (``memory_node.Leader.cutover``); a world
        with fewer raises ``RuntimeError`` at the cutover, as the reference
        does with too few devices."""
        new_num_shards = int(new_num_shards)
        if (isinstance(self.engine.mesh, routing.ProcessGroupMesh) and new_num_shards > 0
                and self.engine.arena.capacity % new_num_shards):
            # the replica rows are scattered in equal blocks, one a rank
            raise ValueError(f"{self.engine.arena.capacity} rows do not split into "
                             f"{new_num_shards} equal shards")
        self._reshard.request(new_num_shards, current=self.engine.arena.num_shards,
                              rnd=self.metrics.rounds)

    def _in_flight(self) -> int:
        return sum(int(g.occupied().sum()) for g in self.groups.values())

    def _cutover(self, rnd: int) -> None:
        m = self.metrics
        old_p = self.engine.arena.num_shards
        target = self._reshard.target
        new_arena = remap_shards(self.engine.arena, target)
        mesh = self.engine.mesh
        new_mesh = None
        if isinstance(mesh, routing.ProcessGroupMesh):
            # every rank of the world switches groups at this header; the
            # async runner drained last round, so no call is in flight
            new_mesh = mesh.leader.cutover(mesh, new_arena, target)
        elif mesh is not None:
            new_mesh = routing.EmulatedMesh(target, mesh.device, axis_name=self.engine.axis_name)
        ep = self._owner_map.advance(new_arena.bounds.tolist())
        old_epoch = ep.epoch - 1

        def fwd(s: int) -> tuple[int, ...]:
            return self._owner_map.forward_shard(s, from_epoch=old_epoch, to_epoch=ep.epoch)

        # per-shard serving state minted under the old owner function
        # forwards through the new epoch: a shard index never survives a
        # reshard raw, only by range translation
        self._dead_until = {d: until for s, until in self._dead_until.items() for d in fwd(s)}
        if self._detector is not None:
            old_dead = self._detector.dead_shards()
            self._detector = ShardFailureDetector(target)
            for s in old_dead:
                for d in fwd(s):
                    self._detector.suspect(d, rnd)
            self._detector.sweep()
        self.engine.reshard(new_arena, new_mesh)
        if self._replicas is not None:
            repc = self.ft.replication
            prim = repc.primaries
            if prim is not None:
                prim = tuple(sorted({d for p in prim for d in fwd(p)}))
            plan = routing.make_replica_plan(target, prim, policy=repc.policy)
            # the standby reshards through the same deterministic remap, so
            # primary and replica stay bit-identical across the cutover
            self._replicas.reset(remap_shards(self._replicas.shadow, target), plan,
                                 mesh=new_mesh)
        if self._watchdog is not None:
            self._watchdog = HeartbeatMonitor(target, timeout_s=1, clock=lambda: self._wd_round)
            self._wd_round = -1  # re-arm the baseline
        if self.ft is not None:
            # a marker and a snapshot in the log: replay never straddles two
            # partitions
            store = self.ft.store
            seq = store.log.append({"kind": "reshard", "old_shards": old_p,
                                    "new_shards": target, "owner_epoch": ep.epoch})
            store.snapshot(self.engine.arena, seq)
            self._writes_since_snapshot = 0
        ev = self._reshard.complete(rnd=rnd, old_shards=old_p, owner_epoch=ep.epoch)
        m.reshards += 1
        m.reshard_drain_rounds += ev.drain_rounds

    def _quantum_for_round(self, now_s: float) -> int:
        """SLO-aware quantum sizing: with the bounds pinned the fixed
        ``quantum``; otherwise, no deadline in sight, grow toward
        ``max_quantum``; a deadline queued or on the device, fit the
        quantum in the earliest deadline's headroom by the EWMA ms per
        iteration, floored at ``min_quantum``."""
        lo, hi = self.min_quantum, self.max_quantum
        if lo == hi:
            return lo
        deadlines = []
        q_dl = self.admission.earliest_deadline_s()
        if q_dl is not None:
            deadlines.append(q_dl)
        for g in self.groups.values():
            for r in g.req:
                if r is not None and r.deadline_ms is not None:
                    deadlines.append(r.arrival_s + r.deadline_ms / 1e3)
        if not deadlines or self._ms_per_iter is None:
            self._cur_quantum = min(hi, max(lo, self._cur_quantum * 2))
        else:
            headroom_ms = max(0.0, (min(deadlines) - now_s) * 1e3)
            target = int(headroom_ms * self.slo_safety / self._ms_per_iter)
            self._cur_quantum = min(hi, max(lo, target))
        return self._cur_quantum

    def _ensure_runner(self) -> DeviceRunner | None:
        if self.pipeline != "async":
            return None
        if self._runner is None:
            self._runner = DeviceRunner(depth=self.runner_depth).start()
        return self._runner

    def _busy(self) -> bool:
        return (bool(self._pending_arrivals) or self.admission.pending() > 0
                or any(g.occupied().any() for g in self.groups.values())
                or self._reshard.phase != "idle")

    def step(self, rnd: int | None = None) -> None:
        """One scheduling round: admit, run every occupied group, retire.

        sync: each group's quantum runs inline.  async: the quanta go to the
        ``DeviceRunner`` and this thread accounts earlier retirements while
        the device works; the round ends on the runner's drain, so the next
        admission sees settled slots and the engine calls are sync's."""
        m = self.metrics
        rnd = m.rounds if rnd is None else rnd
        now = time.perf_counter()
        if self._detector is not None:
            self._revive_dead_shards(rnd)
        if self._reshard.phase == "draining":
            # the reshard barrier: arrivals queue, nothing admits, and the
            # cutover fires the round the last in-flight quantum retires
            self._intake(now, rnd)
            if self._reshard.should_cutover(self._in_flight()):
                self._cutover(rnd)
                self._admit(now, rnd)
        else:
            self._admit(now, rnd)
        quantum = self._quantum_for_round(now)
        if m.quantum_min_used == 0 or quantum < m.quantum_min_used:
            m.quantum_min_used = quantum
        m.quantum_max_used = max(m.quantum_max_used, quantum)
        runner = self._ensure_runner()
        for g in self.groups.values():
            occupied_before = int(g.occupied().sum())
            m.slot_rounds += occupied_before
            m.capacity_rounds += g.n_slots
            if occupied_before == 0 or g.backoff_until > rnd:
                continue  # empty, or parked for a backed-off retry
            work = self._make_work(g, rnd, quantum)
            try:
                if runner is not None:
                    # a pending runner error surfaces here, before the work
                    # is queued: this group simply re-runs next round
                    runner.submit(work)
                else:
                    work.apply(work.run())
            except ShardFailure as e:
                if self.ft is None:
                    raise
                if e.label is None:
                    e.label = g.name
                self._on_shard_failure(e, rnd)
        if runner is not None:
            self._drain_emit()  # overlap: account retirements mid-flight
            try:
                runner.drain()  # barrier: slot state settled for the next admission
            except ShardFailure as e:
                if self.ft is None:
                    raise
                self._on_shard_failure(e, rnd)
        self._drain_emit()
        if self._watchdog is not None:
            self._run_watchdog(rnd)
        if self._detector is not None:
            self._detector.beat_all(rnd)
        m.rounds += 1

    def close(self) -> None:
        """Stop the background runner (idempotent; restarted on demand).  On
        a process group, also end every other rank of the world, each member
        of the serving group returning its copy of the engine's arena and
        each rank outside it None: the service is done."""
        try:
            if self._runner is not None:
                self._runner.close()
                self._runner = None
        finally:
            leader = getattr(self.engine.mesh, "leader", None)
            if leader is not None:
                leader.stop(self.engine.arena)

    def run(self, requests: list[TraversalRequest] | None = None, *,
            max_rounds: int = 100_000) -> ServiceMetrics:
        """Serve until every submitted request has retired."""
        t0 = time.perf_counter()
        for r in requests or []:
            self.submit(r)
        try:
            while self._busy():
                if self.metrics.rounds >= max_rounds:
                    raise RuntimeError(f"service did not drain in {max_rounds} rounds")
                self.step()
        finally:
            self.close()
            self._drain_emit()
        self.metrics.wall_s += time.perf_counter() - t0
        return self.metrics
