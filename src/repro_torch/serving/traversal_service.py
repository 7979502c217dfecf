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
    cuts the arena over (``arena.remap_shards``, owner-epoch forwarding, an
    ``EmulatedMesh`` of the new width);
  * **accounting**: latency percentiles, throughput, deadlines, and the
    engine's supersteps, wire words and commits (``ServiceMetrics``).

The service runs over the engine's one-node path (the ``pulse_chase``
kernel, or the plain executor) and over a mesh (``EmulatedMesh``), on any
schedule: admission sits above the dispatch decision, like the paper's CPU
node.  ``pipeline="async"`` issues every engine call from a
``DeviceRunner`` thread while this thread admits the next round.

Fault tolerance (snapshots and a commit log, shard-failure detection,
replication, the watchdog) is ROADMAP item 8: ``fault_tolerance=`` raises,
and a ``ShardFailure`` propagates to the caller.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core import routing
from repro_torch.core.arena import NULL, remap_shards
from repro_torch.core.engine import BACKENDS, PulseEngine
from repro_torch.core.iterator import (
    STATUS_DONE,
    STATUS_FAULT,
    STATUS_MAXED,
    STATUS_RETRY,
    STATUS_SHED,
    PulseIterator,
)
from repro_torch.distributed.elastic import ReshardPlanner
from repro_torch.distributed.sharding import VersionedOwnerMap
from repro_torch.serving.admission import (
    AdmissionController,
    TenantRateLimiter,
    TraversalRequest,
    apply_write_barriers,
)
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
    # fault tolerance and replication (ROADMAP item 8): always 0 here
    recoveries: int = 0
    replayed_commits: int = 0
    retries: int = 0
    retry_exhausted: int = 0
    recovery_ms_total: float = 0.0
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
        if fault_tolerance is not None:
            raise NotImplementedError(
                "fault_tolerance (snapshots, the commit log, shard-failure detection, "
                "replication, the watchdog) comes with ROADMAP item 8")
        if backend == "xla":
            raise ValueError("backend 'xla' is the JAX package's plain executor; the port's "
                             "is backend='reference' (or None: the kernel on the card)")
        if backend not in (None, *BACKENDS):
            raise ValueError(f"unknown backend {backend!r}; choose None or one of {BACKENDS}")
        if quantum < 1:
            raise ValueError("quantum must be >= 1")
        if pipeline not in ("sync", "async"):
            raise ValueError(f"pipeline must be 'sync' or 'async', got {pipeline!r}")
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
        # live resharding: owner-function epochs and the drain/cutover planner
        self._owner_map = VersionedOwnerMap(engine.arena.bounds.tolist())
        self._reshard = ReshardPlanner()
        self._pending_arrivals: list[TraversalRequest] = []
        # retirement events (writes?, request), pushed by whichever thread
        # retires and drained for accounting on the main thread
        self._emit: deque = deque()

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

        def run():
            t0 = time.perf_counter()
            dev = self.engine.arena.data.device
            res = self.engine.execute(
                g.spec.iterator,
                torch.from_numpy(g.ptr.copy()).to(dev),
                torch.from_numpy(g.scratch.copy()).to(dev),
                max_iters=quantum,
                backend=self.backend,
                compact=self.compact,
                fused=self.fused,
                schedule=self.schedule,
                fabric=self.fabric,
            )
            S = g.spec.iterator.scratch_words
            # one copy to the host a quantum, not a read per slot
            flat = torch.cat([res.ptr[:, None], res.status[:, None], res.iters[:, None],
                              res.scratch.reshape(-1, S)], 1).to(torch.int32).cpu().numpy()
            host = (flat[:, 0], flat[:, 3:], flat[:, 1], flat[:, 2])
            return host, res.stats, time.perf_counter() - t0

        def apply(out):
            host, stats, dt_s = out
            self._apply_result(g, occ, host, stats, dt_s, rnd)

        return QuantumWork(label=g.name, run=run, apply=apply)

    # ------------------------------ elasticity --------------------------------

    def request_reshard(self, new_num_shards: int) -> None:
        """Begin an online 2x change of the shard count: admission pauses,
        every in-flight quantum drains through the write barrier's
        machinery, then the arena cuts over (``remap_shards``, an owner
        epoch, an ``EmulatedMesh`` of the new width) and admission resumes.
        The result equals a cold rebuild at the new count bit for bit."""
        self._reshard.request(int(new_num_shards), current=self.engine.arena.num_shards,
                              rnd=self.metrics.rounds)

    def _in_flight(self) -> int:
        return sum(int(g.occupied().sum()) for g in self.groups.values())

    def _cutover(self, rnd: int) -> None:
        m = self.metrics
        old_p = self.engine.arena.num_shards
        target = self._reshard.target
        new_arena = remap_shards(self.engine.arena, target)
        new_mesh = None
        if self.engine.mesh is not None:
            new_mesh = routing.EmulatedMesh(target, self.engine.mesh.device,
                                            axis_name=self.engine.axis_name)
        ep = self._owner_map.advance(new_arena.bounds.tolist())
        self.engine.reshard(new_arena, new_mesh)
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
            if occupied_before == 0:
                continue
            work = self._make_work(g, rnd, quantum)
            if runner is not None:
                runner.submit(work)  # a pending runner error surfaces here
            else:
                work.apply(work.run())
        if runner is not None:
            self._drain_emit()  # overlap: account retirements mid-flight
            runner.drain()  # barrier: slot state settled for the next admission
        self._drain_emit()
        m.rounds += 1

    def close(self) -> None:
        """Stop the background runner (idempotent; restarted on demand)."""
        if self._runner is not None:
            self._runner.close()
            self._runner = None

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
