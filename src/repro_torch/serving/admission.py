"""Admission control for traversal serving (``PulseService``).

The paper's CPU node (S4.1) is where requests are born: ``init()`` runs
there, and the dispatch engine decides what is offloaded.  At serving
scale it also needs an admission policy: which queued traversal requests
get the accelerator's slots next.

  * **per-tenant FIFO queues**: a tenant's own requests never reorder;
  * **deadline-aware (EDF) selection across tenants**: the head request
    with the earliest absolute deadline wins a free slot;
  * **fairness credits**: ties (the common case with no deadlines) go to
    the tenant served least, so a flooding tenant cannot starve a trickle
    one;
  * **per-structure capacity**: a slot group runs one iterator program, so
    admission respects each group's free slots and skips requests whose
    group is full (they keep their queue position);
  * **write barriers** (``apply_write_barriers``): writers take their
    structure group exclusively.

Pure Python and numpy, as in the JAX package: the same submit sequences
give the same admit lists, shed counts and requeue order.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import deque

import numpy as np


@dataclasses.dataclass
class TraversalRequest:
    """One pointer-traversal request (the wire-format record's CPU-side twin).

    ``query`` is the structure-specific init argument (search key for
    find-style iterators, head pointer for aggregations).  ``deadline_ms``
    is relative to arrival; ``None`` means best-effort.
    """

    req_id: int
    structure: str
    query: int
    tenant: str = "default"
    deadline_ms: float | None = None
    arrive_round: int = 0  # logical arrival time (service rounds)
    value: int = 0  # write payload (inserts/updates; ignored by reads)

    # filled in by the service
    arrival_s: float = -1.0
    admit_s: float = -1.0
    finish_s: float = -1.0
    admit_round: int = -1
    finish_round: int = -1
    status: int = -1
    iters: int = 0
    result: np.ndarray | None = None  # final scratch pad
    # preemption: a MAXED continuation evicted from its slot carries its
    # complete traversal state (cur_ptr + scratch_pad, paper S3/S5) back to
    # the queue and resumes from it when re-admitted
    cont_ptr: int | None = None
    cont_scratch: np.ndarray | None = None
    preemptions: int = 0
    # fault tolerance: times this request was re-queued because its shard
    # group hit a dead shard; past the retry budget it retires STATUS_RETRY
    retries: int = 0

    @property
    def latency_ms(self) -> float:
        if self.finish_s < 0 or self.arrival_s < 0:
            return float("nan")
        return (self.finish_s - self.arrival_s) * 1e3

    @property
    def deadline_met(self) -> bool | None:
        if self.deadline_ms is None:
            return None
        return self.latency_ms <= self.deadline_ms


def apply_write_barriers(
    free_slots: dict[str, int],
    group_of: dict[str, str],
    writes: dict[str, bool],
    occupied: dict[str, bool],
    pending: dict[str, int],
) -> dict[str, int]:
    """Write-path admission barrier: per structure *group*, writers get the
    group exclusively.

    Rules (G = group of a slot-group; a "writer" runs a mutating iterator):

      * a write slot-group admits only while NO other slot-group of G is
        occupied -- one write batch owns the group at a time, so its commit
        supersteps never interleave with that group's reads mid-flight;
      * a read slot-group admits only while no write slot-group of G is
        occupied AND no write request for G is queued -- queued writers
        drain the readers out first (anti-starvation: a write behind a
        steady read stream would otherwise never see the group empty).

    Readers of *other* groups are untouched: the barrier is per structure
    group, exactly the scope one per-structure lock would cover.
    Returns a copy of ``free_slots`` with blocked structures zeroed.
    """
    write_occupied = {
        group_of[n] for n, occ in occupied.items() if occ and writes.get(n)
    }
    read_occupied = {
        group_of[n] for n, occ in occupied.items() if occ and not writes.get(n)
    }
    write_pending = {
        group_of[n] for n in pending if writes.get(n)
    }
    # one writer per group per round: the occupied writer keeps the group;
    # otherwise the pending writer with the OLDEST queued request (arrival
    # sequence, name as tiebreak) wins the claim -- FIFO-consistent, so the
    # winner is the writer admission would reach first, and two write
    # slot-groups of one group are never admitted into the same round
    write_winner: dict[str, str] = {}
    claims: dict[str, tuple] = {}
    for n in sorted(free_slots):
        if not writes.get(n):
            continue
        g = group_of[n]
        if n in pending:
            key = (pending[n], n)
            if g not in claims or key < claims[g]:
                claims[g] = key
                write_winner[g] = n
    for n in free_slots:  # occupied writers override pending claims
        if writes.get(n) and occupied.get(n):
            write_winner[group_of[n]] = n
    out = dict(free_slots)
    for name in out:
        g = group_of[name]
        if writes.get(name):
            if g in read_occupied or write_winner.get(g) != name:
                out[name] = 0
        else:
            if g in write_occupied or g in write_pending:
                out[name] = 0
    return out


class TenantRateLimiter:
    """Per-tenant token bucket: ``rate_rps`` sustained, ``burst`` headroom.

    One flooding tenant drains its own bucket and gets shed at the door;
    other tenants' buckets (and therefore their admission latency) are
    untouched.  Buckets are created lazily, full, on first sight."""

    def __init__(self, rate_rps: float, burst: float | None = None):
        if rate_rps <= 0:
            raise ValueError("rate_rps must be > 0")
        self.rate = float(rate_rps)
        self.burst = float(burst) if burst is not None else max(1.0, self.rate)
        self._tokens: dict[str, float] = {}
        self._stamp: dict[str, float] = {}

    def allow(self, tenant: str, now_s: float) -> bool:
        last = self._stamp.get(tenant, now_s)
        tok = self._tokens.get(tenant, self.burst)
        tok = min(self.burst, tok + max(0.0, now_s - last) * self.rate)
        self._stamp[tenant] = now_s
        if tok >= 1.0:
            self._tokens[tenant] = tok - 1.0
            return True
        self._tokens[tenant] = tok
        return False


class AdmissionController:
    """Per-tenant queues + EDF-with-fairness slot assignment.

    Overload controls (both optional, off by default so the controller
    keeps its original accept-everything contract):

      * ``max_pending`` -- bounded admission queue: a submit that would push
        the total backlog past the bound is *shed* (rejected with
        backpressure) instead of queued, so queue depth -- and therefore
        queueing delay for already-accepted requests -- stays bounded under
        open-loop overload;
      * ``rate_limiter`` -- per-tenant token bucket applied before the
        queue-depth check, so one flooding tenant is shed at its own bucket
        and cannot consume the shared queue budget.

    Bookkeeping is incremental: per-structure min-heaps (lazy deletion)
    give O(structures) ``pending_by_structure`` and an O(1)-amortized
    earliest-deadline query instead of the previous O(backlog) scans --
    under a deep backlog the per-round admission cost no longer grows with
    the number of queued requests.
    """

    def __init__(
        self,
        *,
        max_pending: int | None = None,
        rate_limiter: TenantRateLimiter | None = None,
    ):
        self._queues: dict[str, deque[TraversalRequest]] = {}
        self._served: dict[str, int] = {}
        self._seq = 0  # global arrival tiebreak
        self._push = 0  # heap-entry tiebreak (requeues reuse _seq)
        self._pending = 0
        self.max_pending = max_pending
        self.rate_limiter = rate_limiter
        # (seq, push, req) min-heaps per structure; (abs_deadline, push, req)
        # across all structures.  Entries whose request was admitted are
        # dead; they are popped lazily when they surface at a heap head.
        self._struct_heaps: dict[str, list] = {}
        self._deadline_heap: list = []
        self.shed = 0
        self.shed_rate_limited = 0
        self.shed_queue_full = 0
        self.shed_by_tenant: dict[str, int] = {}

    def _shed(self, req: TraversalRequest, *, rate_limited: bool) -> bool:
        self.shed += 1
        self.shed_rate_limited += int(rate_limited)
        self.shed_queue_full += int(not rate_limited)
        self.shed_by_tenant[req.tenant] = self.shed_by_tenant.get(req.tenant, 0) + 1
        return False

    def _push_heaps(self, req: TraversalRequest) -> None:
        self._push += 1
        heapq.heappush(
            self._struct_heaps.setdefault(req.structure, []),
            (req._seq, self._push, req),  # type: ignore[attr-defined]
        )
        if req.deadline_ms is not None:
            heapq.heappush(
                self._deadline_heap,
                (req.arrival_s + req.deadline_ms / 1e3, self._push, req),
            )

    def submit(self, req: TraversalRequest, now_s: float) -> bool:
        """Queue ``req``; returns False (and counts a shed) when the tenant
        is over its rate or the bounded queue is full."""
        if self.rate_limiter is not None and not self.rate_limiter.allow(
            req.tenant, now_s
        ):
            return self._shed(req, rate_limited=True)
        if self.max_pending is not None and self._pending >= self.max_pending:
            return self._shed(req, rate_limited=False)
        req.arrival_s = now_s
        req._seq = self._seq  # type: ignore[attr-defined]
        req._admitted = False  # type: ignore[attr-defined]
        self._seq += 1
        self._pending += 1
        self._queues.setdefault(req.tenant, deque()).append(req)
        self._served.setdefault(req.tenant, 0)
        self._push_heaps(req)
        return True

    def requeue(self, req: TraversalRequest) -> None:
        """Return a preempted continuation to the *front* of its tenant
        queue.  The request keeps its original arrival ``_seq`` (and
        deadline), so EDF ordering treats it exactly as the old request it
        is; the served credit its admission charged is refunded so
        preemption stays fairness-neutral.  Bounded-queue and rate limits do
        not apply -- the request was already accepted once."""
        req._admitted = False  # type: ignore[attr-defined]
        self._pending += 1
        self._queues.setdefault(req.tenant, deque()).appendleft(req)
        self._served[req.tenant] = max(0, self._served.get(req.tenant, 1) - 1)
        self._push_heaps(req)

    def pending(self) -> int:
        return self._pending

    def pending_by_structure(self) -> dict[str, int]:
        """Earliest queued arrival sequence per structure (presence in the
        dict == has pending work).  Drives the write barriers: the winning
        writer of a group is the one whose request has waited longest, which
        keeps the barrier consistent with FIFO admission order (a name-order
        winner could deadlock against a tenant whose queue head is the other
        writer)."""
        out: dict[str, int] = {}
        for s, h in self._struct_heaps.items():
            while h and h[0][2]._admitted:
                heapq.heappop(h)
            if h:
                out[s] = h[0][0]
        return out

    def head_pending_by_structure(self) -> dict[str, int]:
        """Like ``pending_by_structure`` but restricted to tenant-queue
        *heads* -- the only requests ``admit`` can actually reach this
        round.  This is what the write barriers must consume: a writer
        buried mid-queue cannot take the group now, and blocking the
        group's readers on it would deadlock a tenant whose queue
        interleaves reads ahead of writes (the reads can never drain, so
        the writer never reaches its head)."""
        out: dict[str, int] = {}
        for q in self._queues.values():
            if not q:
                continue
            r = q[0]
            s = getattr(r, "_seq", 0)
            cur = out.get(r.structure)
            out[r.structure] = s if cur is None else min(cur, s)
        return out

    def peek_earliest_deadline(self) -> tuple[float, TraversalRequest] | None:
        """(absolute deadline, request) of the most urgent *queued* (not yet
        admitted) request, or None.  Feeds EDF preemption: the urgent head
        may steal a slot from a strictly-less-urgent continuation."""
        h = self._deadline_heap
        while h and h[0][2]._admitted:
            heapq.heappop(h)
        return (h[0][0], h[0][2]) if h else None

    def earliest_deadline_s(self) -> float | None:
        """Earliest absolute queued deadline, or None.  Feeds SLO-aware
        quantum sizing: a deadline waiting in the queue bounds how long the
        device may stay busy on the current batch before that request must
        get a slot."""
        peek = self.peek_earliest_deadline()
        return peek[0] if peek else None

    def __len__(self) -> int:
        return self.pending()

    def admit(self, free_slots: dict[str, int]) -> list[TraversalRequest]:
        """Fill free slots from the queues; returns the admitted requests.

        Selection loop: among every tenant's head request whose structure
        group still has room, pick the earliest (deadline, served-credit,
        arrival) triple.  A head whose group is full blocks its tenant for
        this round (FIFO within tenant is preserved) -- the tenant's later
        requests for non-full groups wait their turn.
        """
        free = {k: int(v) for k, v in free_slots.items() if v > 0}
        admitted: list[TraversalRequest] = []
        while free:
            best_key = None
            best_tenant = None
            for tenant, q in self._queues.items():
                if not q:
                    continue
                head = q[0]
                if free.get(head.structure, 0) <= 0:
                    continue
                deadline = (
                    float("inf")
                    if head.deadline_ms is None
                    else head.arrival_s + head.deadline_ms / 1e3
                )
                key = (deadline, self._served[tenant], head._seq)  # type: ignore[attr-defined]
                if best_key is None or key < best_key:
                    best_key, best_tenant = key, tenant
            if best_tenant is None:
                break
            req = self._queues[best_tenant].popleft()
            req._admitted = True  # type: ignore[attr-defined]
            self._pending -= 1
            self._served[best_tenant] += 1
            free[req.structure] -= 1
            if free[req.structure] <= 0:
                del free[req.structure]
            admitted.append(req)
        return admitted
