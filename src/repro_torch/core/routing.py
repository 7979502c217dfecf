"""Distributed pointer traversals: the in-network switch as supersteps
(paper S5), on P memory nodes emulated on one device.

The paper routes in-flight traversal requests between memory nodes with a
programmable switch that holds only the range-partition base table.  Here a
mesh of P memory nodes is emulated on one device (``EmulatedMesh``): every
per-shard array carries a leading ``(P, ...)`` axis, each shard's pool of
request records is ``pools[s]``, and the fabric's all_to_all is a transpose
of the send buffer's first two axes.  A batch runs in bulk-synchronous
supersteps (``distributed_execute``, the dispatched schedule): every
shard's local chase (``_local_superstep``: on the card one ``pulse_chase``
launch in its superstep mode over all P pools), then the switch
(``_route_decide``, ``_exchange``, ``_merge_pools``), with the host reading
four counters per superstep to schedule the next.  The paper's properties
hold as in the JAX package:

  * a cross-node hop never bounces through the CPU node (compare
    ``return_to_cpu=True``, the paper's PULSE-ACC ablation, Fig. 9);
  * the request and the response share one wire format, so any shard can
    continue any traversal it receives;
  * the switch knows only ``bounds``; translation and protection happen at
    the owning shard.

Record wire format (R = 6 + S [+ 4 + W] int32 words):
  [id, home_shard, cur_ptr, status, iters, hops, scratch_pad...,
   m_op, m_tgt, m_mask, m_expect, m_data...]
The mutation payload exists only for mutating iterators, whose executor
here is ``core.commit.sequential_commit_execute``.

Ported so far: the read path on the dispatched schedule and the dense
fabric (ROADMAP queue 1, item 6(a)).  The mutating superstep is item 6(b),
the fused and pipelined schedules and the ring fabric 6(c), replication
and fabric faults 6(d); each raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import translation
from repro_torch.core.arena import NULL, PERM_READ, Arena
from repro_torch.core.iterator import (
    STATUS_ACTIVE,
    STATUS_EMPTY,
    STATUS_FAULT,
    PulseIterator,
    step_batch,
)

# request record words: [id, home shard, ptr, status, iters, hops,
# scratch (S), mutation payload (mut_width(W), write path only)]
F_ID, F_HOME, F_PTR, F_STATUS, F_ITERS, F_HOPS, F_SCRATCH = 0, 1, 2, 3, 4, 5, 6


def record_width(scratch_words: int, mut_words: int = 0) -> int:
    return F_SCRATCH + scratch_words + mut_words


def _later(item: str, what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} comes with ROADMAP queue 1, item {item}")


def _check_fabric(fabric: str) -> None:
    if fabric == "ring":
        raise _later("6(c)", "the ring fabric (ppermute distance classes)")
    if fabric != "dense":
        raise ValueError(f"unknown fabric {fabric!r}")


@dataclasses.dataclass(frozen=True)
class EmulatedMesh:
    """P memory nodes emulated on one device: the stand-in for
    ``jax.make_mesh((P,), ("mem",))``.  Every per-shard array carries a
    leading ``(P, ...)`` axis on ``device``."""

    num_shards: int
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError(f"a mesh needs at least one shard, got {self.num_shards}")


def _serve_shard(owner, rec_id, rep_ctx):
    """The switch's serve map: which shard answers a read at ``owner``'s
    range.  Identity; the replica fan-out is item 6(d)."""
    if rep_ctx is not None:
        raise _later("6(d)", "the replica serve map (ReplicaContext)")
    return owner


def pack_requests(ids, home, ptr, scratch) -> torch.Tensor:
    """``(B, R)`` ACTIVE request records on ``ptr``'s device."""
    B, S = scratch.shape
    rec = torch.zeros((B, record_width(S)), dtype=torch.int32, device=ptr.device)
    rec[:, F_ID] = ids
    rec[:, F_HOME] = home
    rec[:, F_PTR] = ptr
    rec[:, F_STATUS] = STATUS_ACTIVE
    rec[:, F_SCRATCH : F_SCRATCH + S] = scratch
    return rec


def empty_records(n: int, scratch_words: int, device="cpu") -> torch.Tensor:
    rec = torch.zeros((n, record_width(scratch_words)), dtype=torch.int32, device=device)
    rec[:, F_STATUS] = STATUS_EMPTY
    return rec


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


# ------------------------------ one superstep --------------------------------


def _local_superstep(
    it: PulseIterator,
    pools: torch.Tensor,  # (P, L, R) every shard's pool
    arena_data: torch.Tensor,  # (cap, W) the whole arena (global rows)
    bounds: torch.Tensor,  # (P + 1,)
    perms: torch.Tensor,  # (P,)
    *,
    k_local: int,
    max_iters: int,
    backend: str = "kernel",
    elide_access_check: bool = False,
):
    """Run up to ``k_local`` iterations for every shard's locally-owned
    ACTIVE records; returns the new pools.

    ``backend="kernel"`` is one ``pulse_chase`` launch in its superstep mode
    over all P pools on a CUDA arena (its plain version on a CPU arena).
    ``backend="reference"`` is the plain chase: ``k_local`` calls of
    ``iterator.step_batch`` per shard over that shard's rows.  Both give the
    same pools bit for bit.

    ``elide_access_check=True`` replaces the per-shard PERM_READ probe with
    constant True; ``distributed_execute`` sets it only when the iterator's
    pulse-verify certificate proves it read-only and every shard grants
    PERM_READ, so eliding is bit-identical.
    """
    if backend == "kernel":
        from repro_torch.kernels.pulse_chase import ops as chase_ops

        return chase_ops.pulse_chase_superstep(
            arena_data, pools, bounds, perms, logic_fn=chase_ops.iterator_logic(it),
            k_local=k_local, max_iters=max_iters, elide_access_check=elide_access_check)
    if backend != "reference":
        raise ValueError(f"unknown local backend {backend!r}")
    S = it.scratch_words
    edges = bounds.tolist()
    granted = translation.access_table(perms, PERM_READ).tolist()
    out = pools.clone()
    for s, pool in enumerate(out):
        lo, hi = int(edges[s]), int(edges[s + 1])
        st = (pool[:, F_PTR], pool[:, F_SCRATCH : F_SCRATCH + S], pool[:, F_STATUS],
              pool[:, F_ITERS])
        for _ in range(k_local):
            st = step_batch(it, arena_data[lo:hi], *st, max_iters=max_iters, local_lo=lo,
                            local_hi=hi, perm_ok=True if elide_access_check else granted[s])
        pool[:, F_PTR], pool[:, F_SCRATCH : F_SCRATCH + S] = st[0], st[1]
        pool[:, F_STATUS], pool[:, F_ITERS] = st[2], st[3]
    return out


def _route_decide(
    pools: torch.Tensor,  # (P, L, R)
    bounds: torch.Tensor,
    num_shards: int,
    *,
    return_to_cpu: bool,
    link_capacity: int | None = None,
    drain_done: bool = False,
):
    """Switch decision and leaver extraction for every shard at once.

    Computes each record's next shard, marks switch-level faults (an ACTIVE
    record whose pointer no shard owns), packs the records that fit under
    the per-link capacity C into a ``(P, P, C, R)`` send buffer (source,
    destination, slot) and strips them from their pools.  A destination
    takes its movers in pool order; the overflow parks in place for the
    next superstep (the JAX package's trash row).  Returns
    ``(kept, send, n_routed)``, ``n_routed`` a device scalar.

    ``drain_done`` (compaction): finished records retire in place instead
    of being shipped home.  ``return_to_cpu`` (PULSE-ACC, Fig. 9): a
    traversal leaving a node returns to its home node, which re-issues it.
    """
    P, L, R = pools.shape
    dev = pools.device
    Cp = L // num_shards if link_capacity is None else int(link_capacity)
    me = torch.arange(P, dtype=torch.int32, device=dev)[:, None]
    status = pools[..., F_STATUS]
    valid = status != STATUS_EMPTY
    active = status == STATUS_ACTIVE

    owner = translation.owner_of(bounds, pools[..., F_PTR].contiguous())
    bad = active & (owner == NULL)  # the switch notifies the CPU node (Fig. 6 step 6)
    status = torch.where(bad, STATUS_FAULT, status).to(torch.int32)
    pools = pools.clone()
    pools[..., F_STATUS] = status
    active = status == STATUS_ACTIVE
    home = pools[..., F_HOME]

    serve = _serve_shard(owner, pools[..., F_ID], None)
    if return_to_cpu:
        stay = active & (owner == me)
        dest = torch.where(stay, me, home)
        dest = torch.where(active & (owner != me), home, dest)
        at_home = active & (home == me) & (owner != me)  # once home, re-issue to the owner
        dest = torch.where(at_home, owner, dest)
    elif drain_done:
        dest = torch.where(active, serve, me)
    else:
        dest = torch.where(active, serve, home)
    dest = torch.where(valid, dest, me).to(torch.int32)
    moves = valid & (dest != me)

    # slot of each mover among its destination's movers, in pool order: a
    # (source, destination, record) one-hot scanned along its last axis
    dests = torch.arange(num_shards, dtype=torch.int32, device=dev)[None, :, None]
    onehot = ((dest[:, None, :] == dests) & moves[:, None, :]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=2, dtype=torch.int32) - onehot
    pos = torch.gather(pos, 1, dest.clamp(0, num_shards - 1).long()[:, None, :])[:, 0]
    fits = moves & (pos < Cp)
    pools[..., F_HOPS] += fits.to(torch.int32)

    # every record has a row of its own: a mover its (source, destination,
    # slot), anything else one past the buffer, dropped after the copy
    row = (me.long() * num_shards + dest.long()) * Cp + pos.long()
    spare = P * P * Cp + torch.arange(P * L, device=dev).reshape(P, L)
    send = empty_records(P * P * Cp + P * L, R - F_SCRATCH, dev)
    send.index_copy_(0, torch.where(fits, row, spare).reshape(-1), pools.reshape(P * L, R))
    send = send[: P * P * Cp].reshape(P, P, Cp, R)

    kept = pools
    kept[..., F_STATUS] = torch.where(fits, STATUS_EMPTY, pools[..., F_STATUS]).to(torch.int32)
    return kept, send, fits.sum()


def _exchange(send: torch.Tensor, num_shards: int, *, fabric: str = "dense"):
    """Carry the send buffer across the fabric: arrivals ``(P, P * C, R)``,
    each destination's ordered by source shard (the dense all_to_all
    layout).  On one device the all_to_all is a transpose of the send
    buffer's source and destination axes."""
    _check_fabric(fabric)
    P, _, Cp, R = send.shape
    return send.transpose(0, 1).reshape(num_shards, P * Cp, R)


def _merge_pools(kept: torch.Tensor, arrivals: torch.Tensor, L: int):
    """Merge arrivals into each shard's pool: valid records first, then
    empties, in a stable order; keep L slots.  Returns ``(merged,
    n_dropped_valid)``, the count a device scalar summed over shards."""
    both = torch.cat([kept, arrivals], dim=1)
    is_empty = (both[..., F_STATUS] == STATUS_EMPTY).to(torch.int32)
    order = torch.sort(is_empty, dim=1, stable=True).indices
    merged = torch.gather(both, 1, order[:, :L, None].expand(-1, -1, both.shape[2]))
    n_dropped = (1 - is_empty).sum() - (merged[..., F_STATUS] != STATUS_EMPTY).sum()
    return merged, n_dropped


def _route(
    pools: torch.Tensor,
    bounds: torch.Tensor,
    num_shards: int,
    *,
    return_to_cpu: bool,
    link_capacity: int | None = None,
    drain_done: bool = False,
    fabric: str = "dense",
):
    """Switch routing: deliver every record to its next shard in one
    superstep.  Returns ``(pools, n_routed, n_dropped_valid)``."""
    L = pools.shape[1]
    kept, send, n_routed = _route_decide(
        pools, bounds, num_shards, return_to_cpu=return_to_cpu,
        link_capacity=link_capacity, drain_done=drain_done)
    arrivals = _exchange(send, num_shards, fabric=fabric)
    merged, n_dropped = _merge_pools(kept, arrivals, L)
    return merged, n_routed, n_dropped


def _remote_active(pools, bounds):
    """ACTIVE records their shard cannot serve (owner elsewhere or none),
    summed over shards."""
    P = pools.shape[0]
    me = torch.arange(P, dtype=torch.int32, device=pools.device)[:, None]
    active = pools[..., F_STATUS] == STATUS_ACTIVE
    owner = _serve_shard(translation.owner_of(bounds, pools[..., F_PTR].contiguous()),
                         pools[..., F_ID], None)
    return (active & (owner != me)).sum()


def superstep(
    it: PulseIterator,
    pools: torch.Tensor,
    arena_data: torch.Tensor,
    bounds: torch.Tensor,
    perms: torch.Tensor,
    *,
    k_local: int,
    max_iters: int,
    return_to_cpu: bool = False,
    link_capacity: int | None = None,
    drain_done: bool = False,
    do_route: bool = True,
    local_backend: str = "kernel",
    elide_access_check: bool = False,
):
    """One read superstep over all P shards: the local chase, then the
    switch.  Returns ``(pools, n_active, n_routed, n_drop, n_remote)``, the
    counters device scalars summed over the shards.

    ``do_route=False`` is the compacted local-only step: every surviving
    traversal already sits at its owning shard, so the fabric is skipped
    (wire payload 0); it still counts the actives that turned remote.
    ``local_backend`` is ``_local_superstep``'s backend.
    """
    pools = _local_superstep(
        it, pools, arena_data, bounds, perms, k_local=k_local, max_iters=max_iters,
        backend=local_backend, elide_access_check=elide_access_check)
    if do_route:
        pools, n_routed, n_drop = _route(
            pools, bounds, pools.shape[0], return_to_cpu=return_to_cpu,
            link_capacity=link_capacity, drain_done=drain_done)
    else:
        n_routed = n_drop = torch.zeros((), dtype=torch.int64, device=pools.device)
    n_active = (pools[..., F_STATUS] == STATUS_ACTIVE).sum()
    n_remote = _remote_active(pools, bounds)
    return pools, n_active, n_routed, n_drop, n_remote


def make_superstep(
    it: PulseIterator,
    num_shards: int,
    *,
    fabric: str = "dense",
    mutate: bool = False,
    drop_prob: float = 0.0,
    replication=None,
    **kw,
):
    """The JAX package's superstep builder, read variant: ``(pools,
    arena_data, bounds, perms) -> superstep(it, pools, ...)`` with ``kw``
    (``superstep``'s keywords) bound.  The mutating superstep, fabric loss,
    replication and the ring fabric raise, naming their sub-items."""
    if mutate:
        raise _later("6(b)", "the mutating superstep (chase, commit, route)")
    if drop_prob > 0.0 or replication is not None:
        raise _later("6(d)", "fabric loss and replication")
    _check_fabric(fabric)
    return functools.partial(superstep, it, **kw)


# ------------------------------- the executor --------------------------------


def place_requests(ptr0, scratch0, num_shards: int):
    """Every request at its home shard (``id % P``): ``(pools (P, L, R),
    B)`` on ``ptr0``'s device, with ``L = Bp``, the batch padded to a
    multiple of P (all requests could, transiently, sit on one shard).
    Request ``i`` takes slot ``i // P`` of shard ``i % P``: the JAX
    package's stable sort by home shard, the padding as EMPTY records."""
    P = num_shards
    B, S = scratch0.shape
    dev = ptr0.device
    Bp = ((B + P - 1) // P) * P
    L = Bp
    ids = torch.arange(B, dtype=torch.int32, device=dev)
    rec = torch.cat([pack_requests(ids, ids % P, ptr0, scratch0),
                     empty_records(Bp - B, S, dev)])
    pools = empty_records(P * L, S, dev).reshape(P, L, -1)
    pools[:, : Bp // P] = rec.reshape(Bp // P, P, -1).transpose(0, 1)
    return pools, B


def distributed_execute(
    it: PulseIterator,
    arena: Arena,
    ptr0,
    scratch0,
    *,
    mesh: EmulatedMesh,
    max_iters: int = 1 << 30,
    k_local: int = 4,
    max_supersteps: int = 1 << 16,
    return_to_cpu: bool = False,
    compact: bool = False,
    min_link_capacity: int = 8,
    schedule: str = "dispatched",
    fabric: str = "dense",
    local_backend: str | None = None,
    fault_injector=None,
    replication=None,
    elide_access_check: bool | None = None,
):
    """Run a batch of traversals over a range-partitioned arena on a mesh
    of P memory nodes emulated on the arena's device.

    The dispatched schedule: one superstep per host iteration (the local
    chase, then the switch), the host reading four counters per superstep
    (actives, routed, dropped, remote) to pick the next.  ``local_backend``
    is ``"kernel"`` (the default for an arena on the card: one
    ``pulse_chase`` launch per superstep over all P pools; its plain version
    on a CPU arena) or ``"reference"`` (the default on the CPU: ``k_local``
    calls of ``step_batch`` per shard).

    ``compact=True`` enables active-set compaction: finished records retire
    in place (``drain_done``); the per-link capacity follows a power-of-two
    envelope of the surviving actives, ``min(L // P, max(min_link_capacity,
    pow2(ceil(n_active / P))))``; a superstep whose actives all sit at
    their owning shard skips the fabric.  Results are bit-identical to the
    uncompacted schedule; only ``crossings`` differ.  ``compact`` is
    ignored under ``return_to_cpu`` (the home bounce is the ablation).

    ``fault_injector`` (the JAX package's ``FaultInjector`` interface:
    ``begin_call``, ``kill_step``, ``fire``, ``plan``): a targeted kill
    fires before the named (1-based) superstep.

    ``elide_access_check=None`` auto-specializes (``can_elide_access_check``);
    ``False`` keeps the probe; ``True`` asserts the caller's own proof.

    Under ``torch.profiler`` the placement, each superstep (its one read of
    the counters included) and the decode show as the spans
    ``routing.place``, ``routing.superstep`` and ``routing.decode``.

    Returns ``(records, RoutingStats)``: the records a ``(B, R)`` int32
    tensor on the arena's device, ordered by request id.  The fused and
    pipelined schedules and the ring fabric are item 6(c), replication,
    fabric loss and stragglers 6(d), mutating iterators 6(b)
    (``core.commit.sequential_commit_execute`` runs them without a mesh, at
    any P).
    """
    kill_at = None
    if fault_injector is not None:
        plan = getattr(fault_injector, "plan", None)
        if plan is not None and (getattr(plan, "drop_prob", 0.0) > 0.0
                                 or getattr(plan, "delay_shard", None) is not None):
            raise _later("6(d)", "injected fabric loss and straggler delays")
        kill_at = fault_injector.kill_step(fault_injector.begin_call())
    if schedule not in ("dispatched", "fused", "pipelined"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule != "dispatched":
        raise _later("6(c)", f"the {schedule} schedule")
    _check_fabric(fabric)
    if it.mutates:
        raise _later("6(b)", "a mutating iterator on a mesh (the commit phase on the fabric)")
    if replication is not None:
        raise _later("6(d)", "replicated reads (ReplicaContext)")
    dev = arena.data.device
    if local_backend is None:
        local_backend = "kernel" if dev.type == "cuda" else "reference"
    if local_backend not in ("kernel", "reference"):
        raise ValueError(f"unknown local_backend {local_backend!r}")
    if elide_access_check is None:
        elide_access_check = can_elide_access_check(it, arena)
    num_shards = arena.num_shards
    if mesh.num_shards != num_shards:
        raise ValueError(f"arena has {num_shards} shards but the mesh has {mesh.num_shards}")
    if torch.device(mesh.device).type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device}, the arena on {dev}")
    if arena.capacity % num_shards:
        raise ValueError("distributed arena must have uniform shard sizes")

    S = it.scratch_words
    R = record_width(S)
    ptr0 = torch.as_tensor(ptr0, dtype=torch.int32).to(dev)
    scratch0 = torch.as_tensor(scratch0, dtype=torch.int32).to(dev).reshape(-1, S)
    with torch.profiler.record_function("routing.place"):
        pools, B = place_requests(ptr0, scratch0, num_shards)
    L = pools.shape[1]
    base_capacity = L // num_shards
    compact = compact and not return_to_cpu

    routed_per_step, active_per_step = [], []
    wire_words_per_step, capacity_per_step = [], []
    local_only_steps = 0
    steps = 0
    # before the first superstep everything is active and sitting at home
    n_active, n_remote = B, B
    for _ in range(max_supersteps):
        # an injected shard death fires before the targeted (1-based) superstep
        if kill_at is not None and steps + 1 >= kill_at:
            fault_injector.fire(steps + 1)
        if compact:
            demand = (n_active + num_shards - 1) // num_shards
            capacity = min(base_capacity, max(min_link_capacity, _pow2_at_least(demand)))
            do_route = n_remote > 0
        else:
            capacity, do_route = base_capacity, True
        with torch.profiler.record_function("routing.superstep"):
            pools, *counts = superstep(
                it, pools, arena.data, arena.bounds, arena.perms, k_local=k_local,
                max_iters=max_iters, return_to_cpu=return_to_cpu,
                link_capacity=capacity if compact else None, drain_done=compact,
                do_route=do_route, local_backend=local_backend,
                elide_access_check=elide_access_check)
            # the dispatched schedule's one read of the device per superstep
            n_active, n_routed, n_drop, n_remote = torch.stack(counts).tolist()
        steps += 1
        routed_per_step.append(n_routed)
        active_per_step.append(n_active)
        capacity_per_step.append(capacity if do_route else 0)
        wire_words_per_step.append(
            num_shards * (num_shards - 1) * capacity * R if do_route else 0)
        local_only_steps += int(not do_route)
        if n_drop != 0:  # not assert: must survive python -O
            raise RuntimeError(f"request records lost in routing (pool overflow): {n_drop}")
        if n_active == 0:
            break
    else:
        raise RuntimeError(
            f"distributed_execute: {n_active} records still ACTIVE after "
            f"max_supersteps={max_supersteps}; raise the cap or lower max_iters "
            f"(records would be returned with partial state otherwise)"
        )
    with torch.profiler.record_function("routing.decode"):
        return _decode_results(
            pools, B, S, supersteps=steps, routed_per_step=routed_per_step,
            active_per_step=active_per_step, wire_words_per_step=wire_words_per_step,
            capacity_per_step=capacity_per_step, local_only_steps=local_only_steps,
            schedule=schedule, fabric=fabric, num_shards=num_shards)


def _decode_results(
    pools,
    B: int,
    scratch_words: int,
    *,
    supersteps: int,
    routed_per_step: list,
    active_per_step: list,
    wire_words_per_step: list,
    capacity_per_step: list,
    local_only_steps: int,
    schedule: str,
    fabric: str,
    num_shards: int,
):
    """Order the final pools' records by request id on their device, and
    build the stats; the host reads the record count and the crossings.

    Every request id in ``[0, B)`` sits in exactly one valid record (a
    record lost in routing has already raised), so sorting by id, with
    empties and padding keyed past the batch, puts the batch in the first
    B rows."""
    flat = pools.reshape(-1, record_width(scratch_words))
    keep = (flat[:, F_STATUS] != STATUS_EMPTY) & (flat[:, F_ID] < B)
    key = torch.where(keep, flat[:, F_ID], B)
    all_rec = flat[torch.sort(key, stable=True).indices[:B]]
    n_kept = int(keep.sum())
    if n_kept != B:  # not assert: must survive python -O
        raise RuntimeError(f"request records lost in routing: {B - n_kept} of {B}")
    stats = RoutingStats(
        supersteps=supersteps,
        crossings=all_rec[:, F_HOPS].cpu().numpy(),
        routed_per_step=routed_per_step,
        active_per_step=active_per_step,
        wire_words_per_step=wire_words_per_step,
        capacity_per_step=capacity_per_step,
        local_only_steps=local_only_steps,
        schedule=schedule,
        fabric=fabric,
        _num_shards=num_shards,
    )
    return all_rec, stats
