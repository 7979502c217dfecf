"""Distributed pointer traversals: the in-network switch as supersteps
(paper S5), on P memory nodes emulated on one device.

The paper routes in-flight traversal requests between memory nodes with a
programmable switch that holds only the range-partition base table.  Here a
mesh of P memory nodes is emulated on one device (``EmulatedMesh``): every
per-shard array carries a leading ``(P, ...)`` axis, each shard's pool of
request records is ``pools[s]``, and the fabric's all_to_all is a transpose
of the send buffer's first two axes (``fabric="dense"``), or the JAX
package's ``P - 1`` ring distance classes, one copy each
(``fabric="ring"``).  A batch runs in bulk-synchronous supersteps: every
shard's local chase (``_local_superstep``: on the card one ``pulse_chase``
launch in its superstep mode over all P pools), for a mutating iterator
every shard's commit phase (``_local_superstep_mut``: the chase in torch
ops over all P pools at once, then on the card one ``pulse_commit`` call
for all P shards), then the switch (``_route_decide``, ``_exchange``,
``_merge_pools``).  ``distributed_execute`` schedules them three ways:
dispatched (the host reads four counters per superstep to pick the next),
fused and pipelined (``_DeviceLoop``: the capacity ladder, the local-only
decision and the loop's end on the device; on the card a chunk of
supersteps replayed from one captured CUDA graph, the host reading one
small tensor a chunk).  The paper's properties hold as in the JAX package:

  * a cross-node hop never bounces through the CPU node (compare
    ``return_to_cpu=True``, the paper's PULSE-ACC ablation, Fig. 9);
  * the request and the response share one wire format, so any shard can
    continue any traversal it receives;
  * the switch knows only ``bounds``; translation and protection happen at
    the owning shard;
  * a staged write rides the fabric to the shard that owns its commit
    target (an ALLOC to its home shard), where it serializes.

Record wire format (R = 6 + S [+ 4 + W] int32 words):
  [id, home_shard, cur_ptr, status, iters, hops, scratch_pad...,
   m_op, m_tgt, m_mask, m_expect, m_data...]
The mutation payload exists only for mutating iterators.

Fault injection and replication (item 6(d)) as in the JAX package:
fabric loss parks a record under a seeded mask (``_drop_mask``, the JAX
package's threefry bits, ``core.prng``) and sends it again next superstep,
on every schedule; a straggler shard sleeps on the dispatched schedule in
the supersteps it serves; a ``ReplicaContext`` (read path, dispatched
schedule) redirects reads bound for a dead (or spread-balanced) primary to
the shard holding its replica, which chases them from its replica rows
(on the card in the same ``pulse_chase`` launch, its replica window).

Memory nodes as processes (item 6(e)): on a ``ProcessGroupMesh`` each
process of a ``torch.distributed`` process group is one memory node, the
counterpart of a ``shard_map`` over a named axis.  ``distributed_execute``
then runs SPMD on the dispatched schedule: a rank holds only its own rows
and pool (``_resident_shard``, the JAX package's ``_resident_arena`` for
one shard), its superstep is the JAX package's per-shard body, the
exchange one ``all_to_all_single`` (dense) or ``P - 1`` of them (the ring's
distance classes), the four counters one all-reduce, and the final pools
one all-gather.

Replication, a targeted kill and the straggler run on a process group as
on the emulated mesh (``_process_group_execute``); a served group's rank 0
announces every call to the other ranks of the world
(``ProcessGroupMesh.leader``), and a live reshard moves the service from
the world's first P ranks to its first 2P (or back; ``drop_resident``
releases the old mesh's rows).

Ported: items 6(a)-(e) of ROADMAP queue 1, 6(e) on the dispatched schedule.
On an ``EmulatedMesh`` the JAX package's resident-arena cache has no
counterpart: on one card the arena already lives on the mesh's device, and
a read runner captures its tensors.
"""
from __future__ import annotations

import dataclasses
import time
import weakref

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import prng, translation
from repro_torch.core.arena import (
    H_COMMITS,
    H_EPOCH,
    M_ALLOC,
    M_NONE,
    NULL,
    PERM_READ,
    Arena,
    mut_width,
)
from repro_torch.core.iterator import (
    STATUS_ACTIVE,
    STATUS_EMPTY,
    STATUS_FAULT,
    STATUS_MAXED,
    PulseIterator,
    mut_step_batch,
    step_batch,
)
from repro_torch.distributed.world import (
    LAUNCHER_ENV,
    all_gather,
    all_reduce_sum,
    join_from_env,
    on_host,
)

# request record words: [id, home shard, ptr, status, iters, hops,
# scratch (S), mutation payload (mut_width(W), write path only)]
F_ID, F_HOME, F_PTR, F_STATUS, F_ITERS, F_HOPS, F_SCRATCH = 0, 1, 2, 3, 4, 5, 6


def record_width(scratch_words: int, mut_words: int = 0) -> int:
    return F_SCRATCH + scratch_words + mut_words


def _check_fabric(fabric: str) -> None:
    if fabric not in ("dense", "ring"):
        raise ValueError(f"unknown fabric {fabric!r}")


@dataclasses.dataclass(frozen=True)
class EmulatedMesh:
    """P memory nodes emulated on one device: the stand-in for
    ``jax.make_mesh((P,), (axis_name,))``.  Every per-shard array carries a
    leading ``(P, ...)`` axis on ``device``; ``axis_name`` names that axis,
    and ``distributed_execute`` refuses any other name, as ``shard_map``
    refuses an axis its mesh lacks."""

    num_shards: int
    device: str | torch.device = "cuda"
    axis_name: str = "mem"

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError(f"a mesh needs at least one shard, got {self.num_shards}")


@dataclasses.dataclass
class FabricStats:
    """The process-group fabric's collectives (``ProcessGroupMesh``'s
    exchanges, counter all-reduces and final gathers) and the host seconds
    they took, each timed from a synchronised device to its result back on
    the device (the staging through the host included)."""

    collectives: int = 0
    seconds: float = 0.0

    def reset(self) -> None:
        self.collectives = 0
        self.seconds = 0.0


FABRIC_STATS = FabricStats()


@dataclasses.dataclass(frozen=True)
class ProcessGroupMesh:
    """P memory nodes as the P processes of a ``torch.distributed`` process
    group: the counterpart of ``jax.make_mesh((P,), (axis_name,))`` with the
    superstep a ``shard_map`` body.  Each process is one memory node: its
    shard is its rank in ``group`` (None: the default group, the world),
    it holds its own arena rows and pool on ``device``, and every
    ``distributed_execute`` call runs SPMD, every rank with the same
    arguments.  The records cross the group's collectives; on a Gloo group
    CUDA tensors go through host copies (Gloo's transport is the host's).

    ``leader`` is set on rank 0 of a served group (``PulseService`` makes
    it, ``serving.memory_node.lead``): every ``distributed_execute`` on the
    mesh first sends its arguments to the other ranks, which run
    ``serving.memory_node.follow`` instead of calling it themselves.

    ``group`` may leave ranks of the world out (``distributed.world.
    first_ranks``): on a rank outside it ``rank`` and ``num_shards`` are -1,
    and the rank joins none of the mesh's calls."""

    group: object = None
    device: str | torch.device = "cuda"
    axis_name: str = "mem"
    # a served process group's rank 0 (``serving.memory_node.Leader``):
    # announces every call to the ranks that follow it
    leader: object = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if not dist.is_initialized():
            raise ValueError("a ProcessGroupMesh needs torch.distributed initialised first "
                             "(ProcessGroupMesh.from_env, or init_process_group)")

    @classmethod
    def from_env(cls, backend: str = "gloo", *, device="cuda", axis_name: str = "mem"):
        """The mesh of this process under ``torchrun`` (or any launcher that
        sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``):
        joins the world's process group with ``backend`` unless this
        process already has."""
        if not join_from_env(backend):
            raise ValueError(f"no process group, and none of {LAUNCHER_ENV} is set")
        return cls(None, device, axis_name)

    @property
    def num_shards(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    def _timed(self, fn, t: torch.Tensor):
        """``fn(t)`` under the span ``routing.fabric``, counted in
        ``FABRIC_STATS`` from a synchronised device on."""
        with torch.profiler.record_function("routing.fabric"):
            if t.is_cuda:
                torch.cuda.current_stream(t.device).synchronize()
            t0 = time.perf_counter()
            out = fn(t)
            FABRIC_STATS.collectives += 1
            FABRIC_STATS.seconds += time.perf_counter() - t0
        return out

    def exchange(self, send: torch.Tensor, *, fabric: str = "dense") -> torch.Tensor:
        """Carry this memory node's send buffer ``(1, P, Cp, R)``
        (destination, slot) across the group: arrivals ``(1, P * Cp, R)``
        ordered by source shard, the layout of ``_exchange``'s transpose.
        ``"dense"`` is one ``all_to_all_single``; ``"ring"`` is the JAX
        package's ``P - 1`` ppermute distance classes, class ``h`` one
        ``all_to_all_single`` whose only non-empty split goes to ``(r + h)
        % P`` and comes from ``(r - h) % P`` (this shard's own block stays
        EMPTY, as the switch leaves it)."""
        _check_fabric(fabric)
        _, P, Cp, R = send.shape
        r, group = self.rank, self.group

        def carry(blocks):
            blocks = blocks.reshape(P * Cp, R)
            blocks = (blocks.cpu() if on_host(blocks, group) else blocks).contiguous()
            if fabric == "dense":
                out = torch.empty_like(blocks)
                dist.all_to_all_single(out, blocks, group=group)
                return out.to(send.device)
            out = empty_records(P * Cp, R - F_SCRATCH, blocks.device).reshape(P, Cp, R)
            for h in range(1, P):
                to, frm = (r + h) % P, (r - h) % P
                got = torch.empty((Cp, R), dtype=blocks.dtype, device=blocks.device)
                dist.all_to_all_single(
                    got, blocks[to * Cp:(to + 1) * Cp],
                    output_split_sizes=[Cp if j == frm else 0 for j in range(P)],
                    input_split_sizes=[Cp if j == to else 0 for j in range(P)], group=group)
                out[frm] = got
            return out.reshape(P * Cp, R).to(send.device)

        return self._timed(carry, send[0]).reshape(1, P * Cp, R)

    def all_reduce(self, counts: torch.Tensor) -> list:
        """The superstep's counters summed over the group in one all-reduce
        of a stacked int64 tensor; read on the host (the superstep's one
        host read)."""
        return self._timed(
            lambda t: all_reduce_sum(t.to(torch.int64), self.group).tolist(), counts)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t``, stacked in rank order ``(P, *t.shape)``, on
        ``t``'s device."""
        return self._timed(lambda x: torch.stack(all_gather(x, self.group)), t)


@dataclasses.dataclass(frozen=True)
class ReplicaPlan:
    """Static hot-shard replication wiring (R = 2) for the READ path.

    ``primary_map[r]`` names the primary shard whose rows replica holder
    ``r`` mirrors (-1: r holds no replica); ``replica_map[p]`` is the
    inverse (-1: p is unreplicated).  Both are tuples, so a plan is
    hashable.

    ``policy`` is the read fan-out rule the switch applies per record:

      * ``"primary"``: never redirect (replicas are cold standbys);
      * ``"failover"``: redirect a read to the replica only while the
        primary is marked dead in ``dead_mask``;
      * ``"spread"``: odd request ids read from the replica, even ids from
        the primary (dead primaries always redirect).  Replicas are
        bit-identical by construction, so the copy that serves a read never
        changes its result.
    """

    primary_map: tuple
    replica_map: tuple
    policy: str = "failover"

    def __post_init__(self):
        if self.policy not in ("primary", "failover", "spread"):
            raise ValueError(f"unknown replica policy {self.policy!r}")
        if len(self.primary_map) != len(self.replica_map):
            raise ValueError("primary_map / replica_map length mismatch")

    @property
    def num_shards(self) -> int:
        return len(self.primary_map)

    @property
    def replicated(self) -> tuple:
        """Primaries that have a replica."""
        return tuple(p for p, r in enumerate(self.replica_map) if r >= 0)


def make_replica_plan(num_shards: int, primaries=None, *, policy: str = "failover") -> ReplicaPlan:
    """An R = 2 plan: primary ``p``'s rows are mirrored on shard ``(p +
    num_shards // 2) % num_shards`` (the antipode: a correlated failure of
    neighbours never takes both copies).  ``primaries`` defaults to every
    shard; each holder mirrors at most one primary."""
    if primaries is None:
        primaries = range(num_shards)
    primary_map = [-1] * num_shards
    replica_map = [-1] * num_shards
    for p in primaries:
        r = (p + max(1, num_shards // 2)) % num_shards
        if primary_map[r] != -1:
            raise ValueError(f"replica holder {r} already mirrors shard {primary_map[r]}")
        primary_map[r] = int(p)
        replica_map[p] = int(r)
    return ReplicaPlan(tuple(primary_map), tuple(replica_map), policy)


@dataclasses.dataclass
class ReplicaContext:
    """Per-call replication operands of ``distributed_execute``.

    ``rep_rows`` has the arena's layout ``(capacity, node_words)``: holder
    ``r``'s rows ``[bounds[r], bounds[r + 1])`` are a copy of
    ``primary_map[r]``'s rows (zeros when r holds none), so each shard
    stores at most one other shard's rows, the R = 2 memory budget.
    ``dead_mask`` ``(P,)`` is the failure detector's verdict for this call.
    Either may be a numpy array or a tensor; both go to the arena's device
    as operands, so one build of a superstep serves healthy and degraded
    rounds."""

    plan: ReplicaPlan
    rep_rows: object  # (capacity, node_words) int32
    dead_mask: object  # (P,) bool


def _rep_operands(replication: ReplicaContext, data: torch.Tensor, P: int, rows=None):
    """``(rep, rep_ctx)`` of a call over the arena rows ``data`` of ``P``
    shards, on their device: ``rep = (rep_rows, primary_map, dead_mask,
    policy)`` for the local chase and ``rep_ctx = (replica_map, dead_mask,
    policy)`` for the switch.  ``rows`` (a memory node of a
    ``ProcessGroupMesh``: its holder slice, ``data`` its own rows) are the
    replica rows already on the device."""
    dev, plan = data.device, replication.plan
    if rows is None:
        rows = torch.as_tensor(replication.rep_rows, dtype=torch.int32).to(dev).contiguous()
    dead = torch.as_tensor(replication.dead_mask, dtype=torch.bool).to(dev).contiguous()
    if plan.num_shards != P or tuple(dead.shape) != (P,):
        raise ValueError(f"a replica plan of {plan.num_shards} shards and a dead mask of "
                         f"shape {tuple(dead.shape)} for an arena of {P} shards")
    if rows.shape != data.shape:
        raise ValueError(f"replica rows {tuple(rows.shape)} do not have the layout of the "
                         f"rows they mirror {tuple(data.shape)}")
    i32 = dict(dtype=torch.int32, device=dev)
    primary = torch.tensor(plan.primary_map, **i32)
    replica = torch.tensor(plan.replica_map, **i32)
    return (rows, primary, dead, plan.policy), (replica, dead, plan.policy)


def _serve_shard(owner, rec_id, rep_ctx):
    """The switch's serve map: which shard answers a read at ``owner``'s
    range under the fan-out policy, elementwise.  Identity when
    replication is off."""
    if rep_ctx is None:
        return owner
    replica_arr, dead_mask, policy = rep_ctx
    num = replica_arr.shape[0]
    safe = owner.clamp(0, num - 1).long()
    alt = replica_arr[safe]
    # a dead replica holder is no fallback: its copy died with it
    has_alt = (alt >= 0) & (owner >= 0) & ~dead_mask[alt.clamp(0, num - 1).long()]
    dead = dead_mask[safe]
    if policy == "spread":
        redirect = has_alt & (dead | (rec_id % 2 == 1))
    elif policy == "failover":
        redirect = has_alt & dead
    else:  # "primary"
        redirect = torch.zeros_like(has_alt)
    return torch.where(redirect, alt, owner).to(torch.int32)


def replica_windows(rep, bounds, perms):
    """Each shard's replica window under ``rep = (rep_rows, primary_map,
    dead_mask, policy)``, as ``(P,)`` tensors ``(own_hi, rep_lo, rep_hi,
    rep_on, rep_perm_ok)``: shard ``s`` serves ``p = primary_map[s]``'s
    range ``[rep_lo, rep_hi)`` while ``rep_on`` (always under ``"spread"``,
    only while ``p`` is dead under the other policies, never while ``s`` is
    dead) under ``p``'s read grant ``rep_perm_ok``; a dead shard's own range
    ``[bounds[s], own_hi)`` is empty.  The plain versions of the superstep
    (``_local_superstep``'s reference backend, ``chase_superstep_reference``)
    read it; the kernel stages the same words in shared memory."""
    _, primary, dead, policy = rep
    ps = primary.clamp(0, primary.shape[0] - 1).long()
    on = (primary >= 0) & ~dead
    if policy != "spread":
        on = on & dead[ps]
    probe = translation.access_table(perms, PERM_READ)
    own_hi = torch.where(dead, bounds[:-1], bounds[1:])
    return own_hi, bounds[ps], bounds[ps + 1], on, probe[ps]


def pack_requests(ids, home, ptr, scratch, mut_words: int = 0) -> torch.Tensor:
    """``(B, R)`` ACTIVE request records on ``ptr``'s device, with an empty
    mutation payload of ``mut_words`` words (a mutating iterator's)."""
    B, S = scratch.shape
    rec = torch.zeros((B, record_width(S, mut_words)), dtype=torch.int32, device=ptr.device)
    rec[:, F_ID] = ids
    rec[:, F_HOME] = home
    rec[:, F_PTR] = ptr
    rec[:, F_STATUS] = STATUS_ACTIVE
    rec[:, F_SCRATCH : F_SCRATCH + S] = scratch
    return rec


def empty_records(n: int, scratch_words: int, device="cpu") -> torch.Tensor:
    """``(n, record_width(scratch_words))`` EMPTY records; a mutating
    iterator's pass ``S + mut_width(W)`` words."""
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


# ----------------------------- the capacity ladder ----------------------------


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def _pow2_at_least_traced(n: torch.Tensor) -> torch.Tensor:
    """Device twin of ``_pow2_at_least``, elementwise on int32: the exact
    bit length of ``n - 1`` counted against ``1 << i`` (no float log2,
    whose rounding at exact powers of two would put the device ladder a
    rung off the host's).  Equal to the host's for every ``n`` in ``[1,
    2**30]``; at 0 it gives 1 (the host 2), a count the ladder never sees
    while a superstep is live."""
    n = n.to(torch.int32)
    powers = torch.ones(31, dtype=torch.int32, device=n.device) << torch.arange(
        31, dtype=torch.int32, device=n.device)
    bl = ((n - 1)[..., None] >= powers).sum(-1, dtype=torch.int32)
    return torch.ones_like(bl) << bl


def _ladder(n_active: int, n_remote: int, *, num_shards: int, base_capacity: int,
            min_link_capacity: int, compact: bool):
    """The dispatched schedule's capacity ladder on the host: ``(capacity,
    do_route)`` for the next superstep from the last one's counts."""
    if not compact:
        return base_capacity, True
    demand = (n_active + num_shards - 1) // num_shards
    return min(base_capacity, max(min_link_capacity, _pow2_at_least(demand))), n_remote > 0


def _ladder_traced(n_active, n_remote, *, num_shards: int, base_capacity: int,
                   min_link_capacity: int, compact: bool):
    """``_ladder`` on device int32 counts (the ONE definition of the rung
    that the device-resident schedules share with the host loop, or their
    wire accounting and pool layouts desync): ``(capacity, do_route)``,
    an int32 and a bool device scalar."""
    dev = n_active.device
    if not compact:
        return (torch.full((), base_capacity, dtype=torch.int32, device=dev),
                torch.ones((), dtype=torch.bool, device=dev))
    demand = (n_active + (num_shards - 1)) // num_shards
    capacity = torch.clamp(_pow2_at_least_traced(demand), min=min_link_capacity)
    return torch.clamp(capacity, max=base_capacity).to(torch.int32), n_remote > 0


def capacity_rungs(base_capacity: int, min_link_capacity: int) -> tuple:
    """The distinct values the compacted capacity ladder can take: powers of
    two clamped to ``[min_link_capacity, base_capacity]``, at most 31."""
    return tuple(sorted({
        min(base_capacity, max(min_link_capacity, 1 << i)) for i in range(31)}))


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
    max_iters: int | torch.Tensor,
    backend: str = "kernel",
    elide_access_check: bool = False,
    edges=None,
    rep=None,
    shard0: int = 0,
    row0: int = 0,
):
    """Run up to ``k_local`` iterations for every shard's locally-owned
    ACTIVE records; returns the new pools.

    ``shard0`` and ``row0`` (a memory node of a ``ProcessGroupMesh``): the
    pools are those of shards ``shard0 ..`` and ``arena_data`` holds the
    rows from global row ``row0`` on; ``bounds`` and ``perms`` stay the
    whole mesh's.

    ``backend="kernel"`` is one ``pulse_chase`` launch in its superstep mode
    over all P pools on a CUDA arena (its plain version on a CPU arena).
    ``backend="reference"`` is the plain chase: ``k_local`` calls of
    ``iterator.step_batch`` per shard over that shard's rows.  Both give the
    same pools bit for bit.

    ``elide_access_check=True`` replaces the per-shard PERM_READ probe with
    constant True; ``distributed_execute`` sets it only when the iterator's
    pulse-verify certificate proves it read-only and every shard grants
    PERM_READ, so eliding is bit-identical.

    ``edges`` (the reference backend) is ``bounds`` read on the host ahead
    of time, so that a captured superstep reads nothing on the host.

    ``max_iters`` is an int, or a 0-d int32 tensor on the arena's device
    (the device-resident loops: a captured chunk reads the call's budget
    from it, so one capture serves every budget).

    ``rep = (rep_rows, primary_map, dead_mask, policy)`` (device tensors and
    the ``ReplicaPlan`` policy) adds each holder's replica window: shard
    ``s`` also chases records whose pointer lies in ``primary_map[s]``'s
    range (always under ``"spread"``, only while that primary is dead
    under the other policies, never while ``s`` is dead), reading
    ``rep_rows`` under the primary's read grant; a dead shard's own range
    collapses to nothing.  The access check is never elided on that
    window.
    """
    if backend == "kernel":
        from repro_torch.kernels.pulse_chase import ops as chase_ops

        return chase_ops.pulse_chase_superstep(
            arena_data, pools, bounds, perms, logic_fn=chase_ops.iterator_logic(it),
            k_local=k_local, max_iters=max_iters, elide_access_check=elide_access_check,
            rep=rep, shard0=shard0, row0=row0)
    if backend != "reference":
        raise ValueError(f"unknown local backend {backend!r}")
    S = it.scratch_words
    if edges is None:
        edges = bounds.tolist()
    probe = translation.access_table(perms, PERM_READ)
    granted = torch.ones_like(probe) if elide_access_check else probe
    windows = replica_windows(rep, bounds, perms) if rep is not None else None
    out = pools.clone()
    for i, pool in enumerate(out):
        s = shard0 + i
        lo, hi = int(edges[s]), int(edges[s + 1])
        kw = dict(local_hi=hi)
        if rep is not None:
            own_hi, rep_lo, rep_hi, rep_on, rep_ok = (w[s] for w in windows)
            kw = dict(local_hi=own_hi, rep_data=rep[0], rep_lo=rep_lo, rep_hi=rep_hi,
                      rep_base=lo - row0, rep_on=rep_on, rep_perm_ok=rep_ok)
        st = (pool[:, F_PTR], pool[:, F_SCRATCH : F_SCRATCH + S], pool[:, F_STATUS],
              pool[:, F_ITERS])
        for _ in range(k_local):
            st = step_batch(it, arena_data[lo - row0:hi - row0], *st, max_iters=max_iters,
                            local_lo=lo, perm_ok=granted[s], **kw)
        pool[:, F_PTR], pool[:, F_SCRATCH : F_SCRATCH + S] = st[0], st[1]
        pool[:, F_STATUS], pool[:, F_ITERS] = st[2], st[3]
    return out


def _local_superstep_mut(
    it: PulseIterator,
    pools: torch.Tensor,  # (P, L, R) every shard's pool, with the mutation payload
    data: torch.Tensor,  # (cap, W) the whole arena: carried state, updated in place
    heap: torch.Tensor,  # (P, HEAP_WORDS) the allocator registers, updated in place
    bounds: torch.Tensor,
    perms: torch.Tensor,
    *,
    k_local: int,
    max_iters: int | torch.Tensor,
    commit: bool = True,
    live: torch.Tensor | None = None,
    shard0: int = 0,
    row0: int = 0,
):
    """Write-path twin of ``_local_superstep``: every shard's chase with
    write-stalls, then every shard's commit phase (``shard0`` and ``row0``
    as there; ``heap`` then holds the pools' shards' rows).

    The chase is ``k_local`` calls of ``iterator.mut_step_batch`` over all
    P pools at once, on the whole arena, each record bounded by its shard's
    rows and read grant: the host issues ``k_local`` steps a superstep
    whatever P is.  It runs in torch ops (``pulse_chase`` is read-only, as
    in the JAX package).  Then the exhausted-budget sweep: a record left
    ACTIVE at ``iters >= max_iters`` with nothing staged retires MAXED
    (a no-op after a fixed ``k_local`` chase; the adaptive chase of item
    6(c) relies on it).  The commit is ``kernels.pulse_commit``: one call
    for all P shards, its kernels on the card, their stages in torch ops on
    the CPU, in place on ``data`` and ``heap``.  Under ``torch.profiler`` the two show as the
    spans ``routing.chase`` and ``routing.commit``.

    ``commit=False`` runs the chase alone and returns the pools (the
    pipelined schedule chases its two wavefronts apart, then commits the
    merged pool: the commit's order never depends on the pool's layout).
    ``live`` (a device bool, the device-resident loops) gates the commit
    (``_commit``).

    Returns ``(pools, data, heap)``.
    """
    P, L, R = pools.shape
    S = it.scratch_words
    MB = F_SCRATCH + S
    with torch.profiler.record_function("routing.chase"):
        flat = pools.reshape(P * L, R)
        lo = bounds[shard0 : shard0 + P, None].expand(P, L).reshape(-1)
        hi = bounds[shard0 + 1 : shard0 + P + 1, None].expand(P, L).reshape(-1)
        granted = translation.access_table(perms, PERM_READ)[shard0 : shard0 + P, None]
        granted = granted.expand(P, L).reshape(-1)
        st = (flat[:, F_PTR], flat[:, F_SCRATCH:MB], flat[:, F_STATUS], flat[:, F_ITERS],
              flat[:, MB:])
        for _ in range(k_local):
            st = mut_step_batch(it, data, *st, max_iters=max_iters, local_lo=lo, local_hi=hi,
                                perm_ok=granted, row0=row0)
        ptr, scr, status, iters, mut = st
        status = torch.where(
            (status == STATUS_ACTIVE) & (iters >= max_iters) & (mut[:, 0] == M_NONE),
            STATUS_MAXED, status).to(torch.int32)
        pools = torch.cat([flat[:, :F_PTR], ptr[:, None], status[:, None], iters[:, None],
                           flat[:, F_HOPS:F_SCRATCH], scr, mut], 1).reshape(P, L, R)
    if not commit:
        return pools
    return _commit(pools, data, heap, bounds, perms, scratch_words=S, live=live, shard0=shard0,
                   row0=row0)


def _shard_keys(drop_seed: int, shards: torch.Tensor) -> torch.Tensor:
    """The loss mask's per-shard keys, ``fold_in(PRNGKey(drop_seed),
    shard)``: ``(..., 2)`` for ``shards`` of shape ``(...)``."""
    return prng.fold_in(prng.prng_key(drop_seed, shards.device), shards)


def _loss_mask(keys: torch.Tensor, L: int, drop_prob: float, step_idx) -> torch.Tensor:
    """``(..., L)`` bool: the pool slots lost this superstep, from the
    per-shard ``keys`` and ``step_idx`` (an int or a device scalar, the
    supersteps completed).  Only device ops: a device-resident loop keys it
    on its device counter inside a captured graph."""
    threshold = torch.tensor(drop_prob, dtype=torch.float32).item()  # compared in float32
    return prng.uniform(prng.fold_in(keys, step_idx), L) < threshold


def _drop_mask(L: int, drop_prob: float, drop_seed: int, my_shard, step_idx) -> torch.Tensor:
    """Fault-injection fabric loss: each pool slot is independently lost
    with probability ``drop_prob`` this superstep, the JAX package's
    ``_drop_mask`` bit for bit (``jax.random.uniform`` under
    ``fold_in(fold_in(PRNGKey(drop_seed), my_shard), step_idx)``).
    ``my_shard`` may be a tensor of shard ids: the mask is then ``(...,
    L)``, one row per shard.  A pure function of (seed, shard, superstep),
    so a lossy run replays bit for bit.  A dropped record parks on its
    source shard and is sent again next superstep."""
    shards = torch.as_tensor(my_shard, dtype=torch.int64)
    return _loss_mask(_shard_keys(drop_seed, shards), L, drop_prob, step_idx)


def _route_decide(
    pools: torch.Tensor,  # (P, L, R)
    bounds: torch.Tensor,
    num_shards: int,
    *,
    return_to_cpu: bool,
    link_capacity: int | torch.Tensor | None = None,
    phys_capacity: int | None = None,
    drain_done: bool = False,
    mut_base: int | None = None,
    drop_mask: torch.Tensor | None = None,
    rep_ctx=None,
    shard0: int = 0,
):
    """Switch decision and leaver extraction for every shard at once
    (``pools`` those of shards ``shard0 ..`` of ``num_shards``: a memory
    node of a ``ProcessGroupMesh`` decides for its own pool alone).

    Computes each record's next shard, marks switch-level faults (an ACTIVE
    record whose pointer no shard owns), packs the records that fit under
    the per-link capacity C into a ``(P, num_shards, Cp, R)`` send buffer
    (source, destination, slot) and strips them from their pools.  A destination
    takes its movers in pool order; the overflow parks in place for the
    next superstep (the JAX package's trash row).  Returns
    ``(kept, send, n_routed)``, ``n_routed`` a device scalar.

    ``phys_capacity`` Cp is the buffer's rows per link, a Python int;
    ``link_capacity`` C only gates which records fit and may be a device
    scalar (the device-resident loops carry the capacity rung as state).
    The parking is then that of a superstep with a buffer of C rows, so
    the pools equal the dispatched schedule's at C bit for bit.  Either
    defaults to the other, and both to ``L // P``.

    ``drain_done`` (compaction): finished records retire in place instead
    of being shipped home.  ``return_to_cpu`` (PULSE-ACC, Fig. 9): a
    traversal leaving a node returns to its home node, which re-issues it.
    ``mut_base`` (the write path) is the column where the mutation payload
    starts: a record with a staged mutation routes to the shard that owns
    its commit target (an ALLOC to its home shard), and an unmappable
    commit target is a switch-level fault that clears the payload.

    ``drop_mask`` ``(P, L)`` (fault injection): a lost record parks in
    place like capacity overflow and is sent again next superstep; its
    hops do not advance.  ``rep_ctx = (replica_map, dead_mask, policy)``
    applies the replica serve map (``_serve_shard``) to ACTIVE reads; a
    fault is still judged on the raw owner.
    """
    P, L, R = pools.shape
    dev = pools.device
    if phys_capacity is None:
        phys_capacity = L // num_shards if link_capacity is None else int(link_capacity)
    Cp = int(phys_capacity)
    C = Cp if link_capacity is None else link_capacity
    src = torch.arange(P, device=dev)[:, None]  # a pool's index in the send buffer
    me = (shard0 + src).to(torch.int32)
    status = pools[..., F_STATUS]
    valid = status != STATUS_EMPTY
    active = status == STATUS_ACTIVE
    pools = pools.clone()

    owner = translation.owner_of(bounds, pools[..., F_PTR].contiguous())
    if mut_base is None:
        bad = active & (owner == NULL)  # the switch notifies the CPU node (Fig. 6 step 6)
    else:
        # a write-pending record is judged on its commit target instead
        m_op = pools[..., mut_base]
        pendm = m_op != M_NONE
        is_alloc = m_op == M_ALLOC
        towner = translation.owner_of(bounds, pools[..., mut_base + 1].contiguous())
        bad_mut = active & pendm & ~is_alloc & (towner == NULL)
        bad = (active & (owner == NULL) & ~pendm) | bad_mut
        pools[..., mut_base] = torch.where(bad_mut, M_NONE, m_op).to(torch.int32)
        pendm = pendm & ~bad_mut
    status = torch.where(bad, STATUS_FAULT, status).to(torch.int32)
    pools[..., F_STATUS] = status
    active = status == STATUS_ACTIVE
    home = pools[..., F_HOME]

    serve = _serve_shard(owner, pools[..., F_ID], rep_ctx)
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
    if mut_base is not None:
        # staged mutations route to their commit shard (ALLOC -> home)
        dest = torch.where(active & pendm, torch.where(is_alloc, home, towner), dest)
    dest = torch.where(valid, dest, me).to(torch.int32)
    moves = valid & (dest != me)

    # slot of each mover among its destination's movers, in pool order: a
    # (source, destination, record) one-hot scanned along its last axis
    dests = torch.arange(num_shards, dtype=torch.int32, device=dev)[None, :, None]
    onehot = ((dest[:, None, :] == dests) & moves[:, None, :]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=2, dtype=torch.int32) - onehot
    pos = torch.gather(pos, 1, dest.clamp(0, num_shards - 1).long()[:, None, :])[:, 0]
    fits = moves & (pos < C)
    if drop_mask is not None:
        fits = fits & ~drop_mask
    pools[..., F_HOPS] += fits.to(torch.int32)

    # every record has a row of its own: a mover its (source, destination,
    # slot), anything else one past the buffer, dropped after the copy
    row = (src * num_shards + dest.long()) * Cp + pos.long()
    n_send = P * num_shards * Cp
    spare = n_send + torch.arange(P * L, device=dev).reshape(P, L)
    send = empty_records(n_send + P * L, R - F_SCRATCH, dev)
    send.index_copy_(0, torch.where(fits, row, spare).reshape(-1), pools.reshape(P * L, R))
    send = send[:n_send].reshape(P, num_shards, Cp, R)

    kept = pools
    kept[..., F_STATUS] = torch.where(fits, STATUS_EMPTY, pools[..., F_STATUS]).to(torch.int32)
    return kept, send, fits.sum()


def _exchange(send: torch.Tensor, num_shards: int, *, fabric: str = "dense", mesh=None):
    """Carry the send buffer ``(P, P, Cp, R)`` (source, destination, slot)
    across the fabric: arrivals ``(P, P * Cp, R)``, each destination's
    ordered by source shard (the dense all_to_all layout).  On a
    ``ProcessGroupMesh`` the buffer is this memory node's ``(1, P, Cp,
    R)`` and the fabric its process group's (``ProcessGroupMesh.exchange``).

    ``fabric="dense"`` is the switch's one all_to_all: on one device a
    transpose of the buffer's source and destination axes.
    ``fabric="ring"`` is the JAX package's ``P - 1`` ppermute distance
    classes: class ``h`` carries each shard ``s``'s block for ``(s + h) %
    P`` forward ``h`` shards, one copy a class here, into the arrivals'
    dense layout; a shard's own block stays EMPTY, as the switch leaves it
    (no record moves to its own shard), so both fabrics give the same
    arrivals bit for bit."""
    _check_fabric(fabric)
    if isinstance(mesh, ProcessGroupMesh):
        return mesh.exchange(send, fabric=fabric)
    P, _, Cp, R = send.shape
    if fabric == "dense":
        return send.transpose(0, 1).reshape(num_shards, P * Cp, R)
    arrivals = empty_records(P * P * Cp, R - F_SCRATCH, send.device).reshape(P, P, Cp, R)
    src = torch.arange(P, device=send.device)
    for h in range(1, P):
        dst = (src + h) % P
        arrivals[dst, src] = send[src, dst]
    return arrivals.reshape(num_shards, P * Cp, R)


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
    link_capacity: int | torch.Tensor | None = None,
    phys_capacity: int | None = None,
    drain_done: bool = False,
    fabric: str = "dense",
    mut_base: int | None = None,
    drop_mask: torch.Tensor | None = None,
    rep_ctx=None,
    shard0: int = 0,
    mesh=None,
):
    """Switch routing: deliver every record to its next shard in one
    superstep (``_route_decide``'s capacities, loss and serve map; the
    exchange over ``mesh``'s process group when it is a
    ``ProcessGroupMesh``).  Returns ``(pools, n_routed, n_dropped_valid)``."""
    L = pools.shape[1]
    kept, send, n_routed = _route_decide(
        pools, bounds, num_shards, return_to_cpu=return_to_cpu,
        link_capacity=link_capacity, phys_capacity=phys_capacity, drain_done=drain_done,
        mut_base=mut_base, drop_mask=drop_mask, rep_ctx=rep_ctx, shard0=shard0)
    arrivals = _exchange(send, num_shards, fabric=fabric, mesh=mesh)
    merged, n_dropped = _merge_pools(kept, arrivals, L)
    return merged, n_routed, n_dropped


def _remote_active(pools, bounds, mut_base: int | None = None, rep_ctx=None, shard0: int = 0):
    """ACTIVE records their shard cannot serve (owner elsewhere or none),
    summed over shards.  A write-pending record's destination is its commit
    shard (an ALLOC's is its home), so a staged remote write keeps the
    fabric scheduled even when every pointer is local.  Under replication
    the serve map decides remoteness."""
    P = pools.shape[0]
    me = shard0 + torch.arange(P, dtype=torch.int32, device=pools.device)[:, None]
    active = pools[..., F_STATUS] == STATUS_ACTIVE
    owner = translation.owner_of(bounds, pools[..., F_PTR].contiguous())
    if mut_base is None:
        owner = _serve_shard(owner, pools[..., F_ID], rep_ctx)
    else:
        m_op = pools[..., mut_base]
        towner = torch.where(
            m_op == M_ALLOC, pools[..., F_HOME],
            translation.owner_of(bounds, pools[..., mut_base + 1].contiguous()))
        owner = torch.where(m_op != M_NONE, towner, owner)
    return (active & (owner != me)).sum()


def _switch(pools, bounds, *, return_to_cpu, link_capacity, drain_done, do_route,
            mut_base, phys_capacity=None, fabric="dense", drop_mask=None, rep_ctx=None,
            shard0=0, mesh=None):
    """The switch half of a superstep and its counters, under the profiler
    span ``routing.switch``: ``(pools, n_active, n_routed, n_drop,
    n_remote)``, the counters device scalars (on a ``ProcessGroupMesh``
    this memory node's own, summed by the caller)."""
    with torch.profiler.record_function("routing.switch"):
        if do_route:
            pools, n_routed, n_drop = _route(
                pools, bounds, bounds.shape[0] - 1, return_to_cpu=return_to_cpu,
                link_capacity=link_capacity, phys_capacity=phys_capacity,
                drain_done=drain_done, fabric=fabric, mut_base=mut_base,
                drop_mask=drop_mask, rep_ctx=rep_ctx, shard0=shard0, mesh=mesh)
        else:
            n_routed = n_drop = torch.zeros((), dtype=torch.int64, device=pools.device)
        n_active = (pools[..., F_STATUS] == STATUS_ACTIVE).sum()
        n_remote = _remote_active(pools, bounds, mut_base, rep_ctx, shard0=shard0)
    return pools, n_active, n_routed, n_drop, n_remote


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
    fabric: str = "dense",
    rep=None,
    rep_ctx=None,
    drop_mask: torch.Tensor | None = None,
    shard0: int = 0,
    row0: int = 0,
    mesh=None,
):
    """One read superstep over all P shards: the local chase, then the
    switch (over ``fabric``).  Returns ``(pools, n_active, n_routed,
    n_drop, n_remote)``, the counters device scalars summed over the
    shards.  On a ``ProcessGroupMesh`` (``mesh``) the superstep of one
    memory node: its pool (shard ``shard0``), its rows (from global row
    ``row0``), the exchange over the process group, its own counters.

    ``do_route=False`` is the compacted local-only step: every surviving
    traversal already sits at its owning shard, so the fabric is skipped
    (wire payload 0); it still counts the actives that turned remote.
    ``local_backend`` is ``_local_superstep``'s backend.  ``rep`` and
    ``rep_ctx`` (``_rep_operands``) add the replica windows and the serve
    map; ``drop_mask`` ``(P, L)`` parks the records lost on the fabric.
    Under ``torch.profiler`` the chase and the switch show as the spans
    ``routing.chase`` and ``routing.switch``.
    """
    with torch.profiler.record_function("routing.chase"):
        pools = _local_superstep(
            it, pools, arena_data, bounds, perms, k_local=k_local, max_iters=max_iters,
            backend=local_backend, elide_access_check=elide_access_check, rep=rep,
            shard0=shard0, row0=row0)
    return _switch(pools, bounds, return_to_cpu=return_to_cpu, link_capacity=link_capacity,
                   drain_done=drain_done, do_route=do_route, mut_base=None, fabric=fabric,
                   drop_mask=drop_mask, rep_ctx=rep_ctx, shard0=shard0, mesh=mesh)


def superstep_mut(
    it: PulseIterator,
    pools: torch.Tensor,
    data: torch.Tensor,
    heap: torch.Tensor,
    bounds: torch.Tensor,
    perms: torch.Tensor,
    *,
    k_local: int,
    max_iters: int,
    return_to_cpu: bool = False,
    link_capacity: int | None = None,
    drain_done: bool = False,
    do_route: bool = True,
    fabric: str = "dense",
    drop_mask: torch.Tensor | None = None,
    shard0: int = 0,
    row0: int = 0,
    mesh=None,
):
    """One write superstep over all P shards: the chase, every shard's
    commit phase, then the switch, which routes a staged write to the
    shard that owns its commit target (``drop_mask`` parks the records
    lost on the fabric; ``shard0``, ``row0`` and ``mesh`` as in
    ``superstep``, ``heap`` then the memory node's own row).  ``data`` and
    ``heap`` are carried state, updated in place.  Returns ``(pools, data, heap, n_active, n_routed, n_drop,
    n_remote)``; the spans are ``routing.chase``, ``routing.commit`` and
    ``routing.switch``."""
    pools, data, heap = _local_superstep_mut(
        it, pools, data, heap, bounds, perms, k_local=k_local, max_iters=max_iters,
        shard0=shard0, row0=row0)
    pools, *counts = _switch(
        pools, bounds, return_to_cpu=return_to_cpu, link_capacity=link_capacity,
        drain_done=drain_done, do_route=do_route, mut_base=F_SCRATCH + it.scratch_words,
        fabric=fabric, drop_mask=drop_mask, shard0=shard0, mesh=mesh)
    return pools, data, heap, *counts


def make_superstep(
    it: PulseIterator,
    num_shards: int,
    *,
    fabric: str = "dense",
    mutate: bool = False,
    drop_prob: float = 0.0,
    drop_seed: int = 0,
    replication: ReplicaPlan | None = None,
    **kw,
):
    """The JAX package's superstep builder: ``(pools, arena_data, bounds,
    perms, *extra) -> superstep(it, pools, ...)``, or with ``mutate=True``
    ``(pools, data, heap, bounds, perms, *extra) -> superstep_mut(it,
    pools, ...)``, with ``fabric`` and ``kw`` (their keywords) bound.

    ``replication`` (read path only) adds two operands after ``perms``:
    the replica rows (the arena's layout) and the dead mask ``(P,)``.
    ``drop_prob > 0`` (fault injection) adds one trailing operand, the
    superstep index, which keys the loss mask with ``drop_seed``
    (``_drop_mask``); a local-only superstep (``do_route=False``) takes
    none."""
    if replication is not None and mutate:
        raise ValueError("replication is a read-path feature (writes park)")
    _check_fabric(fabric)
    inject_drop = drop_prob > 0.0 and kw.get("do_route", True)
    body = superstep_mut if mutate else superstep
    n_fixed = 5 if mutate else 4

    def step(*args):
        fixed, extra = args[:n_fixed], list(args[n_fixed:])
        call = dict(kw, fabric=fabric)
        if replication is not None:
            rows, dead = extra[:2]
            extra = extra[2:]
            call["rep"], call["rep_ctx"] = _rep_operands(
                ReplicaContext(replication, rows, dead), fixed[1], num_shards)
        if inject_drop:
            call["drop_mask"] = _drop_mask(fixed[0].shape[1], drop_prob, drop_seed,
                                           torch.arange(num_shards, device=fixed[0].device),
                                           extra[0])
        return body(it, *fixed, **call)

    return step


# ------------------------- the device-resident loops --------------------------

CHUNK = 8  # supersteps one captured graph runs between two host reads


def _commit(pools, data, heap, bounds, perms, *, scratch_words: int, live=None, shard0=0,
            row0=0):
    """Every shard's commit phase (``kernels.pulse_commit``), in place on
    ``pools``, ``data`` and ``heap``, under the profiler span
    ``routing.commit``.  ``live`` (a device bool) gates it through its
    input: a superstep that is not live hands it only EMPTY records, so it
    applies nothing and leaves ``data`` and ``heap`` as they were."""
    from repro_torch.kernels.pulse_commit import ops as commit_ops

    if live is not None:
        pools[..., F_STATUS] = torch.where(live, pools[..., F_STATUS], STATUS_EMPTY)
    with torch.profiler.record_function("routing.commit"):
        commit_ops.pulse_commit(pools, data, heap, bounds, perms, scratch_words=scratch_words,
                                shard0=shard0, row0=row0)
    return pools, data, heap


@dataclasses.dataclass
class ExecutableCacheStats:
    """Counters of the device-resident loops' cache (the JAX package's
    ``CACHE_STATS``): ``hits`` and ``misses`` count runner lookups;
    ``traces`` counts loop bodies built, a CUDA-graph capture on the card
    and a build of the eager loop on the CPU.  The port adds
    ``host_reads``, the loops' reads of their flags (one a chunk), and
    ``capture_s``, the seconds spent warming up and capturing."""

    hits: int = 0
    misses: int = 0
    traces: int = 0
    host_reads: int = 0
    capture_s: float = 0.0

    def reset(self) -> None:
        self.hits = self.misses = self.traces = self.host_reads = 0
        self.capture_s = 0.0


CACHE_STATS = ExecutableCacheStats()
_FUSED_CACHE: dict = {}


def reset_executable_caches() -> None:
    """Drop every cached runner and its captured graph, and a memory node's
    resident rows (test isolation)."""
    _FUSED_CACHE.clear()
    _RESIDENT.clear()
    CACHE_STATS.reset()


class _DeviceLoop:
    """A whole traversal as one device-resident loop at static shapes: the
    JAX package's ``make_fused_loop`` (``schedule="fused"``) or
    ``make_pipelined_loop`` (``"pipelined"``), read or write path, one
    instance per cache key.

    The carried state lives in this object's buffers on the arena's
    device: the pools (the pipelined loop's resident wavefront), the
    in-flight send buffer and ``did_route`` (pipelined), and the int32
    counters ``n_active``, ``n_remote``, ``steps``, ``routed``,
    ``dropped``, ``local_only`` and the ``cap_counts`` histogram over
    ``capacity_rungs``.  The JAX loop's ``cond`` is the device flag
    ``live``; every superstep computes it first and writes its results
    through ``torch.where(live, new, old)``, so a superstep that is not
    live changes nothing and counts nothing.  ``lax.cond`` becomes the same
    select: both branches run and ``do_route`` (``did_route``) picks one,
    so a local-only superstep keeps its chased pools and never passes them
    through ``_merge_pools``.

    A chunk is ``CHUNK`` supersteps, then the flags (``live``, the counts
    and the histogram) in one small tensor.  On the card the first call
    warms one superstep up on a side stream (which also builds the
    kernels), puts the state back, and captures a chunk as one
    ``torch.cuda.CUDAGraph``; every call replays it and reads the flags
    once a chunk until ``live`` is false.  A failed capture or replay
    raises.  On the CPU the same chunk runs eagerly.

    A write runner owns copies of ``data``, ``heap``, ``bounds`` and
    ``perms``, loaded each call, and hands back fresh ones; a read runner
    owns copies of ``data``, ``bounds`` and ``perms``, loaded when a call
    brings an arena other than the last one (the write path swaps the
    arena after every write, and the next reads replay the same graph).
    The iteration budget and ``halt`` are device scalars loaded each call,
    so one capture serves every budget (``pulse_chase``'s superstep mode
    reads the budget from the device), as one JAX executable does.  Fabric loss
    (``drop_prob > 0``) keys its mask on the device counter ``steps``, as
    the JAX loops key it on theirs."""

    _CARRIED = ("pools", "send", "did_route", "n_active", "n_remote", "steps", "routed",
                "dropped", "cap_counts", "local_only")

    def __init__(self, it: PulseIterator, arena: Arena, *, schedule: str, pool_rows: int,
                 k_local: int, max_supersteps: int, min_link_capacity: int,
                 return_to_cpu: bool, compact: bool, fabric: str, local_backend: str,
                 elide_access_check: bool, drop_prob: float = 0.0, drop_seed: int = 0):
        P, L, dev = arena.num_shards, pool_rows, arena.data.device
        self.it, self.schedule, self.fabric = it, schedule, fabric
        self.P, self.L, self.base, self.device = P, L, L // P, dev
        self.mutate = it.mutates
        self.S = it.scratch_words
        self.R = record_width(self.S, mut_width(arena.node_words) if self.mutate else 0)
        self.mut_base = F_SCRATCH + self.S if self.mutate else None
        self.k_local, self.max_supersteps = k_local, max_supersteps
        self.min_link_capacity, self.return_to_cpu, self.compact = (
            min_link_capacity, return_to_cpu, compact)
        self.local_backend, self.elide = local_backend, elide_access_check
        self.drop_prob = drop_prob
        self.drop_keys = (_shard_keys(drop_seed, torch.arange(P, device=dev))
                          if drop_prob > 0.0 else None)
        self.rungs = capacity_rungs(self.base, min_link_capacity) if compact else (self.base,)
        self.data, self.bounds, self.perms = (torch.empty_like(arena.data),
                                              torch.empty_like(arena.bounds),
                                              torch.empty_like(arena.perms))
        self.heap = torch.empty_like(arena.heap) if self.mutate else None
        self.source = None  # a read runner: the arena its buffers hold (a weak reference)
        # the reference backend's edges are part of a read runner's key
        self.edges = (arena.bounds.tolist() if local_backend == "reference" and not self.mutate
                      else None)
        i32 = dict(dtype=torch.int32, device=dev)
        self.rungs_t = torch.tensor(self.rungs, **i32)
        self.pools = torch.empty((P, L, self.R), **i32)
        self.final = torch.empty_like(self.pools)
        self.empty_send = empty_records(P * P * self.base, self.R - F_SCRATCH, dev).reshape(
            P, P, self.base, self.R)
        self.send = self.empty_send.clone()
        self.did_route = torch.zeros((), dtype=torch.bool, device=dev)
        self.live = torch.zeros((), dtype=torch.bool, device=dev)
        (self.n_active, self.n_remote, self.steps, self.routed, self.dropped, self.local_only,
         self.halt, self.budget) = (torch.zeros((), **i32) for _ in range(8))
        self.cap_counts = torch.zeros(len(self.rungs), **i32)
        self.flags = torch.zeros(6 + len(self.rungs), **i32)
        self._superstep = (self._pipelined_superstep if schedule == "pipelined"
                           else self._fused_superstep)
        self.side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self.graph = None
        if self.side is None:
            CACHE_STATS.traces += 1  # the eager loop is built once per key

    # ---- one superstep ----

    def _live(self):
        live = ((self.n_active > 0) & (self.steps < self.max_supersteps)
                & (self.steps < self.halt))
        return live & (self.dropped == 0) if self.schedule == "fused" else live

    def _ladder(self):
        return _ladder_traced(self.n_active, self.n_remote, num_shards=self.P,
                              base_capacity=self.base,
                              min_link_capacity=self.min_link_capacity, compact=self.compact)

    def _mask(self):
        """This superstep's loss mask, keyed on the device counter, or None."""
        if self.drop_keys is None:
            return None
        return _loss_mask(self.drop_keys, self.L, self.drop_prob, self.steps)

    def _chase(self, pools):
        if self.mutate:
            return _local_superstep_mut(self.it, pools, self.data, self.heap, self.bounds,
                                        self.perms, k_local=self.k_local,
                                        max_iters=self.budget, commit=False)
        with torch.profiler.record_function("routing.chase"):
            return _local_superstep(self.it, pools, self.data, self.bounds, self.perms,
                                    k_local=self.k_local, max_iters=self.budget,
                                    backend=self.local_backend,
                                    elide_access_check=self.elide, edges=self.edges)

    def _on_side(self, fn):
        """``fn()`` on the side stream, forked from and joined back into the
        current one (inside a capture, two branches of the graph)."""
        if self.side is None:
            return fn()
        cur = torch.cuda.current_stream(self.device)
        self.side.wait_stream(cur)
        with torch.cuda.stream(self.side):
            out = fn()
        cur.wait_stream(self.side)
        return out

    def _write(self, live, **new):
        for name, value in new.items():
            buf = getattr(self, name)
            buf.copy_(torch.where(live, value, buf))

    def _tally(self, live, do_route, capacity, n_routed, n_drop, **new):
        i32 = torch.int32
        self._write(
            live, steps=self.steps + 1,
            routed=self.routed + torch.where(do_route, n_routed, 0).to(i32),
            dropped=self.dropped + n_drop.to(i32),
            cap_counts=self.cap_counts + torch.where(do_route, (self.rungs_t == capacity).to(i32), 0),
            local_only=self.local_only + (~do_route).to(i32), **new)

    def _fused_superstep(self):
        """``make_fused_loop``'s body: the chase (for writes, then the
        commit), then the switch at the ladder's rung, selected by
        ``do_route``."""
        live = self._live()
        self.live.copy_(live)
        if self.mutate:
            pools, _, _ = _local_superstep_mut(
                self.it, self.pools, self.data, self.heap, self.bounds, self.perms,
                k_local=self.k_local, max_iters=self.budget, live=live)
        else:
            pools = self._chase(self.pools)
        capacity, do_route = self._ladder()
        with torch.profiler.record_function("routing.switch"):
            routed, n_routed, n_drop = _route(
                pools, self.bounds, self.P, return_to_cpu=self.return_to_cpu,
                link_capacity=capacity, phys_capacity=self.base, drain_done=self.compact,
                fabric=self.fabric, mut_base=self.mut_base, drop_mask=self._mask())
            pools = torch.where(do_route, routed, pools)
            n_active = (pools[..., F_STATUS] == STATUS_ACTIVE).sum(dtype=torch.int32)
            n_remote = _remote_active(pools, self.bounds, self.mut_base).to(torch.int32)
        self._tally(live, do_route, capacity, n_routed, torch.where(do_route, n_drop, 0),
                    pools=pools, n_active=n_active, n_remote=n_remote)

    def _pipelined_superstep(self):
        """``make_pipelined_loop``'s tick: the wavefront that was in flight
        lands and chases on the side stream while the resident one chases,
        the two merge (for writes, the merged pool commits once), then the
        ladder's decision extracts the next in-flight wavefront; the
        scheduler's two counts span both wavefronts."""
        live = self._live()
        self.live.copy_(live)
        landed = self._on_side(
            lambda: self._chase(_exchange(self.send, self.P, fabric=self.fabric)))
        resident = self._chase(self.pools)
        merged, n_drop = _merge_pools(resident, landed, self.L)
        pool_s = torch.where(self.did_route, merged, resident)
        n_drop = torch.where(self.did_route, n_drop, 0)
        if self.mutate:
            _commit(pool_s, self.data, self.heap, self.bounds, self.perms,
                    scratch_words=self.S, live=live)
        capacity, do_route = self._ladder()
        with torch.profiler.record_function("routing.switch"):
            kept, send, n_routed = _route_decide(
                pool_s, self.bounds, self.P, return_to_cpu=self.return_to_cpu,
                link_capacity=capacity, phys_capacity=self.base, drain_done=self.compact,
                mut_base=self.mut_base, drop_mask=self._mask())
            kept = torch.where(do_route, kept, pool_s)
            send = torch.where(do_route, send, self.empty_send)
            n_active = ((kept[..., F_STATUS] == STATUS_ACTIVE).sum(dtype=torch.int32)
                        + (send[..., F_STATUS] == STATUS_ACTIVE).sum(dtype=torch.int32))
            n_remote = _remote_active(kept, self.bounds, self.mut_base).to(torch.int32)
        self._tally(live, do_route, capacity, n_routed, n_drop, pools=kept, send=send,
                    did_route=do_route, n_active=n_active, n_remote=n_remote)

    # ---- a chunk, and the call ----

    def _flags(self):
        """After a chunk: ``live`` once more, and the host's one read:
        ``[live, n_active, steps, dropped, local_only, did_route,
        *cap_counts]``.  The pipelined loop also lands its in-flight
        wavefront here (into ``final``; its drops join ``dropped``), as the
        JAX loop does after its ``while_loop``."""
        live = self._live()
        self.live.copy_(live)
        dropped = self.dropped
        if self.schedule == "pipelined":
            merged, n_drop = _merge_pools(
                self.pools, _exchange(self.send, self.P, fabric=self.fabric), self.L)
            self.final.copy_(torch.where(self.did_route, merged, self.pools))
            dropped = dropped + torch.where(self.did_route, n_drop, 0).to(torch.int32)
        head = torch.stack([live.to(torch.int32), self.n_active, self.steps, dropped,
                            self.local_only, self.did_route.to(torch.int32)])
        self.flags.copy_(torch.cat([head, self.cap_counts]))

    def _chunk(self):
        for _ in range(CHUNK):
            self._superstep()
        self._flags()

    def _load(self, pools, halt: int, max_iters: int, arena: Arena):
        self.pools.copy_(pools)
        n0 = (pools[..., F_STATUS] == STATUS_ACTIVE).sum(dtype=torch.int32)
        self.n_active.copy_(n0)
        self.n_remote.copy_(n0)  # before the first superstep all sit at home
        for t in (self.steps, self.routed, self.dropped, self.local_only, self.cap_counts,
                  self.did_route):
            t.zero_()
        self.send.copy_(self.empty_send)
        self.halt.fill_(halt)
        self.budget.fill_(max_iters)
        if self.mutate or self.source is None or self.source() is not arena:
            pairs = [(self.data, arena.data), (self.bounds, arena.bounds),
                     (self.perms, arena.perms)]
            if self.mutate:
                pairs.append((self.heap, arena.heap))
            else:
                self.source = weakref.ref(arena)
            for mine, theirs in pairs:
                mine.copy_(theirs)

    def _capture(self):
        """Warm one superstep up on a side stream (the kernels build and
        load, every op runs once), put the state back, and capture a chunk."""
        t0 = time.perf_counter()
        state = self._CARRIED + (("data", "heap") if self.mutate else ())
        saved = {n: getattr(self, n).clone() for n in state}
        cur, warm = torch.cuda.current_stream(self.device), torch.cuda.Stream(self.device)
        warm.wait_stream(cur)
        with torch.cuda.stream(warm):
            self._superstep()
        cur.wait_stream(warm)
        for n, t in saved.items():
            getattr(self, n).copy_(t)
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._chunk()
        self.graph = graph
        CACHE_STATS.traces += 1
        CACHE_STATS.capture_s += time.perf_counter() - t0

    def run(self, pools: torch.Tensor, halt: int, max_iters: int, arena: Arena):
        """One call: load the placed pools, the budget and (for writes, or
        a read of another arena) the arena, run chunks until ``live`` is
        false.  Returns ``(final pools, flags)``, the pools this runner's
        buffer (read them before its next call) and ``flags`` the last
        chunk's, on the host."""
        self._load(pools, halt, max_iters, arena)
        if self.side is not None and self.graph is None:
            with torch.profiler.record_function("routing.capture"):
                self._capture()
        while True:
            with torch.profiler.record_function("routing.chunk"):
                if self.graph is not None:
                    self.graph.replay()
                else:
                    self._chunk()
                flags = self.flags.tolist()
            CACHE_STATS.host_reads += 1
            if not flags[0]:
                break
        return (self.final if self.schedule == "pipelined" else self.pools), flags


def get_fused_runner(it: PulseIterator, arena: Arena, *, schedule: str = "fused",
                     pool_rows: int, k_local: int, max_supersteps: int,
                     min_link_capacity: int, return_to_cpu: bool, compact: bool,
                     fabric: str = "dense", local_backend: str = "reference",
                     elide_access_check: bool = False, drop_prob: float = 0.0,
                     drop_seed: int = 0) -> _DeviceLoop:
    """The cached device-resident loop (``_DeviceLoop``) for one key: the
    iterator, the device, the schedule's knobs, the pool's rows, the
    arena's shapes (the runner copies an arena in when a call brings
    another one; a write runner every call), for a read batch on the
    reference backend the shard bounds (the captured chase slices by
    them), and the fabric loss's probability and seed.  The iteration
    budget is not part of the key: it is a device operand of the loop."""
    ident = (tuple(arena.data.shape), tuple(arena.heap.shape))
    if local_backend == "reference" and not it.mutates:
        ident += (tuple(arena.bounds.tolist()),)
    key = (it, str(arena.data.device), ident, arena.num_shards, pool_rows, schedule, k_local,
           max_supersteps, min_link_capacity, return_to_cpu, compact, fabric,
           local_backend, elide_access_check, drop_prob, drop_seed)
    runner = _FUSED_CACHE.get(key)
    if runner is not None:
        CACHE_STATS.hits += 1
        return runner
    CACHE_STATS.misses += 1
    runner = _FUSED_CACHE[key] = _DeviceLoop(
        it, arena, schedule=schedule, pool_rows=pool_rows, k_local=k_local,
        max_supersteps=max_supersteps, min_link_capacity=min_link_capacity,
        return_to_cpu=return_to_cpu, compact=compact, fabric=fabric,
        local_backend=local_backend, elide_access_check=elide_access_check,
        drop_prob=drop_prob, drop_seed=drop_seed)
    return runner


# ------------------------------- the executor --------------------------------


def place_requests(ptr0, scratch0, num_shards: int, mut_words: int = 0):
    """Every request at its home shard (``id % P``): ``(pools (P, L, R),
    B)`` on ``ptr0``'s device, with ``L = Bp``, the batch padded to a
    multiple of P (all requests could, transiently, sit on one shard), and
    an empty mutation payload of ``mut_words`` words.  Request ``i`` takes
    slot ``i // P`` of shard ``i % P``: the JAX package's stable sort by
    home shard, the padding as EMPTY records."""
    P = num_shards
    B, S = scratch0.shape
    dev = ptr0.device
    Bp = ((B + P - 1) // P) * P
    L = Bp
    ids = torch.arange(B, dtype=torch.int32, device=dev)
    rec = torch.cat([pack_requests(ids, ids % P, ptr0, scratch0, mut_words),
                     empty_records(Bp - B, S + mut_words, dev)])
    pools = empty_records(P * L, S + mut_words, dev).reshape(P, L, -1)
    pools[:, : Bp // P] = rec.reshape(Bp // P, P, -1).transpose(0, 1)
    return pools, B


def distributed_execute(
    it: PulseIterator,
    arena: Arena,
    ptr0,
    scratch0,
    *,
    mesh: EmulatedMesh | ProcessGroupMesh,
    axis_name: str = "mem",
    max_iters: int = 1 << 30,
    k_local: int = 4,
    max_supersteps: int = 1 << 16,
    return_to_cpu: bool = False,
    compact: bool = False,
    min_link_capacity: int = 8,
    fused: bool = False,
    schedule: str | None = None,
    fabric: str = "dense",
    local_backend: str | None = None,
    fault_injector=None,
    replication: ReplicaContext | None = None,
    elide_access_check: bool | None = None,
):
    """Run a batch of traversals over a range-partitioned arena on a mesh
    of P memory nodes emulated on the arena's device.  ``axis_name`` must
    name the mesh's axis (``ValueError`` otherwise, as ``shard_map``
    refuses an axis its mesh lacks).

    ``replication`` (read path, dispatched schedule) threads a
    ``ReplicaContext`` through every superstep: the serve map redirects
    reads bound for dead (or spread-balanced) primaries to their replica
    holders, which chase them from their replica rows (on the card in the
    same ``pulse_chase`` launch: its replica window).  Replicas are
    bit-identical by construction, so the final ``(ptr, scratch, status,
    iters)`` equal the failure-free run's; only ``hops`` and superstep
    counts may differ.  A dead shard with no replica cannot serve its
    range.

    ``schedule`` picks the superstep engine (``fused=True`` is the JAX
    package's boolean shorthand for ``"fused"``); all three give the same
    records, pools, superstep counts and wire accounting bit for bit:

      * ``"dispatched"``: one superstep per host iteration (the local
        chase, for a mutating iterator the commit, then the switch), the
        host reading four counters per superstep (actives, routed, dropped,
        remote) to pick the next;
      * ``"fused"``: the whole traversal as one device-resident loop
        (``_DeviceLoop``): the ladder, the local-only decision and the end
        of the loop on the device, on the card a chunk of ``CHUNK``
        supersteps replayed from one captured CUDA graph between two host
        reads;
      * ``"pipelined"``: the same loop with the JAX package's two
        wavefronts: the one in flight lands and chases on a second stream
        while the resident one chases.

    Fused and pipelined runs report aggregates only (``wire_words_total``,
    no per-superstep lists), as the JAX package's do.  ``fabric="ring"``
    carries the records on ``P - 1`` distance classes instead of the dense
    all_to_all, on any schedule (``_exchange``).

    ``local_backend`` is ``"kernel"`` (the default for a read batch on the
    card: one ``pulse_chase`` launch per chase over all P pools, two a
    pipelined tick; its plain version on a CPU arena) or ``"reference"``
    (the default on the CPU and for a mutating iterator: ``k_local`` steps
    of the iterator in torch ops).

    A mutating iterator runs on private copies of ``data`` and ``heap``,
    each superstep's commit phase one ``pulse_commit`` launch on the card
    (its plain version on the CPU); the input arena is never modified, so a
    kill from ``fault_injector`` leaves it as it was.  It refuses, as the
    JAX package does, ``return_to_cpu``, the kernel local backend,
    ``replication`` and ``elide_access_check=True``.  ``replication``
    refuses ``return_to_cpu`` and the device-resident schedules too.

    ``compact=True`` enables active-set compaction: finished records retire
    in place (``drain_done``); the per-link capacity follows a power-of-two
    envelope of the surviving actives, ``min(L // P, max(min_link_capacity,
    pow2(ceil(n_active / P))))`` (``_ladder``; on the device
    ``_ladder_traced``); a superstep whose actives all sit at their owning
    shard skips the fabric.  Results are bit-identical to the uncompacted
    schedule; only ``crossings`` differ.  ``compact`` is ignored under
    ``return_to_cpu`` (the home bounce is the ablation).

    ``fault_injector`` (``core.faults.FaultInjector``, test-only): a
    targeted kill fires before the named (1-based) superstep (a
    device-resident loop halts there, ``halt`` a device scalar, and the
    host fires it); fabric loss parks each routed record under the seeded
    mask (``_drop_mask``, keyed on the supersteps completed) on every
    schedule; a straggler shard sleeps ``delay_s`` before each dispatched
    superstep in which it serves work (an ACTIVE record points into its
    range and no replica serves in its place), the one case in which the
    host reads the pools.

    ``elide_access_check=None`` auto-specializes (``can_elide_access_check``,
    never under replication); ``False`` keeps the probe; ``True`` asserts
    the caller's own proof and raises for a mutating iterator or under
    replication.

    Under ``torch.profiler`` the placement, each superstep (its one read of
    the counters included) and the decode show as the spans
    ``routing.place``, ``routing.superstep`` and ``routing.decode``; inside
    a superstep, ``routing.chase``, ``routing.commit`` (writes),
    ``routing.switch`` and ``routing.counters`` (the one host read of the
    superstep's counters, which waits for the device's work).  A
    device-resident loop shows ``routing.capture`` (its first call on the
    card) and one ``routing.chunk`` per chunk, its read of the flags
    included, in place of ``routing.superstep``.

    On a ``ProcessGroupMesh`` the call is one memory node's, SPMD: every
    rank calls it with the same arguments, as every device runs a
    ``shard_map`` body (``_process_group_execute``).  Rank ``r`` moves only
    its rows ``[bounds[r], bounds[r + 1])`` (and its heap row) to the
    mesh's device, keeps only pool ``r``, and runs the JAX package's
    per-shard superstep on the dispatched schedule, the records crossing
    the group's collectives; it returns what ``EmulatedMesh`` returns, on
    every rank, on the mesh's device.  It keeps ``compact``,
    ``return_to_cpu``, ``min_link_capacity``, ``elide_access_check``,
    mutating iterators, both fabrics, ``replication`` (a rank moves only
    its holder slice of ``rep_rows`` to the device, and takes either the
    arena's layout or that slice alone) and every fault of the
    injector: the loss mask, a targeted kill (every rank raises the same
    ``ShardFailure``) and the straggler (only rank ``delay_shard`` sleeps,
    in the supersteps in which the emulated mesh's would).  It refuses with
    ``NotImplementedError`` what needs more than one card: the fused and
    pipelined schedules (ROADMAP queue 1, item 1).  On a mesh with a
    ``leader`` (rank 0 of a served group) the call's arguments first go to
    the ranks that follow it (``serving.memory_node``).

    Returns ``(records, RoutingStats)``, plus the post-commit ``Arena`` on
    the input's device for a mutating iterator: the records a ``(B, R)``
    int32 tensor on the arena's device, ordered by request id.
    """
    on_group = isinstance(mesh, ProcessGroupMesh)
    if on_group:
        _refuse_on_a_process_group(schedule="fused" if schedule is None and fused else schedule)
    kill_at = None
    delay_s, delay_shard = 0.0, None
    drop_prob, drop_seed = 0.0, 0
    if fault_injector is not None:
        kill_at = fault_injector.kill_step(fault_injector.begin_call())
        plan = fault_injector.plan
        drop_prob, drop_seed = float(plan.drop_prob), int(plan.drop_seed)
        if plan.delay_shard is not None:
            delay_s, delay_shard = float(plan.delay_s), int(plan.delay_shard)
    if schedule is None:
        schedule = "fused" if fused else "dispatched"
    if schedule not in ("dispatched", "fused", "pipelined"):
        raise ValueError(f"unknown schedule {schedule!r}")
    _check_fabric(fabric)
    mutate = it.mutates
    if mutate and return_to_cpu:
        raise ValueError(
            "mutating iterators cannot run under the return_to_cpu ablation: the home "
            "bounce would reorder commits against the write path's superstep contract")
    if mutate and local_backend == "kernel":
        raise ValueError(
            "mutating iterators are not supported on the pulse_chase kernel local "
            "backend: it is read-only; use local_backend='reference'")
    if replication is not None:
        if mutate:
            raise ValueError(
                "replication serves the READ path only: writes to a dead shard park "
                "under backoff until recovery rebuilds it")
        if return_to_cpu:
            raise ValueError("replication is incompatible with the return_to_cpu ablation")
        if schedule in ("fused", "pipelined"):
            raise ValueError(
                "replication runs on the dispatched schedule (results are "
                "schedule-invariant, so degraded rounds fall back to it)")
    if elide_access_check and (mutate or replication is not None):
        raise ValueError(
            "elide_access_check=True is only sound for verified read-only traversals "
            "without replication")
    dev = torch.device(mesh.device) if on_group else arena.data.device
    if local_backend is None:
        local_backend = "kernel" if dev.type == "cuda" and not mutate else "reference"
    if local_backend not in ("kernel", "reference"):
        raise ValueError(f"unknown local_backend {local_backend!r}")
    if elide_access_check is None:
        # a replicated round keeps the probe: the replica window checks the
        # primary's grant, and degraded-mode perms may change between rounds
        elide_access_check = replication is None and can_elide_access_check(it, arena)
    num_shards = arena.num_shards
    if axis_name != mesh.axis_name:
        raise ValueError(f"axis {axis_name!r} is not the mesh's; its axis is {mesh.axis_name!r}")
    if mesh.num_shards != num_shards:
        raise ValueError(f"arena has {num_shards} shards but the mesh has {mesh.num_shards}")
    if torch.device(mesh.device).type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device}, the arena on {dev}")
    if arena.capacity % num_shards:
        raise ValueError("distributed arena must have uniform shard sizes")
    if on_group:
        call = dict(max_iters=max_iters, k_local=k_local, max_supersteps=max_supersteps,
                    return_to_cpu=return_to_cpu, compact=compact,
                    min_link_capacity=min_link_capacity, fabric=fabric,
                    local_backend=local_backend, elide_access_check=elide_access_check)
        if mesh.leader is not None:
            # rank 0 of a served group: the followers join this call
            mesh.leader.announce(it, arena, ptr0, scratch0, call, replication=replication,
                                 fault_injector=fault_injector, kill_at=kill_at)
        out = _process_group_execute(
            it, arena, ptr0, scratch0, mesh=mesh, **call, drop_prob=drop_prob,
            drop_seed=drop_seed, replication=replication, kill_at=kill_at,
            fault_injector=fault_injector, delay_s=delay_s, delay_shard=delay_shard)
        if mesh.leader is not None and mutate:
            mesh.leader.keep(out[2])
        return out

    S = it.scratch_words
    MW = mut_width(arena.node_words) if mutate else 0
    R = record_width(S, MW)
    ptr0 = torch.as_tensor(ptr0, dtype=torch.int32).to(dev)
    scratch0 = torch.as_tensor(scratch0, dtype=torch.int32).to(dev).reshape(-1, S)
    with torch.profiler.record_function("routing.place"):
        pools, B = place_requests(ptr0, scratch0, num_shards, MW)
    L = pools.shape[1]
    base_capacity = L // num_shards
    compact = compact and not return_to_cpu
    if schedule != "dispatched":
        runner = get_fused_runner(
            it, arena, schedule=schedule, pool_rows=L, k_local=k_local,
            max_supersteps=max_supersteps, min_link_capacity=min_link_capacity,
            return_to_cpu=return_to_cpu, compact=compact, fabric=fabric,
            local_backend=local_backend, elide_access_check=elide_access_check,
            drop_prob=drop_prob, drop_seed=drop_seed)
        # an armed kill caps the loop at kill_at - 1 supersteps
        halt = kill_at - 1 if kill_at is not None else max_supersteps
        pools, flags = runner.run(pools, halt, min(max_iters, (1 << 31) - 1), arena)
        _, n_active, steps, n_drop, local_only, _, *cap_counts = flags
        if n_drop != 0:  # not assert: must survive python -O
            raise RuntimeError(f"request records lost in routing (pool overflow): {n_drop}")
        if kill_at is not None and n_active > 0 and steps >= kill_at - 1:
            # halted at the injected death with work left: the call dies here
            fault_injector.fire(kill_at)
        if n_active != 0:
            raise RuntimeError(
                f"distributed_execute: {n_active} records still ACTIVE after "
                f"max_supersteps={max_supersteps}; raise the cap or lower max_iters "
                f"(records would be returned with partial state otherwise)")
        # the per-rung histogram to a wire total in Python integers (an
        # int32 product on the device would wrap at large pools)
        wire = sum(c * num_shards * (num_shards - 1) * cap * R
                   for c, cap in zip(cap_counts, runner.rungs))
        with torch.profiler.record_function("routing.decode"):
            records, stats = _decode_results(
                pools, B, S, mut_words=MW, supersteps=steps, local_only_steps=local_only,
                wire_words_total=wire, fused=True, schedule=schedule, fabric=fabric,
                num_shards=num_shards)
            if not mutate:
                return records, stats
            data, heap = runner.data.clone(), runner.heap.clone()
            cols = [H_EPOCH, H_COMMITS]
            stats.epochs, stats.commits = (heap[:, cols].sum(0) - arena.heap[:, cols].sum(0)).tolist()
        return records, stats, Arena(data=data, bounds=arena.bounds, perms=arena.perms,
                                     heap=heap)

    if mutate:
        # the arena is the value being transformed: this call's private copies
        data, heap = arena.data.clone(), arena.heap.clone()
        epochs0, commits0 = heap[:, [H_EPOCH, H_COMMITS]].sum(0).tolist()
    rep = rep_ctx = drop_keys = None
    if replication is not None:
        rep, rep_ctx = _rep_operands(replication, arena.data, num_shards)
    if drop_prob > 0.0:
        drop_keys = _shard_keys(drop_seed, torch.arange(num_shards, device=dev))
    if delay_s > 0.0:
        dlo, dhi, delay_serves = _straggler_range(arena, delay_shard, replication)
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
        if delay_s > 0.0 and delay_serves:
            # the straggler extends the barrier only on supersteps in which
            # it serves work: an ACTIVE record points into its range
            ptrs = pools[..., F_PTR]
            if bool(((pools[..., F_STATUS] == STATUS_ACTIVE) & (ptrs >= dlo)
                     & (ptrs < dhi)).any()):
                _straggle(delay_s, steps)
        capacity, do_route = _ladder(n_active, n_remote, num_shards=num_shards,
                                     base_capacity=base_capacity,
                                     min_link_capacity=min_link_capacity, compact=compact)
        route_kw = dict(k_local=k_local, max_iters=max_iters, return_to_cpu=return_to_cpu,
                        link_capacity=capacity if compact else None, drain_done=compact,
                        do_route=do_route, fabric=fabric,
                        drop_mask=(_loss_mask(drop_keys, L, drop_prob, steps)
                                   if drop_keys is not None and do_route else None))
        with torch.profiler.record_function("routing.superstep"):
            if mutate:
                pools, data, heap, *counts = superstep_mut(
                    it, pools, data, heap, arena.bounds, arena.perms, **route_kw)
            else:
                pools, *counts = superstep(
                    it, pools, arena.data, arena.bounds, arena.perms,
                    local_backend=local_backend, elide_access_check=elide_access_check,
                    rep=rep, rep_ctx=rep_ctx, **route_kw)
            # the dispatched schedule reads the device once per superstep
            with torch.profiler.record_function("routing.counters"):
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
        records, stats = _decode_results(
            pools, B, S, mut_words=MW, supersteps=steps, routed_per_step=routed_per_step,
            active_per_step=active_per_step, wire_words_per_step=wire_words_per_step,
            capacity_per_step=capacity_per_step, local_only_steps=local_only_steps,
            schedule=schedule, fabric=fabric, num_shards=num_shards)
        if not mutate:
            return records, stats
        epochs, commits = heap[:, [H_EPOCH, H_COMMITS]].sum(0).tolist()
        stats.commits, stats.epochs = commits - commits0, epochs - epochs0
    return records, stats, Arena(data=data, bounds=arena.bounds, perms=arena.perms, heap=heap)


def _straggle(delay_s: float, superstep: int) -> None:
    """The straggler's sleep before (0-based) superstep ``superstep`` of a
    call, on the shard that serves work in it (a test records it instead)."""
    time.sleep(delay_s)


def _straggler_range(arena: Arena, delay_shard: int, replication):
    """``(lo, hi, serves)``: the straggler's range, and whether it serves
    work at all in this call.  A replicated straggler, alive, still serves
    its reads; dead, its replica serves them and it costs no one
    anything."""
    lo, hi = arena.bounds[delay_shard:delay_shard + 2].tolist()
    serves = not (replication is not None and replication.plan.replica_map[delay_shard] >= 0
                  and bool(torch.as_tensor(replication.dead_mask)[delay_shard]))
    return lo, hi, serves


def _refuse_on_a_process_group(*, schedule) -> None:
    """What ``distributed_execute`` does not run on a ``ProcessGroupMesh``,
    naming its entry of ROADMAP queue 1; never run as something else."""
    if schedule in ("fused", "pipelined"):
        raise NotImplementedError(
            f"schedule={schedule!r} on a ProcessGroupMesh needs its collectives inside the "
            "captured CUDA graph, that is NCCL on more than one card: ROADMAP queue 1, "
            "item 1 (the fused and pipelined schedules on NCCL); use schedule='dispatched'")


# a memory node's resident rows: (id(arena), mesh) -> (rows, heap row,
# bounds, perms, row0) on the mesh's device, the JAX package's
# ``_resident_arena`` for one shard
_RESIDENT: dict = {}


def _resident_shard(arena: Arena, mesh: ProcessGroupMesh):
    """This rank's rows ``[bounds[r], bounds[r + 1])`` of ``arena.data``,
    its heap row and the switch's tables, on the mesh's device, moved once
    per (arena, mesh)."""
    key = (id(arena), mesh)
    ent = _RESIDENT.get(key)
    if ent is None:
        r, dev = mesh.rank, torch.device(mesh.device)
        edges = arena.bounds.tolist()
        if len(set(np.diff(edges).tolist())) != 1:
            raise ValueError("distributed arena must have uniform shard sizes")
        lo, hi = int(edges[r]), int(edges[r + 1])
        ent = (arena.data[lo:hi].to(dev).contiguous(), arena.heap[r:r + 1].to(dev).contiguous(),
               arena.bounds.to(dev), arena.perms.to(dev), lo)
        _RESIDENT[key] = ent
        # evict when the arena dies, so a recycled id() cannot alias stale rows
        weakref.finalize(arena, _RESIDENT.pop, key, None)
    return ent


# a memory node's holder slice of replica rows: (id(rep_rows), mesh) ->
# rows on the mesh's device
_RESIDENT_REPLICA: dict = {}


def _resident_replica(rep_rows, arena: Arena, mesh: ProcessGroupMesh) -> torch.Tensor:
    """This rank's holder slice of ``rep_rows`` on the mesh's device: rows
    ``[bounds[r], bounds[r + 1])`` of replica rows in the arena's layout,
    or ``rep_rows`` itself when it has only this rank's rows (what a
    follower holds), moved once per (rows, mesh)."""
    key = (id(rep_rows), mesh)
    rows = _RESIDENT_REPLICA.get(key)
    if rows is None:
        r = mesh.rank
        lo, hi = arena.bounds[r:r + 2].tolist()
        t = torch.as_tensor(rep_rows, dtype=torch.int32)
        if t.ndim == 2 and t.shape[0] == arena.capacity:
            t = t[lo:hi]
        elif t.ndim != 2 or t.shape[0] != hi - lo:
            raise ValueError(f"replica rows {tuple(t.shape)} are neither the arena's layout "
                             f"{tuple(arena.data.shape)} nor rank {r}'s {hi - lo} rows")
        rows = t.to(torch.device(mesh.device)).contiguous()
        _RESIDENT_REPLICA[key] = rows
        weakref.finalize(rep_rows, _RESIDENT_REPLICA.pop, key, None)
    return rows


def drop_resident(mesh: ProcessGroupMesh) -> None:
    """Release this rank's resident rows and replica slices moved for
    ``mesh`` (a served group's old mesh at a live reshard: a rank that
    leaves the group holds none after it, and one that stays moves its new
    rows on its next call)."""
    for cache in (_RESIDENT, _RESIDENT_REPLICA):
        for key in [k for k in cache if k[1] == mesh]:
            del cache[key]


def _process_group_execute(it: PulseIterator, arena: Arena, ptr0, scratch0, *,
                           mesh: ProcessGroupMesh, max_iters: int, k_local: int,
                           max_supersteps: int, return_to_cpu: bool, compact: bool,
                           min_link_capacity: int, fabric: str, local_backend: str,
                           drop_prob: float, drop_seed: int, elide_access_check: bool,
                           replication: ReplicaContext | None, kill_at: int | None,
                           fault_injector, delay_s: float, delay_shard: int | None):
    """``distributed_execute`` on a ``ProcessGroupMesh``: this rank's memory
    node on the dispatched schedule.  Each superstep is the JAX package's
    per-shard body (``make_superstep``): the local chase over its own pool
    and rows (on the card one ``pulse_chase`` launch of its one shard, the
    replica window over its holder slice when ``replication`` is on), for
    a mutating iterator the commit on its rows and heap row (one
    ``pulse_commit`` call), ``_route_decide`` for ``my_shard = r`` under
    the serve map, the exchange and the merge, then the four counters in
    one all-reduce and the superstep's one host read.  At the end one
    all-gather of the final pools (for writes of every shard's rows and
    heap row too), so every rank decodes the same results.

    The kill fires on every rank before the same (1-based) superstep, the
    supersteps counted from the all-reduced counters, so every rank raises
    the same ``ShardFailure``.  The straggler: only rank ``delay_shard``
    sleeps, before each superstep in which an ACTIVE record of any pool
    points into its range (the placed pools before the first, which every
    rank places whole; after that a fifth word of the counters'
    all-reduce, counted on each pool after the exchange); the others wait
    for it at the superstep's first collective."""
    P, r = mesh.num_shards, mesh.rank
    dev = torch.device(mesh.device)
    mutate = it.mutates
    rows, heap_row, bounds, perms, row0 = _resident_shard(arena, mesh)
    rep = rep_ctx = None
    if replication is not None:
        rep, rep_ctx = _rep_operands(replication, rows, P,
                                     rows=_resident_replica(replication.rep_rows, arena, mesh))
    S = it.scratch_words
    MW = mut_width(arena.node_words) if mutate else 0
    R = record_width(S, MW)
    ptr0 = torch.as_tensor(ptr0, dtype=torch.int32).to(dev)
    scratch0 = torch.as_tensor(scratch0, dtype=torch.int32).to(dev).reshape(-1, S)
    straggle = False
    if delay_s > 0.0:
        dlo, dhi, straggle = _straggler_range(arena, delay_shard, replication)

    def serving(p):  # ACTIVE records pointing into the straggler's range
        ptrs = p[..., F_PTR]
        return ((p[..., F_STATUS] == STATUS_ACTIVE) & (ptrs >= dlo) & (ptrs < dhi)).sum()

    with torch.profiler.record_function("routing.place"):
        pools, B = place_requests(ptr0, scratch0, P, MW)
        n_serving = int(serving(pools)) if straggle else 0
        pools = pools[r:r + 1].contiguous()
    L = pools.shape[1]
    base_capacity = L // P
    compact = compact and not return_to_cpu
    if mutate:
        data, heap = rows.clone(), heap_row.clone()  # this call's private copies
        epochs0, commits0 = arena.heap[:, [H_EPOCH, H_COMMITS]].sum(0).tolist()
    drop_keys = (_shard_keys(drop_seed, torch.tensor([r], device=dev)) if drop_prob > 0.0
                 else None)
    routed_per_step, active_per_step = [], []
    wire_words_per_step, capacity_per_step = [], []
    local_only_steps = steps = 0
    n_active, n_remote = B, B  # before the first superstep all sit at home
    for _ in range(max_supersteps):
        # an injected shard death fires before the targeted (1-based) superstep
        if kill_at is not None and steps + 1 >= kill_at:
            fault_injector.fire(steps + 1)
        if straggle and n_serving and r == delay_shard:
            _straggle(delay_s, steps)
        capacity, do_route = _ladder(n_active, n_remote, num_shards=P,
                                     base_capacity=base_capacity,
                                     min_link_capacity=min_link_capacity, compact=compact)
        route_kw = dict(k_local=k_local, max_iters=max_iters, return_to_cpu=return_to_cpu,
                        link_capacity=capacity if compact else None, drain_done=compact,
                        do_route=do_route, fabric=fabric, shard0=r, row0=row0, mesh=mesh,
                        drop_mask=(_loss_mask(drop_keys, L, drop_prob, steps)
                                   if drop_keys is not None and do_route else None))
        with torch.profiler.record_function("routing.superstep"):
            if mutate:
                pools, data, heap, *counts = superstep_mut(
                    it, pools, data, heap, bounds, perms, **route_kw)
            else:
                pools, *counts = superstep(
                    it, pools, rows, bounds, perms, local_backend=local_backend,
                    elide_access_check=elide_access_check, rep=rep, rep_ctx=rep_ctx,
                    **route_kw)
            if straggle:
                counts.append(serving(pools))
            with torch.profiler.record_function("routing.counters"):
                totals = mesh.all_reduce(torch.stack(counts))
            n_active, n_routed, n_drop, n_remote = totals[:4]
            n_serving = totals[4] if straggle else 0
        steps += 1
        routed_per_step.append(n_routed)
        active_per_step.append(n_active)
        capacity_per_step.append(capacity if do_route else 0)
        wire_words_per_step.append(P * (P - 1) * capacity * R if do_route else 0)
        local_only_steps += int(not do_route)
        if n_drop != 0:  # not assert: must survive python -O
            raise RuntimeError(f"request records lost in routing (pool overflow): {n_drop}")
        if n_active == 0:
            break
    else:
        raise RuntimeError(
            f"distributed_execute: {n_active} records still ACTIVE after "
            f"max_supersteps={max_supersteps}; raise the cap or lower max_iters "
            f"(records would be returned with partial state otherwise)")
    with torch.profiler.record_function("routing.decode"):
        records, stats = _decode_results(
            mesh.all_gather(pools[0]), B, S, mut_words=MW, supersteps=steps,
            routed_per_step=routed_per_step, active_per_step=active_per_step,
            wire_words_per_step=wire_words_per_step, capacity_per_step=capacity_per_step,
            local_only_steps=local_only_steps, schedule="dispatched", fabric=fabric,
            num_shards=P)
        if not mutate:
            return records, stats
        data = mesh.all_gather(data).reshape(arena.capacity, arena.node_words)
        heap = mesh.all_gather(heap[0])
        epochs, commits = heap[:, [H_EPOCH, H_COMMITS]].sum(0).tolist()
        stats.commits, stats.epochs = commits - commits0, epochs - epochs0
    return records, stats, Arena(data=data, bounds=bounds, perms=perms, heap=heap)


def _decode_results(
    pools,
    B: int,
    scratch_words: int,
    *,
    mut_words: int = 0,
    supersteps: int,
    routed_per_step: list | None = None,
    active_per_step: list | None = None,
    wire_words_per_step: list | None = None,
    capacity_per_step: list | None = None,
    local_only_steps: int = 0,
    wire_words_total: int | None = None,
    fused: bool = False,
    schedule: str,
    fabric: str,
    num_shards: int,
):
    """Order the final pools' records by request id on their device, and
    build the stats; the host reads the record count and the crossings.
    A device-resident run passes ``wire_words_total`` and ``fused=True``
    and no per-superstep lists.

    Every request id in ``[0, B)`` sits in exactly one valid record (a
    record lost in routing has already raised), so sorting by id, with
    empties and padding keyed past the batch, puts the batch in the first
    B rows."""
    flat = pools.reshape(-1, record_width(scratch_words, mut_words))
    keep = (flat[:, F_STATUS] != STATUS_EMPTY) & (flat[:, F_ID] < B)
    key = torch.where(keep, flat[:, F_ID], B)
    all_rec = flat[torch.sort(key, stable=True).indices[:B]]
    n_kept = int(keep.sum())
    if n_kept != B:  # not assert: must survive python -O
        raise RuntimeError(f"request records lost in routing: {B - n_kept} of {B}")
    stats = RoutingStats(
        supersteps=supersteps,
        crossings=all_rec[:, F_HOPS].cpu().numpy(),
        routed_per_step=routed_per_step or [],
        active_per_step=active_per_step or [],
        wire_words_per_step=wire_words_per_step or [],
        capacity_per_step=capacity_per_step or [],
        local_only_steps=local_only_steps,
        wire_words_total=wire_words_total,
        fused=fused,
        schedule=schedule,
        fabric=fabric,
        _num_shards=num_shards,
    )
    return all_rec, stats
