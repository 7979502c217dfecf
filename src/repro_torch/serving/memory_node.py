"""A served process group: rank 0 runs ``PulseService``, the other ranks
follow it.

The service is single-controller, like the paper's CPU node: one Python
process decides each round, and its admission reads the wall clock
(arrivals, deadlines, SLO sizing, the rate limiter).  P ranks that each
ran their own service would admit different slots and hang in their
collectives.  So on a ``routing.ProcessGroupMesh`` the service runs on rank
0, which is also memory node 0, and the other ranks are memory nodes that
join every engine call it makes:

  * ``lead(mesh, arena, structures)`` (``PulseService`` calls it on rank 0)
    returns the mesh with a ``Leader``: every ``distributed_execute`` on it
    first broadcasts one call header (the engine's reads and writes, the
    watchdog's probes, the standby's and the recovery's replays, the
    warm-ups alike);
  * ``follow(mesh, arena, structures)`` (every other rank of the world)
    joins each call with the header's arguments until the service's
    ``close`` says stop.

Two groups carry the traffic.  The headers go to every rank of the world
(the default group), so a rank outside the serving group (the mesh's
group, the world's first P ranks: ``distributed.world.first_ranks``) hears
each call, the cutover of a live reshard and the stop, and skips what is
not its own.  The serving group carries the rest: arena installs, replica
rows and every collective of the call.  Every rank issues the world's
broadcasts in one order and every member the group's, so no two ranks wait
on different collectives.

A header says what the call is (an engine call, an arena to install, the
cutover, or stop) and carries the iterator by its ``StructureSpec`` name
(``PROBE`` for the watchdog's probe: iterators hold closures and are never
pickled; each rank builds the same table from the same specs), ``ptr0``
and ``scratch0`` as numpy, the call's keywords, the replica plan, dead
mask and version of the replica rows for a replicated read, and the fault
injector's ``kill_at`` for this call with the plan's loss and straggler,
so that a follower needs no injector of its own.

Arenas are named by handles.  Rank 0's first arena is handle 0 on every
member; an arena rank 0 uses that its followers do not hold (a recovered
snapshot, the standby's shadow, a remapped arena) is broadcast whole
first; a write call's result, which the call's final all-gather already
gives every member, takes the handle its header names.  An arena rank 0
lets go of is dropped on the followers with the next header.  A replica
holder receives its slice of the replica rows only when their version
changes, and no rank receives another's rows (``distributed.world.
scatter``).

The live reshard (``Leader.cutover``): rank 0 announces the new width
``Q``, every rank of the world makes or takes the group of its first ``Q``
ranks at that header, drops the arenas and replica rows it holds and the
rows it moved to its device (``routing.drop_resident``), and rank 0 then
installs the remapped arena on the new group.  A rank the group gains
serves from the next call; a rank a shrink leaves out holds nothing and
waits for the stop.

Every rank raises the same ``ShardFailure`` in a killed call; a follower
catches it and waits for the next header, with the arena it had.  Any
other error ends the follower, and with it the world.  Rank 0 issues every
collective from one thread at a time: the service drains its device
runner before a recovery, a probe, a cutover or a stop.
"""

from __future__ import annotations

import dataclasses
import time
import weakref

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import routing
from repro_torch.core.arena import Arena
from repro_torch.core.faults import FaultInjector, FaultPlan, ShardFailure
from repro_torch.distributed import world

PROBE = "<shard watchdog probe>"  # the probe iterator's name in a header


def iterator_table(structures) -> dict:
    """Name -> iterator: every spec's, and the watchdog's probe."""
    from repro_torch.serving.traversal_service import _PROBE_IT

    table = {name: spec.iterator for name, spec in structures.items()}
    table[PROBE] = _PROBE_IT
    return table


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass
class LeaderStats:
    """Rank 0's control traffic: headers and the arenas (and their bytes,
    each sent to every other rank of the serving group) and replica rows
    they carried, the host seconds of the live reshards' cutovers (the
    remapped arena's install included) and of all of it."""

    headers: int = 0
    calls: int = 0
    arenas: int = 0
    arena_bytes: int = 0
    replica_versions: int = 0
    cutover_s: float = 0.0
    seconds: float = 0.0


class Leader:
    """Rank 0's side of a served process group (``ProcessGroupMesh.leader``).

    ``announce`` sends one engine call's header (``distributed_execute``
    calls it with the call's resolved arguments), ``keep`` names a write
    call's result, ``cutover`` moves the service to another width, ``stop``
    ends the followers.  Headers go to the world, installs and replica
    rows to ``group``, the serving group.  Not thread-safe: one thread at a
    time, in one order (the service's contract)."""

    def __init__(self, mesh: routing.ProcessGroupMesh, arena: Arena, structures):
        self.group = mesh.group
        table = iterator_table(structures)
        self._its = list(table.values())  # keeps every id() below alive
        self._names = {id(it): name for name, it in table.items()}
        self._handles: dict = {}  # id(arena) -> handle
        self._next = 0
        self._evicted: list = []
        self._pending_out = None
        self._rep_rows = None  # the replica rows last scattered
        self._rep_version = 0
        self.stopped = False
        self.stats = LeaderStats()
        self._register(arena)  # handle 0: every follower starts from it

    def _register(self, arena: Arena, handle: int | None = None) -> int:
        if handle is None:
            handle, self._next = self._next, self._next + 1
        key = id(arena)
        self._handles[key] = handle
        weakref.finalize(arena, self._forget, key, handle)
        return handle

    def _forget(self, key, handle) -> None:
        if self._handles.get(key) == handle:
            del self._handles[key]
        self._evicted.append(handle)

    def _send(self, header: dict) -> None:
        header["evict"], self._evicted = self._evicted, []
        t0 = time.perf_counter()
        world.broadcast_object(header)  # the world: every rank hears every header
        self.stats.headers += 1
        self.stats.seconds += time.perf_counter() - t0

    def _handle(self, arena: Arena) -> int:
        """The followers' handle of ``arena``, broadcast to them first if
        they do not hold it."""
        h = self._handles.get(id(arena))
        if h is not None:
            return h
        h = self._register(arena)
        fields = [getattr(arena, f) for f in ("data", "bounds", "perms", "heap")]
        self._send(dict(kind="arena", handle=h,
                        fields=[(tuple(t.shape), t.dtype) for t in fields]))
        t0 = time.perf_counter()
        for t in fields:
            world.broadcast(t, group=self.group)
        self.stats.arenas += 1
        self.stats.arena_bytes += sum(t.numel() * t.element_size() for t in fields)
        self.stats.seconds += time.perf_counter() - t0
        return h

    def _check_live(self) -> None:
        if self.stopped:
            raise RuntimeError("the followers of this process group have stopped "
                               "(PulseService.close): a served group serves one service")

    def announce(self, it, arena: Arena, ptr0, scratch0, call: dict, *, replication,
                 fault_injector, kill_at) -> None:
        """Send one ``distributed_execute`` call to the followers: its
        arena (installed first if new to them), iterator, inputs and
        keywords, the replica operands and this call's faults."""
        self._check_live()
        name = self._names.get(id(it))
        if name is None:
            raise ValueError(f"iterator {getattr(it, 'name', it)!r} is not one of the served "
                             "structures' (nor the watchdog's probe): the followers cannot "
                             "name it")
        h = self._handle(arena)
        rep, send_rows = None, False
        if replication is not None:
            send_rows = replication.rep_rows is not self._rep_rows
            if send_rows:
                self._rep_rows, self._rep_version = replication.rep_rows, self._rep_version + 1
            rep = dict(plan=replication.plan, version=self._rep_version,
                       dead=_host(replication.dead_mask).astype(bool))
        faults = None
        plan = getattr(fault_injector, "plan", None)
        if plan is not None:
            faults = dict(kill_shard=plan.kill_shard if kill_at is not None else None,
                          kill_at=kill_at, drop_prob=plan.drop_prob, drop_seed=plan.drop_seed,
                          delay_shard=plan.delay_shard, delay_s=plan.delay_s)
        out = None
        if it.mutates:
            out, self._next = self._next, self._next + 1
        self._pending_out = out
        self._send(dict(kind="call", it=name, arena=h, ptr0=_host(ptr0),
                        scratch0=_host(scratch0), call=call, rep=rep, faults=faults, out=out))
        self.stats.calls += 1
        if send_rows:
            t0 = time.perf_counter()
            world.scatter(torch.as_tensor(replication.rep_rows, dtype=torch.int32).cpu(),
                          group=self.group)
            self.stats.replica_versions += 1
            self.stats.seconds += time.perf_counter() - t0

    def keep(self, arena: Arena) -> None:
        """A write call's result: the handle its header named."""
        self._register(arena, self._pending_out)
        self._pending_out = None

    def cutover(self, mesh: routing.ProcessGroupMesh, arena: Arena, shards: int):
        """The live reshard's switch to ``shards`` memory nodes, the world's
        first ``shards`` ranks (``PulseService._cutover``, once the planner
        has drained every quantum): announce it, take the new group on every
        rank at this header, drop what every rank holds for the old mesh,
        and install the remapped ``arena`` on the new group.  Returns the
        new mesh, led by this leader.  Raises ``RuntimeError``, announcing
        nothing, when the world has fewer ranks than ``shards``."""
        self._check_live()
        size = dist.get_world_size()
        if size < shards:
            raise RuntimeError(f"reshard to {shards} shards needs {shards} ranks, the world "
                               f"has {size}")
        t0 = time.perf_counter()
        self._send(dict(kind="reshard", shards=shards))
        self.group = world.first_ranks(shards)
        routing.drop_resident(mesh)
        # the followers drop every arena at the header: any arena used from
        # here on is installed on the new group first
        self._handles.clear()
        self._rep_rows = None
        new = dataclasses.replace(mesh, group=self.group)
        self._handle(arena)
        self.stats.cutover_s += time.perf_counter() - t0
        return new

    def stop(self, arena: Arena) -> None:
        """End every other rank of the world; each member of the serving
        group returns its copy of ``arena`` (idempotent)."""
        if self.stopped:
            return
        self._send(dict(kind="stop", arena=self._handle(arena)))
        self.stopped = True


def lead(mesh: routing.ProcessGroupMesh, arena: Arena, structures):
    """Rank 0's mesh of a served group: ``mesh`` with a ``Leader`` whose
    followers start from ``arena`` and serve ``structures``."""
    if mesh.rank != 0:
        raise ValueError(f"rank {mesh.rank} of a served process group follows rank 0: call "
                         "serving.memory_node.follow(mesh, arena, structures) there")
    if mesh.leader is not None:
        raise ValueError("this process group already has a leader: a served group serves "
                         "one service")
    return dataclasses.replace(mesh, leader=Leader(mesh, arena, structures))


def _one_call_injector(faults):
    """A fault injector whose call 0 is this call, from a header's faults."""
    if faults is None:
        return None
    kill_at = faults["kill_at"]
    return FaultInjector(FaultPlan(
        kill_shard=faults["kill_shard"] if kill_at is not None else None, kill_call=0,
        kill_superstep=kill_at if kill_at is not None else 1, drop_prob=faults["drop_prob"],
        drop_seed=faults["drop_seed"], delay_shard=faults["delay_shard"],
        delay_s=faults["delay_s"]))


def follow(mesh: routing.ProcessGroupMesh, arena: Arena | None, structures) -> Arena | None:
    """A memory node of a served group (every rank of the world but 0):
    join every call rank 0 announces, with the arena it names, until it
    says stop.  ``mesh`` is the service's first mesh as this rank sees it
    (its group may leave this rank out: then ``arena`` may be None, and the
    rank joins no call until a cutover brings it in).  Returns this rank's
    copy of the arena the stop names (the service engine's), or None on a
    rank outside the serving group at the stop: one the service never
    used, or one a shrink left out."""
    if mesh.rank == 0:
        raise ValueError("rank 0 of a served process group runs the PulseService")
    its = iterator_table(structures)
    arenas = {0: arena} if mesh.rank > 0 else {}
    rep_rows, rep_version = None, 0
    while True:
        h = world.broadcast_object(None)
        for k in h["evict"]:
            arenas.pop(k, None)
        if h["kind"] == "stop":
            return arenas[h["arena"]] if mesh.rank > 0 else None
        if h["kind"] == "reshard":
            routing.drop_resident(mesh)
            mesh = dataclasses.replace(mesh, group=world.first_ranks(h["shards"]))
            arenas.clear()
            rep_rows, rep_version = None, 0
            continue
        r = mesh.rank
        if r < 0:
            continue  # outside the serving group: the install and the call are its members'
        if h["kind"] == "arena":
            data, bounds, perms, heap = (world.broadcast(None, shape, dtype, group=mesh.group)
                                         for shape, dtype in h["fields"])
            arenas[h["handle"]] = Arena(data=data, bounds=bounds, perms=perms, heap=heap)
            continue
        cur = arenas[h["arena"]]
        rep = None
        if h["rep"] is not None:
            if h["rep"]["version"] != rep_version:
                lo, hi = cur.bounds[r:r + 2].tolist()
                rep_rows = world.scatter(None, (hi - lo, cur.node_words), torch.int32,
                                         group=mesh.group)
                rep_version = h["rep"]["version"]
            rep = routing.ReplicaContext(h["rep"]["plan"], rep_rows, h["rep"]["dead"])
        try:
            out = routing.distributed_execute(
                its[h["it"]], cur, torch.from_numpy(h["ptr0"]), torch.from_numpy(h["scratch0"]),
                mesh=mesh, axis_name=mesh.axis_name, schedule="dispatched", replication=rep,
                fault_injector=_one_call_injector(h["faults"]), **h["call"])
        except ShardFailure:
            continue  # every rank raised it; rank 0 recovers and calls again
        if h["out"] is not None:
            arenas[h["out"]] = out[2]
