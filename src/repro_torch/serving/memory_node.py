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
    first broadcasts one call header over the group (the engine's reads and
    writes, the watchdog's probes, the standby's and the recovery's
    replays, the warm-ups alike);
  * ``follow(mesh, arena, structures)`` (ranks 1 ..) joins each call with
    the header's arguments until the service's ``close`` says stop.

A header says what the call is (an engine call, an arena to install, or
stop) and carries the iterator by its ``StructureSpec`` name (``PROBE``
for the watchdog's probe: iterators hold closures and are never pickled;
each rank builds the same table from the same specs), ``ptr0`` and
``scratch0`` as numpy, the call's keywords, the replica plan, dead mask
and version of the replica rows for a replicated read, and the fault
injector's ``kill_at`` for this call with the plan's loss and straggler,
so that a follower needs no injector of its own.

Arenas are named by handles.  Rank 0's first arena is handle 0 on every
rank; an arena rank 0 uses that its followers do not hold (a recovered
snapshot, the standby's shadow) is broadcast whole first; a write call's
result, which the call's final all-gather already gives every rank, takes
the handle its header names.  An arena rank 0 lets go of is dropped on
the followers with the next header.  A replica holder receives its slice
of the replica rows only when their version changes, and no rank receives
another's rows (``distributed.world.scatter``).

Every rank raises the same ``ShardFailure`` in a killed call; a follower
catches it and waits for the next header, with the arena it had.  Any
other error ends the follower, and with it the world.  Rank 0 issues every
collective from one thread at a time: the service drains its device
runner before a recovery, a probe or a stop.
"""

from __future__ import annotations

import dataclasses
import time
import weakref

import numpy as np
import torch

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
    """Rank 0's control traffic: headers and the arenas and replica rows
    they carried, and the host seconds its broadcasts took."""

    headers: int = 0
    calls: int = 0
    arenas: int = 0
    replica_versions: int = 0
    seconds: float = 0.0


class Leader:
    """Rank 0's side of a served process group (``ProcessGroupMesh.leader``).

    ``announce`` sends one engine call's header (``distributed_execute``
    calls it with the call's resolved arguments), ``keep`` names a write
    call's result, ``stop`` ends the followers.  Not thread-safe: one
    thread at a time, in one order (the service's contract)."""

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
        world.broadcast_object(header, self.group)
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

    def stop(self, arena: Arena) -> None:
        """End the followers; each returns its copy of ``arena`` (idempotent)."""
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


def follow(mesh: routing.ProcessGroupMesh, arena: Arena, structures) -> Arena:
    """A memory node of a served group (ranks 1 ..): join every call rank 0
    announces, with the arena it names, until it says stop; returns this
    rank's copy of the arena the stop names (the service engine's)."""
    if mesh.rank == 0:
        raise ValueError("rank 0 of a served process group runs the PulseService")
    its = iterator_table(structures)
    arenas = {0: arena}
    r = mesh.rank
    rep_rows, rep_version = None, 0
    while True:
        h = world.broadcast_object(None, mesh.group)
        for k in h["evict"]:
            arenas.pop(k, None)
        if h["kind"] == "stop":
            return arenas[h["arena"]]
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
