"""Fault-tolerant arenas: snapshots, a durable commit log and replay recovery.

The write path's determinism contract makes recovery cheap: every schedule
and fabric commits staged mutations in one canonical (class, slot, id)
order, bit-identical to the sequential commit
(``core.commit.sequential_commit_execute``).  So the commit log records a
write quantum's *inputs* (iterator name, ptr0/scratch0, budget, knobs), not
arena words; replaying them through the sequential commit from the latest
snapshot rebuilds the exact post-commit arena, heap registers included.

The durability protocol (no acknowledged commit is lost):

  1. a write quantum executes (any schedule, fabric or backend);
  2. on success its inputs and the commit and epoch deltas it observed are
     appended to the log and fsynced; only then is it acknowledged;
  3. every ``snapshot_every`` logged quanta the whole arena is snapshotted
     through ``CheckpointManager._atomic_save`` (manifest, shard npz, the
     atomic ``LATEST`` pointer) and the log's replayed prefix is dropped.

A crash between the execution and the append loses an unacknowledged
quantum (the client retries); a crash mid-snapshot leaves a directory
without a manifest, which restore ignores.  Recovery is the latest snapshot
plus the replay of every logged quantum with ``seq > snapshot.log_seq``,
each checked against its logged commit and epoch deltas.

A quantum is replayed by the executor that wrote it: on a mesh through
``routing.distributed_execute`` (each commit phase one ``pulse_commit``
launch on the card), on one node through the sequential commit.  The
determinism contract makes the two bit-equal, so either replays a log
written by the other.

The files are the JAX package's (``repro.distributed.arena_ft``): a
snapshot or a log written by either package recovers in the other when
the same iterator names are registered.

On a ``routing.ProcessGroupMesh`` the replays of ``recover`` and of the
standby run through ``distributed_execute`` on the group, and the
snapshots and the log are written by rank 0 only: the served group's
``PulseService`` holds the store there, and the other ranks hold none.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import routing
from repro_torch.core.arena import H_EPOCH, Arena, arena_from_numpy
from repro_torch.distributed.checkpoint import CheckpointManager


class RecoveryError(RuntimeError):
    """Snapshot or log state is unusable, or replay diverged from the log."""


class ReplicationError(RuntimeError):
    """A replica diverged from its primary (the bit-identity invariant)."""


@dataclasses.dataclass(frozen=True)
class ArenaSnapshot:
    """A restored arena and the log position it stands for."""

    arena: Arena
    log_seq: int  # last commit-log seq folded into this arena
    epoch: int  # sum of the shards' H_EPOCH registers at snapshot time


@dataclasses.dataclass
class RecoveryInfo:
    """What one ``recover()`` did (feeds ServiceMetrics)."""

    snapshot_seq: int  # log seq the restored snapshot covered
    log_seq: int  # last log seq after replay
    replayed_quanta: int
    replayed_commits: int
    wall_s: float


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


Mesh = routing.EmulatedMesh | routing.ProcessGroupMesh


def _replay(it, arena: Arena, ptr0, scratch0, *, mesh: Mesh | None,
            max_iters: int, k_local: int, compact: bool):
    """Apply one write quantum to ``arena``: ``(RoutingStats, new Arena)``.

    With a ``mesh``, through ``routing.distributed_execute`` on the
    dispatched schedule, as the engine runs a write on a mesh (no capture,
    each commit phase one ``pulse_commit`` launch on the card); without
    one, through the sequential commit, the engine's write on one node.
    On a ``ProcessGroupMesh`` every rank joins the replay (a served group's
    rank 0 announces it to the ranks that follow it)."""
    if mesh is None:
        from repro_torch.core.commit import sequential_commit_execute

        _, stats, arena = sequential_commit_execute(
            it, arena, ptr0, scratch0, max_iters=max_iters, k_local=k_local, compact=compact)
        return stats, arena
    _, stats, arena = routing.distributed_execute(
        it, arena, ptr0, scratch0, mesh=mesh, axis_name=mesh.axis_name, max_iters=max_iters,
        k_local=k_local, compact=compact, schedule="dispatched")
    return stats, arena


class CommitLog:
    """Append-only JSONL log of acknowledged write quanta.

    One JSON object a line; ``append`` flushes and fsyncs before it
    returns, so a returned seq is durable.  ``entries`` drops a torn final
    line (a crash mid-append: that record was never acknowledged); a torn
    line *followed by* valid records is corruption and raises.
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._seq = 0
        for e in self.entries():
            self._seq = max(self._seq, int(e["seq"]))
        self._f = open(self.path, "a", encoding="utf-8")

    @property
    def seq(self) -> int:
        """Last durable (acknowledged) sequence number; 0 = empty log."""
        return self._seq

    def append(self, record: dict) -> int:
        """Assign the next seq, write and fsync, return the seq (the ack)."""
        self._seq += 1
        rec = {"seq": self._seq, **record}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())
        return self._seq

    def entries(self) -> list[dict]:
        if not self.path.exists():
            return []
        out = []
        lines = self.path.read_text(encoding="utf-8").splitlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    break  # torn tail: unacknowledged
                raise RecoveryError(f"corrupt commit log {self.path} at line {i + 1}") from None
        return out

    def quanta(self) -> list[dict]:
        """The entries that describe write quanta (markers dropped)."""
        return [e for e in self.entries() if "kind" not in e]

    def truncate_through(self, seq: int) -> int:
        """Compact: drop every entry with seq <= ``seq`` (folded into a
        durable snapshot).  Returns the number of entries dropped.

        The survivors, headed by a ``kind: truncated`` marker that keeps
        the seq high-water mark across a reopen, go to a ``.tmp`` sibling,
        fsynced, then ``os.replace`` over the log and the directory entry
        fsynced.  A crash before the replace leaves the old log and a stray
        ``.tmp`` (never read); a crash after leaves the compacted log.
        Either way the snapshot and the log replay to the same arena."""
        entries = self.entries()
        keep = [e for e in entries if int(e.get("seq", 0)) > seq]
        dropped = len(entries) - len(keep)
        if dropped <= 0:
            return 0
        tmp = self.path.with_name(self.path.name + ".tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps({"seq": int(seq), "kind": "truncated"}) + "\n")
            for e in keep:
                f.write(json.dumps(e) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        dfd = os.open(self.path.parent, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        self._f = open(self.path, "a", encoding="utf-8")
        return dropped

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class ArenaStore:
    """Snapshot and commit-log durability for one arena.

    Owns a ``CheckpointManager`` (synchronous saves: a returned snapshot is
    durable) and a ``CommitLog`` in the same directory.  The log names
    iterators, so recovery needs the iterators that wrote it registered
    under the same names (the service registers its writing specs).
    """

    def __init__(self, directory: str | Path, *, keep: int = 3):
        self.dir = Path(directory)
        self.mgr = CheckpointManager(self.dir, keep=keep, async_save=False)
        self.log = CommitLog(self.dir / "commit_log.jsonl")
        self._iterators: dict[str, object] = {}
        self.snapshots_taken = 0

    def register_iterator(self, name: str, it) -> None:
        prev = self._iterators.get(name)
        if prev is not None and prev is not it:
            raise ValueError(f"iterator name {name!r} already registered")
        self._iterators[name] = it

    # ----------------------------- logging --------------------------------

    def log_quantum(self, it_name: str, ptr0, scratch0, *, max_iters: int, k_local: int,
                    compact: bool, commits: int, epochs: int) -> int:
        """Record one executed write quantum; the returned seq is the
        acknowledgment (durable on return)."""
        if it_name not in self._iterators:
            raise ValueError(f"unregistered iterator {it_name!r}")
        return self.log.append({
            "it": it_name,
            "ptr0": _host(ptr0).astype(np.int64).tolist(),
            "scratch0": _host(scratch0).astype(np.int64).tolist(),
            "max_iters": int(max_iters),
            "k_local": int(k_local),
            "compact": bool(compact),
            "commits": int(commits),
            "epochs": int(epochs),
        })

    # ---------------------------- snapshots -------------------------------

    def snapshot(self, arena: Arena, log_seq: int | None = None, *,
                 compact_log: bool = True) -> int:
        """Persist the whole arena atomically at ``log_seq`` (default: the
        log's durable seq); returns that seq.  Once ``LATEST`` has flipped,
        the log's entries with ``seq <= log_seq`` are dropped
        (``compact_log=False`` keeps the whole history)."""
        seq = self.log.seq if log_seq is None else int(log_seq)
        heap = _host(arena.heap)
        self.mgr._atomic_save(
            step=seq,
            arrays={"data": _host(arena.data), "bounds": _host(arena.bounds),
                    "perms": _host(arena.perms), "heap": heap},
            manifest={"kind": "arena_snapshot", "log_seq": seq,
                      "epoch": int(heap[:, H_EPOCH].sum()), "num_shards": arena.num_shards,
                      "capacity": arena.capacity, "node_words": arena.node_words},
        )
        self.snapshots_taken += 1
        if compact_log:
            self.log.truncate_through(seq)
        return seq

    def ensure_baseline(self, arena: Arena) -> None:
        """Snapshot the arena before serving if no snapshot exists, so
        recovery always has a state to replay from."""
        if self.mgr.latest_step() is None:
            self.snapshot(arena)

    def load_snapshot(self, step: int | None = None, *, device="cuda") -> ArenaSnapshot:
        """The snapshot at ``step`` (default: the latest) as an arena on
        ``device``."""
        step = self.mgr.latest_step() if step is None else step
        if step is None:
            raise RecoveryError(f"no arena snapshot under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        if manifest.get("kind") != "arena_snapshot":
            raise RecoveryError(f"{d} is not an arena snapshot")
        with np.load(d / f"shard_{self.mgr.host_id}.npz") as z:
            arena = arena_from_numpy(z["data"], z["bounds"], z["perms"], z["heap"],
                                     device=device)
        return ArenaSnapshot(arena, int(manifest["log_seq"]), int(manifest["epoch"]))

    # ---------------------------- recovery --------------------------------

    def recover(self, *, device="cuda", mesh: Mesh | None = None) -> tuple[Arena, RecoveryInfo]:
        """The latest snapshot, on ``device``, plus the replay of every
        newer logged quantum: over ``mesh`` through
        ``routing.distributed_execute`` when given (the snapshot must have
        the mesh's shard count), else through the sequential commit.

        Each replay's commit and epoch deltas must equal the log's: the log
        holds what the acknowledged execution observed and every schedule
        equals the sequential commit, so a mismatch means the snapshot and
        the log disagree, not a drift to tolerate."""
        t0 = time.perf_counter()
        snap = self.load_snapshot(device=device)
        arena = snap.arena
        if mesh is not None and mesh.num_shards != arena.num_shards:
            raise RecoveryError(f"the snapshot at seq {snap.log_seq} has {arena.num_shards} "
                                f"shards, the mesh {mesh.num_shards}")
        replayed = commits = 0
        last_seq = snap.log_seq
        for e in self.log.quanta():
            if int(e["seq"]) <= snap.log_seq:
                continue
            it = self._iterators.get(e["it"])
            if it is None:
                raise RecoveryError(f"log references unregistered iterator {e['it']!r}")
            B = len(e["ptr0"])
            ptr0 = np.asarray(e["ptr0"], np.int32)
            scratch0 = np.asarray(e["scratch0"], np.int32).reshape(B, -1)
            stats, arena = _replay(it, arena, ptr0, scratch0, mesh=mesh,
                                   max_iters=int(e["max_iters"]), k_local=int(e["k_local"]),
                                   compact=bool(e["compact"]))
            if stats.commits != int(e["commits"]) or stats.epochs != int(e["epochs"]):
                raise RecoveryError(
                    f"replay diverged at seq {e['seq']}: observed ({stats.commits} commits, "
                    f"{stats.epochs} epochs), log says ({e['commits']}, {e['epochs']})")
            replayed += 1
            commits += stats.commits
            last_seq = int(e["seq"])
        info = RecoveryInfo(snapshot_seq=snap.log_seq, log_seq=last_seq,
                            replayed_quanta=replayed, replayed_commits=commits,
                            wall_s=time.perf_counter() - t0)
        return arena, info

    def close(self) -> None:
        self.log.close()


# ------------------------------ replication ----------------------------------


@dataclasses.dataclass(frozen=True)
class ReplicationConfig:
    """Hot-shard replication (R = 2, log shipping).

    ``primaries`` names the shards to replicate (None: every shard, each
    mirrored on its antipode, ``routing.make_replica_plan``).  ``policy``
    is the read fan-out: "primary" (a cold standby), "failover" (the
    replica serves only while its primary is suspected dead), "spread"
    (odd request ids always read the replica).  ``verify_every_quantum``
    checks replica == primary rows after each shipped write quantum."""

    policy: str = "failover"
    primaries: tuple[int, ...] | None = None
    verify_every_quantum: bool = True


def _clone(arena: Arena) -> Arena:
    return Arena(data=arena.data.clone(), bounds=arena.bounds.clone(),
                 perms=arena.perms.clone(), heap=arena.heap.clone())


class ReplicaSet:
    """Log-shipping hot standby: a shadow arena kept bit-identical to the
    primary by replaying every acknowledged write quantum, over ``mesh``
    through ``routing.distributed_execute`` when given (the service passes
    its engine's), else through the sequential commit.

    The commit stream is serialized in the canonical order and every
    schedule equals the sequential commit, so replica == primary holds by
    construction; ``verify`` checks it.  ``rep_rows`` is the read fan-out's
    device operand: holder r's rows carry its primary's rows from local
    offset 0 (each holder mirrors at most one shard, the R = 2 budget).
    The shadow is the standby's own copy (tensors are mutable), and
    ``rep_rows`` is built on its device once per shipped quantum."""

    def __init__(self, plan: routing.ReplicaPlan, arena: Arena, *, mesh: Mesh | None = None):
        self.plan = plan
        self.mesh = mesh
        self.shadow = _clone(arena)
        self.quanta_applied = 0
        self._rows: torch.Tensor | None = None

    def apply_quantum(self, it, ptr0, scratch0, *, max_iters: int, k_local: int,
                      compact: bool) -> None:
        """Ship one acknowledged write quantum to the standby."""
        _, self.shadow = _replay(it, self.shadow, ptr0, scratch0, mesh=self.mesh,
                                 max_iters=max_iters, k_local=k_local, compact=compact)
        self.quanta_applied += 1
        self._rows = None

    def verify(self, primary: Arena) -> None:
        """Raise unless replica rows == primary rows for every replicated
        shard (compared on the primary's device)."""
        b = primary.bounds.tolist()
        sd = self.shadow.data.to(primary.data.device)
        for holder, p in enumerate(self.plan.primary_map):
            if p < 0:
                continue
            lo, hi = b[p], b[p + 1]
            if not torch.equal(primary.data[lo:hi], sd[lo:hi]):
                raise ReplicationError(
                    f"replica of shard {p} (held by {holder}) diverged from the primary "
                    f"after {self.quanta_applied} quanta")

    def rep_rows(self) -> torch.Tensor:
        """``(capacity, node_words)`` operand for ``ReplicaContext`` on the
        shadow's device: holder r's range holds primary_map[r]'s rows.
        Reused until the next ``apply_quantum`` or ``reset``."""
        if self._rows is not None:
            return self._rows
        sd = self.shadow.data
        b = self.shadow.bounds.tolist()
        out = torch.zeros_like(sd)
        for holder, p in enumerate(self.plan.primary_map):
            if p < 0:
                continue
            n = b[p + 1] - b[p]
            cap = b[holder + 1] - b[holder]
            if n > cap:
                raise ReplicationError(f"holder {holder} range ({cap} rows) cannot mirror "
                                       f"shard {p} ({n} rows)")
            out[b[holder]: b[holder] + n] = sd[b[p]: b[p + 1]]
        self._rows = out
        return out

    def reset(self, arena: Arena, plan: routing.ReplicaPlan | None = None, *,
              mesh: Mesh | None = None) -> None:
        """Re-anchor the standby (after a recovery or a reshard: a new
        ``mesh`` with the new width)."""
        if plan is not None:
            self.plan = plan
        if mesh is not None:
            self.mesh = mesh
        self.shadow = _clone(arena)
        self.quanta_applied = 0
        self._rows = None


@dataclasses.dataclass
class FaultToleranceConfig:
    """The serving layer's fault tolerance (``PulseService(...,
    fault_tolerance=)``).

    ``snapshot_every`` counts logged write quanta between snapshots.  A
    group parked on a dead shard backs off exponentially with jitter:
    ``base * 2**attempt`` rounds, capped at ``cap``, +/- ``jitter`` of it
    (seeded with ``seed``, so reruns repeat).  ``dead_rounds`` keeps a
    shard marked dead that many rounds after its recovery (0: revive at
    once), the re-provisioning window.  ``retry_budget`` bounds a
    request's retries; past it the request retires STATUS_RETRY.

    ``replication`` turns on hot-shard replicas (``ReplicationConfig``):
    reads fan out to replicas by the policy, and a suspected-dead
    primary's reads go to its replica with no retry charged while
    recovery rebuilds it.  ``watchdog_timeout_s`` > 0 arms the per-round
    shard watchdog: every shard is probed with a one-record traversal, and
    a shard whose probes exceed the timeout two rounds running is
    suspected dead, which catches stragglers that never raise
    ``ShardFailure``."""

    store: ArenaStore
    snapshot_every: int = 8
    retry_budget: int = 5
    backoff_base: int = 1  # rounds
    backoff_cap: int = 16  # rounds
    backoff_jitter: float = 0.5
    dead_rounds: int = 0
    seed: int = 0
    replication: ReplicationConfig | None = None
    watchdog_timeout_s: float = 0.0  # 0 disables the shard watchdog
