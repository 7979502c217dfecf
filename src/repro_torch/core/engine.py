"""PulseEngine: the user-facing traversal engine (dispatch + execute).

Execution paths:
  * ``backend="kernel"``    -- the pulse_chase CUDA kernel, one launch per
                               call (the default when the arena is on the
                               card).
  * ``backend="reference"`` -- the plain torch executor
                               (``iterator.execute_batched``), the oracle the
                               kernel path is held against.
  * a mesh                  -- with ``mesh=routing.EmulatedMesh(P, ...)`` and
                               a P-shard arena, a read batch is routed across
                               the P memory nodes in supersteps
                               (``routing.distributed_execute``, on the
                               schedule and fabric asked); the backend picks
                               the local chase: one ``pulse_chase`` launch
                               per chase, or the plain chase.  With
                               ``mesh=routing.ProcessGroupMesh(...)`` every
                               rank of a process group is one memory node
                               and calls ``execute`` with the same arguments
                               (SPMD), on the dispatched schedule, with
                               ``replication`` and the fault injector (loss,
                               kill, straggler) passed through; a served
                               group's rank 0 calls it alone and the others
                               follow (``serving.memory_node``).
  * ``cpu_node``            -- the Cache-based baseline: the traversal runs at
                               the CPU node with an LRU trace of node fetches;
                               chosen by the dispatch model for iterators it
                               does not offload when the arena is on the CPU,
                               and only on request (``force_offload=False``)
                               when it is on the card.

Mutating iterators (the write path) run through the sequential commit
(``core.commit``: the chase on the arena's device, the commits on the host)
on one node, and on a mesh through ``routing.distributed_execute`` (on the
card each superstep's commit phase is one ``pulse_commit`` launch); the
engine swaps in the committed arena.

The dispatch engine's offload decision (t_c <= eta * t_d, S4.1) lives in
``core.dispatch``.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core import commit as commit_mod
from repro_torch.core import dispatch as dispatch_mod
from repro_torch.core import routing
from repro_torch.core.arena import NULL, PERM_READ, Arena
from repro_torch.core.iterator import (
    STATUS_DONE,
    STATUS_FAULT,
    STATUS_MAXED,
    PulseIterator,
    execute_batched,
)

# Re-exported: part of the engine's public surface.
can_elide_access_check = routing.can_elide_access_check

BACKENDS = ("kernel", "reference")


@dataclasses.dataclass
class CpuNodeTrace:
    """Access trace from the cpu_node path (feeds Fig. 7 latency models)."""

    total_fetches: int
    cache_hits: int
    per_request_iters: np.ndarray

    @property
    def misses(self) -> int:
        return self.total_fetches - self.cache_hits


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def _fused_step(it: PulseIterator, node, ptr, scratch):
    if it.step_fn is not None:
        return it.step_fn(node, ptr, scratch)
    done, scr = it.end_fn(node, ptr, scratch)
    nptr, nscr = it.next_fn(node, ptr, scr)
    return done, torch.where(done, ptr, nptr), torch.where(done[:, None], scr, nscr)


def cpu_node_execute(
    it: PulseIterator,
    arena: Arena,
    ptr0,
    scratch0,
    *,
    max_iters: int = 1 << 20,
    cache_nodes: int = 0,
):
    """Cache-based baseline: traverse at the CPU node over remote memory.

    Functionally equivalent to the accelerator path; additionally simulates
    a CPU-side LRU cache of ``cache_nodes`` node records and reports the
    trace.  Runs hop by hop on the host (numpy, with the iterator's batched
    body on CPU tensors) -- it *is* the slow path being modelled.
    Returns numpy ``(ptr, scratch, iters, trace)``.
    """
    data = arena.data.cpu().numpy()
    ptr = torch.as_tensor(ptr0).cpu().numpy().astype(np.int64)
    B = ptr.shape[0]
    scratch = torch.as_tensor(scratch0).cpu().numpy().astype(np.int32)
    scratch = scratch.reshape(B, it.scratch_words).copy()
    done = np.zeros(B, bool)
    iters = np.zeros(B, np.int64)
    lru: OrderedDict[int, None] = OrderedDict()
    hits = fetches = 0

    while not done.all() and (iters[~done].min(initial=0) < max_iters):
        live = ~done & (ptr != NULL)
        if not live.any():
            break
        # CPU-node cache simulation, per node fetch
        for a in ptr[live]:
            fetches += 1
            a = int(a)
            if a in lru:
                hits += 1
                lru.move_to_end(a)
            elif cache_nodes > 0:
                lru[a] = None
                if len(lru) > cache_nodes:
                    lru.popitem(last=False)
        node = data[np.clip(ptr, 0, data.shape[0] - 1)]
        d, np_, ns = _fused_step(
            it, torch.from_numpy(node), torch.from_numpy(ptr.astype(np.int32)),
            torch.from_numpy(scratch.copy()),
        )
        d, np_, ns = d.numpy(), np_.numpy(), ns.numpy()
        scratch[live] = ns[live]
        iters[live] += 1
        newly_done = live & (d | (np_ == NULL) | (iters >= max_iters))
        ptr[live & ~newly_done] = np_[live & ~newly_done]
        done |= newly_done
    trace = CpuNodeTrace(fetches, hits, iters.copy())
    return ptr.astype(np.int32), scratch, iters, trace


@dataclasses.dataclass
class ExecResult:
    """Per-lane results as int32 tensors on the arena's device."""

    ptr: torch.Tensor
    scratch: torch.Tensor
    status: torch.Tensor
    iters: torch.Tensor
    stats: object | None = None
    offloaded: bool = True
    decision: dispatch_mod.OffloadDecision | None = None
    # write path: the post-commit arena (mutating iterators only).  The
    # engine already swapped its own arena to it; a caller holding the
    # pre-call Arena keeps an intact snapshot.
    arena: Arena | None = None
    # write path: where the call's wall time went, and the bytes it moved
    commit_trace: object | None = None


class PulseEngine:
    """Front door: dispatch decision + the right execution path."""

    def __init__(
        self,
        arena: Arena,
        *,
        mesh=None,
        axis_name: str = "mem",
        accel: dispatch_mod.AcceleratorSpec | None = None,
        eta: float | None = None,
        fault_injector=None,
    ):
        self.arena = arena
        self.mesh = mesh
        # the mesh axis the shards lie on; every routed call passes it on
        self.axis_name = axis_name
        self.accel = accel or dispatch_mod.AcceleratorSpec()
        self.eta = self.accel.eta if eta is None else eta
        # test-only fault hook (core.faults.FaultInjector); every execute()
        # counts as one call toward the plan's kill_call
        self.fault_injector = fault_injector
        # the kernel path's logic (and its code tensor) per iterator, and the
        # dispatch model's decision per (iterator, eta): counting an ISA
        # program's longest path is Python work on every call otherwise
        self._logic: dict = {}
        self._decisions: dict = {}
        # the overlap model's schedule per (iterator, k_local); serving calls
        # execute() per quantum
        self._schedule_cache: dict = {}

    def _local_fault_check(self):
        """Register the engine call with the fault injector and fire its
        kill before any work runs."""
        inj = self.fault_injector
        if inj is not None:
            k = inj.kill_step(inj.begin_call())
            if k is not None:
                inj.fire(k)

    def reshard(self, arena: Arena, mesh=None) -> None:
        """Install a re-partitioned arena (``arena.remap_shards``) and, when
        given, a mesh of the new width.  The decisions that depend on the
        shard count go (the overlap model's schedules); the device-resident
        runners key on the arena's shapes, so those of the new width build
        on their first call."""
        self.arena = arena
        if mesh is not None:
            self.mesh = mesh
        self._schedule_cache.clear()

    def dispatch(self, it: PulseIterator) -> dispatch_mod.OffloadDecision:
        key = (it, self.accel, self.eta)
        decision = self._decisions.get(key)
        if decision is None:
            decision = self._decisions[key] = dispatch_mod.offload_decision(
                it, self.arena.node_words, self.accel, eta=self.eta
            )
        return decision

    def execute(
        self,
        it: PulseIterator,
        ptr0,
        scratch0,
        *,
        max_iters: int = 1 << 20,
        force_offload: bool | None = None,
        return_to_cpu: bool = False,
        k_local: int = 4,
        cache_nodes: int = 0,
        compact: bool = True,
        fused: bool = True,
        backend: str | None = None,
        schedule: str = "auto",
        fabric: str = "dense",
        replication=None,
    ) -> ExecResult:
        """Dispatch + execute a batch of traversals.

        ``backend`` selects the executor: ``"kernel"`` runs the pulse_chase
        kernel, one launch for the whole batch (the plain version of the
        kernel when the arena is on the CPU); ``"reference"`` runs the
        plain executor.  The default is ``"kernel"`` for an arena on the
        card and ``"reference"`` otherwise.  Both give bit-identical
        ``ptr``, ``scratch``, ``status`` and ``iters``, except that the
        kernel path detects translation faults every depth quantum.

        ``force_offload=None`` follows the dispatch model only for an arena
        on the CPU.  An arena on the card is always traversed on the card:
        the model's decision is still made and returned in
        ``ExecResult.decision``, and the host-side ``cpu_node`` baseline
        runs only when the caller asks for it with ``force_offload=False``.

        A mutating iterator runs on the write path whatever the device
        (``_execute_mut``, with ``k_local``, ``compact``, ``schedule`` and
        ``fabric`` passed on); the kernel backend is read-only
        (``backend="kernel"`` raises), and so is the CPU node
        (``force_offload=False`` raises): the commits live with the data.

        On a mesh (``mesh=routing.EmulatedMesh(P, device)`` and an arena of P
        > 1 shards) an offloaded read batch runs through
        ``routing.distributed_execute``, with ``k_local``, ``compact``,
        ``return_to_cpu``, ``schedule`` and ``fabric`` passed on:
        ``"dispatched"``, or the device-resident ``"fused"`` and
        ``"pipelined"`` (on the card a chunk of supersteps replayed from one
        captured CUDA graph), on the ``"dense"`` or the ``"ring"`` fabric;
        ``backend="kernel"`` runs each local chase as one ``pulse_chase``
        launch, ``"reference"`` as the plain chase.  ``schedule="auto"``
        consults the dispatch engine's overlap model
        (``dispatch.schedule_decision``, ``_resolve_schedule``), which
        normally picks the pipelined schedule; ``fused=False`` is the
        explicit opt-out of device-resident loops (``"dispatched"``).  A
        ``replication`` context (``routing.ReplicaContext``) runs a read
        batch on a mesh on the dispatched schedule, the only one that
        serves replicas; on one node, and for a mutating iterator, it is
        not used, as in the reference.  Results and wire words do not
        depend on the schedule.
        """
        on_mesh = self.mesh is not None and self.arena.num_shards > 1
        on_group = isinstance(self.mesh, routing.ProcessGroupMesh)
        if on_mesh and not (on_group or isinstance(self.mesh, routing.EmulatedMesh)):
            raise NotImplementedError(
                "the port's fabrics are routing.EmulatedMesh (one card) and, since item "
                "6(e), routing.ProcessGroupMesh (a torch.distributed process group); "
                f"got {type(self.mesh).__name__}"
            )
        if it.mutates:
            if backend == "kernel":
                raise ValueError(
                    "mutating iterators are not supported on the pulse_chase "
                    "kernel backend: it is read-only"
                )
            if force_offload is False:
                raise ValueError(
                    "mutating iterators cannot run at the CPU node "
                    "(force_offload=False): commits live with the data"
                )
            if backend not in (None, *BACKENDS):
                raise ValueError(f"unknown backend {backend!r}; choose one of {BACKENDS}")
            return self._execute_mut(it, ptr0, scratch0, max_iters=max_iters, k_local=k_local,
                                     compact=compact, fused=fused, schedule=schedule,
                                     fabric=fabric)
        # a memory node of a process group chases on its mesh's device, and
        # always offloads: its rows are there, whatever holds the arena
        on_card = (torch.device(self.mesh.device).type == "cuda" if on_group and on_mesh
                   else _on_card(self.arena.data))
        if backend is None:
            backend = "kernel" if on_card else "reference"
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; choose one of {BACKENDS}")
        decision = self.dispatch(it)
        if force_offload is not None:
            offload = force_offload
        else:
            offload = decision.offload or on_card or (on_group and on_mesh)
        dev = self.arena.data.device
        if not offload:
            self._local_fault_check()
            ptr, scratch, iters, trace = cpu_node_execute(
                it, self.arena, ptr0, scratch0,
                max_iters=max_iters, cache_nodes=cache_nodes,
            )
            status = np.where(iters >= max_iters, STATUS_MAXED, STATUS_DONE)
            return ExecResult(
                torch.from_numpy(ptr).to(dev),
                torch.from_numpy(scratch).to(dev),
                torch.from_numpy(status.astype(np.int32)).to(dev),
                torch.from_numpy(iters.astype(np.int32)).to(dev),
                trace,
                False,
                decision,
            )

        if on_mesh:
            if replication is not None:
                # replica fan-out runs on the dispatched schedule; results do
                # not depend on the schedule
                schedule = "dispatched"
            else:
                schedule = self._resolve_schedule(it, schedule, fused, k_local)
            rec, stats = routing.distributed_execute(
                it, self.arena, ptr0, scratch0, mesh=self.mesh, axis_name=self.axis_name,
                max_iters=max_iters,
                k_local=k_local, return_to_cpu=return_to_cpu, compact=compact,
                schedule=schedule, fabric=fabric, local_backend=backend,
                fault_injector=self.fault_injector, replication=replication,
            )
            S = it.scratch_words
            return ExecResult(
                ptr=rec[:, routing.F_PTR].contiguous(),
                scratch=rec[:, routing.F_SCRATCH : routing.F_SCRATCH + S].contiguous(),
                status=rec[:, routing.F_STATUS].contiguous(),
                iters=rec[:, routing.F_ITERS].contiguous(),
                stats=stats,
                decision=decision,
            )

        self._local_fault_check()
        if backend == "kernel":
            res = self._execute_kernel(it, ptr0, scratch0, max_iters=max_iters)
            return dataclasses.replace(res, decision=decision)
        elide = routing.can_elide_access_check(it, self.arena)
        ptr, scratch, status, iters = execute_batched(
            it, self.arena, ptr0, scratch0,
            max_iters=min(max_iters, (1 << 31) - 1), elide_access_check=elide,
        )
        return ExecResult(ptr, scratch, status, iters, decision=decision)

    def _resolve_schedule(self, it: PulseIterator, schedule: str, fused: bool,
                          k_local: int) -> str:
        """``schedule="auto"``: the dispatch engine's overlap-model pick
        (cached per iterator and ``k_local``), ``"fused"`` where it answers
        ``"local"``; ``fused=False`` is the explicit opt-out of
        device-resident loops.  Shared by the read and write paths.

        On a ``routing.ProcessGroupMesh`` ``"auto"`` resolves to
        ``"dispatched"``, the one schedule a process group runs (the
        device-resident loops need their collectives inside a captured CUDA
        graph: NCCL on more than one card, ROADMAP queue 1, item 1); the
        reference would run the overlap model's pick, with the same records
        bit for bit and only the stats' shape apart."""
        if schedule != "auto":
            return schedule
        if not fused or isinstance(self.mesh, routing.ProcessGroupMesh):
            return "dispatched"
        key = (it, k_local)
        sd = self._schedule_cache.get(key)
        if sd is None:
            sd = self._schedule_cache[key] = dispatch_mod.schedule_decision(
                it, self.arena.node_words, self.arena.num_shards, self.accel, k_local=k_local)
        return sd.schedule if sd.schedule != "local" else "fused"

    def _execute_mut(self, it: PulseIterator, ptr0, scratch0, *, max_iters: int,
                     k_local: int, compact: bool, fused: bool, schedule: str,
                     fabric: str) -> ExecResult:
        """Write path: run a mutating iterator and swap the engine's arena to
        the post-commit state.

        On a mesh (P > 1 shards) the batch runs through
        ``routing.distributed_execute`` on the resolved schedule and the
        fabric asked, the arena and heap carried through its supersteps,
        each commit phase one ``pulse_commit`` call on the card; on one node or one shard, through
        the sequential commit (``core.commit``), whose ``CommitTrace`` the
        result carries.  The input Arena object is never modified, so a
        caller can replay a snapshot."""
        S = it.scratch_words
        trace = None
        if self.mesh is not None and self.arena.num_shards > 1:
            schedule = self._resolve_schedule(it, schedule, fused, k_local)
            rec, stats, new_arena = routing.distributed_execute(
                it, self.arena, ptr0, scratch0, mesh=self.mesh, axis_name=self.axis_name,
                max_iters=max_iters,
                k_local=k_local, compact=compact, schedule=schedule, fabric=fabric,
                fault_injector=self.fault_injector,
            )
        else:
            trace = commit_mod.CommitTrace()
            rec, stats, new_arena = commit_mod.sequential_commit_execute(
                it, self.arena, ptr0, scratch0, max_iters=max_iters, k_local=k_local,
                compact=compact, fault_injector=self.fault_injector, trace=trace,
            )
            rec = torch.from_numpy(rec).to(new_arena.data.device)
        self.arena = new_arena
        return ExecResult(
            ptr=rec[:, routing.F_PTR].contiguous(),
            scratch=rec[:, routing.F_SCRATCH : routing.F_SCRATCH + S].contiguous(),
            status=rec[:, routing.F_STATUS].contiguous(),
            iters=rec[:, routing.F_ITERS].contiguous(),
            stats=stats,
            arena=new_arena,
            commit_trace=trace,
        )

    def _execute_kernel(
        self, it: PulseIterator, ptr0, scratch0, *, max_iters: int
    ) -> ExecResult:
        """Single-node path on the pulse_chase kernel: one launch runs the
        batch to its end (``pulse_chase_run``; its plain version on the CPU).

        Translation/protection faults (NULL or out-of-range pointers,
        perm-revoked ranges) are checked by the kernel against a
        ``FaultCheck`` every depth quantum of a lane's iterations, as the
        JAX package's wave scheduler checks them between chunks, so
        detection is quantum-granular rather than per-iteration like the
        reference executor -- a faulting lane may execute a few extra
        clamped (harmless) loads first, and its iteration count includes
        them.  Lanes still active after ``max_iters`` report MAXED
        (resumable).
        """
        from repro_torch.kernels.pulse_chase import ops as chase_ops

        arena = self.arena
        dev = arena.data.device
        ptr0 = torch.as_tensor(ptr0, dtype=torch.int32).to(dev)
        B = ptr0.shape[0]
        scratch0 = torch.as_tensor(scratch0, dtype=torch.int32).to(dev)
        scratch0 = scratch0.reshape(B, it.scratch_words)
        logic = self._logic.get(it)
        if logic is None:
            logic = self._logic[it] = chase_ops.iterator_logic(it)
        max_steps = int(min(max_iters, 1 << 20))
        fault = chase_ops.FaultCheck(arena.bounds, arena.perms, arena.capacity, PERM_READ)
        ptr, scratch, st, wstats = chase_ops.pulse_chase_run(
            arena.data, ptr0, scratch0, torch.zeros(B, dtype=torch.int32, device=dev),
            logic_fn=logic, max_steps=max_steps, fault_fn=fault,
        )
        status = torch.where(st == 1, STATUS_DONE, STATUS_MAXED).to(torch.int32)
        status = torch.where(wstats.faulted, STATUS_FAULT, status).to(torch.int32)
        return ExecResult(ptr, scratch, status, wstats.retire_step, wstats)
