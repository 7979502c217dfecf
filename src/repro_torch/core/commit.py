"""The write path's sequential executor: the sequential commit (the
determinism contract).

``sequential_commit_execute`` runs a batch under the superstep schedule of
the multi-shard engine -- placement, local chase, commit, the capacity
ladder, parking, exchange, merge -- as a *sequential* host program: shards
are visited one at a time and every staged mutation is applied strictly one
at a time, in the canonical (class, slot, id) order.  It runs at any shard
count P with no mesh, and with P = 1 it is the single-node write executor
that ``PulseEngine.execute`` runs mutating iterators through.

Where the work runs:
  * the chase (``iterator.mut_step_batch``, ``k_local`` steps a superstep)
    runs on the arena's device, over a private copy of ``data`` made once
    per call;
  * the commits run on a host mirror of ``data`` and ``heap``, copied down
    once per call, in plain numpy stores (``kernels.pulse_commit.ref.
    commit_shard``, a Python loop over the eligible records, as the JAX
    package's executor does);
  * after each shard's commit phase, only the rows it wrote go back to the
    device copy, in one scatter;
  * each shard's pool of records (L x R int32) crosses the bus once each
    way per superstep.
So no superstep moves the whole arena.  The input arena is never modified.

On a mesh (``core.routing.distributed_execute``) the commit runs on the
arena's device instead: on the card, every shard's commit phase is one
``pulse_commit`` call (three kernels and a sort) a superstep, and nothing
crosses the bus; this executor is the oracle that path is held against.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import routing
from repro_torch.core.arena import (
    H_COMMITS,
    H_EPOCH,
    M_ALLOC,
    M_NONE,
    NULL,
    PERM_READ,
    PERM_WRITE,
    Arena,
    mut_width,
)
from repro_torch.core.iterator import (
    STATUS_ACTIVE,
    STATUS_EMPTY,
    STATUS_FAULT,
    PulseIterator,
    mut_step_batch,
    step_batch,
)
from repro_torch.core.routing import (
    F_HOME,
    F_HOPS,
    F_ID,
    F_ITERS,
    F_PTR,
    F_SCRATCH,
    F_STATUS,
)
from repro_torch.kernels.pulse_commit.ref import commit_shard


@dataclasses.dataclass
class CommitTrace:
    """Where one call's wall time went, per superstep (host clock): the
    chase (the pools' upload, ``k_local`` steps on the device, their
    download) and the commit (the host commits and the scatter of the
    written rows), and the bytes it moved each way between host and device
    (on a CPU arena the same counts, though nothing crosses a bus)."""

    chase_s: list = dataclasses.field(default_factory=list)
    commit_s: list = dataclasses.field(default_factory=list)
    h2d_bytes: list = dataclasses.field(default_factory=list)
    d2h_bytes: list = dataclasses.field(default_factory=list)
    rows_written: list = dataclasses.field(default_factory=list)


def _owner_of(bounds: np.ndarray, ptr: np.ndarray) -> np.ndarray:
    shard = np.searchsorted(bounds, ptr, side="right").astype(np.int64) - 1
    P = len(bounds) - 1
    valid = (ptr >= 0) & (ptr < bounds[-1]) & (shard >= 0) & (shard < P)
    return np.where(valid, shard, NULL).astype(np.int32)


def _serve_np(owner: np.ndarray, rec_id: np.ndarray, rep) -> np.ndarray:
    """The switch's serve map (``routing._serve_shard``) in numpy: the shard
    that serves a read at ``owner``'s range under the replication policy.
    ``rep = (replica_map, dead_mask, policy)`` or None (the identity).  A
    copy on purpose, as the reference's oracle keeps its own: this executor
    checks the dispatched run, so it shares none of its code."""
    if rep is None:
        return owner
    replica_map, dead_mask, policy = rep
    P = len(replica_map)
    safe = np.clip(owner, 0, P - 1)
    alt = replica_map[safe]
    has_alt = (alt >= 0) & (owner >= 0) & ~dead_mask[np.clip(alt, 0, P - 1)]
    dead = dead_mask[safe]
    if policy == "spread":
        redirect = has_alt & (dead | (rec_id % 2 == 1))
    elif policy == "failover":
        redirect = has_alt & dead
    else:  # "primary"
        redirect = np.zeros_like(has_alt)
    return np.where(redirect, alt, owner).astype(np.int32)


def _decide_and_send(pool, bounds, s, P, *, capacity, drain_done, MB, rep=None):
    """The switch decision: fault-mark, compute destinations (staged
    mutations route to their commit shard; reads through the serve map
    ``rep``), park overflow, extract leavers.  Returns the per-destination
    send blocks and blanks leavers in place."""
    status = pool[:, F_STATUS]
    valid = status != STATUS_EMPTY
    active = status == STATUS_ACTIVE

    if MB is not None:
        m_op = pool[:, MB]
        pendm = m_op != M_NONE
        is_alloc = m_op == M_ALLOC
        towner = _owner_of(bounds, pool[:, MB + 1])
    else:
        pendm = np.zeros(len(pool), bool)

    owner = _owner_of(bounds, pool[:, F_PTR])
    bad = active & (owner == NULL) & ~pendm
    if MB is not None:
        bad_mut = active & pendm & ~is_alloc & (towner == NULL)
        bad = bad | bad_mut
        pool[bad_mut, MB] = M_NONE
        pendm = pendm & ~bad_mut
    pool[bad, F_STATUS] = STATUS_FAULT
    active = pool[:, F_STATUS] == STATUS_ACTIVE

    serve = _serve_np(owner, pool[:, F_ID], rep)
    if drain_done:
        dest = np.where(active, serve, s)
    else:
        dest = np.where(active, serve, pool[:, F_HOME])
    if MB is not None:
        cdest = np.where(is_alloc, pool[:, F_HOME], towner)
        dest = np.where(active & pendm, cdest, dest)
    dest = np.where(valid, dest, s).astype(np.int32)

    # each destination takes its first `capacity` movers in pool order;
    # the overflow parks in place for the next superstep
    movers = np.flatnonzero(valid & (dest != s))
    send, n_routed = [], 0
    for d in range(P):
        r = movers[dest[movers] == d][:capacity]
        pool[r, F_HOPS] += 1
        send.append(pool[r].copy())
        pool[r, F_STATUS] = STATUS_EMPTY
        n_routed += len(r)
    return send, n_routed


def _merge(kept, arrivals, L):
    both = np.concatenate([kept, arrivals], axis=0) if len(arrivals) else kept
    is_empty = both[:, F_STATUS] == STATUS_EMPTY
    order = np.argsort(is_empty, kind="stable")
    merged = both[order][:L]
    dropped = int((~is_empty).sum()) - int(
        (merged[:, F_STATUS] != STATUS_EMPTY).sum()
    )
    return merged, dropped


def _remote_count(pool, bounds, s, MB, rep=None):
    active = pool[:, F_STATUS] == STATUS_ACTIVE
    owner = _owner_of(bounds, pool[:, F_PTR])
    if MB is not None:
        m_op = pool[:, MB]
        towner = np.where(
            m_op == M_ALLOC, pool[:, F_HOME], _owner_of(bounds, pool[:, MB + 1])
        )
        owner = np.where(m_op != M_NONE, towner, owner)
    else:
        owner = _serve_np(owner, pool[:, F_ID], rep)
    return int((active & (owner != s)).sum())


def _chase(it, data, pool_t, *, S, MB, lo, hi, readable, max_iters, k_local, rep_kw=None):
    """``k_local`` steps of one shard's pool (an (L, R) tensor on the
    arena's device) over its rows ``[lo, hi)`` of ``data``, the whole
    arena; returns the new pool tensor.  ``rep_kw`` (replicated reads) are
    ``step_batch``'s replica-window arguments and the served ``local_hi``."""
    ptr = pool_t[:, F_PTR]
    scr = pool_t[:, F_SCRATCH : F_SCRATCH + S]
    st = pool_t[:, F_STATUS]
    iters = pool_t[:, F_ITERS]
    args = {**dict(max_iters=max_iters, local_lo=lo, local_hi=hi, perm_ok=readable),
            **(rep_kw or {})}
    if MB is None:
        for _ in range(k_local):
            ptr, scr, st, iters = step_batch(it, data[lo:hi], ptr, scr, st, iters, **args)
        tail = []
    else:
        mut = pool_t[:, MB:]
        for _ in range(k_local):
            ptr, scr, st, iters, mut = mut_step_batch(
                it, data, ptr, scr, st, iters, mut, **args)
        tail = [mut]
    return torch.cat([pool_t[:, :F_PTR], ptr[:, None], st[:, None], iters[:, None],
                      pool_t[:, F_HOPS : F_SCRATCH], scr, *tail], 1)


def sequential_commit_execute(
    it: PulseIterator,
    arena: Arena,
    ptr0,
    scratch0,
    *,
    max_iters: int = 1 << 30,
    k_local: int = 4,
    max_supersteps: int = 1 << 16,
    compact: bool = True,
    min_link_capacity: int = 8,
    fault_injector=None,
    replication=None,
    trace: CommitTrace | None = None,
):
    """Run a batch to completion under the sequential-commit schedule.

    Returns ``(records (B, R) int32 numpy ordered by id, RoutingStats, new
    Arena)`` for mutating iterators, or ``(records, RoutingStats)`` for
    read-only ones, as the JAX package's executor does.  The new arena lives
    on the input arena's device; the input arena is never modified.

    ``fault_injector`` (``core.faults.FaultInjector``): a targeted kill
    raises before the named (1-based) superstep runs, and the mutated
    copies are discarded, so the input arena stays as it was.  Fabric loss
    and delay do not apply (this schedule has no fabric).

    ``replication`` (``routing.ReplicaContext``, read iterators): the
    oracle of the device read fan-out.  A holder serves its primary's
    range from this executor's own copy of the primary's rows (replicas
    are bit-identical by construction), so a dispatched replicated run
    must match it bit for bit, hops and supersteps included.

    ``trace``, when given, is filled with the split of the wall time and
    the bytes moved (``CommitTrace``).
    """
    kill_at = None
    if fault_injector is not None:
        kill_at = fault_injector.kill_step(fault_injector.begin_call())
    if replication is not None and it.mutates:
        raise ValueError(
            "replication serves the READ path only; the write path commits "
            "through the primary and ships the log to the replica"
        )
    P = arena.num_shards
    dev = arena.data.device
    bounds = arena.bounds.cpu().numpy()
    perms = arena.perms.cpu().numpy()
    dev_data = arena.data.clone()  # the chase's private copy
    data = arena.data.cpu().numpy().copy()  # the commits' host mirror
    heap = arena.heap.cpu().numpy().copy()
    commits0 = int(heap[:, H_COMMITS].sum())
    epochs0 = int(heap[:, H_EPOCH].sum())
    mutate = it.mutates
    S = it.scratch_words
    W = data.shape[1]
    MB = F_SCRATCH + S if mutate else None
    R = routing.record_width(S, mut_width(W) if mutate else 0)

    ptr0 = torch.as_tensor(ptr0).cpu().numpy().astype(np.int32)
    B = len(ptr0)
    scratch0 = torch.as_tensor(scratch0).cpu().numpy().astype(np.int32).reshape(B, S)
    Bp = ((B + P - 1) // P) * P
    L = Bp
    rec = np.zeros((Bp, R), np.int32)
    rec[:, F_STATUS] = STATUS_EMPTY
    rec[:B, F_ID] = np.arange(B)
    rec[:B, F_PTR] = ptr0
    rec[:B, F_STATUS] = STATUS_ACTIVE
    rec[:B, F_SCRATCH : F_SCRATCH + S] = scratch0
    home = np.arange(Bp, dtype=np.int32) % P
    rec[:, F_HOME] = home
    rec_sorted = rec[np.argsort(home, kind="stable")]
    counts = np.bincount(home, minlength=P)
    pools = np.zeros((P, L, R), np.int32)
    pools[:, :, F_STATUS] = STATUS_EMPTY
    off = 0
    for s in range(P):
        c = int(counts[s])
        pools[s, :c] = rec_sorted[off : off + c]
        off += c

    base_capacity = L // P
    readable = (perms & PERM_READ) == PERM_READ
    writable = (perms & PERM_WRITE) == PERM_WRITE
    pool_bytes = L * R * 4

    rep_np = primary_map = dead_np = None
    if replication is not None:
        plan = replication.plan
        primary_map = np.asarray(plan.primary_map, np.int32)
        dead_np = torch.as_tensor(replication.dead_mask).cpu().numpy().astype(bool)
        rep_np = (np.asarray(plan.replica_map, np.int32), dead_np, plan.policy)

    routed_per_step, active_per_step = [], []
    wire_words_per_step, capacity_per_step = [], []
    local_only_steps = 0
    steps = 0
    n_active, n_remote = B, B
    for _ in range(max_supersteps):
        # an injected shard death fires before the targeted (1-based)
        # superstep: the mutated copies are dropped, never published
        if kill_at is not None and steps + 1 >= kill_at:
            fault_injector.fire(steps + 1)
        # ---- local phase: chase then commit, shard by shard ---------------
        chase_s = commit_s = 0.0
        n_written = 0
        for s in range(P):
            t0 = time.perf_counter()
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            rep_kw = None
            if replication is not None:
                # shard s doubles as the replica holder of primary_map[s]:
                # it serves the primary's range when the policy spreads or
                # the primary is dead (never while itself dead), and a dead
                # shard serves nothing of its own
                p = int(primary_map[s])
                ps = max(p, 0)
                plo, phi = int(bounds[ps]), int(bounds[ps + 1])
                rep_kw = dict(rep_data=dev_data[plo:phi], rep_lo=plo, rep_hi=phi, rep_base=0,
                              rep_on=bool(p >= 0 and not dead_np[s]
                                          and (plan.policy == "spread" or dead_np[p])),
                              rep_perm_ok=bool(readable[ps]), local_hi=lo if dead_np[s] else hi)
            pool_t = _chase(
                it, dev_data, torch.from_numpy(pools[s]).to(dev), S=S, MB=MB,
                lo=lo, hi=hi, readable=bool(readable[s]), max_iters=max_iters,
                k_local=k_local, rep_kw=rep_kw)
            pools[s] = pool_t.cpu().numpy()
            t1 = time.perf_counter()
            chase_s += t1 - t0
            if mutate:
                written: list = []
                commit_shard(pools[s], data, heap, s, lo, hi, bool(writable[s]), written,
                             S=S, W=W)
                if written:
                    rows = np.unique(np.asarray(written, np.int64))
                    dev_data[torch.from_numpy(rows).to(dev)] = torch.from_numpy(
                        data[rows]).to(dev)
                    n_written += len(rows)
                commit_s += time.perf_counter() - t1
        if trace is not None:
            trace.chase_s.append(chase_s)
            trace.commit_s.append(commit_s)
            trace.h2d_bytes.append(P * pool_bytes + n_written * (W * 4 + 8))
            trace.d2h_bytes.append(P * pool_bytes)
            trace.rows_written.append(n_written)

        # ---- switch phase: the capacity ladder, sequentially --------------
        if compact:
            demand = (n_active + P - 1) // P
            capacity = min(
                base_capacity,
                max(min_link_capacity, routing._pow2_at_least(demand)),
            )
            do_route = n_remote > 0
        else:
            capacity, do_route = base_capacity, True
        if do_route:
            sends = []
            n_routed = 0
            for s in range(P):
                send, routed = _decide_and_send(
                    pools[s], bounds, s, P,
                    capacity=capacity, drain_done=compact, MB=MB, rep=rep_np,
                )
                sends.append(send)
                n_routed += routed
            for d in range(P):
                arrivals = np.concatenate([sends[s][d] for s in range(P)], axis=0)
                pools[d], dropped = _merge(pools[d], arrivals, L)
                if dropped:
                    raise RuntimeError(f"sequential commit: pool overflow of {dropped}")
        else:
            n_routed = 0

        steps += 1
        n_active = int((pools[:, :, F_STATUS] == STATUS_ACTIVE).sum())
        n_remote = sum(_remote_count(pools[s], bounds, s, MB, rep_np) for s in range(P))
        routed_per_step.append(n_routed)
        active_per_step.append(n_active)
        capacity_per_step.append(capacity if do_route else 0)
        wire_words_per_step.append(P * (P - 1) * capacity * R if do_route else 0)
        local_only_steps += int(not do_route)
        if n_active == 0:
            break
    else:
        raise RuntimeError(
            f"sequential_commit_execute: {n_active} records still ACTIVE "
            f"after max_supersteps={max_supersteps}"
        )

    all_rec = pools.reshape(-1, R)
    all_rec = all_rec[all_rec[:, F_STATUS] != STATUS_EMPTY]
    all_rec = all_rec[all_rec[:, F_ID] < B]
    all_rec = all_rec[np.argsort(all_rec[:, F_ID], kind="stable")]
    stats = routing.RoutingStats(
        supersteps=steps,
        crossings=all_rec[:, F_HOPS].copy(),
        routed_per_step=routed_per_step,
        active_per_step=active_per_step,
        wire_words_per_step=wire_words_per_step,
        capacity_per_step=capacity_per_step,
        local_only_steps=local_only_steps,
        schedule="sequential-oracle",
        commits=int(heap[:, H_COMMITS].sum()) - commits0,
        epochs=int(heap[:, H_EPOCH].sum()) - epochs0,
        _num_shards=P,
    )
    if not mutate:
        return all_rec, stats
    new_arena = Arena(
        data=dev_data,
        bounds=arena.bounds,
        perms=arena.perms,
        heap=torch.from_numpy(heap).to(dev),
    )
    return all_rec, stats, new_arena
