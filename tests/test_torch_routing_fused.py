"""Port parity: the device-resident schedules (``schedule="fused"`` and
``"pipelined"``) and the ring fabric of ``routing.distributed_execute``
(item 6(c)).

The same numpy inputs, made from a seed, go through the JAX package and
through the port on the CPU, and every int32 output must be bit-equal:

  * the capacity ladder on the device (``_pow2_at_least_traced``,
    ``_ladder_traced``) against the host's and the JAX package's, and
    ``capacity_rungs`` against the JAX one;
  * the ring ``_exchange`` against the dense one, P = 1 to 8;
  * every schedule and fabric against the port's dispatched dense run at
    P = 2, 4 and 8: reads on the five structures and the hash ISA, compact
    and not, and the ``return_to_cpu`` ablation (the writes are
    ``tests/test_torch_routing_fused_write.py``): records and every stats
    field the JAX package reports on those schedules;
  * against the JAX ``distributed_execute(schedule=..., fabric=...)`` at
    P = 1 in this process, and at P = 4 in one subprocess: this file run as
    a script, with four host devices in the subprocess's environment alone
    (JAX fixes its device count when it starts, and this process keeps one);
  * a kill on both schedules, and the runner cache.

The tests marked ``gpu`` (``pytest -m gpu`` on the card, which has no JAX)
hold every schedule and fabric on the card against a CPU copy, count the
captures, replay a chunk under ``torch.cuda.set_sync_debug_mode("error")``
and count a call's host reads.

Run as a script (``python tests/test_torch_routing_fused.py OUT.npz`` with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``) it writes the JAX
package's four-device results to OUT.npz."""

import dataclasses
import json
import math
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
try:
    import jax
    import jax.numpy as jnp

    from repro.core import routing as jrouting
except ImportError:  # the card's machine has no JAX; its gpu tests need none
    jax = None
from repro_torch.core import arena as tarena
from repro_torch.core import faults as tfaults
from repro_torch.core import iterator as titer
from repro_torch.core import routing as trouting
from repro_torch.core.structures import btree as tbtree
from repro_torch.core.structures import hash_table as thash

if jax is not None:
    from test_torch_routing import _hash_isa, _structure
    from test_torch_routing_write import _phases

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
STRUCTURES = ("list", "bst", "btree", "hash", "skip", "hash_isa")
DEVICE_RESIDENT = [("fused", "dense"), ("fused", "ring"), ("pipelined", "dense"),
                   ("pipelined", "ring")]
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")


def _carry(jar, device=CPU):
    return tarena.arena_from_numpy(
        *(np.asarray(x) for x in (jar.data, jar.bounds, jar.perms, jar.heap)), device=device)


def _read_inputs(name, P):
    return _hash_isa(P) if name == "hash_isa" else _structure(name, P)


def _run(tit, tar, p0, s0, P, **kw):
    return trouting.distributed_execute(
        tit, tar, torch.as_tensor(p0), torch.as_tensor(s0),
        mesh=trouting.EmulatedMesh(P, tar.data.device.type), **kw)


def _assert_device_resident_stats(st, ref, schedule, fabric):
    """What a fused or pipelined run reports against the dispatched dense
    run ``ref``: the same supersteps, local-only steps, crossings, wire
    words, commits and epochs; aggregates only; the schedule and fabric
    asked."""
    assert (st.schedule, st.fabric, st.fused) == (schedule, fabric, True)
    assert st.supersteps == ref.supersteps and st.local_only_steps == ref.local_only_steps
    np.testing.assert_array_equal(st.crossings, ref.crossings)
    assert st.wire_words_total == ref.total_wire_words == st.total_wire_words
    assert (st.commits, st.epochs) == (ref.commits, ref.epochs)
    assert st.routed_per_step == st.active_per_step == st.wire_words_per_step == []
    assert st.capacity_per_step == []
    P = st._num_shards
    assert st.ring_hops == ((st.supersteps - st.local_only_steps) * (P - 1)
                            if fabric == "ring" else 0)


# ------------------------------- the ladder -----------------------------------


LADDER_COUNTS = np.array(sorted(set(range(4097)) | {
    2**k + d for k in range(1, 31) for d in (-1, 0, 1)}), np.int64)


@needs_jax
def test_pow2_at_least_traced_matches_jax_and_the_host():
    """Bit-equal to the JAX ``_pow2_at_least_traced`` at every count of
    0..4,096 and at 2^k - 1, 2^k, 2^k + 1 up to 2^30 + 1; equal to the host's
    ``_pow2_at_least`` from 1 to 2^30 (0 never reaches the ladder while a
    superstep is live)."""
    got = trouting._pow2_at_least_traced(torch.from_numpy(LADDER_COUNTS.astype(np.int32)))
    want = np.asarray(jax.vmap(jrouting._pow2_at_least_traced)(
        jnp.asarray(LADDER_COUNTS, jnp.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    host = (LADDER_COUNTS >= 1) & (LADDER_COUNTS <= 2**30)
    np.testing.assert_array_equal(
        got.numpy()[host], [trouting._pow2_at_least(int(n)) for n in LADDER_COUNTS[host]])


@needs_jax
@pytest.mark.parametrize("P", [1, 2, 4, 8])
@pytest.mark.parametrize("compact", [True, False], ids=["compact", "uncompacted"])
def test_ladder_traced_matches_the_host_ladder_and_jax(P, compact):
    """``(capacity, do_route)`` from device counts equals the dispatched
    loop's host ladder (``_ladder``) and the JAX ``_ladder_traced`` for
    every count of 0..4,096 and the powers of two around 2^k up to 2^30, on a
    grid of base and minimum capacities."""
    counts = LADDER_COUNTS[LADDER_COUNTS <= 2**30]
    n = torch.from_numpy(counts.astype(np.int32))
    for base, min_link in ((1, 1), (8, 8), (512, 8), (16384, 2), (4, 64)):
        kw = dict(num_shards=P, base_capacity=base, min_link_capacity=min_link,
                  compact=compact)
        for remote in (0, 5):
            cap, route = trouting._ladder_traced(n, torch.full_like(n, remote), **kw)
            cap = cap.expand(n.shape).numpy()
            route = route.expand(n.shape).numpy()
            jcap, jroute = jax.vmap(lambda a, r: jrouting._ladder_traced(a, r, **kw))(
                jnp.asarray(counts, jnp.int32), jnp.full(counts.shape, remote, jnp.int32))
            np.testing.assert_array_equal(cap, np.broadcast_to(np.asarray(jcap), n.shape))
            np.testing.assert_array_equal(route, np.broadcast_to(np.asarray(jroute), n.shape))
            host = [trouting._ladder(int(c), remote, **kw) for c in counts]
            live = counts >= 1
            np.testing.assert_array_equal(cap[live], [h[0] for h, ok in zip(host, live) if ok])
            assert list(route) == [h[1] for h in host]


@needs_jax
def test_capacity_rungs_match_jax():
    for base in (1, 2, 7, 8, 100, 4096, 65536):
        for min_link in (1, 2, 8, 64):
            assert trouting.capacity_rungs(base, min_link) == jrouting.capacity_rungs(
                base, min_link)


# ------------------------------ the ring fabric --------------------------------


@pytest.mark.parametrize("P", range(1, 9))
def test_ring_exchange_equals_the_dense_transpose(P):
    """On seeded send buffers whose self blocks are EMPTY (no record moves
    to its own shard), the ring's P - 1 distance classes give the dense
    all_to_all's arrivals bit for bit; a self block the switch never
    writes stays EMPTY on the ring."""
    g = np.random.default_rng(P)
    Cp, R = 3, 9
    send = torch.from_numpy(g.integers(-9, 1000, (P, P, Cp, R)).astype(np.int32))
    empty = trouting.empty_records(Cp, R - trouting.F_SCRATCH)
    for s in range(P):
        send[s, s] = empty
    dense = trouting._exchange(send, P, fabric="dense")
    ring = trouting._exchange(send, P, fabric="ring")
    assert ring.shape == (P, P * Cp, R) and torch.equal(ring, dense)
    send[0, 0, 0, trouting.F_STATUS] = titer.STATUS_ACTIVE
    assert torch.equal(trouting._exchange(send, P, fabric="ring")[0, :Cp], empty)
    with pytest.raises(ValueError, match="fabric"):
        trouting._exchange(send, P, fabric="torus")


# --------------- (a) against the port's dispatched dense run ------------------


@needs_jax
@pytest.mark.parametrize("compact", [True, False], ids=["compact", "uncompacted"])
@pytest.mark.parametrize("P", [2, 4, 8])
@pytest.mark.parametrize("name", STRUCTURES)
def test_read_schedules_match_the_dispatched_run(name, P, compact):
    """Fused and pipelined on both fabrics, and dispatched on the ring, the
    chase on the kernel's plain version (the card's route): records
    bit-equal to the dispatched dense run, and its superstep counts,
    crossings and wire words."""
    _, tit, jar, p0, s0, max_iters = _read_inputs(name, P)
    tar = _carry(jar)
    kw = dict(max_iters=max_iters, compact=compact, local_backend="kernel")
    rec, st = _run(tit, tar, p0, s0, P, **kw)
    ring_rec, ring_st = _run(tit, tar, p0, s0, P, fabric="ring", **kw)
    assert torch.equal(ring_rec, rec) and ring_st.fabric == "ring"
    assert dataclasses.replace(ring_st, fabric="dense", crossings=None) == dataclasses.replace(
        st, crossings=None)
    assert ring_st.ring_hops == (st.supersteps - st.local_only_steps) * (P - 1)
    for schedule, fabric in DEVICE_RESIDENT:
        got, gst = _run(tit, tar, p0, s0, P, schedule=schedule, fabric=fabric, **kw)
        assert torch.equal(got, rec), (schedule, fabric)
        _assert_device_resident_stats(gst, st, schedule, fabric)
    if compact and P == 4 and name == "list":  # the fabric was skipped and crossed
        assert st.local_only_steps > 0 and st.crossings.sum() > 0


@needs_jax
@pytest.mark.parametrize("name", ["list", "btree"])
def test_return_to_cpu_schedules_match_the_dispatched_run(name):
    """The PULSE-ACC ablation (``compact`` ignored): the home bounce on
    every schedule and fabric."""
    _, tit, jar, p0, s0, max_iters = _structure(name, 4)
    tar = _carry(jar)
    rec, st = _run(tit, tar, p0, s0, 4, max_iters=max_iters, return_to_cpu=True, compact=True)
    for schedule, fabric in DEVICE_RESIDENT:
        got, gst = _run(tit, tar, p0, s0, 4, max_iters=max_iters, return_to_cpu=True,
                        compact=True, schedule=schedule, fabric=fabric)
        assert torch.equal(got, rec), (schedule, fabric)
        _assert_device_resident_stats(gst, st, schedule, fabric)
    assert st.local_only_steps == 0 and st.crossings.sum() > 0


# ----------------- (b) against the JAX executor at P = 1 ----------------------


def _stats_json(st):
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        out[f.name] = v.tolist() if isinstance(v, np.ndarray) else v
    return json.dumps(out)


@needs_jax
@pytest.mark.parametrize("schedule,fabric", DEVICE_RESIDENT)
def test_matches_jax_at_one_shard(schedule, fabric):
    """In this process JAX sees one device: reads (the list, the hash table)
    and writes (the hash table's rw batch, B+tree updates) on the JAX
    package's same schedule and fabric, every stats field equal."""
    mesh = jax.make_mesh((1,), ("mem",))
    kw = dict(schedule=schedule, fabric=fabric, compact=True)
    for name in ("list", "hash"):
        jit_, tit, jar, p0, s0, max_iters = _read_inputs(name, 1)
        jrec, jst = jrouting.distributed_execute(
            jit_, jar, jnp.asarray(p0), jnp.asarray(s0), mesh=mesh, max_iters=max_iters, **kw)
        rec, st = _run(tit, _carry(jar), p0, s0, 1, max_iters=max_iters, **kw)
        np.testing.assert_array_equal(np.asarray(jrec), rec, err_msg=name)
        assert _stats_json(st) == _stats_json(jst), name
    for name in ("hash_mixed_rw", "btree_update"):
        jar, [(_, jit_, tit, jargs, targs, max_iters)] = _phases(name, 1)
        jrec, jst, jar2 = jrouting.distributed_execute(
            jit_, jar, *jit_.init(*jargs), mesh=mesh, max_iters=max_iters, **kw)
        rec, st, tar2 = _run(tit, _carry(jar), *tit.init(*targs), 1, max_iters=max_iters,
                             **kw)
        np.testing.assert_array_equal(np.asarray(jrec), rec, err_msg=name)
        assert _stats_json(st) == _stats_json(jst), name
        np.testing.assert_array_equal(np.asarray(jar2.data), tar2.data.numpy())
        np.testing.assert_array_equal(np.asarray(jar2.heap), tar2.heap.numpy())


# ------------- (c) against the JAX executor on four devices -------------------

# (case id, workload, distributed_execute keyword arguments)
MESH_CASES = (
    [(f"{n}-{s}-{f}", n, dict(compact=True, schedule=s, fabric=f))
     for n in ("list", "hash", "btree", "hash_isa") for s, f in DEVICE_RESIDENT]
    + [("list-return_to_cpu-fused-ring", "list",
        dict(return_to_cpu=True, compact=True, schedule="fused", fabric="ring")),
       ("list-return_to_cpu-pipelined-dense", "list",
        dict(return_to_cpu=True, schedule="pipelined", fabric="dense")),
       ("btree-uncompacted-pipelined-ring", "btree",
        dict(compact=False, schedule="pipelined", fabric="ring"))]
    + [(f"hash_mixed_rw-{s}-{f}", "hash_mixed_rw", dict(compact=True, schedule=s, fabric=f))
       for s, f in DEVICE_RESIDENT]
    + [("btree_update-uncompacted-fused-dense", "btree_update",
        dict(compact=False, schedule="fused", fabric="dense")),
       ("btree_update-uncompacted-pipelined-ring", "btree_update",
        dict(compact=False, schedule="pipelined", fabric="ring")),
       ("chain_mixed_rw-pipelined-ring", "chain_mixed_rw",
        dict(compact=True, schedule="pipelined", fabric="ring"))]
)
MUTATING = ("hash_mixed_rw", "btree_update", "chain_mixed_rw")


def _jax_mesh_script(out_path):
    """Script mode: every MESH_CASES case through the JAX package's
    ``distributed_execute`` on four host devices; outputs to ``out_path``."""
    assert jax.device_count() == 4, jax.devices()
    mesh = jax.make_mesh((4,), ("mem",))
    arrays = {}
    for cid, name, kw in MESH_CASES:
        if name in MUTATING:
            jar, [(_, jit_, _, jargs, _, max_iters)] = _phases(name, 4)
            rec, st, jar2 = jrouting.distributed_execute(
                jit_, jar, *jit_.init(*jargs), mesh=mesh, max_iters=max_iters, **kw)
            arrays[f"{cid}/data"] = np.asarray(jar2.data)
            arrays[f"{cid}/heap"] = np.asarray(jar2.heap)
        else:
            jit_, _, jar, p0, s0, max_iters = _read_inputs(name, 4)
            rec, st = jrouting.distributed_execute(
                jit_, jar, jnp.asarray(p0), jnp.asarray(s0), mesh=mesh, max_iters=max_iters,
                **kw)
        arrays[f"{cid}/records"] = np.asarray(rec)
        arrays[f"{cid}/stats"] = np.asarray(_stats_json(st))
    np.savez(out_path, **arrays)


@pytest.fixture(scope="module")
def jax_mesh_results(tmp_path_factory):
    """The JAX package's four-device results, from one subprocess whose
    environment alone carries the device count."""
    if jax is None:
        pytest.skip("needs the JAX package")
    out = tmp_path_factory.mktemp("jax_mesh_fused") / "results.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, str(Path(__file__)), str(out)], env=env,
                          capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}"
    return dict(np.load(out))


@needs_jax
@pytest.mark.parametrize("case", MESH_CASES, ids=[c[0] for c in MESH_CASES])
def test_matches_jax_on_four_devices(case, jax_mesh_results):
    """Records, every RoutingStats field and, for writes, the final
    ``data`` and ``heap`` equal the JAX package's same schedule and fabric."""
    cid, name, kw = case
    if name in MUTATING:
        jar, [(_, _, tit, _, targs, max_iters)] = _phases(name, 4)
        rec, st, tar2 = _run(tit, _carry(jar), *tit.init(*targs), 4, max_iters=max_iters, **kw)
        np.testing.assert_array_equal(jax_mesh_results[f"{cid}/data"], tar2.data.numpy())
        np.testing.assert_array_equal(jax_mesh_results[f"{cid}/heap"], tar2.heap.numpy())
    else:
        _, tit, jar, p0, s0, max_iters = _read_inputs(name, 4)
        rec, st = _run(tit, _carry(jar), p0, s0, 4, max_iters=max_iters, **kw)
    np.testing.assert_array_equal(jax_mesh_results[f"{cid}/records"], rec)
    assert json.loads(_stats_json(st)) == json.loads(str(jax_mesh_results[f"{cid}/stats"]))


# ------------------------ (d) the kill and the cache ---------------------------


@needs_jax
@pytest.mark.parametrize("schedule", ["fused", "pipelined"])
def test_a_kill_fires_at_the_reference_superstep(schedule):
    """A targeted kill halts the device loop and fires before the named
    superstep, as on the dispatched schedule, on a read and on a write
    batch; the write batch's input arena is left as it was; a kill past
    the traversal's end never fires."""
    plan = dict(kill_shard=2, kill_call=0, kill_superstep=3)
    _, tit, jar, p0, s0, max_iters = _structure("list", 4)
    tar = _carry(jar)
    for sched in ("dispatched", schedule):
        inj = tfaults.FaultInjector(tfaults.FaultPlan(**plan))
        with pytest.raises(tfaults.ShardFailure) as exc:
            _run(tit, tar, p0, s0, 4, max_iters=max_iters, compact=True, schedule=sched,
                 fault_injector=inj)
        assert (exc.value.superstep, exc.value.shard) == (3, 2), sched
    jar, [(_, _, wit, _, targs, mi)] = _phases("hash_mixed_rw", 4)
    war = _carry(jar)
    before = (war.data.clone(), war.heap.clone())
    inj = tfaults.FaultInjector(tfaults.FaultPlan(**plan))
    with pytest.raises(tfaults.ShardFailure) as exc:
        _run(wit, war, *wit.init(*targs), 4, max_iters=mi, compact=True, schedule=schedule,
             fault_injector=inj)
    assert exc.value.superstep == 3
    assert torch.equal(war.data, before[0]) and torch.equal(war.heap, before[1])
    rec, st = _run(tit, tar, p0, s0, 4, max_iters=max_iters, compact=True)
    late = tfaults.FaultInjector(tfaults.FaultPlan(**dict(plan, kill_superstep=10**6)))
    got, gst = _run(tit, tar, p0, s0, 4, max_iters=max_iters, compact=True, schedule=schedule,
                    fault_injector=late)
    assert torch.equal(got, rec) and gst.supersteps == st.supersteps


@needs_jax
def test_the_runner_cache_hits_on_the_same_key():
    """A second call with the same key builds nothing (a hit, no new trace);
    another iteration budget is the same key (the budget is a device
    operand: a hit, no new trace) and gives the dispatched run's results at
    that budget, on reads and writes; a read of another arena of the same
    shapes is a hit too, its arena copied in; a write runner serves the
    next call's committed arena."""
    trouting.reset_executable_caches()
    stats = trouting.CACHE_STATS
    _, tit, jar, p0, s0, max_iters = _structure("hash", 4)
    tar = _carry(jar)
    kw = dict(compact=True, schedule="pipelined", fabric="ring")
    first = _run(tit, tar, p0, s0, 4, max_iters=max_iters, **kw)[0]
    assert (stats.misses, stats.hits, stats.traces) == (1, 0, 1)
    assert stats.host_reads >= 1
    assert torch.equal(_run(tit, tar, p0, s0, 4, max_iters=max_iters, **kw)[0], first)
    assert (stats.misses, stats.hits, stats.traces) == (1, 1, 1)
    for budget in (3, 5):
        got, st = _run(tit, tar, p0, s0, 4, max_iters=budget, **kw)
        want, wst = _run(tit, tar, p0, s0, 4, max_iters=budget, compact=True)
        assert torch.equal(got, want) and st.supersteps == wst.supersteps
        assert (got[:, trouting.F_STATUS] == titer.STATUS_MAXED).any()
    assert (stats.misses, stats.hits, stats.traces) == (1, 3, 1)
    other = _carry(jar)
    assert torch.equal(_run(tit, other, p0, s0, 4, max_iters=max_iters, **kw)[0], first)
    assert (stats.misses, stats.hits, stats.traces) == (1, 4, 1)
    del tar, other
    assert len(trouting._FUSED_CACHE) == 1
    jar, [(_, _, wit, _, targs, mi), *_] = _phases("skiplist_insert_delete", 4)
    war = _carry(jar)
    for _ in range(2):
        _, _, war = _run(wit, war, *wit.init(*targs), 4, max_iters=mi, schedule="fused")
    assert (stats.misses, stats.traces) == (2, 2) and len(trouting._FUSED_CACHE) == 2
    budget = 7
    got, st, gar = _run(wit, war, *wit.init(*targs), 4, max_iters=budget, schedule="fused")
    want, wst, har = _run(wit, war, *wit.init(*targs), 4, max_iters=budget)
    assert (stats.misses, stats.traces) == (2, 2)
    assert torch.equal(got, want) and st.supersteps == wst.supersteps
    assert (got[:, trouting.F_STATUS] == titer.STATUS_MAXED).any()
    assert torch.equal(gar.data, har.data) and torch.equal(gar.heap, har.heap)
    trouting.reset_executable_caches()
    assert len(trouting._FUSED_CACHE) == 0 and stats.traces == 0


def test_unknown_schedules_and_fabrics_raise():
    ar = tarena.make_arena(np.zeros((8, 4), np.int32), num_shards=2, device=CPU)
    it = thash.find_iterator(4)
    p0 = torch.zeros(2, dtype=torch.int32)
    s0 = torch.zeros((2, it.scratch_words), dtype=torch.int32)
    mesh = trouting.EmulatedMesh(2, CPU)
    with pytest.raises(ValueError, match="schedule"):
        trouting.distributed_execute(it, ar, p0, s0, mesh=mesh, schedule="overlapped")
    with pytest.raises(ValueError, match="fabric"):
        trouting.distributed_execute(it, ar, p0, s0, mesh=mesh, schedule="fused",
                                     fabric="torus")


# --------------------------------- the card -----------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with pytest -m gpu")


def _card_read(body, P=4, n=3000, B=2048, seed=11):
    """(arena on the card, iterator, ptr0, scr0): the hash table (its
    native body, or the ISA ``hash_find``) or the B+tree, interleaved."""
    from repro_torch.core import isa as tisa
    from repro_torch.core.structures import isa_programs as tprogs

    g = np.random.default_rng(seed)
    keys = np.sort(g.choice(10**6, n, replace=False)).astype(np.int32)
    vals = g.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    q = torch.from_numpy(np.concatenate([keys[g.integers(0, n, B - B // 8)],
                                         g.integers(10**6, 2 * 10**6, B // 8)]).astype(np.int32))
    kw = dict(num_shards=P, policy="interleaved", device="cuda")
    if body == "btree_find":
        ar, root, _ = tbtree.build(keys, vals, **kw)
        it = tbtree.find_iterator()
        return ar, it, *it.init(q.cuda(), root)
    ar, heads = thash.build(keys, vals, 64, **kw)
    it = thash.find_iterator(64)
    p0, s0 = it.init(q.cuda(), torch.as_tensor(heads).cuda())
    if body == "isa":
        it = tisa.as_pulse_iterator(tprogs.hash_find_program())
    return ar, it, p0, s0


def _to_cpu(ar):
    return tarena.arena_from_numpy(*(t.cpu().numpy() for t in (ar.data, ar.bounds, ar.perms,
                                                               ar.heap)), device=CPU)


def _card_write(P=4, seed=3):
    """A mixed find/insert/delete batch over a writable hash table: (arena
    builder, iterator, init arguments)."""
    rng = np.random.default_rng(seed)
    NB, n = 64, 2000
    keys = rng.choice(np.arange(10**6), n, replace=False).astype(np.int32)
    per = -(-(n + NB + 1024) // P)
    b = tarena.ArenaBuilder(per * P, 4, num_shards=P, policy="interleaved")
    sent = thash.build_writable(b, keys, keys + 1, NB)
    kb = thash._np_hash(keys, NB)
    victims = np.array([keys[np.flatnonzero(kb == bk)[0]] for bk in range(0, NB, 2)], np.int32)
    ins = np.arange(2 * 10**6, 2 * 10**6 + 256, dtype=np.int32)
    finds = rng.choice(np.setdiff1d(keys, victims), 512).astype(np.int32)
    ops = np.concatenate([np.zeros(512), np.ones(256), np.full(len(victims), 2)]).astype(np.int32)
    qk = np.concatenate([finds, ins, victims]).astype(np.int32)
    return b, thash.rw_iterator(NB), (ops, qk, qk * 3, sent)


@pytest.mark.gpu
@pytest.mark.parametrize("compact", [True, False], ids=["compact", "uncompacted"])
@pytest.mark.parametrize("body", ["hash_find", "isa", "btree_find"])
def test_schedules_on_card_match_cpu_copy(body, compact):
    """Every schedule and fabric on the card, the chase on the kernel, equal
    the same call on a CPU copy: records and every stats field; one capture
    per key, none on the second call."""
    _card()
    from repro_torch.kernels.pulse_chase import ops as chase_ops

    ar, it, p0, s0 = _card_read(body)
    cpu = _to_cpu(ar)
    kw = dict(max_iters=4096, compact=compact)
    for schedule, fabric in [("dispatched", "ring")] + DEVICE_RESIDENT:
        traces = trouting.CACHE_STATS.traces
        launches = chase_ops.pulse_chase.launches
        rec, st = _run(it, ar, p0, s0, 4, schedule=schedule, fabric=fabric, **kw)
        if schedule != "dispatched":
            assert trouting.CACHE_STATS.traces == traces + 1
            assert chase_ops.pulse_chase.launches > launches  # warmed up and captured
            again, _ = _run(it, ar, p0, s0, 4, schedule=schedule, fabric=fabric, **kw)
            assert trouting.CACHE_STATS.traces == traces + 1 and torch.equal(again, rec)
        crec, cst = _run(it, cpu, p0.cpu(), s0.cpu(), 4, schedule=schedule, fabric=fabric, **kw)
        assert rec.is_cuda and torch.equal(rec.cpu(), crec), (schedule, fabric)
        assert _stats_json(st) == _stats_json(cst), (schedule, fabric)
    trouting.reset_executable_caches()


@pytest.mark.gpu
@pytest.mark.parametrize("schedule,fabric", DEVICE_RESIDENT)
def test_write_schedules_on_card_match_cpu_copy(schedule, fabric):
    """The mixed hash-table batch on the card (its commits on
    ``pulse_commit``, inside the captured graph) equals the CPU copy:
    records, stats, final data and heap; the input arena untouched."""
    _card()
    b, it, args = _card_write()
    outs = []
    for dev in ("cuda", "cpu"):
        ar = b.finish(device=dev)
        before = ar.data.clone()
        rec, st, ar2 = _run(it, ar, *it.init(*args), 4, max_iters=4096, compact=True,
                            schedule=schedule, fabric=fabric)
        assert torch.equal(ar.data, before)
        outs.append((rec, st, ar2))
    (g, gst, gar), (c, cst, car) = outs
    assert gar.data.is_cuda and torch.equal(g.cpu(), c)
    assert torch.equal(gar.data.cpu(), car.data) and torch.equal(gar.heap.cpu(), car.heap)
    assert _stats_json(gst) == _stats_json(cst) and cst.commits > 0
    trouting.reset_executable_caches()


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", ["fused", "pipelined"])
def test_a_replayed_chunk_makes_no_host_sync(schedule):
    """A captured chunk replays with nothing read on the host."""
    _card()
    trouting.reset_executable_caches()
    ar, it, p0, s0 = _card_read("hash_find")
    _run(it, ar, p0, s0, 4, max_iters=4096, compact=True, schedule=schedule)
    (runner,) = trouting._FUSED_CACHE.values()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runner.graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    trouting.reset_executable_caches()


DECODE_READS = 3  # the access-check elision's perms scan, the record count, the crossings


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", ["fused", "pipelined"])
def test_host_reads_per_call(schedule):
    """A captured call reads the device once a chunk, and the decode's few:
    at most ceil(supersteps / CHUNK) + DECODE_READS synchronising calls
    (a write call reads its heap instead of the perms)."""
    _card()
    ar, it, p0, s0 = _card_read("hash_find")
    kw = dict(max_iters=4096, compact=True, schedule=schedule)
    _run(it, ar, p0, s0, 4, **kw)
    torch.cuda.synchronize()
    reads = trouting.CACHE_STATS.host_reads
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, st = _run(it, ar, p0, s0, 4, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    chunks = trouting.CACHE_STATS.host_reads - reads
    assert chunks == math.ceil(st.supersteps / trouting.CHUNK)
    assert syncs <= chunks + DECODE_READS, (syncs, chunks, st.supersteps)
    trouting.reset_executable_caches()


if __name__ == "__main__":
    _jax_mesh_script(sys.argv[1])
