"""Port parity: the write path on the mesh (item 6(b)) -- mutating iterators
through ``routing.distributed_execute`` and ``PulseEngine(arena,
mesh=EmulatedMesh(P, device)).execute``, every shard's commit phase one
``pulse_commit`` call a superstep.

The same numpy inputs, made from a seed, go through the JAX package and
through the port on the CPU, and every int32 output must be bit-equal:

  * the port's ``distributed_execute`` on ``EmulatedMesh(P, "cpu")``
    against the JAX ``sequential_commit_execute`` at P = 2, 4 and 8,
    compacted and not, on the workloads of ``tests/test_torch_write_path.py``
    and the skip list's insert/delete (``tests/test_torch_skiplist.py``):
    records, final ``data`` and ``heap``, every ``RoutingStats`` field but
    ``schedule``;
  * against the JAX ``distributed_execute`` at P = 4 (dispatched, dense), in
    one subprocess: this file run as a script, with four host devices in the
    subprocess's environment alone (about 25-35 s on a CPU core, mostly
    compiles); ``schedule`` included;
  * ``pulse_commit``'s serial plain version and the CPU model of its CUDA
    stages (``ref.pulse_commit_staged``, the wrapper's CPU route) against
    the JAX ``_commit_phase``, jitted on the CPU for one shard at a time, on
    seeded pools of every edge case and on the card test's random pools,
    and the sort of the order key (``ref.commit_key``) against the plain
    version's lexsort;
  * the mutating local chase over all P pools in one call against the JAX
    ``_local_superstep_mut`` per shard, and ``_route_decide`` and
    ``_remote_active`` with the mutation payload against the JAX package's;
  * the engine: ``k_local`` and ``compact`` reach the write path, the
    engine on a mesh swaps in the sequential commit's arena, and a kill
    leaves the arena as it was; the refusals; the profiler spans.

The tests marked ``gpu`` (``pytest -m gpu`` on the card, which has no JAX)
hold the ``pulse_commit`` kernels against the serial plain version, on the
edge cases, on random pools and at the main path's scale (P = 4 pools of
16,384 staged stores), and a mutating batch on ``EmulatedMesh(4, "cuda")``
against its CPU copy.

Run as a script (``python tests/test_torch_routing_write.py OUT.npz`` with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``) it writes the JAX
package's four-device results to OUT.npz."""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
try:
    import jax
    import jax.numpy as jnp

    from repro.core import commit as jcommit
    from repro.core import engine as jengine
    from repro.core import iterator as jiter
    from repro.core import routing as jrouting
    from repro.core import translation as jtrans
    from repro.core.structures import linked_list as jlist
except ImportError:  # the card's machine has no JAX; its gpu tests need none
    jax = None
from repro_torch.core import arena as tarena
from repro_torch.core import engine as tengine
from repro_torch.core import faults as tfaults
from repro_torch.core import iterator as titer
from repro_torch.core import routing as trouting
from repro_torch.core.structures import hash_table as thash
from repro_torch.core.structures import linked_list as tlist
from repro_torch.kernels.pulse_commit import ops as tops
from repro_torch.kernels.pulse_commit import ref as tref

if jax is not None:
    from test_torch_skiplist import phase_inits, skiplist_insert_delete
    from test_torch_write_path import WORKLOADS, _small_list

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")
F = trouting
INT_MIN = -(2**31)
NAMES = ["chain_mixed_rw", "hash_mixed_rw", "bst_update", "btree_update", "perm_fault",
         "alloc_exhaustion", "skiplist_insert_delete"]


def _carry(jar):
    return tarena.arena_from_numpy(
        *(np.asarray(x) for x in (jar.data, jar.bounds, jar.perms, jar.heap)), device=CPU)


def _assert_stats_equal(js, ts, skip=()):
    names = [f.name for f in dataclasses.fields(js)]
    assert names == [f.name for f in dataclasses.fields(ts)]
    for name in names:
        if name in skip:
            continue
        a, b = getattr(js, name), getattr(ts, name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, (name, a, b)
    assert js.total_wire_words == ts.total_wire_words and js.ring_hops == ts.ring_hops


def _assert_arena_equal(jar, tar, msg=""):
    np.testing.assert_array_equal(np.asarray(jar.data), tar.data.numpy(), err_msg=f"data {msg}")
    np.testing.assert_array_equal(np.asarray(jar.heap), tar.heap.numpy(), err_msg=f"heap {msg}")


def _phases(name, P):
    """(JAX arena, [(phase, JAX iterator, port iterator, JAX init args, port
    init args, max_iters)]) of one workload; the skip list has two phases,
    the second on the first's committed arena."""
    if name == "skiplist_insert_delete":
        jar, _, _, _, phases = skiplist_insert_delete(P)
        return jar, [(ph, jit_, tit, *phase_inits(args), 4096)
                     for ph, jit_, tit, args in phases]
    jit_, tit, jar, args, max_iters = WORKLOADS[name](P, np.random.default_rng(11))
    targs = [torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray) else a for a in args]
    return jar, [(name, jit_, tit, args, targs, max_iters)]


def _port_mesh(tit, tar, tinit, P, **kw):
    return trouting.distributed_execute(tit, tar, *tinit, mesh=trouting.EmulatedMesh(P, CPU),
                                        **kw)


# -------------- (a) against the JAX sequential commit, P = 2, 4, 8 -------------


@needs_jax
@pytest.mark.parametrize("compact", [True, False], ids=["compact", "uncompacted"])
@pytest.mark.parametrize("P", [2, 4, 8])
@pytest.mark.parametrize("name", NAMES)
def test_distributed_write_matches_jax_sequential_commit(name, P, compact):
    """Records, final data and heap, and every RoutingStats field but
    ``schedule`` equal the JAX sequential commit; the input arena is left
    as it was."""
    jar, phases = _phases(name, P)
    tar = _carry(jar)
    for phase, jit_, tit, jargs, targs, max_iters in phases:
        jrec, jst, jar2 = jcommit.sequential_commit_execute(
            jit_, jar, *jit_.init(*jargs), max_iters=max_iters, compact=compact)
        before = (tar.data.clone(), tar.heap.clone())
        rec, st, tar2 = _port_mesh(tit, tar, tit.init(*targs), P, max_iters=max_iters,
                                   compact=compact)
        assert rec.dtype == torch.int32 and rec.shape[1] == trouting.record_width(
            tit.scratch_words, tarena.mut_width(tar.node_words))
        np.testing.assert_array_equal(jrec, rec, err_msg=f"records ({phase})")
        _assert_stats_equal(jst, st, skip=("schedule",))
        assert st.schedule == "dispatched" and jst.schedule == "sequential-oracle"
        _assert_arena_equal(jar2, tar2, phase)
        assert torch.equal(tar.data, before[0]) and torch.equal(tar.heap, before[1])
        assert tar2.bounds is tar.bounds and tar2.perms is tar.perms
        status = rec[:, F.F_STATUS]
        if name in ("perm_fault", "alloc_exhaustion"):
            assert (status == titer.STATUS_FAULT).all()
        else:
            assert (status == titer.STATUS_DONE).all() and st.commits > 0
        jar, tar = jar2, tar2
    if compact and P == 4 and name == "chain_mixed_rw":
        assert st.local_only_steps > 0 and st.crossings.sum() > 0


# ------------- (b) against the JAX executor on four devices -------------------

# (case id, workload, compact)
MESH_CASES = [(f"{n}-{c}", n, c == "compact") for n in ("hash_mixed_rw", "btree_update")
              for c in ("compact", "uncompacted")] + [
    ("chain_mixed_rw-compact", "chain_mixed_rw", True),
    ("perm_fault-compact", "perm_fault", True)]


def _stats_json(st):
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        out[f.name] = v.tolist() if isinstance(v, np.ndarray) else v
    return json.dumps(out)


def _jax_mesh_script(out_path):
    """Script mode: every MESH_CASES case through the JAX package's
    ``distributed_execute`` on four host devices; outputs to ``out_path``."""
    assert jax.device_count() == 4, jax.devices()
    mesh = jax.make_mesh((4,), ("mem",))
    arrays = {}
    for cid, name, compact in MESH_CASES:
        jar, [(_, jit_, _, jargs, _, max_iters)] = _phases(name, 4)
        rec, st, jar2 = jrouting.distributed_execute(
            jit_, jar, *jit_.init(*jargs), mesh=mesh, max_iters=max_iters, compact=compact,
            schedule="dispatched")
        arrays[f"{cid}/records"] = np.asarray(rec)
        arrays[f"{cid}/stats"] = np.asarray(_stats_json(st))
        arrays[f"{cid}/data"] = np.asarray(jar2.data)
        arrays[f"{cid}/heap"] = np.asarray(jar2.heap)
    np.savez(out_path, **arrays)


@pytest.fixture(scope="module")
def jax_mesh_results(tmp_path_factory):
    """The JAX package's four-device results, from one subprocess whose
    environment alone carries the device count."""
    if jax is None:
        pytest.skip("needs the JAX package")
    out = tmp_path_factory.mktemp("jax_mesh_write") / "results.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, str(Path(__file__)), str(out)], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}"
    return dict(np.load(out))


@needs_jax
@pytest.mark.parametrize("case", MESH_CASES, ids=[c[0] for c in MESH_CASES])
def test_distributed_write_matches_jax_on_four_devices(case, jax_mesh_results):
    """Dense dispatched schedule, compacted and not: records, final data
    and heap, and every RoutingStats field, ``schedule`` included."""
    cid, name, compact = case
    jar, [(_, _, tit, _, targs, max_iters)] = _phases(name, 4)
    rec, st, tar2 = _port_mesh(tit, _carry(jar), tit.init(*targs), 4, max_iters=max_iters,
                               compact=compact)
    np.testing.assert_array_equal(jax_mesh_results[f"{cid}/records"], rec)
    assert json.loads(_stats_json(st)) == json.loads(str(jax_mesh_results[f"{cid}/stats"]))
    np.testing.assert_array_equal(jax_mesh_results[f"{cid}/data"], tar2.data.numpy())
    np.testing.assert_array_equal(jax_mesh_results[f"{cid}/heap"], tar2.heap.numpy())


# ------------------- (c) the commit phase's plain version ---------------------

COMMIT_CASES = ["cas_hit_miss", "store_race", "free_then_alloc", "double_free",
                "alloc_exhaustion", "write_denied", "wide_mask_w40", "nothing_eligible",
                "cas_store_run12", "free_then_bump"]
MAIN_PATH_SHAPES = ["distinct", "racing", "alloc_overflow"]  # _main_path_pools


def _commit_case(case, seed=0):
    """(data (cap, W), heap (P, 4), bounds, perms, pools (P, L, R), S) int32
    numpy for one edge case of the commit phase: P = 2 shards of 16 rows,
    records at random slots with ids in [0, L), beside records no shard
    may commit (EMPTY, or staged at another shard's rows)."""
    g = np.random.default_rng(seed)
    P, rows, S = 2, 16, 3
    L = 16 if case == "cas_store_run12" else 12  # a run of 12 and its neighbours
    W = 40 if case == "wide_mask_w40" else 4
    cap = P * rows
    data = g.integers(-50, 50, (cap, W)).astype(np.int32)
    bounds = np.arange(P + 1, dtype=np.int32) * rows
    perms = np.full(P, tarena.PERM_READ | tarena.PERM_WRITE, np.int32)
    heap = np.zeros((P, tarena.HEAP_WORDS), np.int32)
    heap[:, tarena.H_FREE] = tarena.NULL
    heap[:, tarena.H_BUMP] = bounds[1:] - 4  # four spare rows a shard
    heap[:, tarena.H_EPOCH] = [3, 5]
    heap[:, tarena.H_COMMITS] = [40, 7]
    R = trouting.record_width(S, tarena.mut_width(W))
    MB = trouting.F_SCRATCH + S
    pools = np.zeros((P, L, R), np.int32)
    pools[..., F.F_STATUS] = titer.STATUS_EMPTY
    ids = np.stack([g.permutation(L) for _ in range(P)])  # distinct ids in [0, L)
    recs = []  # (shard, op, tgt, mask, expect, data row or None, home)
    M = tarena

    def rec(s, op, tgt, mask=-1, expect=0, home=None, row=None):
        recs.append((s, op, tgt, mask, expect, row, s if home is None else home))

    if case == "cas_hit_miss":
        rec(0, M.M_CAS, 3, 0b0100, int(data[3, 2]))  # hit on word 2
        rec(0, M.M_CAS, 5, 0b0110, int(data[5, 1]) + 1)  # miss on word 1
        rec(0, M.M_CAS, 7, 0, int(data[7, 0]))  # an empty mask compares word 0
        rec(1, M.M_CAS, 20, 1 << 9, int(data[20, 0]))  # no word selected at W = 4: word 0
        rec(1, M.M_CAS, 21, 0b1000, int(data[21, 3]) - 1)
    elif case == "store_race":
        for mask in (0b0011, 0b0110, -1, 0b1000):
            rec(0, M.M_STORE, 6, mask)
        rec(1, M.M_STORE, 25, 0b0101)
        rec(1, M.M_CAS, 25, 0b0001, 0)
    elif case == "free_then_alloc":
        rec(0, M.M_ALLOC, 1, 0b0011)  # pops the slot the FREE pushed
        rec(0, M.M_FREE, 9)
        rec(0, M.M_FREE, 4)
        rec(0, M.M_ALLOC, 0, -1)
        rec(0, M.M_ALLOC, 2, 0b0101)  # the free list is empty again: bump
        rec(1, M.M_ALLOC, -7, -1)  # scratch index clipped to 0
        rec(1, M.M_STORE, 17, -1)
    elif case == "double_free":
        rec(0, M.M_FREE, 9)
        rec(0, M.M_FREE, 9)  # row 9 now links to itself
        for t in range(3):  # each ALLOC stages word 0, which the next pop follows
            rec(0, M.M_ALLOC, t, 0b0001)
    elif case == "alloc_exhaustion":
        for t in range(6):  # four spare rows on shard 1: the last two fault
            rec(1, M.M_ALLOC, t % S, 0b0001)
        rec(0, M.M_ALLOC, 99, 0b1111)  # scratch index clipped to S - 1
    elif case == "write_denied":
        perms[1] = tarena.PERM_READ
        rec(1, M.M_STORE, 18, -1)
        rec(1, M.M_ALLOC, 0, -1)
        rec(1, M.M_FREE, 30)
        rec(0, M.M_STORE, 2, 0b0001)
    elif case == "wide_mask_w40":
        rec(0, M.M_STORE, 3, INT_MIN | 1)  # words 0 and 31..39
        rec(0, M.M_STORE, 4, 1 << 30)  # word 30 alone
        rec(0, M.M_CAS, 5, INT_MIN, int(data[5, 31]))  # the lowest selected word is 31
        rec(1, M.M_CAS, 19, INT_MIN | (1 << 12), int(data[19, 12]) + 1)
        rec(1, M.M_ALLOC, 1, INT_MIN)
    elif case == "cas_store_run12":
        # twelve racing writers of slot 6 in id order: a CAS hits only on
        # what the run's earlier records left in word 0
        for t in range(5):
            rec(0, M.M_STORE, 6, -1, row=np.full(W, 1000 + t))
        for t in range(5):
            rec(0, M.M_CAS, 6, 0b0001, 1000 + t, row=np.full(W, 2000 + t))
        for _ in range(2):
            rec(0, M.M_CAS, 6, 0b0011, int(data[6, 0]), row=np.full(W, 3000))
        rec(0, M.M_STORE, 7, 0b0010)  # a neighbour slot, applied beside the run
    elif case == "free_then_bump":
        # more ALLOCs than freed rows: the pops end and the bump takes over
        for t in (9, 4, 11):
            rec(0, M.M_FREE, t)
        for t in range(6):
            rec(0, M.M_ALLOC, t % S, 0b0101)
        rec(1, M.M_FREE, 17)
        for t in range(7):  # one pop, four spare rows, two faults
            rec(1, M.M_ALLOC, t % S, -1)
    # records no shard commits here: EMPTY, staged elsewhere, or homed elsewhere
    rec(0, M.M_STORE, 20, -1)  # shard 1's row, still at shard 0
    rec(1, M.M_ALLOC, 0, -1, home=0)
    if case != "nothing_eligible":
        rec(1, M.M_FREE, 3)
    slots = [0] * P
    for s, op, tgt, mask, expect, row, home in recs:
        r = pools[s, slots[s]]
        r[F.F_ID] = ids[s, slots[s]]
        slots[s] += 1
        r[F.F_HOME], r[F.F_PTR] = home, int(g.integers(0, cap))
        r[F.F_STATUS], r[F.F_ITERS], r[F.F_HOPS] = titer.STATUS_ACTIVE, 2, 1
        r[F.F_SCRATCH:MB] = g.integers(-9, 9, S)
        r[MB : MB + 4] = op, tgt, mask, expect
        r[MB + 4 :] = g.integers(100, 200, W) if row is None else row
    e = pools[1, L - 1]  # an EMPTY record with a stale payload
    e[MB : MB + 4] = M.M_STORE, 18, -1, 0
    return data, heap, bounds, perms, pools, S


@functools.lru_cache(maxsize=None)
def _jax_commit_fn(S, W):
    """The JAX ``_commit_phase`` of one shard, jitted once per (S, W)."""
    return jax.jit(lambda pool, rows, h, lo, hi, s, ok: jrouting._commit_phase(
        pool, rows, h, lo, hi, s, ok, S=S, W=W))


def _jax_commit(data, heap, bounds, perms, pools, S):
    """The JAX ``_commit_phase`` for each shard in turn (they touch disjoint
    rows and registers)."""
    fn = _jax_commit_fn(S, data.shape[1])
    data, heap, pools = data.copy(), heap.copy(), pools.copy()
    for s in range(pools.shape[0]):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        ok = jtrans.check_access(jnp.asarray(perms), jnp.int32(s), tarena.PERM_WRITE)
        pool, rows, h = fn(pools[s], data[lo:hi], heap[s], jnp.int32(lo), jnp.int32(hi),
                           jnp.int32(s), ok)
        pools[s], data[lo:hi], heap[s] = np.asarray(pool), np.asarray(rows), np.asarray(h)
    return data, heap, pools


def _lexsort_order(pools, bounds, S):
    """Each shard's eligible records in the plain version's lexsort order."""
    MB = trouting.F_SCRATCH + S
    out = []
    for s, pool in enumerate(pools):
        op, tgt = pool[:, MB], pool[:, MB + 1]
        alloc = op == tarena.M_ALLOC
        pend = (op != tarena.M_NONE) & (pool[:, F.F_STATUS] != titer.STATUS_EMPTY)
        idx = np.flatnonzero(pend & np.where(alloc, pool[:, F.F_HOME] == s,
                                             (tgt >= bounds[s]) & (tgt < bounds[s + 1])))
        klass = np.where(alloc, 2, np.where(op == tarena.M_FREE, 1, 0))[idx]
        out.append(idx[np.lexsort((pool[idx, F.F_ID], np.where(alloc, 0, tgt)[idx], klass))])
    return out


@needs_jax
@pytest.mark.parametrize("case", COMMIT_CASES)
def test_commit_plain_version_matches_jax_commit_phase(case):
    """Pools, data and heap bit-equal to the JAX ``_commit_phase``; the
    sort of the order key gives the plain version's lexsort, every eligible
    key below the top one; on CPU tensors the wrapper runs the CPU model of
    the kernel's stages, bit-equal too, and launches nothing."""
    data, heap, bounds, perms, pools, S = _commit_case(case)
    want = _jax_commit(data, heap, bounds, perms, pools, S)
    t = [torch.from_numpy(x.copy()) for x in (pools, data, heap, bounds, perms)]
    got_pools, got_data, got_heap = tref.pulse_commit_reference(*t, scratch_words=S)
    for name, a, b in zip(("data", "heap", "pools"), want, (got_data, got_heap, got_pools)):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    key = tref.commit_key(torch.from_numpy(pools), torch.from_numpy(bounds), scratch_words=S,
                          capacity=data.shape[0])
    assert key.dtype == torch.int64
    sk, order = torch.sort(key, dim=1, stable=True)
    top = tref.key_top(data.shape[0], pools.shape[1])
    for s, idx in enumerate(_lexsort_order(pools, bounds, S)):
        assert int((sk[s] < top).sum()) == len(idx)
        np.testing.assert_array_equal(order[s, : len(idx)].numpy(), idx)
    launches = tops.pulse_commit.launches
    t = [torch.from_numpy(x.copy()) for x in (pools, data, heap, bounds, perms)]
    out = tops.pulse_commit(*t, scratch_words=S)
    assert tops.pulse_commit.launches == launches
    for a, b in zip((want[2], want[0], want[1]), out):
        np.testing.assert_array_equal(a, b.numpy())
    _check_commit_edge(case, data, heap, pools, want, S)


@needs_jax
@pytest.mark.parametrize("W", [4, 40])
def test_commit_plain_version_matches_jax_on_random_pools(W):
    """The card test's random pools (racing targets, rows freed twice,
    write-revoked shards, wide masks): the plain version bit-equal to the
    JAX ``_commit_phase``, so it is a sound oracle for the kernel."""
    for seed in range(3):
        data, heap, bounds, perms, pools, S = _card_pools(4, W, seed)
        want = _jax_commit(data, heap, bounds, perms, pools, S)
        t = [torch.from_numpy(x.copy()) for x in (pools, data, heap, bounds, perms)]
        got_pools, got_data, got_heap = tref.pulse_commit_reference(*t, scratch_words=S)
        for name, a, b in zip(("data", "heap", "pools"), want, (got_data, got_heap, got_pools)):
            np.testing.assert_array_equal(a, b.numpy(), err_msg=f"{name} seed {seed}")


def _staged_vs_serial(host):
    """The CPU model of the kernel's stages and the serial plain version on
    copies of the same inputs: ``(staged, serial)``, each (pools, data,
    heap)."""
    data, heap, bounds, perms, pools, S = host

    def fresh():
        return [torch.from_numpy(x.copy()) for x in (pools, data, heap, bounds, perms)]

    return (tref.pulse_commit_staged(*fresh(), scratch_words=S),
            tref.pulse_commit_reference(*fresh(), scratch_words=S))


@needs_jax
@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("W", [4, 20, 40])
def test_commit_staged_model_matches_jax_on_random_pools(W, seed):
    """The card test's random pools (racing runs, rows freed twice, ALLOCs
    popping slots past the shard, write-revoked shards, wide masks): the
    staged model bit-equal to the serial commit and to the JAX
    ``_commit_phase``."""
    host = _card_pools(4, W, seed)
    data, heap, bounds, perms, pools, S = host
    want = _jax_commit(data, heap, bounds, perms, pools, S)
    staged, serial = _staged_vs_serial(host)
    for name, a, b, c in zip(("pools", "data", "heap"), (want[2], want[0], want[1]), staged,
                             serial):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=f"{name} staged")
        np.testing.assert_array_equal(a, c.numpy(), err_msg=f"{name} serial")


@pytest.mark.parametrize("shape", MAIN_PATH_SHAPES)
def test_commit_staged_model_matches_serial_at_the_main_paths_shape(shape):
    """The main path's pools (every record staged, P = 4) at a small L:
    distinct slots, 10% racing, and more ALLOCs than the shards have rows;
    the staged model bit-equal to the serial commit."""
    host = _main_path_pools(1024, shape)
    staged, serial = _staged_vs_serial(host)
    for name, a, b in zip(("pools", "data", "heap"), staged, serial):
        assert torch.equal(a, b), (shape, name)


def _check_commit_edge(case, data, heap, pools, want, S):
    """The edge each case is there for really occurs."""
    new_data, new_heap, new_pools = want
    MB = trouting.F_SCRATCH + S
    st = new_pools[..., F.F_STATUS]
    if case == "cas_hit_miss":
        assert (new_data[3] != data[3]).any() and (new_data[5] == data[5]).all()
        assert (new_heap[:, tarena.H_COMMITS] - heap[:, tarena.H_COMMITS] == [3, 2]).all()
    elif case == "free_then_alloc":
        assert new_heap[0, tarena.H_FREE] == tarena.NULL  # both freed slots popped
        assert new_heap[0, tarena.H_BUMP] == heap[0, tarena.H_BUMP] + 1
    elif case == "double_free":
        # the third ALLOC pops a slot past the arena, clamped to the shard's last row
        scr = new_pools[0, :, F.F_SCRATCH:MB]
        assert (scr >= data.shape[0]).any() and (new_data[15] != data[15]).any()
        assert new_heap[0, tarena.H_BUMP] == heap[0, tarena.H_BUMP]
    elif case == "alloc_exhaustion":
        assert (st[1] == titer.STATUS_FAULT).sum() == 2
    elif case == "write_denied":
        assert (st[1] == titer.STATUS_FAULT).sum() == 3 and (new_data[16:] == data[16:]).all()
        assert (new_heap[1] == heap[1]).all() and new_heap[0, tarena.H_EPOCH] == heap[0, tarena.H_EPOCH] + 1
    elif case == "wide_mask_w40":
        assert (new_data[3, 31:] != data[3, 31:]).all() and (new_data[3, 1:31] == data[3, 1:31]).all()
        assert (new_data[5, 31:] != data[5, 31:]).all()  # the CAS hit on word 31
    elif case == "nothing_eligible":
        assert (new_data == data).all() and (new_heap == heap).all()
        assert (new_pools == pools).all()
    elif case == "cas_store_run12":
        run = (pools[0, :, MB] != tarena.M_NONE) & (pools[0, :, MB + 1] == 6)
        assert run.sum() == 12 and new_data[6, 0] != data[6, 0]
        assert (new_data[7, [0, 2, 3]] == data[7, [0, 2, 3]]).all()
    elif case == "free_then_bump":
        assert new_heap[0, tarena.H_FREE] == tarena.NULL
        assert new_heap[0, tarena.H_BUMP] == heap[0, tarena.H_BUMP] + 3
        assert new_heap[1, tarena.H_BUMP] == 2 * 16 and (st[1] == titer.STATUS_FAULT).sum() == 2
    if case != "nothing_eligible":
        assert (new_pools[..., MB] == tarena.M_NONE).sum() > (pools[..., MB] == tarena.M_NONE).sum()


# ------------- (d) the mutating chase over all P pools, and the switch ---------


def _mid_run(name, P, steps=2, perms=None, max_iters=None):
    """(JAX iterator, port iterator, data, heap, bounds, perms, pools, k_local,
    max_iters) a few port supersteps into a workload."""
    jar, [(_, jit_, tit, _, targs, mi)] = _phases(name, P)
    tar = _carry(jar)
    if perms is not None:
        tar = dataclasses.replace(tar, perms=torch.tensor(perms, dtype=torch.int32))
    mi = mi if max_iters is None else max_iters
    p0, s0 = tit.init(*targs)
    S = tit.scratch_words
    pools, _ = trouting.place_requests(p0, s0.reshape(-1, S), P,
                                       tarena.mut_width(tar.node_words))
    data, heap = tar.data.clone(), tar.heap.clone()
    step = trouting.make_superstep(tit, P, mutate=True, k_local=2, max_iters=mi,
                                   drain_done=True, link_capacity=8)
    for _ in range(steps):
        pools, data, heap, *_ = step(pools, data, heap, tar.bounds, tar.perms)
    return jit_, tit, data, heap, tar.bounds, tar.perms, pools, 3, mi


# (workload, P, perms, max_iters, supersteps before): staged writes and, on
# the BST, budgets running out occur in each
MUT_CHASE_CASES = [("hash_mixed_rw", 4, None, None, 3),
                   ("chain_mixed_rw", 4, [3, 3, 1, 3], None, 8),
                   ("btree_update", 8, [3, 2, 3, 3, 3, 1, 3, 3], None, 3),
                   ("bst_update", 2, None, 5, 4)]


@needs_jax
@pytest.mark.parametrize("case", MUT_CHASE_CASES, ids=[c[0] for c in MUT_CHASE_CASES])
def test_mut_chase_over_all_pools_matches_jax_per_shard(case):
    """One ``_local_superstep_mut`` over all P pools (the chase in one
    ``mut_step_batch`` call a step, then the commit) equals the JAX
    ``_local_superstep_mut`` per shard, with reads or writes revoked on a
    shard and budgets running out; ``mut_step_batch`` over the whole arena
    with per-record bounds equals its per-shard call."""
    name, P, perms, max_iters, steps = case
    jit_, tit, data, heap, bounds, perms_t, pools, k_local, mi = _mid_run(
        name, P, steps=steps, perms=perms, max_iters=max_iters)
    S = tit.scratch_words
    fn = jax.jit(lambda pool, rows, h, b, pm, s: jrouting._local_superstep_mut(
        jit_, pool, rows, h, b, pm, s, k_local=k_local, max_iters=mi))
    want_pools, want_data, want_heap = pools.numpy().copy(), data.numpy().copy(), heap.numpy().copy()
    b = bounds.numpy()
    for s in range(P):
        lo, hi = int(b[s]), int(b[s + 1])
        pool, rows, h = fn(want_pools[s], want_data[lo:hi], want_heap[s], jnp.asarray(b),
                           jnp.asarray(perms_t.numpy()), jnp.int32(s))
        want_pools[s], want_data[lo:hi], want_heap[s] = (np.asarray(x) for x in (pool, rows, h))
    got = trouting._local_superstep_mut(tit, pools, data.clone(), heap.clone(), bounds, perms_t,
                                        k_local=k_local, max_iters=mi)
    np.testing.assert_array_equal(want_pools, got[0].numpy())
    np.testing.assert_array_equal(want_data, got[1].numpy())
    np.testing.assert_array_equal(want_heap, got[2].numpy())
    # the port's mut_step_batch over the whole arena with per-record bounds
    # (the chase's one call a step) equals the JAX package's per-shard call
    # over the shard's rows
    MB = F.F_SCRATCH + S
    L = pools.shape[1]

    def fields(pool):
        return (pool[:, F.F_PTR], pool[:, F.F_SCRATCH:MB], pool[:, F.F_STATUS],
                pool[:, F.F_ITERS], pool[:, MB:])

    ok = (perms_t & tarena.PERM_READ) == tarena.PERM_READ
    whole = fields(pools.reshape(P * L, -1))
    for _ in range(k_local):
        whole = titer.mut_step_batch(
            tit, data, *whole, max_iters=mi, local_lo=bounds[:-1].repeat_interleave(L),
            local_hi=bounds[1:].repeat_interleave(L), perm_ok=ok.repeat_interleave(L))
    jstep = jax.jit(lambda rows, lo, hi, grant, *st: jiter.mut_step_batch(
        jit_, rows, *st, max_iters=mi, local_lo=lo, local_hi=hi, perm_ok=grant))
    for s in range(P):
        lo, hi = int(b[s]), int(b[s + 1])
        st = [jnp.asarray(x.numpy()) for x in fields(pools[s])]
        for _ in range(k_local):
            st = jstep(jnp.asarray(data[lo:hi].numpy()), jnp.int32(lo), jnp.int32(hi),
                       jnp.bool_(bool(ok[s])), *st)
        for a, x in zip(whole, st):
            np.testing.assert_array_equal(a[s * L : (s + 1) * L].numpy(), np.asarray(x))
    assert (whole[4][:, 0] != tarena.M_NONE).sum() > 0  # the commit had work


def _switch_pools(seed, P=4, L=16, S=2, W=4):
    """Seeded pools for the switch: every status, pointers in and out of the
    arena, staged mutations with mappable and unmappable targets, ALLOCs."""
    g = np.random.default_rng(seed)
    cap = P * 10
    R = trouting.record_width(S, tarena.mut_width(W))
    MB = F.F_SCRATCH + S
    pools = g.integers(-5, 50, (P, L, R)).astype(np.int32)
    pools[..., F.F_ID] = np.arange(P * L).reshape(P, L)
    pools[..., F.F_HOME] = g.integers(0, P, (P, L))
    pools[..., F.F_PTR] = g.choice([-1, 3, 12, 25, 38, cap, cap + 4], (P, L))
    pools[..., F.F_STATUS] = g.choice([0, 0, 0, 1, 2, 3, 4], (P, L))
    pools[..., F.F_HOPS] = g.integers(0, 4, (P, L))
    pools[..., MB] = g.choice([tarena.M_NONE] * 3 + [tarena.M_STORE, tarena.M_CAS,
                                                     tarena.M_ALLOC, tarena.M_FREE], (P, L))
    pools[..., MB + 1] = g.choice([-1, 0, 7, 15, 22, 39, cap, cap + 9], (P, L))
    # on every shard: an active STORE and FREE with unmappable targets, an
    # active ALLOC away from home, and a staged write at a local pointer
    # whose target is remote
    for s in range(P):
        rows = pools[s, :4]
        rows[:, F.F_STATUS] = titer.STATUS_ACTIVE
        rows[:, MB] = [tarena.M_STORE, tarena.M_FREE, tarena.M_ALLOC, tarena.M_CAS]
        rows[:, MB + 1] = [cap + 1, -3, 0, ((s + 1) % P) * 10 + 2]
        rows[2, F.F_HOME] = (s + 2) % P
        rows[3, F.F_PTR] = s * 10 + 1
    bounds = np.arange(P + 1, dtype=np.int32) * 10
    return pools, bounds, MB


@needs_jax
@pytest.mark.parametrize("drain_done,capacity", [(False, None), (True, 3), (True, 1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_switch_with_staged_writes_matches_jax(seed, drain_done, capacity):
    """``_route_decide`` and ``_remote_active`` with ``mut_base`` equal the
    JAX package's per shard: payloads cleared on an unmappable target, a
    staged write sent to its target's owner, an ALLOC home, the slot order
    among a destination's movers, the parked overflow."""
    pools, bounds, MB = _switch_pools(seed)
    P, L, _ = pools.shape
    kept, send, n = trouting._route_decide(
        torch.from_numpy(pools), torch.from_numpy(bounds), P, return_to_cpu=False,
        link_capacity=capacity, drain_done=drain_done, mut_base=MB)
    remote = trouting._remote_active(torch.from_numpy(pools), torch.from_numpy(bounds), MB)
    want_n = want_remote = 0
    for s in range(P):
        jk, js, jn = jrouting._route_decide(
            jnp.asarray(pools[s]), jnp.asarray(bounds), jnp.int32(s), P, return_to_cpu=False,
            link_capacity=capacity, drain_done=drain_done, mut_base=MB)
        np.testing.assert_array_equal(np.asarray(jk), kept[s].numpy(), err_msg=f"kept {s}")
        np.testing.assert_array_equal(np.asarray(js), send[s].numpy(), err_msg=f"send {s}")
        want_n += int(jn)
        want_remote += int(jrouting._remote_active(jnp.asarray(pools[s]), jnp.asarray(bounds),
                                                   jnp.int32(s), MB))
    assert int(n) == want_n > 0 and int(remote) == want_remote > 0
    cleared = (pools[..., MB] != 0) & (kept.numpy()[..., MB] == 0)
    assert cleared.any()  # an unmappable commit target faulted


# ------------------------------- (e) the engine -------------------------------


@needs_jax
@pytest.mark.parametrize("k_local,compact", [(1, False), (2, True), (4, True)])
def test_engine_write_path_passes_k_local_and_compact(k_local, compact):
    """``PulseEngine.execute`` of a mutating iterator on one node hands
    ``k_local`` and ``compact`` to the sequential commit, as the JAX
    engine does: with ``k_local=1, compact=False`` the rw batch over the
    16-key list takes 20 supersteps in both (it took 7 in the port when the
    engine dropped them); every stats field and the arena equal."""
    jar, head, keys = _small_list(n=16, cap=128)
    ops = np.array([1, 0, 2, 0, 1], np.int32)
    qk = np.array([500, keys[2], keys[5], keys[9], 501], np.int32)
    qv = np.arange(5, dtype=np.int32)
    jit_, tit = jlist.rw_iterator(), tlist.rw_iterator()
    kw = dict(max_iters=500, k_local=k_local, compact=compact)
    jeng = jengine.PulseEngine(jar)
    jres = jeng.execute(jit_, *jit_.init(ops, qk, qv, head), **kw)
    teng = tengine.PulseEngine(_carry(jar))
    tres = teng.execute(tit, *tit.init(ops, qk, qv, head), **kw)
    _assert_stats_equal(jres.stats, tres.stats)
    for f in ("ptr", "scratch", "status", "iters"):
        np.testing.assert_array_equal(np.asarray(getattr(jres, f)), getattr(tres, f).numpy(), f)
    _assert_arena_equal(jeng.arena, teng.arena)
    if (k_local, compact) == (1, False):
        assert jres.stats.supersteps == tres.stats.supersteps == 20


@needs_jax
@pytest.mark.parametrize("name", ["hash_mixed_rw", "btree_update"])
def test_engine_on_a_mesh_swaps_in_the_committed_arena(name):
    """``PulseEngine(ar, mesh=EmulatedMesh(4, "cpu")).execute`` of a
    mutating iterator on the dispatched schedule swaps in the arena that
    the JAX sequential commit gives, with the same records and stats but
    ``schedule``; the input arena is untouched; the result carries no host
    commit trace.  ``"auto"`` resolves as the JAX engine resolves it, to
    the same records, arena and aggregates."""
    jar, [(_, jit_, tit, jargs, targs, max_iters)] = _phases(name, 4)
    jrec, jst, jar2 = jcommit.sequential_commit_execute(jit_, jar, *jit_.init(*jargs),
                                                        max_iters=max_iters, k_local=3)
    tar = _carry(jar)
    before = tar.data.clone()
    eng = tengine.PulseEngine(tar, mesh=trouting.EmulatedMesh(4, CPU))
    res = eng.execute(tit, *tit.init(*targs), max_iters=max_iters, k_local=3,
                      schedule="dispatched")
    assert eng.arena is res.arena and eng.arena is not tar and res.commit_trace is None
    _assert_arena_equal(jar2, eng.arena)
    _assert_stats_equal(jst, res.stats, skip=("schedule",))
    assert res.stats.schedule == "dispatched"
    np.testing.assert_array_equal(jrec[:, F.F_STATUS], res.status.numpy())
    np.testing.assert_array_equal(jrec[:, F.F_SCRATCH : F.F_SCRATCH + tit.scratch_words],
                                  res.scratch.numpy())
    assert torch.equal(tar.data, before)
    want = jengine.PulseEngine(jar)._resolve_schedule(jit_, "auto", True, 3)
    auto = tengine.PulseEngine(tar, mesh=trouting.EmulatedMesh(4, CPU)).execute(
        tit, *tit.init(*targs), max_iters=max_iters, k_local=3)
    assert auto.stats.schedule == want and auto.stats.fused == (want != "dispatched")
    _assert_arena_equal(jar2, auto.arena)
    _assert_stats_equal(jst, auto.stats, skip=(
        "schedule", "fused", "routed_per_step", "active_per_step", "wire_words_per_step",
        "capacity_per_step", "wire_words_total"))
    assert torch.equal(auto.status, res.status) and torch.equal(auto.scratch, res.scratch)
    assert torch.equal(tar.data, before)


@needs_jax
def test_engine_on_a_mesh_kill_leaves_the_arena():
    """A kill before superstep 3 of a mutating call on a mesh raises, the
    engine keeps its arena, and the input is untouched; the next call
    commits."""
    jar, [(_, _, tit, _, targs, max_iters)] = _phases("chain_mixed_rw", 4)
    tar = _carry(jar)
    before = (tar.data.clone(), tar.heap.clone())
    plan = tfaults.FaultPlan(kill_shard=1, kill_call=0, kill_superstep=3)
    eng = tengine.PulseEngine(tar, mesh=trouting.EmulatedMesh(4, CPU),
                              fault_injector=tfaults.FaultInjector(plan))
    with pytest.raises(tfaults.ShardFailure) as e:
        eng.execute(tit, *tit.init(*targs), max_iters=max_iters)
    assert e.value.superstep == 3 and eng.arena is tar
    assert torch.equal(tar.data, before[0]) and torch.equal(tar.heap, before[1])
    res = eng.execute(tit, *tit.init(*targs), max_iters=max_iters)
    assert (res.status == titer.STATUS_DONE).all() and eng.arena is res.arena


def _refusals():
    ar = tarena.make_arena(np.zeros((8, 4), np.int32), num_shards=2, device=CPU)
    it = tlist.insert_iterator()
    p0 = torch.zeros(2, dtype=torch.int32)
    s0 = torch.zeros((2, it.scratch_words), dtype=torch.int32)

    def run(**kw):
        return lambda: trouting.distributed_execute(it, ar, p0, s0,
                                                    mesh=trouting.EmulatedMesh(2, CPU), **kw)

    return {"return_to_cpu": (run(return_to_cpu=True), "return_to_cpu"),
            "kernel_backend": (run(local_backend="kernel"), "read-only"),
            "replication": (run(replication=object()), "READ path"),
            "elide_access_check": (run(elide_access_check=True), "read-only traversals")}


@pytest.mark.parametrize("case", ["return_to_cpu", "kernel_backend", "replication",
                                  "elide_access_check"])
def test_write_refusals_raise_value_error(case):
    fn, match = _refusals()[case]
    with pytest.raises(ValueError, match=match):
        fn()


@needs_jax
def test_profiler_spans_split_a_write_call():
    """Under the profiler a mutating call shows its placement, its decode,
    and in each superstep the chase, the commit and the switch."""
    from torch.profiler import ProfilerActivity, profile

    jar, [(_, _, tit, _, targs, max_iters)] = _phases("hash_mixed_rw", 4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, st, _ = _port_mesh(tit, _carry(jar), tit.init(*targs), 4, max_iters=max_iters,
                              compact=True)
    calls = {e.key: e.count for e in prof.key_averages() if e.key.startswith("routing.")}
    n = st.supersteps
    assert calls == {"routing.place": 1, "routing.superstep": n, "routing.chase": n,
                     "routing.commit": n, "routing.switch": n, "routing.counters": n,
                     "routing.decode": 1}


@needs_jax
def test_make_superstep_mutate_runs_the_write_superstep():
    """``make_superstep(mutate=True)`` binds ``superstep_mut``: stepped by
    hand from the placement it ends where ``distributed_execute`` does."""
    jar, [(_, _, tit, _, targs, max_iters)] = _phases("btree_update", 4)
    tar = _carry(jar)
    p0, s0 = tit.init(*targs)
    rec, st, tar2 = _port_mesh(tit, tar, (p0, s0), 4, max_iters=max_iters)
    step = trouting.make_superstep(tit, 4, mutate=True, k_local=4, max_iters=max_iters)
    pools, B = trouting.place_requests(p0, s0.reshape(-1, tit.scratch_words), 4,
                                       tarena.mut_width(tar.node_words))
    data, heap = tar.data.clone(), tar.heap.clone()
    for _ in range(st.supersteps):
        pools, data, heap, n_active, *_ = step(pools, data, heap, tar.bounds, tar.perms)
    assert int(n_active) == 0
    assert torch.equal(data, tar2.data) and torch.equal(heap, tar2.heap)
    flat = pools.reshape(-1, pools.shape[2])
    flat = flat[flat[:, F.F_STATUS] != titer.STATUS_EMPTY]
    assert torch.equal(flat[torch.argsort(flat[:, F.F_ID])], rec)


# ---------------------------------- the card ----------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with pytest -m gpu")


def _card_pools(P, W, seed):
    """Random pools of staged mutations over P shards of 64 rows, for the
    kernel: every op, racing targets (a row freed twice threads the free
    list through itself, so later ALLOCs pop slots outside the shard), wide
    masks, some shards write-revoked and some nearly out of rows."""
    g = np.random.default_rng(seed)
    rows, S, L = 64, 3, 96
    cap = P * rows
    data = g.integers(-40, 40, (cap, W)).astype(np.int32)
    bounds = np.arange(P + 1, dtype=np.int32) * rows
    perms = np.where(g.random(P) < 0.2, tarena.PERM_READ, 3).astype(np.int32)
    heap = np.zeros((P, tarena.HEAP_WORDS), np.int32)
    heap[:, tarena.H_FREE] = tarena.NULL
    heap[:, tarena.H_BUMP] = bounds[1:] - g.integers(0, 6, P)
    R = trouting.record_width(S, tarena.mut_width(W))
    MB = F.F_SCRATCH + S
    pools = g.integers(-99, 99, (P, L, R)).astype(np.int32)
    pools[..., F.F_ID] = np.stack([g.permutation(L) for _ in range(P)])
    pools[..., F.F_HOME] = g.integers(0, P, (P, L))
    pools[..., F.F_STATUS] = g.choice([0, 0, 0, 1, 4], (P, L))
    pools[..., MB] = g.choice([0, 1, 1, 2, 3, 4], (P, L))
    tgt = bounds[:-1, None] + g.integers(0, rows // 4, (P, L))  # racing on few rows
    elsewhere = g.random((P, L)) < 0.2
    pools[..., MB + 1] = np.where(elsewhere, g.integers(0, cap, (P, L)), tgt)
    pools[..., MB + 2] = g.choice([-1, 0, 1, 5, INT_MIN, INT_MIN | 3, 1 << 30, 0x0F0F], (P, L))
    cas = pools[..., MB] == tarena.M_CAS
    pools[..., MB + 3] = np.where(cas & (g.random((P, L)) < 0.5),
                                  data[np.clip(pools[..., MB + 1], 0, cap - 1), 0],
                                  pools[..., MB + 3])
    return data, heap, bounds, perms, pools, S


def _main_path_pools(L, shape, seed=0, P=4, W=20):
    """P pools of L records each, every one staged, for the commit at the
    main path's shape: ``distinct`` is ``wiredtiger_update``'s phase (STOREs
    and CASes of one word, each to its own slot of the record's shard, a
    fifth of the CASes missing), ``racing`` the same with 10% of the targets
    drawn from 64 hot slots a shard, ``alloc_overflow`` FREEs, then ALLOCs
    homed at each shard past its freed and spare rows."""
    g = np.random.default_rng(seed)
    rows, S = 2 * L, 3
    cap = P * rows
    data = g.integers(-1000, 1000, (cap, W)).astype(np.int32)
    bounds = np.arange(P + 1, dtype=np.int32) * rows
    perms = np.full(P, tarena.PERM_READ | tarena.PERM_WRITE, np.int32)
    heap = np.zeros((P, tarena.HEAP_WORDS), np.int32)
    heap[:, tarena.H_FREE] = tarena.NULL
    heap[:, tarena.H_BUMP] = bounds[1:] - L // 8
    R = trouting.record_width(S, tarena.mut_width(W))
    MB = F.F_SCRATCH + S
    pools = np.zeros((P, L, R), np.int32)
    pools[..., F.F_ID] = np.stack([g.permutation(L) for _ in range(P)])
    pools[..., F.F_HOME] = np.arange(P)[:, None]
    pools[..., F.F_STATUS] = titer.STATUS_ACTIVE
    pools[..., MB + 4 :] = g.integers(-1000, 1000, (P, L, W))
    local = np.stack([g.permutation(rows)[:L] for _ in range(P)])  # distinct slots a shard
    if shape == "racing":
        hot = g.random((P, L)) < 0.1
        local = np.where(hot, g.integers(0, 64, (P, L)), local)
    tgt = bounds[:-1, None] + local
    if shape == "alloc_overflow":
        op = np.where(np.arange(L) < L // 4, tarena.M_FREE, tarena.M_ALLOC)
        op = g.permuted(np.tile(op, (P, 1)), axis=1)
        tgt = np.where(op == tarena.M_FREE, tgt, g.integers(-2, S + 2, (P, L)))
        mask = g.choice([-1, 1, 0b0101], (P, L))
    else:
        op = np.where(g.random((P, L)) < 0.7, tarena.M_STORE, tarena.M_CAS)
        mask = 1 << g.integers(0, W, (P, L))
        word = np.argmax((mask[..., None] >> np.arange(W)) & 1, -1)
        expect = data[tgt, word] + (g.random((P, L)) < 0.2)
        pools[..., MB + 3] = expect
    pools[..., MB], pools[..., MB + 1], pools[..., MB + 2] = op, tgt, mask
    return data, heap, bounds, perms, pools, S


@pytest.mark.gpu
@pytest.mark.parametrize("W", [4, 20, 40])
@pytest.mark.parametrize("P", [1, 4, 8])
def test_pulse_commit_kernel_matches_plain_on_card(P, W):
    """One launch for all P shards: pools, data and heap bit-equal to the
    plain version on the same inputs, with nothing read on the host."""
    _card()
    for seed in range(3):
        host = _card_pools(P, W, seed)
        S = host[-1]
        cpu = [torch.from_numpy(x.copy()) for x in (host[4], host[0], host[1], host[2], host[3])]
        want = tref.pulse_commit_reference(*cpu, scratch_words=S)
        card = [t.cuda() for t in (torch.from_numpy(x.copy())
                                    for x in (host[4], host[0], host[1], host[2], host[3]))]
        before = tops.pulse_commit.launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = tops.pulse_commit(*card, scratch_words=S)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert tops.pulse_commit.launches == before + 1
        for name, a, b in zip(("pools", "data", "heap"), want, got):
            assert torch.equal(a, b.cpu()), (P, W, seed, name)


@pytest.mark.gpu
@pytest.mark.parametrize("case", COMMIT_CASES)
def test_pulse_commit_edge_cases_on_card(case):
    """The edge cases of the plain version's CPU test, on the kernel."""
    _card()
    data, heap, bounds, perms, pools, S = _commit_case(case)
    cpu = [torch.from_numpy(x.copy()) for x in (pools, data, heap, bounds, perms)]
    want = tref.pulse_commit_reference(*cpu, scratch_words=S)
    got = tops.pulse_commit(*(t.cuda() for t in (torch.from_numpy(x.copy()) for x in (
        pools, data, heap, bounds, perms))), scratch_words=S)
    torch.cuda.synchronize()
    for name, a, b in zip(("pools", "data", "heap"), want, got):
        assert torch.equal(a, b.cpu()), (case, name)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", MAIN_PATH_SHAPES)
def test_pulse_commit_kernel_at_the_main_paths_scale(shape):
    """P = 4 pools of 16,384 staged records (``wiredtiger_update``'s commit
    phase; then with 10% of the targets racing; then ALLOCs past the
    shards' rows): one commit phase on the kernels, bit-equal to the serial
    plain version, counted once, with nothing read on the host."""
    _card()
    host = _main_path_pools(16384, shape)
    data, heap, bounds, perms, pools, S = host
    cpu = [torch.from_numpy(x.copy()) for x in (pools, data, heap, bounds, perms)]
    want = tref.pulse_commit_reference(*cpu, scratch_words=S)
    card = [torch.from_numpy(x.copy()).cuda() for x in (pools, data, heap, bounds, perms)]
    before = tops.pulse_commit.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tops.pulse_commit(*card, scratch_words=S)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert tops.pulse_commit.launches == before + 1
    for name, a, b in zip(("pools", "data", "heap"), want, got):
        assert torch.equal(a, b.cpu()), (shape, name)


@pytest.mark.gpu
def test_write_batch_on_a_card_mesh_matches_cpu():
    """One mixed find/insert/delete batch over a writable hash table through
    ``PulseEngine(arena, mesh=EmulatedMesh(4, "cuda")).execute`` on the
    dispatched schedule (one ``pulse_commit`` launch a superstep, no
    ``pulse_chase`` launch) and on a CPU copy: records, stats, final data
    and heap bit-equal."""
    _card()
    from repro_torch.kernels.pulse_chase import ops as chase_ops

    rng = np.random.default_rng(3)
    NB, n, P = 64, 2000, 4
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
    it = thash.rw_iterator(NB)
    results = []
    for dev in ("cuda", "cpu"):
        ar = b.finish(device=dev)
        eng = tengine.PulseEngine(ar, mesh=trouting.EmulatedMesh(P, dev))
        commits, chases = tops.pulse_commit.launches, chase_ops.pulse_chase.launches
        res = eng.execute(it, *it.init(ops, qk, qk * 3, sent), max_iters=4096,
                          schedule="dispatched")
        if dev == "cuda":
            assert tops.pulse_commit.launches - commits == res.stats.supersteps
            assert chase_ops.pulse_chase.launches == chases
        results.append((res, eng.arena))
    (g, ga), (c, ca) = results
    assert ga.data.is_cuda and g.ptr.is_cuda
    for f in ("ptr", "scratch", "status", "iters"):
        assert torch.equal(getattr(g, f).cpu(), getattr(c, f)), f
    assert torch.equal(ga.data.cpu(), ca.data) and torch.equal(ga.heap.cpu(), ca.heap)
    _assert_stats_equal(c.stats, g.stats)
    assert (c.status == titer.STATUS_DONE).all() and c.stats.crossings.sum() > 0


if __name__ == "__main__":
    _jax_mesh_script(sys.argv[1])
