"""Port parity: replication and the overlap model (item 6(d)).

The same numpy inputs, made from a seed, go through the JAX package and the
port on the CPU; int32 state is compared bit for bit.

  * ``make_replica_plan``, ``ReplicaPlan``'s errors and the serve map
    (``_serve_shard``) against the JAX package's.
  * ``iterator.step_batch`` with a replica window, and the superstep mode's
    plain version with the replica windows (``ref.chase_superstep_reference``,
    the plain chase and the wrapper on CPU tensors) against the JAX
    ``_local_superstep(rep=...)`` per shard.
  * Replicated reads (every dead primary; policies ``failover``, ``spread``
    and ``primary``) on the five structures: against the healthy run,
    against the port's and the JAX ``sequential_commit_execute(replication=)``
    (no mesh), and against the JAX ``distributed_execute(replication=)`` in
    this process at P = 1 and at P = 4 in one subprocess (this file run as a
    script, the four host devices in its environment alone).
  * ``dispatch.schedule_decision`` and ``workload_table`` field for field,
    and ``PulseEngine``'s ``schedule="auto"`` resolution, against the JAX
    package's for every structure iterator, P in {1, 2, 4, 8} and
    ``k_local`` in {1, 4}.
  * Every refusal the reference raises, with its type and message.

The tests marked ``gpu`` (``pytest -m gpu`` on the card, which has no JAX)
hold the kernel's replica window against its plain version for the
interpreter and every native body, and a replicated routed batch and a
lossy fused batch on the card against a CPU copy.

Run as a script (``python tests/test_torch_replication.py OUT.npz`` with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``) it writes the JAX
package's four-device results to OUT.npz."""

import dataclasses
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
    from repro.core import dispatch as jdispatch
    from repro.core import engine as jengine
    from repro.core import isa as jisa
    from repro.core import iterator as jiter
    from repro.core import routing as jrouting
    from repro.core.structures import bst as jbst
    from repro.core.structures import btree as jbtree
    from repro.core.structures import hash_table as jhash
    from repro.core.structures import isa_programs as jprogs
    from repro.core.structures import linked_list as jlist
    from repro.core.structures import skiplist as jskip
except ImportError:  # the card's machine has no JAX; its gpu tests need none
    jax = None
from repro_torch.core import arena as tarena
from repro_torch.core import commit as tcommit
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import engine as tengine
from repro_torch.core import faults as tfaults
from repro_torch.core import isa as tisa
from repro_torch.core import iterator as titer
from repro_torch.core import routing as trouting
from repro_torch.core.structures import bst as tbst
from repro_torch.core.structures import btree as tbtree
from repro_torch.core.structures import hash_table as thash
from repro_torch.core.structures import isa_programs as tprogs
from repro_torch.core.structures import linked_list as tlist
from repro_torch.core.structures import skiplist as tskip
from repro_torch.kernels.pulse_chase import ops as tops
from repro_torch.kernels.pulse_chase import ref as tref

if jax is not None:
    from test_torch_routing import (
        SUPERSTEP_CASES,
        _assert_stats_equal,
        _carry,
        _stats_json,
        _structure,
        _superstep_case,
    )

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
STRUCTURES = ("list", "bst", "btree", "hash", "skip")
POLICIES = ("failover", "spread", "primary")
PAYLOAD = [trouting.F_ID, trouting.F_PTR, trouting.F_STATUS, trouting.F_ITERS]
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")


def _rep_rows(plan, data, bounds):
    """Holder ``r``'s rows of the arena's layout hold ``primary_map[r]``'s."""
    data, bounds = np.asarray(data), np.asarray(bounds)
    rows = np.zeros_like(data)
    for holder, p in enumerate(plan.primary_map):
        if p >= 0:
            rows[bounds[holder]:bounds[holder + 1]] = data[bounds[p]:bounds[p + 1]]
    return rows


def _contexts(jar, P, policy, dead):
    """The JAX and the port ``ReplicaContext`` of one plan and dead set."""
    mask = np.zeros(P, bool)
    mask[list(dead)] = True
    out = []
    for mod in (jrouting, trouting):
        plan = mod.make_replica_plan(P, policy=policy)
        out.append(mod.ReplicaContext(plan=plan, rep_rows=_rep_rows(plan, jar.data, jar.bounds),
                                      dead_mask=mask))
    return out


def _dead_sets(P, policy):
    """Every single dead primary under ``failover``; healthy and one dead
    under ``spread``; healthy under ``primary`` (a dead primary strands its
    reads there, by design)."""
    if policy == "failover":
        return [(d,) for d in range(P)]
    return [(), (1 % P,)] if policy == "spread" else [()]


# ------------------------------ (a) the plan ----------------------------------


@needs_jax
@pytest.mark.parametrize("P", [1, 2, 3, 4, 8])
def test_make_replica_plan_matches_jax(P):
    for primaries in (None, [0], list(range(0, P, 2))):
        for policy in POLICIES:
            want = jrouting.make_replica_plan(P, primaries, policy=policy)
            got = trouting.make_replica_plan(P, primaries, policy=policy)
            assert (got.primary_map, got.replica_map, got.policy) == (
                want.primary_map, want.replica_map, want.policy)
            assert got.num_shards == want.num_shards and got.replicated == want.replicated


def _plan_errors(mod):
    return [lambda: mod.ReplicaPlan((0,), (0,), policy="nearest"),
            lambda: mod.ReplicaPlan((0, 1), (0,)),
            lambda: mod.make_replica_plan(4, [0, 0])]


@needs_jax
@pytest.mark.parametrize("i", range(3), ids=["policy", "length", "holder"])
def test_replica_plan_errors_match_jax(i):
    with pytest.raises(ValueError) as want:
        _plan_errors(jrouting)[i]()
    with pytest.raises(ValueError, match=str(want.value).replace("(", r"\(").replace(")", r"\)")):
        _plan_errors(trouting)[i]()


@needs_jax
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("P", [2, 4, 8])
def test_serve_map_matches_jax(P, policy):
    """Owners (NULL among them) and ids at random, under every dead set of
    up to two shards (a dead holder is no fallback)."""
    g = np.random.default_rng(P)
    owner = g.integers(-1, P, (3, 40)).astype(np.int32)
    ids = g.integers(0, 1000, (3, 40)).astype(np.int32)
    plan = jrouting.make_replica_plan(P, policy=policy)
    for a in range(P):
        for b in (a, (a + P // 2) % P):
            dead = np.zeros(P, bool)
            dead[[a, b]] = True
            want = jrouting._serve_shard(
                jnp.asarray(owner), jnp.asarray(ids),
                (jnp.asarray(plan.replica_map, jnp.int32), jnp.asarray(dead), policy))
            got = trouting._serve_shard(
                torch.from_numpy(owner), torch.from_numpy(ids),
                (torch.tensor(plan.replica_map, dtype=torch.int32), torch.from_numpy(dead),
                 policy))
            np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert trouting._serve_shard(torch.from_numpy(owner), torch.from_numpy(ids), None) is not None


# ----------------------- (b) step_batch and the superstep ----------------------

STEP_CASES = ("window_on", "window_off", "window_revoked", "own_collapsed")


@needs_jax
@pytest.mark.parametrize("case", STEP_CASES)
def test_step_batch_with_a_replica_window_matches_jax(case):
    """One step over shard 1's rows of a four-shard list, with shard 3's
    rows as its replica window (read from a copy at ``rep_base``):
    pointers in its own range, in the window, elsewhere and NULL."""
    jit_, tit, jar, p0, s0, max_iters = _structure("list", 4)
    data, bounds = np.asarray(jar.data), np.asarray(jar.bounds)
    lo, hi, rlo, rhi = (int(x) for x in (bounds[1], bounds[2], bounds[3], bounds[4]))
    g = np.random.default_rng(4)
    B = 48
    ptr = np.concatenate([g.integers(lo, hi, 16), g.integers(rlo, rhi, 16),
                          g.integers(0, lo, 8), np.full(4, -1), g.integers(hi, rlo, 4)])
    ptr = ptr.astype(np.int32)
    scratch = np.tile(s0[:1], (B, 1)).astype(np.int32)
    scratch[:, 0] = g.integers(0, 96, B)
    status = np.where(g.random(B) < 0.85, titer.STATUS_ACTIVE, titer.STATUS_DONE).astype(np.int32)
    iters = g.integers(0, 3, B).astype(np.int32)
    rep_data = np.concatenate([np.zeros((5, data.shape[1]), np.int32), data[rlo:rhi]])
    kw = dict(local_lo=lo, local_hi=lo if case == "own_collapsed" else hi, rep_lo=rlo,
              rep_hi=rhi, rep_base=5, rep_on=case != "window_off",
              rep_perm_ok=case != "window_revoked")
    want = jiter.step_batch(jit_, jnp.asarray(data[lo:hi]), jnp.asarray(ptr),
                            jnp.asarray(scratch), jnp.asarray(status), jnp.asarray(iters),
                            max_iters=3, rep_data=jnp.asarray(rep_data), **kw)
    got = titer.step_batch(tit, torch.from_numpy(data[lo:hi].copy()), torch.from_numpy(ptr),
                           torch.from_numpy(scratch), torch.from_numpy(status),
                           torch.from_numpy(iters), max_iters=3,
                           rep_data=torch.from_numpy(rep_data),
                           **{k: torch.tensor(v) if isinstance(v, bool) else v
                              for k, v in kw.items()})
    for w, t in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), t.numpy())
    st = got[2].numpy()
    if case == "window_revoked":
        assert (st[16:32][status[16:32] == 0] == titer.STATUS_FAULT).all()
    elif case == "window_on":
        assert (got[3].numpy()[16:32] > iters[16:32]).any()


# (id, policy, dead shards)
REP_VARIANTS = [("failover-dead0", "failover", (0,)), ("spread", "spread", ()),
                ("spread-dead1", "spread", (1,)), ("primary", "primary", ())]


def _jax_superstep_rep(jit_, data, bounds, perms, pool, k_local, max_iters, plan, rows, dead):
    """The JAX ``_local_superstep(rep=...)`` of every shard, over its rows
    and its slice of the replica rows."""
    out = pool.copy()
    b = np.asarray(bounds)
    step = jax.jit(lambda pool_s, rows_s, my_shard, rep_s: jrouting._local_superstep(
        jit_, pool_s, rows_s, jnp.asarray(bounds), jnp.asarray(perms), my_shard,
        k_local=k_local, max_iters=max_iters,
        rep=(rep_s, jnp.asarray(plan.primary_map, jnp.int32), jnp.asarray(dead), plan.policy)))
    for s in range(pool.shape[0]):
        lo, hi = int(b[s]), int(b[s + 1])
        out[s] = np.asarray(step(jnp.asarray(pool[s]), jnp.asarray(data[lo:hi]), jnp.int32(s),
                                 jnp.asarray(rows[lo:hi])))
    return out


@needs_jax
@pytest.mark.parametrize("variant", REP_VARIANTS, ids=[v[0] for v in REP_VARIANTS])
@pytest.mark.parametrize("route", ["torch", "isa"])
@pytest.mark.parametrize("case", SUPERSTEP_CASES)
def test_superstep_plain_version_with_replicas_matches_jax(case, route, variant):
    """The plain version of the superstep mode with the replica windows
    (and the plain chase, and the wrapper on CPU tensors) equals the JAX
    ``_local_superstep(rep=...)`` of every shard."""
    _, policy, dead_set = variant
    jit_, tit, data, bounds, perms, pool, k_local, max_iters = _superstep_case(case, route)
    P = pool.shape[0]
    plan = trouting.make_replica_plan(P, policy=policy)
    rows = _rep_rows(plan, data.numpy(), bounds.numpy())
    dead = np.zeros(P, bool)
    dead[list(dead_set)] = True
    want = _jax_superstep_rep(jit_, data.numpy(), bounds.numpy(), perms.numpy(), pool.numpy(),
                              k_local, max_iters, plan, rows, dead)
    rep = (torch.from_numpy(rows), torch.tensor(plan.primary_map, dtype=torch.int32),
           torch.from_numpy(dead), policy)
    logic = tops.iterator_logic(tit)
    got = tref.chase_superstep_reference(data, pool, bounds, perms, logic, k_local,
                                         scratch_words=tit.scratch_words, max_iters=max_iters,
                                         rep=rep)
    np.testing.assert_array_equal(want, got.numpy())
    plain = trouting._local_superstep(tit, pool, data, bounds, perms, k_local=k_local,
                                      max_iters=max_iters, backend="reference", rep=rep)
    np.testing.assert_array_equal(want, plain.numpy())
    wrapped = tops.pulse_chase_superstep(data, pool, bounds, perms, logic_fn=logic,
                                         k_local=k_local, max_iters=max_iters, rep=rep)
    assert torch.equal(wrapped, got)


# ------------------------- (c) replicated reads --------------------------------


def _sequential_pair(jit_, tit, jar, p0, s0, max_iters, jctx, tctx):
    jrec, jst = jcommit.sequential_commit_execute(jit_, jar, p0, s0, max_iters=max_iters,
                                                  k_local=4, compact=True, replication=jctx)
    trec, tst = tcommit.sequential_commit_execute(tit, _carry(jar), p0, s0,
                                                  max_iters=max_iters, k_local=4, compact=True,
                                                  replication=tctx)
    np.testing.assert_array_equal(jrec, trec)
    _assert_stats_equal(jst, tst)
    return jrec, jst


@needs_jax
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", STRUCTURES)
def test_replicated_reads_match_jax_sequential(name, policy):
    """At P = 4, every dead set of the policy: the port's sequential
    executor equals the JAX one, and the dispatched run on both local
    backends equals them bit for bit (hops and supersteps included, every
    stat but ``schedule``); the payload equals the healthy run's."""
    jit_, tit, jar, p0, s0, max_iters = _structure(name, 4)
    tar = _carry(jar)
    mesh = trouting.EmulatedMesh(4, CPU)
    args = (torch.from_numpy(p0), torch.from_numpy(s0))
    healthy, _ = trouting.distributed_execute(tit, tar, *args, mesh=mesh, max_iters=max_iters,
                                              compact=True)
    for dead in _dead_sets(4, policy):
        jctx, tctx = _contexts(jar, 4, policy, dead)
        jrec, jst = _sequential_pair(jit_, tit, jar, p0, s0, max_iters, jctx, tctx)
        for backend in ("reference", "kernel"):
            rec, st = trouting.distributed_execute(
                tit, tar, *args, mesh=mesh, max_iters=max_iters, compact=True,
                replication=tctx, local_backend=backend)
            np.testing.assert_array_equal(jrec, rec, err_msg=f"{dead} {backend}")
            _assert_stats_equal(jst, st, skip=("schedule",))
        np.testing.assert_array_equal(healthy[:, PAYLOAD], rec[:, PAYLOAD])
        np.testing.assert_array_equal(healthy[:, trouting.F_SCRATCH:], rec[:, trouting.F_SCRATCH:])


@needs_jax
@pytest.mark.parametrize("P", [2, 8])
def test_replica_fanout_matrix(P):
    """ft_checks.check_replica_fanout_matrix at P = 2 and 8 on its 64-key
    list: every dead primary, failover; payload equal to the healthy run
    and every record DONE; with shard 0 and with the last shard dead,
    bit-equal to the port's sequential executor, and with shard 0 dead
    that to the JAX one."""
    from test_torch_faults import _batch

    jit_, tit, jar, jinit, tinit, max_iters = _batch("list", P)
    p0, s0 = (np.asarray(x) for x in jinit)
    tar = _carry(jar)
    mesh = trouting.EmulatedMesh(P, CPU)
    healthy, _ = trouting.distributed_execute(tit, tar, *tinit, mesh=mesh, max_iters=max_iters,
                                              compact=True)
    for dead in range(P):
        jctx, tctx = _contexts(jar, P, "failover", (dead,))
        rec, st = trouting.distributed_execute(tit, tar, *tinit, mesh=mesh, max_iters=max_iters,
                                               compact=True, replication=tctx)
        if dead in (0, P - 1):
            if dead == 0:
                want, wst = _sequential_pair(jit_, tit, jar, p0, s0, max_iters, jctx, tctx)
            else:
                want, wst = tcommit.sequential_commit_execute(
                    tit, tar, p0, s0, max_iters=max_iters, k_local=4, compact=True,
                    replication=tctx)
            np.testing.assert_array_equal(want, rec)
            assert st.supersteps == wst.supersteps
        np.testing.assert_array_equal(healthy[:, PAYLOAD], rec[:, PAYLOAD])
        assert (rec[:, trouting.F_STATUS] == titer.STATUS_DONE).all()


@needs_jax
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", ["list", "btree", "hash"])
def test_replicated_reads_match_jax_at_one_shard(name, policy):
    """In this process JAX sees one device: the mesh of one shard, whose
    replica holder is itself (spread serves every read from the copy)."""
    jit_, tit, jar, p0, s0, max_iters = _structure(name, 1)
    jctx, tctx = _contexts(jar, 1, policy, ())
    jrec, jst = jrouting.distributed_execute(
        jit_, jar, jnp.asarray(p0), jnp.asarray(s0), mesh=jax.make_mesh((1,), ("mem",)),
        max_iters=max_iters, compact=True, replication=jctx)
    rec, st = trouting.distributed_execute(
        tit, _carry(jar), torch.from_numpy(p0), torch.from_numpy(s0),
        mesh=trouting.EmulatedMesh(1, CPU), max_iters=max_iters, compact=True, replication=tctx)
    np.testing.assert_array_equal(np.asarray(jrec), rec)
    _assert_stats_equal(jst, st)


# (case id, structure, policy, dead shards)
MESH_CASES = ([(f"list-failover-dead{d}", "list", "failover", (d,)) for d in range(4)]
              + [("list-spread", "list", "spread", ()),
                 ("list-spread-dead2", "list", "spread", (2,)),
                 ("list-primary", "list", "primary", ()),
                 ("hash-failover-dead1", "hash", "failover", (1,)),
                 ("btree-spread", "btree", "spread", ()),
                 ("skip-failover-dead3", "skip", "failover", (3,))])


def _jax_mesh_script(out_path):
    """Script mode: every MESH_CASES case through the JAX package's
    ``distributed_execute(replication=)`` on four host devices."""
    assert jax.device_count() == 4, jax.devices()
    mesh = jax.make_mesh((4,), ("mem",))
    arrays = {}
    for cid, name, policy, dead in MESH_CASES:
        jit_, _, jar, p0, s0, max_iters = _structure(name, 4)
        jctx, _ = _contexts(jar, 4, policy, dead)
        rec, st = jrouting.distributed_execute(
            jit_, jar, jnp.asarray(p0), jnp.asarray(s0), mesh=mesh, max_iters=max_iters,
            compact=True, schedule="dispatched", replication=jctx)
        arrays[f"{cid}/records"] = np.asarray(rec)
        arrays[f"{cid}/stats"] = np.asarray(_stats_json(st))
    np.savez(out_path, **arrays)


@pytest.fixture(scope="module")
def jax_mesh_results(tmp_path_factory):
    """The JAX package's four-device results, from one subprocess whose
    environment alone carries the device count."""
    if jax is None:
        pytest.skip("needs the JAX package")
    out = tmp_path_factory.mktemp("jax_mesh_replication") / "results.npz"
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
def test_replicated_reads_match_jax_on_four_devices(case, jax_mesh_results):
    cid, name, policy, dead = case
    _, tit, jar, p0, s0, max_iters = _structure(name, 4)
    _, tctx = _contexts(jar, 4, policy, dead)
    rec, st = trouting.distributed_execute(
        tit, _carry(jar), torch.from_numpy(p0), torch.from_numpy(s0),
        mesh=trouting.EmulatedMesh(4, CPU), max_iters=max_iters, compact=True,
        replication=tctx)
    np.testing.assert_array_equal(jax_mesh_results[f"{cid}/records"], rec)
    assert json.loads(_stats_json(st)) == json.loads(str(jax_mesh_results[f"{cid}/stats"]))


@needs_jax
def test_make_superstep_takes_the_replica_operands():
    """``make_superstep(replication=plan)`` takes the replica rows and the
    dead mask after ``perms``: one superstep equals ``superstep`` with the
    operands built by the executor."""
    _, tit, jar, p0, s0, max_iters = _structure("list", 4)
    tar = _carry(jar)
    _, tctx = _contexts(jar, 4, "failover", (1,))
    pools, _ = trouting.place_requests(torch.from_numpy(p0), torch.from_numpy(s0), 4)
    kw = dict(k_local=4, max_iters=max_iters, local_backend="reference")
    step = trouting.make_superstep(tit, 4, replication=tctx.plan, **kw)
    got = step(pools, tar.data, tar.bounds, tar.perms, tctx.rep_rows, tctx.dead_mask)
    rep, rep_ctx = trouting._rep_operands(tctx, tar.data, 4)
    want = trouting.superstep(tit, pools, tar.data, tar.bounds, tar.perms, rep=rep,
                              rep_ctx=rep_ctx, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ----------------------- (d) the overlap model, the engine ---------------------


def _iterator_pairs():
    """(id, JAX iterator, port iterator) for every structure iterator and
    the ISA programs."""
    pairs = [("list_find", jlist.find_iterator(), tlist.find_iterator()),
             ("list_sum", jlist.sum_iterator(), tlist.sum_iterator()),
             ("list_insert", jlist.insert_iterator(), tlist.insert_iterator()),
             ("list_delete", jlist.delete_iterator(), tlist.delete_iterator()),
             ("hash_find", jhash.find_iterator(16), thash.find_iterator(16)),
             ("hash_rw", jhash.rw_iterator(16), thash.rw_iterator(16)),
             ("bst_find", jbst.find_iterator(), tbst.find_iterator()),
             ("bst_update", jbst.update_iterator(), tbst.update_iterator()),
             ("btree_find", jbtree.find_iterator(), tbtree.find_iterator()),
             ("btree_update", jbtree.update_iterator(), tbtree.update_iterator()),
             ("btree_range_agg", jbtree.range_aggregate_iterator(),
              tbtree.range_aggregate_iterator()),
             ("skip_find", jskip.find_iterator(), tskip.find_iterator()),
             ("skip_insert", jskip.insert_iterator(), tskip.insert_iterator())]
    for name in ("list_find_program", "hash_find_program", "bst_find_program",
                 "btree_find_program"):
        pairs.append((name, jisa.as_pulse_iterator(getattr(jprogs, name)()),
                      tisa.as_pulse_iterator(getattr(tprogs, name)())))
    return pairs


@needs_jax
@pytest.mark.parametrize("node_words", [32, 40, 64])
def test_schedule_decision_and_workload_table_match_jax(node_words):
    """Every field of ``schedule_decision`` (the floats equal, not close)
    for P in {1, 2, 4, 8} and k_local in {1, 4}, and ``workload_table``."""
    pairs = _iterator_pairs()
    for _, jit_, tit in pairs:
        for P in (1, 2, 4, 8):
            for k_local in (1, 4):
                want = jdispatch.schedule_decision(jit_, node_words, P, k_local=k_local)
                got = tdispatch.schedule_decision(tit, node_words, P, k_local=k_local)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
    want = jdispatch.workload_table([(n, j, node_words, 7) for n, j, _ in pairs])
    got = tdispatch.workload_table([(n, t, node_words, 7) for n, _, t in pairs])
    assert got == want


@needs_jax
@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_engine_resolves_auto_as_the_jax_engine(P):
    """``_resolve_schedule`` of both engines on the same arena, for every
    iterator, ``k_local`` in {1, 4} and ``fused`` either way; an explicit
    schedule passes through."""
    from repro.core.arena import ArenaBuilder

    jar = ArenaBuilder(64 * P, 40, num_shards=P).finish()  # rows wide enough for every node
    jeng, teng = jengine.PulseEngine(jar), tengine.PulseEngine(_carry(jar))
    for _, jit_, tit in _iterator_pairs():
        for k_local in (1, 4):
            for fused in (True, False):
                want = jeng._resolve_schedule(jit_, "auto", fused, k_local)
                assert teng._resolve_schedule(tit, "auto", fused, k_local) == want
        assert teng._resolve_schedule(tit, "fused", True, 4) == "fused"


@needs_jax
def test_engine_runs_the_resolved_schedule_and_replicas():
    """On a mesh of four: ``schedule="auto"`` runs the schedule the JAX
    engine resolves (the pipelined one here), with the dispatched run's
    results; a replication context runs dispatched and equals
    ``distributed_execute(replication=)``; a mutating iterator and a single
    node do not use it, as in the reference."""
    jit_, tit, jar, p0, s0, max_iters = _structure("hash", 4)
    tar = _carry(jar)
    mesh = trouting.EmulatedMesh(4, CPU)
    args = (torch.from_numpy(p0), torch.from_numpy(s0))
    want = jengine.PulseEngine(jar)._resolve_schedule(jit_, "auto", True, 4)
    assert want == "pipelined"
    res = tengine.PulseEngine(tar, mesh=mesh).execute(tit, *args, max_iters=max_iters)
    rec, st = trouting.distributed_execute(tit, tar, *args, mesh=mesh, max_iters=max_iters,
                                           compact=True)
    assert res.stats.schedule == want and res.stats.fused
    assert torch.equal(res.scratch, rec[:, trouting.F_SCRATCH:])
    assert res.stats.supersteps == st.supersteps
    _, tctx = _contexts(jar, 4, "failover", (2,))
    rep = tengine.PulseEngine(tar, mesh=mesh).execute(tit, *args, max_iters=max_iters,
                                                      replication=tctx)
    rrec, rst = trouting.distributed_execute(tit, tar, *args, mesh=mesh, max_iters=max_iters,
                                             compact=True, replication=tctx)
    assert rep.stats.schedule == "dispatched" and torch.equal(rep.iters,
                                                               rrec[:, trouting.F_ITERS])
    _assert_stats_equal(rst, rep.stats)
    one = tengine.PulseEngine(tar).execute(tit, *args, max_iters=max_iters, replication=tctx)
    assert torch.equal(one.scratch, res.scratch)
    jar_w, head, _ = _structure_list_for_writes()
    wit = tlist.insert_iterator()
    newk = np.arange(6, dtype=np.int32) + 900
    outs = [tengine.PulseEngine(_carry(jar_w), mesh=mesh).execute(
        wit, *wit.init(newk, newk, head), max_iters=4096, replication=r)
        for r in (None, _contexts(jar_w, 4, "failover", (1,))[1])]
    assert torch.equal(outs[0].scratch, outs[1].scratch)
    assert torch.equal(outs[0].arena.data, outs[1].arena.data)


def _structure_list_for_writes():
    from test_torch_faults import _ft_list

    return _ft_list(4)


# ------------------------------ (e) refusals -----------------------------------


def _refusals(routing_mod, commit_mod, arena, mesh, ctx, rit, wit, p0, s0, w0):
    """(id, callable) of every refusal the reference raises on replication."""
    run = dict(mesh=mesh, max_iters=64)
    return [
        ("write_path", lambda: routing_mod.distributed_execute(wit, arena, *w0, replication=ctx,
                                                               **run)),
        ("return_to_cpu", lambda: routing_mod.distributed_execute(
            rit, arena, p0, s0, replication=ctx, return_to_cpu=True, **run)),
        ("fused", lambda: routing_mod.distributed_execute(rit, arena, p0, s0, replication=ctx,
                                                          schedule="fused", **run)),
        ("pipelined", lambda: routing_mod.distributed_execute(
            rit, arena, p0, s0, replication=ctx, schedule="pipelined", **run)),
        ("fused_flag", lambda: routing_mod.distributed_execute(rit, arena, p0, s0,
                                                               replication=ctx, fused=True,
                                                               **run)),
        ("elide", lambda: routing_mod.distributed_execute(
            rit, arena, p0, s0, replication=ctx, elide_access_check=True, **run)),
        ("elide_write", lambda: routing_mod.distributed_execute(
            wit, arena, *w0, elide_access_check=True, **run)),
        ("superstep_write", lambda: routing_mod.make_superstep(
            wit, 2, **({"axis_name": "mem"} if routing_mod is jrouting else {}), k_local=4,
            max_iters=8, mutate=True, replication=ctx.plan)),
        ("sequential_write", lambda: commit_mod.sequential_commit_execute(
            wit, arena, *w0, replication=ctx)),
    ]


REFUSALS = ("write_path", "return_to_cpu", "fused", "pipelined", "fused_flag", "elide",
            "elide_write", "superstep_write", "sequential_write")


@needs_jax
@pytest.mark.parametrize("cid", REFUSALS)
def test_refusals_match_jax(cid):
    """The reference's refusal raises in the port with its type and
    message (the JAX calls on a mesh of one device: each refusal comes
    before the mesh is checked)."""
    _, _, jar, p0, s0, _ = _structure("list", 2)
    jctx, tctx = _contexts(jar, 2, "failover", (1,))
    newk = np.array([900, 901], np.int32)
    jw, tw = jlist.insert_iterator(), tlist.insert_iterator()
    head = int(p0[0])
    jcalls = dict(_refusals(jrouting, jcommit, jar, jax.make_mesh((1,), ("mem",)), jctx,
                            jlist.find_iterator(), jw, jnp.asarray(p0), jnp.asarray(s0),
                            jw.init(jnp.asarray(newk), jnp.asarray(newk), head)))
    tcalls = dict(_refusals(trouting, tcommit, _carry(jar), trouting.EmulatedMesh(2, CPU), tctx,
                            tlist.find_iterator(), tw, torch.from_numpy(p0),
                            torch.from_numpy(s0), tw.init(newk, newk, head)))
    with pytest.raises(Exception) as want:
        jcalls[cid]()
    with pytest.raises(type(want.value)) as got:
        tcalls[cid]()
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)


def test_replica_operands_are_checked():
    """A replica context whose rows or dead mask do not fit the arena
    raises before any superstep runs."""
    ar = tarena.make_arena(np.zeros((8, 4), np.int32), num_shards=2, device=CPU)
    it = tlist.find_iterator()
    p0 = torch.zeros(2, dtype=torch.int32)
    s0 = torch.zeros((2, it.scratch_words), dtype=torch.int32)
    plan = trouting.make_replica_plan(2)
    mesh = trouting.EmulatedMesh(2, CPU)
    for rows, dead in ((np.zeros((4, 4), np.int32), np.zeros(2, bool)),
                       (np.zeros((8, 4), np.int32), np.zeros(3, bool))):
        with pytest.raises(ValueError):
            trouting.distributed_execute(it, ar, p0, s0, mesh=mesh,
                                         replication=trouting.ReplicaContext(plan, rows, dead))


# --------------------------------- the card ------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with pytest -m gpu")


CARD_BODIES = ["isa", "list_find", "list_sum", "hash_find", "bst_find", "btree_find",
               "btree_range_agg", "skiplist_find"]


@pytest.mark.gpu
@pytest.mark.parametrize("body", CARD_BODIES)
def test_replica_window_matches_plain_on_card(body):
    """The superstep mode with the replica windows, on the kernel and on
    its plain version, on the same CUDA tensors: every superstep of a
    routed run, under each policy and dead set, a revoked primary, and
    replica rows that differ from the primary's (so a wrong row shows)."""
    _card()
    from test_torch_routing import _card_structure

    ar, it, p0, s0 = _card_structure(body)
    logic = tops.iterator_logic(it)
    P = 4
    pools, _ = trouting.place_requests(p0, s0.reshape(p0.shape[0], -1), P)
    route = trouting.make_superstep(it, P, k_local=4, max_iters=64, local_backend="reference")
    variants = [(policy, dead) for policy in POLICIES for dead in ((), (0,), (2,), (1, 3))]
    for step in range(5):
        for policy, dead in variants:
            plan = trouting.make_replica_plan(P, policy=policy)
            rows = torch.from_numpy(_rep_rows(plan, ar.data.cpu().numpy(),
                                              ar.bounds.cpu().numpy())).cuda()
            if step == 4:
                rows = rows ^ 1  # a copy that differs: the window must read it
            mask = torch.zeros(P, dtype=torch.bool, device="cuda")
            mask[list(dead)] = True
            rep = (rows, torch.tensor(plan.primary_map, dtype=torch.int32, device="cuda"),
                   mask, policy)
            for perms in (ar.perms, torch.tensor([3, 0, 3, 2], dtype=torch.int32,
                                                 device="cuda")):
                got = tops.pulse_chase_superstep(ar.data, pools, ar.bounds, perms, logic_fn=logic,
                                                 k_local=4, max_iters=64, rep=rep)
                want = tref.chase_superstep_reference(ar.data, pools, ar.bounds, perms, logic, 4,
                                                      scratch_words=it.scratch_words,
                                                      max_iters=64, rep=rep)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (body, step, policy, dead)
        pools = route(pools, ar.data, ar.bounds, ar.perms)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("policy", POLICIES)
def test_replicated_batch_on_card_matches_cpu(policy):
    """A replicated routed batch over ``EmulatedMesh(4, "cuda")`` (one
    superstep-mode launch a superstep) equals the same call on a CPU copy:
    records and every stat; a dead primary's reads complete."""
    _card()
    from test_torch_routing import _card_structure

    ar, it, p0, s0 = _card_structure("btree_find")
    plan = trouting.make_replica_plan(4, policy=policy)
    rows = _rep_rows(plan, ar.data.cpu().numpy(), ar.bounds.cpu().numpy())
    dead = np.zeros(4, bool)
    dead[1] = policy != "primary"
    out = []
    for dev in ("cuda", "cpu"):
        a = tarena.arena_from_numpy(*(t.cpu().numpy() for t in (ar.data, ar.bounds, ar.perms,
                                                                 ar.heap)), device=dev)
        ctx = trouting.ReplicaContext(plan, torch.from_numpy(rows).to(dev),
                                      torch.from_numpy(dead).to(dev))
        n0 = tops.pulse_chase.launches
        rec, st = trouting.distributed_execute(it, a, p0.to(dev), s0.to(dev),
                                               mesh=trouting.EmulatedMesh(4, dev),
                                               max_iters=4096, compact=True, replication=ctx)
        if dev == "cuda":
            assert tops.pulse_chase.launches - n0 == st.supersteps
        out.append((rec.cpu(), st))
    assert torch.equal(out[0][0], out[1][0])
    for f in dataclasses.fields(out[0][1]):
        a, b = getattr(out[0][1], f.name), getattr(out[1][1], f.name)
        assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b, f.name
    assert (out[1][0][:, trouting.F_STATUS] == titer.STATUS_DONE).all()


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", ["fused", "pipelined"])
def test_lossy_device_resident_batch_on_card_matches_cpu(schedule):
    """Fabric loss on a device-resident schedule: the mask keyed on the
    device counter inside the captured graph gives the CPU copy's records
    and stats, and the loss-free run's records.  (Loss can shorten a run:
    a parked record keeps the fabric scheduled, so the run takes fewer
    local-only supersteps.)"""
    _card()
    from test_torch_routing import _card_structure

    ar, it, p0, s0 = _card_structure("hash_find")
    out = []
    for dev, loss in (("cuda", True), ("cpu", True), ("cuda", False)):
        a = tarena.arena_from_numpy(*(t.cpu().numpy() for t in (ar.data, ar.bounds, ar.perms,
                                                                 ar.heap)), device=dev)
        inj = tfaults.FaultInjector(tfaults.FaultPlan(drop_prob=0.4, drop_seed=7)) if loss else None
        rec, st = trouting.distributed_execute(it, a, p0.to(dev), s0.to(dev),
                                               mesh=trouting.EmulatedMesh(4, dev),
                                               max_iters=4096, compact=True, schedule=schedule,
                                               fault_injector=inj)
        out.append((rec.cpu(), st))
    assert torch.equal(out[0][0], out[1][0]) and out[0][1].supersteps == out[1][1].supersteps
    assert out[0][1].total_wire_words == out[1][1].total_wire_words
    np.testing.assert_array_equal(out[0][1].crossings, out[1][1].crossings)
    assert torch.equal(out[0][0][:, trouting.F_SCRATCH:], out[2][0][:, trouting.F_SCRATCH:])


if __name__ == "__main__":
    _jax_mesh_script(sys.argv[1])
