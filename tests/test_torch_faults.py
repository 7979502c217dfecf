"""Port parity: fault injection (item 6(d)) -- the port's own
``core.faults``, the fabric-loss mask, loss on every schedule and fabric,
the straggler's attribution and the kill.

The same numpy inputs, made from a seed, go through the JAX package and the
port on the CPU; int32 state is compared bit for bit.

  * ``routing._drop_mask`` against the JAX ``_drop_mask`` over seeds {0, 7,
    2**31 - 1}, shards 0-7, steps 0-63, L in {1, 24, 4096} and
    ``drop_prob`` in {0.3, 0.4, 1.0}.
  * Loss (``FaultPlan(drop_prob=0.4, drop_seed=7)``) on every schedule x
    fabric, reads and writes: records and every ``RoutingStats`` field (and
    a write's final arena) against the JAX ``distributed_execute`` with the
    same plan, in this process at P = 1 and at P = 4 in one subprocess
    (this file run as a script with four host devices in its environment
    alone); against the loss-free run and a replay at P = 8.
  * The straggler: the supersteps it sleeps in (``time.sleep`` counted)
    against the JAX package's, and none while its replica serves for it.
  * The kill on every schedule x fabric, and the 1-based fire-before count.

The checks mirror ``tests/helpers/ft_checks.py``, which is not imported: it
sets ``XLA_FLAGS`` when imported, and this process must keep one device.

Run as a script (``python tests/test_torch_faults.py OUT.npz`` with
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
    from repro.core import faults as jfaults
    from repro.core import routing as jrouting
    from repro.core.arena import ArenaBuilder as JBuilder
    from repro.core.structures import linked_list as jlist
except ImportError:  # the card's machine has no JAX
    jax = None
from repro_torch.core import arena as tarena
from repro_torch.core import commit as tcommit
from repro_torch.core import faults as tfaults
from repro_torch.core import iterator as titer
from repro_torch.core import routing as trouting
from repro_torch.core.structures import linked_list as tlist

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
SCHEDULES = (("dispatched", "dense"), ("fused", "dense"), ("fused", "ring"),
             ("pipelined", "dense"), ("pipelined", "ring"))  # ft_checks.SCHEDULES
LOSS = dict(drop_prob=0.4, drop_seed=7)
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")


# ------------------------------- inputs --------------------------------------


def _ft_list(P):
    """``ft_checks._build`` at ``P`` shards: a 64-key list (keys 10-73,
    values 3x) in an interleaved arena of 512 rows; (JAX arena, head, keys)."""
    b = JBuilder(512, 4, num_shards=P, policy="interleaved")
    keys = np.arange(10, 74, dtype=np.int32)
    head = jlist.build_into(b, keys, keys * 3)
    return b.finish(), head, keys


def _carry(jar):
    return tarena.arena_from_numpy(
        *(np.asarray(x) for x in (jar.data, jar.bounds, jar.perms, jar.heap)), device=CPU)


def _batch(name, P):
    """(JAX iterator, port iterator, JAX arena, JAX init, port init,
    max_iters) of one batch: over ft_checks' list, ``list`` (32 finds) or
    ``insert`` (12 inserts, the write path); ``hash``, the hash table of
    ``tests/test_torch_routing.py`` (32 finds, half of them misses)."""
    if name == "hash":
        from test_torch_routing import _structure

        jit_, tit, jar, p0, s0, max_iters = _structure("hash", P)
        return jit_, tit, jar, (jnp.asarray(p0), jnp.asarray(s0)), (
            torch.from_numpy(p0), torch.from_numpy(s0)), max_iters
    jar, head, keys = _ft_list(P)
    if name == "list":
        q = keys[np.random.default_rng(23).permutation(len(keys))[:32]]
        jit_, tit = jlist.find_iterator(), tlist.find_iterator()
        p0, s0 = (np.array(x) for x in jit_.init(jnp.asarray(q), head))
        return jit_, tit, jar, (jnp.asarray(p0), jnp.asarray(s0)), (
            torch.from_numpy(p0), torch.from_numpy(s0)), 4096
    newk = np.arange(12, dtype=np.int32) + 700
    jit_, tit = jlist.insert_iterator(), tlist.insert_iterator()
    return (jit_, tit, jar, jit_.init(jnp.asarray(newk), jnp.asarray(newk + 1), head),
            tit.init(newk, newk + 1, head), 4096)


def _stats_json(st):
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        out[f.name] = v.tolist() if isinstance(v, np.ndarray) else v
    return json.dumps(out)


def _port(tit, tar, init, P, **kw):
    return trouting.distributed_execute(tit, tar, *init, mesh=trouting.EmulatedMesh(P, CPU),
                                        **kw)


# ----------------------------- (a) the module ----------------------------------


@needs_jax
def test_faults_module_matches_jax():
    """The port's own FaultPlan, ShardFailure and FaultInjector: the same
    fields and defaults, the same message, the kill fired once."""
    fields = [(f.name, f.default) for f in dataclasses.fields(tfaults.FaultPlan)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(jfaults.FaultPlan)]
    e, je = tfaults.ShardFailure(3, 5), jfaults.ShardFailure(3, 5)
    assert str(e) == str(je) and (e.shard, e.superstep, e.label) == (3, 5, None)
    assert isinstance(e, RuntimeError)
    for plan in (dict(kill_shard=1, kill_call=2, kill_superstep=4), dict(), dict(kill_call=1)):
        t, j = tfaults.FaultInjector(tfaults.FaultPlan(**plan)), jfaults.FaultInjector(
            jfaults.FaultPlan(**plan))
        for _ in range(4):
            call = t.begin_call()
            assert call == j.begin_call() and t.kill_step(call) == j.kill_step(call)
            if t.kill_step(call) is not None:
                with pytest.raises(tfaults.ShardFailure):
                    t.fire(t.kill_step(call))
                with pytest.raises(jfaults.ShardFailure):
                    j.fire(j.kill_step(call))
            assert t.fired == j.fired


# ----------------------------- (b) the drop mask -------------------------------


@needs_jax
@pytest.mark.parametrize("drop_prob", [0.3, 0.4, 1.0])
@pytest.mark.parametrize("L", [1, 24, 4096])
@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_drop_mask_matches_jax(seed, L, drop_prob):
    """Every shard 0-7 and step 0-63: the port's mask (all shards and steps
    in one call, ``(8, 64, L)``) equals the JAX ``_drop_mask`` bit for
    bit."""
    shards, steps = jnp.arange(8, dtype=jnp.int32), jnp.arange(64, dtype=jnp.int32)
    jmask = jax.jit(jax.vmap(jax.vmap(
        lambda sh, st: jrouting._drop_mask(L, drop_prob, seed, sh, st), (None, 0)), (0, None)))
    want = np.asarray(jmask(shards, steps))  # (8, 64, L)
    got = trouting._drop_mask(L, drop_prob, seed, torch.arange(8)[:, None], torch.arange(64))
    np.testing.assert_array_equal(want, got.numpy())
    if drop_prob == 1.0:
        assert got.all()
    # one shard and a device-scalar step give the same rows
    one = trouting._drop_mask(L, drop_prob, seed, 5, torch.tensor(9, dtype=torch.int32))
    np.testing.assert_array_equal(one.numpy(), want[5, 9])


# ------------------------ (c) loss against the JAX package ---------------------

# (case id, batch, schedule, fabric)
LOSS_CASES = [(f"{b}-{s}-{f}", b, s, f) for b in ("list", "insert") for s, f in SCHEDULES]
MESH_LOSS_CASES = LOSS_CASES + [(f"hash-{s}-{f}", "hash", s, f) for s, f in SCHEDULES]


def _check_loss(case, jrec, jst, jarena, P):
    _, batch, schedule, fabric = case
    _, tit, jar, _, tinit, max_iters = _batch(batch, P)
    inj = tfaults.FaultInjector(tfaults.FaultPlan(**LOSS))
    out = _port(tit, _carry(jar), tinit, P, max_iters=max_iters, compact=True,
                schedule=schedule, fabric=fabric, fault_injector=inj)
    np.testing.assert_array_equal(jrec, out[0])
    assert json.loads(_stats_json(out[1])) == json.loads(jst)
    if jarena is not None:
        np.testing.assert_array_equal(jarena[0], out[2].data.numpy())
        np.testing.assert_array_equal(jarena[1], out[2].heap.numpy())


@needs_jax
@pytest.mark.parametrize("case", LOSS_CASES, ids=[c[0] for c in LOSS_CASES])
def test_loss_matches_jax_at_one_shard(case):
    """In this process JAX sees one device: the mesh of one shard, with the
    loss plan (its mask keyed and applied, though at one shard no record
    crosses)."""
    _, batch, schedule, fabric = case
    jit_, _, jar, jinit, _, max_iters = _batch(batch, 1)
    out = jrouting.distributed_execute(
        jit_, jar, *jinit, mesh=jax.make_mesh((1,), ("mem",)), max_iters=max_iters,
        compact=True, schedule=schedule, fabric=fabric,
        fault_injector=jfaults.FaultInjector(jfaults.FaultPlan(**LOSS)))
    arena = (np.asarray(out[2].data), np.asarray(out[2].heap)) if len(out) == 3 else None
    _check_loss(case, np.asarray(out[0]), _stats_json(out[1]), arena, 1)


# (case id, delay shard, replica policy or None, dead shard or None)
DELAY_CASES = [("shard1", 1, None, None), ("shard1-replica-dead", 1, "failover", 1),
               ("shard1-other-dead", 1, "failover", 3)]


def _rep_ctx(routing_mod, jar, P, policy, dead):
    plan = routing_mod.make_replica_plan(P, policy=policy)
    data, bounds = np.asarray(jar.data), np.asarray(jar.bounds)
    rows = np.zeros_like(data)
    for holder, p in enumerate(plan.primary_map):
        if p >= 0:
            rows[bounds[holder]:bounds[holder + 1]] = data[bounds[p]:bounds[p + 1]]
    mask = np.zeros(P, bool)
    if dead is not None:
        mask[dead] = True
    return routing_mod.ReplicaContext(plan=plan, rep_rows=rows, dead_mask=mask)


def _delay_run(routing_mod, faults_mod, case, P, mesh):
    """Run the ``list`` batch with a straggler; returns (records, stats,
    sleeps), ``time.sleep`` counted instead of slept."""
    _, shard, policy, dead = case
    jit_, tit, jar, jinit, tinit, max_iters = _batch("list", P)
    port = routing_mod is trouting
    it, init = (tit, tinit) if port else (jit_, jinit)
    arena = _carry(jar) if port else jar
    rep = _rep_ctx(routing_mod, jar, P, policy, dead) if policy else None
    sleeps = []
    real = routing_mod.time.sleep
    routing_mod.time.sleep = sleeps.append
    try:
        rec, st = routing_mod.distributed_execute(
            it, arena, *init, mesh=mesh, max_iters=max_iters, compact=True,
            schedule="dispatched", replication=rep, fault_injector=faults_mod.FaultInjector(
                faults_mod.FaultPlan(delay_shard=shard, delay_s=0.02)))
    finally:
        routing_mod.time.sleep = real
    return np.asarray(rec), st, sleeps


@needs_jax
def test_straggler_matches_jax_at_one_shard():
    """At one shard the straggler serves every superstep with work: the
    same sleeps as the JAX package's, and the records of the run without
    it."""
    got = _delay_run(trouting, tfaults, ("s0", 0, None, None), 1, trouting.EmulatedMesh(1, CPU))
    want = _delay_run(jrouting, jfaults, ("s0", 0, None, None), 1, jax.make_mesh((1,), ("mem",)))
    np.testing.assert_array_equal(want[0], got[0])
    assert got[2] == want[2] == [0.02] * got[1].supersteps


def _jax_mesh_script(out_path):
    """Script mode: every LOSS_CASES and DELAY_CASES case through the JAX
    package's ``distributed_execute`` on four host devices."""
    assert jax.device_count() == 4, jax.devices()
    mesh = jax.make_mesh((4,), ("mem",))
    arrays = {}
    for case in MESH_LOSS_CASES:
        cid, batch, schedule, fabric = case
        jit_, _, jar, jinit, _, max_iters = _batch(batch, 4)
        out = jrouting.distributed_execute(
            jit_, jar, *jinit, mesh=mesh, max_iters=max_iters, compact=True,
            schedule=schedule, fabric=fabric,
            fault_injector=jfaults.FaultInjector(jfaults.FaultPlan(**LOSS)))
        arrays[f"{cid}/records"] = np.asarray(out[0])
        arrays[f"{cid}/stats"] = np.asarray(_stats_json(out[1]))
        if len(out) == 3:
            arrays[f"{cid}/data"] = np.asarray(out[2].data)
            arrays[f"{cid}/heap"] = np.asarray(out[2].heap)
    for case in DELAY_CASES:
        rec, st, sleeps = _delay_run(jrouting, jfaults, case, 4, mesh)
        arrays[f"delay-{case[0]}/records"] = rec
        arrays[f"delay-{case[0]}/stats"] = np.asarray(_stats_json(st))
        arrays[f"delay-{case[0]}/sleeps"] = np.asarray(len(sleeps))
    np.savez(out_path, **arrays)


@pytest.fixture(scope="module")
def jax_mesh_results(tmp_path_factory):
    """The JAX package's four-device results, from one subprocess whose
    environment alone carries the device count."""
    if jax is None:
        pytest.skip("needs the JAX package")
    out = tmp_path_factory.mktemp("jax_mesh_faults") / "results.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, str(Path(__file__)), str(out)], env=env,
                          capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}"
    return dict(np.load(out))


@needs_jax
@pytest.mark.parametrize("case", MESH_LOSS_CASES, ids=[c[0] for c in MESH_LOSS_CASES])
def test_loss_matches_jax_on_four_devices(case, jax_mesh_results):
    """Records, every RoutingStats field (superstep counts grown by the
    loss) and, for writes, the final data and heap equal the JAX package's
    same schedule and fabric under the same plan."""
    cid = case[0]
    arena = ((jax_mesh_results[f"{cid}/data"], jax_mesh_results[f"{cid}/heap"])
             if f"{cid}/data" in jax_mesh_results else None)
    _check_loss(case, jax_mesh_results[f"{cid}/records"],
                str(jax_mesh_results[f"{cid}/stats"]), arena, 4)


@needs_jax
@pytest.mark.parametrize("case", DELAY_CASES, ids=[c[0] for c in DELAY_CASES])
def test_straggler_matches_jax_on_four_devices(case, jax_mesh_results):
    """The straggler sleeps in the same supersteps as the JAX package's
    (only those in which it serves work; none while its replica serves for
    it), and changes no record or stat."""
    cid = f"delay-{case[0]}"
    rec, st, sleeps = _delay_run(trouting, tfaults, case, 4, trouting.EmulatedMesh(4, CPU))
    np.testing.assert_array_equal(jax_mesh_results[f"{cid}/records"], rec)
    assert json.loads(_stats_json(st)) == json.loads(str(jax_mesh_results[f"{cid}/stats"]))
    assert len(sleeps) == int(jax_mesh_results[f"{cid}/sleeps"])
    if case[3] == case[1]:  # the straggler is dead and its replica serves
        assert sleeps == []
    else:
        assert 0 < len(sleeps) <= st.supersteps and set(sleeps) == {0.02}


# --------------------- (d) the ft_checks properties, P = 8 ---------------------


@functools.lru_cache(maxsize=None)
def _loss_free_list_run():
    """The ``list`` batch at P = 8 without loss, dispatched: records and
    superstep counts are the same on every schedule and fabric."""
    _, tit, jar, _, tinit, max_iters = _batch("list", 8)
    return _port(tit, _carry(jar), tinit, 8, max_iters=max_iters, compact=True)


@needs_jax
@pytest.mark.parametrize("schedule,fabric", SCHEDULES)
def test_loss_keeps_every_record_and_replays(schedule, fabric):
    """ft_checks.check_drop_retransmit_identity: records equal the loss-free
    run, every one DONE, supersteps no fewer; the same seed replays the
    records and every stat."""
    _, tit, jar, _, tinit, max_iters = _batch("list", 8)
    tar = _carry(jar)
    run = dict(max_iters=max_iters, compact=True, schedule=schedule, fabric=fabric)
    ref, rst = _loss_free_list_run()
    got = [_port(tit, tar, tinit, 8, fault_injector=tfaults.FaultInjector(
        tfaults.FaultPlan(**LOSS)), **run) for _ in range(2)]
    (rec, st), (rec2, st2) = got
    assert torch.equal(rec[:, trouting.F_SCRATCH:], ref[:, trouting.F_SCRATCH:])
    for f in (trouting.F_ID, trouting.F_PTR, trouting.F_STATUS, trouting.F_ITERS):
        assert torch.equal(rec[:, f], ref[:, f])
    assert (rec[:, trouting.F_STATUS] == titer.STATUS_DONE).all()
    assert st.supersteps > rst.supersteps
    assert torch.equal(rec2, rec) and _stats_json(st2) == _stats_json(st)


@needs_jax
@pytest.mark.parametrize("schedule,fabric", [("dispatched", "dense"), ("pipelined", "ring")])
def test_loss_on_the_write_path_is_valid_and_replays(schedule, fabric):
    """ft_checks.check_drop_write_path_validity: every insert lands and is
    found, and a replay gives the same records and arena bit for bit."""
    jar, head, _ = _ft_list(8)
    newk = np.arange(12, dtype=np.int32) + 700
    it = tlist.insert_iterator()
    tar = _carry(jar)
    runs = [_port(it, tar, it.init(newk, newk + 1, head), 8, max_iters=4096, compact=True,
                  schedule=schedule, fabric=fabric, fault_injector=tfaults.FaultInjector(
                      tfaults.FaultPlan(drop_prob=0.3, drop_seed=3))) for _ in range(2)]
    (rec, st, ar), (rec2, st2, ar2) = runs
    assert (rec[:, trouting.F_STATUS] == titer.STATUS_DONE).all() and st.commits > 0
    fit = tlist.find_iterator()
    _, fscr, _, _ = titer.execute_batched(fit, ar, *fit.init(torch.from_numpy(newk), head),
                                          max_iters=4096)
    assert (fscr[:, 2] == 1).all()
    assert torch.equal(rec2, rec) and torch.equal(ar2.data, ar.data)
    assert torch.equal(ar2.heap, ar.heap) and st2.commits == st.commits


@needs_jax
@pytest.mark.parametrize("schedule,fabric", SCHEDULES)
def test_a_kill_publishes_nothing(schedule, fabric):
    """ft_checks.check_kill_every_schedule with the port's injector: the
    kill raises ShardFailure(2, 3), the input arena is untouched, and a
    clean rerun of the same pre-state equals the JAX sequential commit."""
    jit_, tit, jar, jinit, tinit, max_iters = _batch("insert", 8)
    tar = _carry(jar)
    before = (tar.data.clone(), tar.heap.clone())
    jrec, jst, jar2 = jcommit.sequential_commit_execute(jit_, jar, *jinit, max_iters=max_iters)
    run = dict(max_iters=max_iters, compact=True, schedule=schedule, fabric=fabric)
    with pytest.raises(tfaults.ShardFailure) as exc:
        _port(tit, tar, tinit, 8, fault_injector=tfaults.FaultInjector(
            tfaults.FaultPlan(kill_shard=2, kill_superstep=3)), **run)
    assert (exc.value.shard, exc.value.superstep) == (2, 3)
    assert torch.equal(tar.data, before[0]) and torch.equal(tar.heap, before[1])
    rec, st, tar2 = _port(tit, tar, tinit, 8, **run)
    np.testing.assert_array_equal(jrec, rec)
    np.testing.assert_array_equal(np.asarray(jar2.data), tar2.data.numpy())
    np.testing.assert_array_equal(np.asarray(jar2.heap), tar2.heap.numpy())
    assert st.commits == jst.commits


@needs_jax
@pytest.mark.parametrize("schedule", ["dispatched", "fused"])
def test_the_kill_counts_supersteps_from_one(schedule):
    """ft_checks.check_kill_superstep_counting: a kill at superstep 1 runs
    none; one past the run's end never fires; the sequential executor dies
    the same way."""
    _, tit, jar, _, tinit, max_iters = _batch("list", 8)
    tar = _carry(jar)
    run = dict(max_iters=max_iters, compact=True, schedule=schedule)
    ref, rst = _port(tit, tar, tinit, 8, **run)
    with pytest.raises(tfaults.ShardFailure) as exc:
        _port(tit, tar, tinit, 8, fault_injector=tfaults.FaultInjector(
            tfaults.FaultPlan(kill_shard=0, kill_superstep=1)), **run)
    assert exc.value.superstep == 1
    late = tfaults.FaultInjector(tfaults.FaultPlan(kill_shard=0,
                                                   kill_superstep=rst.supersteps + 1))
    rec, _ = _port(tit, tar, tinit, 8, fault_injector=late, **run)
    assert not late.fired and torch.equal(rec, ref)
    with pytest.raises(tfaults.ShardFailure):
        tcommit.sequential_commit_execute(tit, tar, *tinit, max_iters=max_iters,
                                          fault_injector=tfaults.FaultInjector(
                                              tfaults.FaultPlan(kill_shard=0)))


# ------------------------- (e) the superstep builder ---------------------------


@needs_jax
def test_make_superstep_takes_the_loss_operand():
    """``make_superstep(drop_prob=, drop_seed=)`` takes the superstep index
    as its last operand: a step at index i parks exactly the movers the
    mask of i loses, and a local-only step takes no index."""
    _, tit, jar, _, tinit, max_iters = _batch("list", 8)
    tar = _carry(jar)
    pools, _ = trouting.place_requests(*tinit, 8)
    kw = dict(k_local=2, max_iters=max_iters, local_backend="reference")
    plain = trouting.make_superstep(tit, 8, **kw)(pools, tar.data, tar.bounds, tar.perms)
    lossy = trouting.make_superstep(tit, 8, drop_prob=1.0, drop_seed=7, **kw)
    got = lossy(pools, tar.data, tar.bounds, tar.perms, 3)
    assert int(got[2]) == 0 and int(plain[2]) > 0  # every mover lost: nothing routed
    some = trouting.make_superstep(tit, 8, drop_prob=0.4, drop_seed=7, **kw)
    chased = trouting._local_superstep(tit, pools, tar.data, tar.bounds, tar.perms,
                                       k_local=2, max_iters=max_iters, backend="reference")
    mask = trouting._drop_mask(pools.shape[1], 0.4, 7, torch.arange(8), 3)
    _, _, want = trouting._route_decide(chased, tar.bounds, 8, return_to_cpu=False,
                                        drop_mask=mask)
    assert int(some(pools, tar.data, tar.bounds, tar.perms, 3)[2]) == int(want) < int(plain[2])
    local = trouting.make_superstep(tit, 8, drop_prob=0.4, do_route=False, **kw)
    assert int(local(pools, tar.data, tar.bounds, tar.perms)[2]) == 0


if __name__ == "__main__":
    _jax_mesh_script(sys.argv[1])
