"""Port parity: ``PulseService`` on memory nodes as processes (ROADMAP queue
1, item 3) -- rank 0 of a Gloo process group on the CPU serves, ranks 1-3
follow it (``serving.memory_node.follow``), against the same service over
``EmulatedMesh(4, "cpu")`` and the JAX service on four host devices.

One world of 4 ranks (this file run as a script, ``python
tests/test_torch_service_pg.py world OUT_DIR``, started by
``distributed.world.spawn``) runs, one service after another, each rank 0
serving and ranks 1-3 following until the service's ``close``:

  * the read/write scenarios of ``tests/test_torch_traversal_service.py``
    (the mixed heap with its B+tree updates, 40 of its 80 requests, and the
    read/write tenant pair), sync and async: every request (status,
    iters, result, rounds), every ``ServiceMetrics`` count and the final
    arena equal the emulated service's and the JAX service's (one
    subprocess, ``python tests/test_torch_service_pg.py jax OUT.npz``,
    dispatched; results and counts do not depend on the schedule), and
    every follower ends with the engine's arena;
  * a kill with durable recovery (a writable hash table of 64 keys, finds
    and inserts, failover replication, a log-shipped standby, shard 3
    killed at call 7, a read quantum, before superstep 2), sync and async: equal to the emulated
    service in every request and count, the standby equal to the
    primary, the log recovering to the resident arena;
  * the watchdog on the same table, reads only: shard 1 delayed 0.5 s a
    superstep against a timeout of 0.2 s (a healthy probe takes 12-110 ms
    here; the wall clock decides, so its properties are held, not its
    counts): shard 1 is suspected and served around, with no retry;
  * the refusals: a service on rank 1 and ``follow`` on rank 0 raise;
    after ``close`` rank 0's engine calls raise, the followers having
    returned.

The live reshard on a process group is ``tests/test_torch_reshard_pg.py``'s.
"""

import importlib.util
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import routing as trouting
from repro_torch.distributed import world
from repro_torch.serving.batching import DeviceRunner, QuantumWork

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
HAS_JAX = importlib.util.find_spec("jax") is not None
needs_jax = pytest.mark.skipif(not HAS_JAX, reason="needs the JAX package")
WORLD_TIMEOUT = 120.0
SERVICE_RUNS = [(s, p) for s in ("mixed", "rw") for p in ("sync", "async")]
MIXED_REQUESTS = 40  # of MESH_RUNS' 80: the mixed heap's five structures, eight rounds
KILL = dict(kill_shard=3, kill_call=7, kill_superstep=2)  # call 7 is a read quantum
FT_KEYS = np.arange(100, 164, dtype=np.int32)
WATCHDOG = dict(timeout_s=0.2, delay_s=0.5, quantum=2)  # a healthy probe: 12-110 ms on the CPU


def _svc_mod():
    """``tests/test_torch_traversal_service.py``, its scenario builders and
    ``outcome``; a rank of the world imports it without JAX (the port's half
    of the builders is all a rank needs)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_traversal_service

    return test_torch_traversal_service


def _mesh_kw(T, scenario):
    """The scenario's keywords and the service's, ``MESH_RUNS``' with the
    mixed heap's requests cut to ``MIXED_REQUESTS`` for the time."""
    kw = dict(dict(T.MESH_RUNS)[scenario])
    skw = dict(kw.pop("scenario_kw", {}))
    if scenario == "mixed":
        skw["n_req"] = MIXED_REQUESTS
    return skw, kw


# ----------------------------------- runs ---------------------------------------


def scenario_run(T, scenario, pipeline, mesh, follower: bool):
    """One read/write scenario over ``mesh``: rank 0's (or the emulated
    mesh's) outcome, or a follower's final arena."""
    from repro_torch.core.arena import arena_from_numpy
    from repro_torch.core.engine import PulseEngine
    from repro_torch.serving import memory_node

    skw, kw = _mesh_kw(T, scenario)
    arrays, specs, tuples = T.SCENARIOS[scenario](4, **skw)
    arena = arena_from_numpy(*arrays, device=CPU)
    if follower:
        return _arena_out(memory_node.follow(mesh, arena, specs("torch")))
    eng = PulseEngine(arena, mesh=mesh)
    svc = T.tsvc.PulseService(eng, specs("torch"), pipeline=pipeline, schedule="dispatched",
                              **kw)
    reqs = T._requests("torch", tuples)
    m = svc.run(reqs)
    return T.outcome(reqs, m, eng.arena)


def _arena_out(arena):
    return dict(data=arena.data.cpu().numpy(), heap=arena.heap.cpu().numpy())


def _ft_setup(mesh, plan, store_dir, *, watchdog=0.0, dead_rounds=3, reads_only=False):
    """A durable hash-table service at P = 4 (the read/write pair's
    writable table, 64 keys in 8 buckets; finds, and inserts of new keys
    unless ``reads_only``), with failover replication:
    ``(engine, specs, FaultToleranceConfig or None, requests)``."""
    from repro_torch.core.arena import ArenaBuilder
    from repro_torch.core.engine import PulseEngine
    from repro_torch.core.faults import FaultInjector, FaultPlan
    from repro_torch.core.structures import hash_table
    from repro_torch.distributed.arena_ft import (
        ArenaStore,
        FaultToleranceConfig,
        ReplicationConfig,
    )
    from repro_torch.serving.admission import TraversalRequest
    from repro_torch.serving.traversal_service import StructureSpec

    b = ArenaBuilder(512, 4, num_shards=4, policy="interleaved")
    sent = torch.from_numpy(hash_table.build_writable(b, FT_KEYS, 2 * FT_KEYS, 8))
    specs = {"hash": StructureSpec(hash_table.find_iterator(8), (sent,), group="hash")}
    if not reads_only:
        specs["hash_ins"] = StructureSpec(hash_table.insert_iterator(8), (sent,), group="hash",
                                          takes_value=True)
    eng = PulseEngine(b.finish(device=CPU), mesh=mesh,
                      fault_injector=FaultInjector(FaultPlan(**plan)) if plan else None)
    reqs = []
    for i in range(36):
        if i % 4 == 2:
            if not reads_only:
                reqs.append(TraversalRequest(i, "hash_ins", 1000 + i, value=2000 + i,
                                             tenant="w", arrive_round=i // 8))
        else:
            reqs.append(TraversalRequest(i, "hash", int(FT_KEYS[(i * 7) % len(FT_KEYS)]),
                                         tenant="r", arrive_round=i // 8))
    ft = None
    if store_dir is not None:
        ft = FaultToleranceConfig(store=ArenaStore(store_dir), snapshot_every=100,
                                  dead_rounds=dead_rounds,
                                  replication=ReplicationConfig(policy="failover"),
                                  watchdog_timeout_s=watchdog)
    return eng, specs, ft, reqs


def kill_run(T, pipeline, mesh, follower: bool, store_dir):
    """The durable kill: rank 0's (or the emulated mesh's) outcome with the
    standby's check and the log's recovery, or a follower's arena."""
    from repro_torch.distributed.arena_ft import ArenaStore
    from repro_torch.serving import memory_node
    from repro_torch.serving.traversal_service import PulseService

    eng, specs, ft, reqs = _ft_setup(mesh, KILL, None if follower else store_dir)
    if follower:
        return _arena_out(memory_node.follow(mesh, eng.arena, specs))
    svc = PulseService(eng, specs, slots_per_structure=8, quantum=6, pipeline=pipeline,
                       fault_tolerance=ft)
    m = svc.run(reqs)
    ft.store.close()
    svc._replicas.verify(eng.arena)  # the standby still equals the primary
    out = T.outcome(reqs, m, eng.arena)
    if pipeline == "sync":  # the log, replayed by rank 0 alone (the sequential commit)
        store = ArenaStore(store_dir)
        store.register_iterator("hash_ins", specs["hash_ins"].iterator)
        rec, _ = store.recover(device=CPU)
        store.close()
        out["recovered_same"] = np.asarray(torch.equal(rec.data, eng.arena.data)
                                           and torch.equal(rec.heap, eng.arena.heap))
    leader = getattr(eng.mesh, "leader", None)
    if leader is not None:
        out["leader"] = np.asarray(json.dumps(vars(leader.stats)))
    return out


def watchdog_run(mesh, follower: bool, store_dir):
    """Reads only, the watchdog armed after its warm-up, then shard 1
    delayed 2.5x its timeout (``WATCHDOG``): rank 0's properties, or a
    follower's arena."""
    from repro_torch.core.faults import FaultInjector, FaultPlan
    from repro_torch.serving import memory_node
    from repro_torch.serving.traversal_service import PulseService

    eng, specs, ft, reqs = _ft_setup(mesh, None, None if follower else store_dir,
                                     watchdog=1.0, dead_rounds=1000, reads_only=True)
    if follower:
        return _arena_out(memory_node.follow(mesh, eng.arena, specs))
    svc = PulseService(eng, specs, slots_per_structure=8, quantum=WATCHDOG["quantum"],
                       fault_tolerance=ft)
    svc.ft.watchdog_timeout_s = timeout = WATCHDOG["timeout_s"]
    eng.fault_injector = FaultInjector(FaultPlan(delay_shard=1, delay_s=WATCHDOG["delay_s"]))
    m = svc.run(reqs)
    ft.store.close()
    return dict(suspects=m.watchdog_suspects, probes=m.watchdog_probes,
                failover=m.failover_quanta, retries=m.retries, recoveries=m.recoveries,
                dead=sorted(svc._detector.dead_shards()), timeout=timeout,
                results=np.stack([r.result for r in reqs]),
                queries=np.asarray([r.query for r in reqs]),
                status=np.asarray([r.status for r in reqs]), **_arena_out(eng.arena))


def refusal_run(T, mesh, rank: int):
    """The refusals, and a stopped group: rank 0's messages."""
    from repro_torch.core.arena import arena_from_numpy
    from repro_torch.core.engine import PulseEngine
    from repro_torch.serving import memory_node

    arrays, specs, _ = T.SCENARIOS["list"](4)
    arena = arena_from_numpy(*arrays, device=CPU)
    out = {}
    try:
        if rank == 0:
            memory_node.follow(mesh, arena, specs("torch"))
        else:
            T.tsvc.PulseService(PulseEngine(arena, mesh=mesh), specs("torch"))
    except ValueError as e:
        out["wrong_rank"] = str(e)
    if rank:
        memory_node.follow(mesh, arena, specs("torch"))
        return out
    eng = PulseEngine(arena, mesh=mesh)
    svc = T.tsvc.PulseService(eng, specs("torch"), slots_per_structure=4, quantum=4)
    svc.close()
    it = specs("torch")["list"].iterator
    try:
        eng.execute(it, torch.zeros(1, dtype=torch.int32),
                    torch.zeros((1, it.scratch_words), dtype=torch.int32))
    except RuntimeError as e:
        out["after_close"] = str(e)
    return out


def _world_rank(rank, world_size, out_dir):
    sys.modules.setdefault("jax", None)  # the port's half of the scenario builders only
    T = _svc_mod()
    mesh = trouting.ProcessGroupMesh(device=CPU)
    follower = rank != 0
    out, seconds = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for scenario, pipeline in SERVICE_RUNS:
            t0 = time.perf_counter()
            out[f"{scenario}/{pipeline}"] = scenario_run(T, scenario, pipeline, mesh, follower)
            seconds[f"{scenario}/{pipeline}"] = time.perf_counter() - t0
        for pipeline in ("sync", "async"):
            t0 = time.perf_counter()
            out[f"kill/{pipeline}"] = kill_run(T, pipeline, mesh, follower,
                                               Path(tmp) / f"kill_{pipeline}")
            seconds[f"kill/{pipeline}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["watchdog"] = watchdog_run(mesh, follower, Path(tmp) / "watchdog")
        seconds["watchdog"] = time.perf_counter() - t0
    out["refusals"] = refusal_run(T, mesh, rank)
    out["seconds"] = seconds
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def _jax_script(out_path):
    """Script mode: the JAX service over four host devices, dispatched, for
    each read/write scenario, to ``out_path``."""
    import jax

    assert jax.device_count() == 4, jax.devices()
    T = _svc_mod()
    arrays = {}
    for scenario in ("mixed", "rw"):
        skw, kw = _mesh_kw(T, scenario)
        got = T.outcome(*T.serve("jax", scenario, 4, scenario_kw=skw, schedule="dispatched",
                                 **kw))
        for k, v in got.items():
            arrays[f"{scenario}/{k}"] = v
    np.savez(out_path, **arrays)


# --------------------------------- fixtures -------------------------------------


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world of 4 ranks and the JAX service's run, started together as
    subprocesses; the emulated mesh's services meanwhile."""
    if not HAS_JAX:
        pytest.skip("needs the JAX package")
    tmp = tmp_path_factory.mktemp("service_pg")
    jax_out = tmp / "jax.npz"
    procs = {"jax": subprocess.Popen(
        [sys.executable, str(Path(__file__)), "jax", str(jax_out)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    (tmp / "world").mkdir()
    procs["world"] = subprocess.Popen(
        [sys.executable, str(Path(__file__)), "world", str(tmp / "world")], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    T = _svc_mod()
    emulated = {}
    mesh = trouting.EmulatedMesh(4, CPU)
    for scenario, pipeline in SERVICE_RUNS:
        emulated[f"{scenario}/{pipeline}"] = scenario_run(T, scenario, pipeline, mesh, False)
    for pipeline in ("sync", "async"):
        emulated[f"kill/{pipeline}"] = kill_run(T, pipeline, mesh, False, tmp / f"kill_{pipeline}")
    logs = {}
    for key, proc in procs.items():
        try:
            logs[key], _ = proc.communicate(timeout=WORLD_TIMEOUT + 60)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        assert proc.returncode == 0, f"{key}:\n{logs[key]}"
    ranks = []
    for r in range(4):
        with open(tmp / "world" / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    jax_arrays = dict(np.load(jax_out))
    jax_runs = {s: {k: jax_arrays[f"{s}/{k}"] for k in ("req", "result", "metrics", "data",
                                                        "heap")} for s in ("mixed", "rw")}
    return dict(emulated=emulated, ranks=ranks, jax=jax_runs, T=T)


# ---------------------------------- the tests -----------------------------------

RUN_IDS = [f"{s}-{p}" for s, p in SERVICE_RUNS]


@needs_jax
@pytest.mark.parametrize("scenario,pipeline", SERVICE_RUNS, ids=RUN_IDS)
def test_served_group_equals_the_emulated_service(scenario, pipeline, runs):
    """Every request, every metric count and the final arena of rank 0's
    service equal the same service's over ``EmulatedMesh(4)``."""
    key = f"{scenario}/{pipeline}"
    runs["T"].assert_same(runs["emulated"][key], runs["ranks"][0][key], key)
    m = json.loads(str(runs["ranks"][0][key]["metrics"]))
    assert m["supersteps"] > 0 and m["wire_words"] > 0 and m["commits"] > 0


@needs_jax
@pytest.mark.parametrize("scenario,pipeline", SERVICE_RUNS, ids=RUN_IDS)
def test_served_group_equals_the_jax_service(scenario, pipeline, runs):
    key = f"{scenario}/{pipeline}"
    runs["T"].assert_same(runs["jax"][scenario], runs["ranks"][0][key], key)


@needs_jax
@pytest.mark.parametrize("key", [f"{s}/{p}" for s, p in SERVICE_RUNS]
                         + ["kill/sync", "kill/async", "watchdog"])
def test_every_follower_ends_with_the_engine_arena(key, runs):
    """``follow`` returns, on ``close``, its copy of rank 0's engine arena:
    the writes' results, the recovered arena, bit for bit."""
    lead = runs["ranks"][0][key]
    for r in range(1, 4):
        got = runs["ranks"][r][key]
        np.testing.assert_array_equal(lead["data"], got["data"], err_msg=f"rank {r}")
        np.testing.assert_array_equal(lead["heap"], got["heap"], err_msg=f"rank {r}")


@needs_jax
@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_a_kill_recovers_durably_on_the_group(pipeline, runs):
    """Shard 3 killed at call 7: one recovery, the failover replica serving
    the dead shard's reads with no read retried, the standby shipped every
    write quantum, and all of it equal to the emulated service; the log
    recovers to the resident arena; the leader installed the standby's and
    the recovery's arenas on the followers and scattered replica rows."""
    key = f"kill/{pipeline}"
    got = runs["ranks"][0][key]
    runs["T"].assert_same(runs["emulated"][key], got, key)
    m = json.loads(str(got["metrics"]))
    assert m["recoveries"] == 1 and m["replica_quanta"] > 0 and m["completed"] == 36
    assert m["failover_quanta"] >= 1 and m["retries"] == 0
    assert pipeline == "async" or bool(got["recovered_same"])
    stats = json.loads(str(got["leader"]))
    assert stats["arenas"] >= 2 and stats["replica_versions"] >= 1
    assert stats["headers"] > stats["calls"] > 0


@needs_jax
def test_the_watchdog_suspects_the_delayed_rank(runs):
    """The straggler sleeps on rank 1 alone and rank 0 waits for it at the
    superstep's collective: the watchdog suspects shard 1, the reads fan
    out to its replica, and every read finds its key (no retry, no
    recovery)."""
    got = runs["ranks"][0]["watchdog"]
    assert got["suspects"] >= 1 and 1 in got["dead"], got
    assert got["failover"] >= 1 and got["retries"] == got["recoveries"] == 0
    assert (got["status"] == runs["T"].STATUS_DONE).all()
    np.testing.assert_array_equal(got["results"][:, 1], 2 * got["queries"])


@needs_jax
def test_close_stops_the_followers(runs):
    """``close`` ends every follower (the world ran to its end), and rank 0's
    engine on the stopped group refuses further calls."""
    msg = runs["ranks"][0]["refusals"]["after_close"]
    assert "stopped" in msg and "PulseService.close" in msg


@needs_jax
@pytest.mark.parametrize("rank", [0, 1])
def test_only_rank_0_serves(rank, runs):
    """A service on rank 1 and ``follow`` on rank 0 raise ``ValueError``."""
    msg = runs["ranks"][rank]["refusals"]["wrong_rank"]
    assert ("runs the PulseService" if rank == 0 else "follows rank 0") in msg, msg


def test_wait_idle_waits_and_leaves_the_error_pending():
    """``DeviceRunner.wait_idle``: every queued quantum has run or been
    skipped behind an error when it returns, and the error is raised by the
    next ``drain``, not by it."""
    ran = []

    def work(i, fail=False):
        def run():
            time.sleep(0.01)
            if fail:
                raise ValueError(f"quantum {i}")
            return i
        return QuantumWork(label=str(i), run=run, apply=ran.append)

    runner = DeviceRunner(depth=4).start()
    try:
        runner.submit(work(0))
        runner.submit(work(1, fail=True))
        runner.submit(work(2))
        runner.wait_idle()
        assert runner.in_flight == 0 and ran == [0]
        with pytest.raises(ValueError, match="quantum 1"):
            runner.drain()
    finally:
        runner.close()


if __name__ == "__main__":
    if sys.argv[1] == "world":
        world.spawn(_world_rank, 4, (sys.argv[2],), timeout=WORLD_TIMEOUT)
    else:
        _jax_script(sys.argv[2])
