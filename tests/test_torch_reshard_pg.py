"""Port parity: the live reshard on memory nodes as processes (ROADMAP queue
1, item 6) -- ``PulseService.request_reshard`` on a ``routing.ProcessGroupMesh``
whose world has twice the ranks it serves on, against the same service over
``EmulatedMesh`` and the JAX service on eight host devices.

One world of 8 Gloo ranks on the CPU (this file run as a script, ``python
tests/test_torch_reshard_pg.py world OUT_DIR``, started by
``distributed.world.spawn``) runs, one service after another, rank 0
serving and every other rank in ``serving.memory_node.follow``:

  * the grow: ``tests/test_torch_elastic.py``'s BST service (40 requests,
    every fourth an in-place update, ``slots_per_structure=8``,
    ``quantum=6``) on ranks 0-3 (``distributed.world.first_ranks(4)``),
    ``request_reshard(8)`` at round 3, sync read-write, async read-write
    and sync read-only: every request (status, iters, result, rounds),
    every ``ServiceMetrics`` count and the final ``data``, ``bounds``,
    ``perms`` and ``heap`` equal the emulated service's (4 -> 8, in this
    process) and the JAX service's (dispatched; results and counts do not
    depend on the schedule, and async equals sync); every rank ends with
    the engine's arena; ranks 4-7 join no call before the cutover and some
    after it (each rank counts the calls it joined, by the arena's width);
  * the shrink (run first, so that every rank makes the group of the
    first 4 ranks at its cutover's header): the same service on all 8
    ranks from ``remap_shards(bst4, 8)``, ``request_reshard(4)`` at round
    3, sync read-write: equal to the emulated service and to the JAX one
    (``jax.devices()[:4]`` after the cutover); ranks 4-7 join no call
    after the cutover, hold no resident rows when ``follow`` returns
    (``routing.drop_resident``) and return None at the close;
  * a durable grow (sync): ``tests/test_torch_service_pg.py``'s writable
    hash table under fault tolerance with failover replication, the
    reshard to 8 requested at round 2, shard 5 killed at a read quantum
    after the cutover (call ``DURABLE_KILL``, before superstep 2): equal
    to the emulated service in every request and count, one recovery on
    the 8-rank group, the ``"reshard"`` marker appended to the log, the
    log recovering to the resident arena, the standby equal to the primary;
  * a service on ranks 0-3 that never reshards: ``close`` ends all 8.

A second world, of 4 ranks serving 4 (``python tests/test_torch_reshard_pg.py
small OUT_DIR``), asks for 8: the cutover raises ``RuntimeError`` naming 8
ranks and a world of 4, and ``close`` still ends the followers; on an arena
of 4 x 129 rows the request itself raises ``ValueError``.
"""

import importlib.util
import json
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import routing as trouting
from repro_torch.distributed import world

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
HAS_JAX = importlib.util.find_spec("jax") is not None
needs_jax = pytest.mark.skipif(not HAS_JAX, reason="needs the JAX package")
WORLD = 8
SERVED = 4  # the grow's first width, the shrink's last
WORLD_TIMEOUT = 150.0
RESHARD_AT = 3  # the round at which the BST runs ask for the reshard
GROW_RUNS = [("sync", True), ("async", True), ("sync", False)]  # (pipeline, writes)
GROW_IDS = [f"{p}-{'rw' if w else 'ro'}" for p, w in GROW_RUNS]
DURABLE_RESHARD_AT = 2
DURABLE_KILL = dict(kill_shard=5, kill_call=8, kill_superstep=2)  # call 8: a read quantum at 8


def _tests_mod(name):
    """A sibling test module and its scenario builders; a rank imports it
    without JAX (the port's half of the builders is all a rank needs)."""
    sys.path.insert(0, str(ROOT / "tests"))
    return __import__(name)


# ----------------------------------- runs ---------------------------------------


def _outcome(E, reqs, m, arena):
    out = E.outcome(reqs, m, arena)
    out["bounds"], out["perms"] = (np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)
                                   for t in (arena.bounds, arena.perms))
    return out


def assert_same(E, want, got, tag):
    E.assert_same(want, got, tag)
    for k in ("bounds", "perms"):
        np.testing.assert_array_equal(want[k], got[k], err_msg=f"{tag}: {k}")


def bst_service(pkg, mesh, start, target, pipeline="sync", writes=True, *, follower=False):
    """``test_torch_elastic.serve_reshard``'s BST service over ``mesh`` at
    ``start`` shards (the 4-shard build, or its remap at 8), the reshard to
    ``target`` asked for at round ``RESHARD_AT`` (None: never).  The port
    on a process group or an ``EmulatedMesh`` (``pkg="torch"``; a
    follower's final arena, or None) or the JAX package (``mesh`` a
    ``jax.sharding.Mesh``): rank 0's outcome."""
    from repro_torch.core import arena as tarena

    E = _tests_mod("test_torch_elastic")
    tar, root = E._bst4()
    if start == 8:
        tar = tarena.remap_shards(tar, 8)
    if pkg == "jax":
        from repro.core.engine import PulseEngine
        from repro.core.structures import bst
        from repro.serving import admission as adm
        from repro.serving import traversal_service as svc_mod

        eng = PulseEngine(E._jax_arena(tar), mesh=mesh)
    else:
        from repro_torch.core.engine import PulseEngine
        from repro_torch.core.structures import bst
        from repro_torch.serving import admission as adm
        from repro_torch.serving import memory_node
        from repro_torch.serving import traversal_service as svc_mod

        eng = PulseEngine(tar, mesh=mesh)
    specs = {"bst": svc_mod.StructureSpec(bst.find_iterator(), (root,), group="bst"),
             "bst_upd": svc_mod.StructureSpec(bst.update_iterator(), (root,), group="bst",
                                              takes_value=True)}
    if follower:
        return memory_node.follow(mesh, tar, specs)
    svc = svc_mod.PulseService(eng, specs, slots_per_structure=8, quantum=6, pipeline=pipeline,
                               schedule="dispatched")
    reqs = E.bst_reqs(adm, writes=writes)
    for r in reqs:
        svc.submit(r)
    try:
        while svc._busy():
            if target is not None and svc.metrics.rounds == RESHARD_AT:
                svc.request_reshard(target)
            if svc.metrics.rounds > 10000:
                raise RuntimeError("the service did not drain")
            svc.step()
    finally:
        svc.close()
        svc._drain_emit()
    return _outcome(E, reqs, svc.metrics, eng.arena)


def durable_grow(mesh, store_dir, *, follower=False):
    """The durable grow: ``test_torch_service_pg._ft_setup``'s writable
    hash table at 4 shards with failover replication, the reshard to 8 at
    round ``DURABLE_RESHARD_AT``, shard 5 killed by ``DURABLE_KILL``.
    Rank 0's (or the emulated mesh's) outcome with its checks, or a
    follower's arena."""
    from repro_torch.distributed.arena_ft import ArenaStore
    from repro_torch.serving import memory_node
    from repro_torch.serving.traversal_service import PulseService

    S = _tests_mod("test_torch_service_pg")
    E = _tests_mod("test_torch_elastic")
    eng, specs, ft, reqs = S._ft_setup(mesh, DURABLE_KILL, None if follower else store_dir)
    if follower:
        return memory_node.follow(mesh, eng.arena, specs)
    svc = PulseService(eng, specs, slots_per_structure=8, quantum=6, schedule="dispatched",
                       fault_tolerance=ft)
    failed_at = []  # the engine's width at each shard failure
    on_failure = svc._on_shard_failure
    svc._on_shard_failure = lambda e, rnd: (failed_at.append(eng.arena.num_shards),
                                            on_failure(e, rnd))
    markers = []  # the log's markers as appended (the snapshot after one compacts it away)
    append = ft.store.log.append
    ft.store.log.append = lambda rec: (markers.append(rec) if "kind" in rec else None,
                                       append(rec))[1]
    for r in reqs:
        svc.submit(r)
    try:
        while svc._busy():
            if svc.metrics.rounds == DURABLE_RESHARD_AT:
                svc.request_reshard(8)
            svc.step()
    finally:
        svc.close()
        svc._drain_emit()
    ft.store.close()
    svc._replicas.verify(eng.arena)
    out = _outcome(E, reqs, svc.metrics, eng.arena)
    store = ArenaStore(store_dir)
    store.register_iterator("hash_ins", specs["hash_ins"].iterator)
    rec, _ = store.recover(device=CPU)
    out.update(
        failed_at=np.asarray(failed_at),
        markers=np.asarray(json.dumps(markers)),
        recovered_same=np.asarray(all(torch.equal(getattr(rec, f), getattr(eng.arena, f))
                                      for f in ("data", "bounds", "perms", "heap"))),
        standby_same=np.asarray(all(torch.equal(getattr(svc._replicas.shadow, f),
                                                getattr(eng.arena, f))
                                    for f in ("data", "bounds", "perms", "heap"))))
    store.close()
    return out


def _arena_out(arena):
    if arena is None:
        return None
    return {f: getattr(arena, f).cpu().numpy() for f in ("data", "bounds", "perms", "heap")}


def _world_rank(rank, world_size, out_dir):
    """Every run of the world of 8 on one rank; its outputs, and the widths
    of the calls it joined in each run, to ``out_dir/rank{rank}.pkl``."""
    sys.modules.setdefault("jax", None)  # the port's half of the scenario builders only
    joined = []
    execute = trouting.distributed_execute

    def counted(it, arena, *args, **kw):
        joined.append(int(arena.num_shards))
        return execute(it, arena, *args, **kw)

    trouting.distributed_execute = counted
    from repro_torch.serving import memory_node

    follow, resident = memory_node.follow, []

    def follow_counted(*args):
        # the rows still resident as follow returns (its caller still holds
        # the arena the service started from)
        got = follow(*args)
        resident.append(len(trouting._RESIDENT) + len(trouting._RESIDENT_REPLICA))
        return got

    memory_node.follow = follow_counted
    follower = rank != 0
    out = {}

    def run(key, fn, *args, **kw):
        joined.clear()
        resident.clear()
        got = fn(*args, follower=follower, **kw)
        out[key] = dict(got=_arena_out(got) if follower else got, joined=list(joined),
                        resident=resident[0] if follower else None)

    # the shrink first: every rank makes the group of the first 4 ranks at
    # its cutover's header (dist.new_group); later runs take it made
    run("shrink", bst_service, "torch", trouting.ProcessGroupMesh(world.first_ranks(WORLD), CPU),
        WORLD, SERVED)
    served = trouting.ProcessGroupMesh(world.first_ranks(SERVED), CPU)
    for pipeline, writes in GROW_RUNS:
        run(f"grow/{pipeline}/{writes}", bst_service, "torch", served, SERVED, WORLD, pipeline,
            writes)
    with tempfile.TemporaryDirectory() as tmp:
        run("durable", durable_grow, served, Path(tmp) / "durable")
    run("none", bst_service, "torch", served, SERVED, None, "sync", False)
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def _uneven_arena():
    """A 4-shard list arena of 4 x 129 rows, which 8 shards cannot split
    evenly, and its specs."""
    from repro_torch.core.arena import ArenaBuilder
    from repro_torch.core.structures import linked_list
    from repro_torch.serving.traversal_service import StructureSpec

    b = ArenaBuilder(4 * 129, 4, num_shards=SERVED, policy="interleaved")
    keys = np.arange(100, 116, dtype=np.int32)
    head = linked_list.build_into(b, keys, 2 * keys)
    return b.finish(device=CPU), {"list": StructureSpec(linked_list.find_iterator(), (head,))}


def _small_rank(rank, world_size, out_dir):
    """The world of 4 serving 4: ``request_reshard(8)``'s error at the
    cutover, then on an arena whose rows 8 shards cannot split evenly, the
    error at the request, on rank 0."""
    from repro_torch.core.engine import PulseEngine
    from repro_torch.serving import memory_node
    from repro_torch.serving.traversal_service import PulseService

    sys.modules.setdefault("jax", None)
    mesh = trouting.ProcessGroupMesh(world.first_ranks(world_size), CPU)
    out = {}
    try:
        bst_service("torch", mesh, SERVED, WORLD, follower=rank != 0)
    except RuntimeError as e:
        out["error"] = str(e)
    arena, specs = _uneven_arena()
    if rank:
        memory_node.follow(mesh, arena, specs)
    else:
        svc = PulseService(PulseEngine(arena, mesh=mesh), specs)
        try:
            svc.request_reshard(WORLD)
        except ValueError as e:
            out["uneven"] = str(e)
        finally:
            svc.close()
    with open(Path(out_dir) / f"small{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def _jax_script(out_path):
    """Script mode: the JAX services on eight host devices, dispatched: the
    grow read-write and read-only (sync) and the shrink, to ``out_path``."""
    import jax

    assert jax.device_count() == WORLD, jax.devices()

    def mesh(n):
        return jax.sharding.Mesh(np.array(jax.devices()[:n]), ("mem",))

    arrays = {}
    runs = {f"grow/{w}": (SERVED, WORLD, w) for w in (True, False)}
    runs["shrink"] = (WORLD, SERVED, True)
    for key, (start, target, writes) in runs.items():
        got = bst_service("jax", mesh(start), start, target, writes=writes)
        arrays.update({f"{key}/{k}": v for k, v in got.items()})
    np.savez(out_path, **arrays)


# --------------------------------- fixtures -------------------------------------


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worlds of 8 and 4 ranks and the JAX services' run, started
    together as subprocesses; the emulated mesh's services meanwhile."""
    if not HAS_JAX:
        pytest.skip("needs the JAX package")
    tmp = tmp_path_factory.mktemp("reshard_pg")
    jax_out = tmp / "jax.npz"
    procs = {"jax": subprocess.Popen(
        [sys.executable, str(Path(__file__)), "jax", str(jax_out)],
        env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
                 JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    for kind in ("world", "small"):
        procs[kind] = subprocess.Popen(
            [sys.executable, str(Path(__file__)), kind, str(tmp)], env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    E = _tests_mod("test_torch_elastic")
    emulated = {}
    for pipeline, writes in GROW_RUNS:
        emulated[f"grow/{pipeline}/{writes}"] = bst_service(
            "torch", trouting.EmulatedMesh(SERVED, CPU), SERVED, WORLD, pipeline, writes)
    emulated["shrink"] = bst_service("torch", trouting.EmulatedMesh(WORLD, CPU), WORLD, SERVED)
    emulated["durable"] = durable_grow(trouting.EmulatedMesh(SERVED, CPU), tmp / "durable")
    logs = {}
    for key, proc in procs.items():
        try:
            logs[key], _ = proc.communicate(timeout=WORLD_TIMEOUT + 60)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        assert proc.returncode == 0, f"{key}:\n{logs[key]}"
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    small = []
    for r in range(SERVED):
        with open(tmp / f"small{r}.pkl", "rb") as f:
            small.append(pickle.load(f))
    got = dict(np.load(jax_out))
    jax_runs = {}
    for key in ("grow/True", "grow/False", "shrink"):
        jax_runs[key] = {k.rsplit("/", 1)[1]: v for k, v in got.items()
                         if k.rsplit("/", 1)[0] == key}
    return dict(emulated=emulated, ranks=ranks, small=small, jax=jax_runs, E=E)


# ---------------------------------- the tests -----------------------------------


def _metrics(got):
    return json.loads(str(got["metrics"]))


@needs_jax
@pytest.mark.parametrize("pipeline,writes", GROW_RUNS, ids=GROW_IDS)
def test_grow_equals_the_emulated_service(pipeline, writes, runs):
    """4 -> 8 on the process group: every request, every count and the
    final arena equal the same service's over ``EmulatedMesh(4)``."""
    key = f"grow/{pipeline}/{writes}"
    got = runs["ranks"][0][key]["got"]
    assert_same(runs["E"], runs["emulated"][key], got, key)
    m = _metrics(got)
    assert m["reshards"] == 1 and m["completed"] == 40 and (m["commits"] > 0) == writes
    assert len(got["bounds"]) == WORLD + 1


@needs_jax
@pytest.mark.parametrize("pipeline,writes", GROW_RUNS, ids=GROW_IDS)
def test_grow_equals_the_jax_service(pipeline, writes, runs):
    key = f"grow/{pipeline}/{writes}"
    assert_same(runs["E"], runs["jax"][f"grow/{writes}"], runs["ranks"][0][key]["got"], key)


@needs_jax
@pytest.mark.parametrize("key", [f"grow/{p}/{w}" for p, w in GROW_RUNS] + ["durable"])
def test_every_rank_ends_with_the_engine_arena(key, runs):
    """Each of the 8 ranks' ``follow`` returns, at the close, its copy of
    rank 0's engine arena, the new ranks' included."""
    lead = runs["ranks"][0][key]["got"]
    for r in range(1, WORLD):
        got = runs["ranks"][r][key]["got"]
        for f in ("data", "bounds", "perms", "heap"):
            np.testing.assert_array_equal(lead[f], got[f], err_msg=f"rank {r}: {f}")


@needs_jax
@pytest.mark.parametrize("key", [f"grow/{p}/{w}" for p, w in GROW_RUNS] + ["durable"])
def test_new_ranks_join_only_after_the_cutover(key, runs):
    """Ranks 0-3 join calls at 4 shards, then at 8; ranks 4-7 join none
    at 4 and at least one at 8; every rank of a width joins its calls."""
    joined = [runs["ranks"][r][key]["joined"] for r in range(WORLD)]
    for r in range(SERVED):
        assert joined[r] == joined[0], r
        assert 4 in joined[r] and 8 in joined[r] and joined[r] == sorted(joined[r]), r
    for r in range(SERVED, WORLD):
        assert joined[r] == [w for w in joined[0] if w == 8] and joined[r], r


@needs_jax
@pytest.mark.parametrize("reference", ["emulated", "jax"])
def test_shrink_equals_the_reference_services(reference, runs):
    """8 -> 4 on the process group, from ``remap_shards(bst4, 8)``: equal
    to the emulated service (8 -> 4) and to the JAX one."""
    got = runs["ranks"][0]["shrink"]["got"]
    assert_same(runs["E"], runs[reference]["shrink"], got, f"shrink vs {reference}")
    assert _metrics(got)["reshards"] == 1 and len(got["bounds"]) == SERVED + 1


@needs_jax
def test_a_shrink_leaves_the_last_ranks_idle(runs):
    """After 8 -> 4, ranks 4-7 join no call, hold no resident rows and
    return None at the close; ranks 1-3 end with the engine's arena."""
    lead = runs["ranks"][0]["shrink"]
    assert 8 in lead["joined"] and 4 in lead["joined"]
    for r in range(1, WORLD):
        got = runs["ranks"][r]["shrink"]
        if r < SERVED:
            assert got["joined"] == lead["joined"], r
            np.testing.assert_array_equal(got["got"]["data"], lead["got"]["data"])
        else:
            assert got["joined"] == [w for w in lead["joined"] if w == 8], r
            assert got["got"] is None and got["resident"] == 0, r


@needs_jax
def test_a_durable_grow_recovers_on_the_grown_group(runs):
    """The writable table under fault tolerance grows to 8, then shard 5
    dies at a read quantum: equal to the emulated service in every request
    and count; one recovery, at 8 shards; the reshard's marker was appended
    to the log (the snapshot after it compacts it away), which recovers to
    the resident arena; the standby equals the primary."""
    got = runs["ranks"][0]["durable"]["got"]
    assert_same(runs["E"], runs["emulated"]["durable"], got, "durable")
    m = _metrics(got)
    assert m["reshards"] == 1 and m["recoveries"] == 1 and m["completed"] == 36
    assert m["failover_quanta"] >= 1 and m["replica_quanta"] > 0
    assert got["failed_at"].tolist() == [8]
    markers = json.loads(str(got["markers"]))
    assert [(e["old_shards"], e["new_shards"]) for e in markers] == [(4, 8)]
    assert bool(got["recovered_same"]) and bool(got["standby_same"])


@needs_jax
def test_close_ends_every_rank_of_a_world_that_never_reshards(runs):
    """A service on ranks 0-3 of the world of 8 that never reshards: the
    world ran to its end; ranks 1-3 end with the engine's arena, ranks 4-7
    joined no call and return None."""
    lead = runs["ranks"][0]["none"]
    assert _metrics(lead["got"])["reshards"] == 0 and set(lead["joined"]) == {4}
    for r in range(1, WORLD):
        got = runs["ranks"][r]["none"]
        if r < SERVED:
            np.testing.assert_array_equal(got["got"]["data"], lead["got"]["data"])
        else:
            assert got["got"] is None and got["joined"] == [], r


@needs_jax
def test_too_small_a_world_raises_at_the_cutover(runs):
    msg = runs["small"][0]["error"]
    assert "8 ranks" in msg and "world has 4" in msg, msg
    assert all(not s for s in runs["small"][1:])  # the followers ended at the close


@needs_jax
def test_rows_that_do_not_split_raise_at_the_request(runs):
    """On a process group ``request_reshard`` refuses, before any drain, a
    width whose shards the arena's rows cannot fill evenly (the replica
    rows are scattered in equal blocks); the reference has no such check
    and would fail at the cutover's first call."""
    msg = runs["small"][0]["uneven"]
    assert "516 rows" in msg and "8 equal shards" in msg, msg


if __name__ == "__main__":
    if sys.argv[1] == "world":
        world.spawn(_world_rank, WORLD, (sys.argv[2],), timeout=WORLD_TIMEOUT)
    elif sys.argv[1] == "small":
        world.spawn(_small_rank, SERVED, (sys.argv[2],), timeout=WORLD_TIMEOUT)
    else:
        _jax_script(sys.argv[2])
