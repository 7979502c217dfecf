"""Port parity: traversal serving (item 7), ``repro_torch.serving.
traversal_service.PulseService`` against the JAX package's.

The same seeded heaps (built once with the port's builders and carried
into the JAX package) and the same submit sequences go through both
services, at a fixed quantum, and every request must retire with the same
``status``, ``iters``, ``result``, ``admit_round`` and ``finish_round``,
every ``ServiceMetrics`` count must agree and a write tenant's final arena
must be bit-equal:

  * the four-structure heap of ``tests/test_serving_traversals.py`` with a
    B+tree update tenant beside its readers, on the port's ``"kernel"``
    and ``"reference"`` backends (the JAX service on ``"xla"``), sync and
    async, at P = 1 in this process and at P = 4 (``EmulatedMesh``
    against a JAX mesh of four host devices) from one subprocess: this
    file run as a script with four devices in its environment alone;
  * the read/write tenant pair (list inserts and deletes, hash inserts)
    likewise;
  * continuations, backfill, tenant fairness and EDF preemption on the
    list service of ``tests/test_async_service.py``, and its sync/async
    identity with writes.

Rate limits, shedding and SLO quantum sizing read the wall clock, so they
are held to their JAX tests' properties, not bit for bit; so are the
device runner, the verify-at-registration rejection and the refusals
(``backend="xla"``; fault tolerance's are in
``tests/test_torch_fault_tolerance.py``).  The ``gpu`` test runs the async
service on the fused schedule on the card against a CPU copy.

Run as a script (``python tests/test_torch_traversal_service.py OUT.npz``
with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``) it writes the
JAX package's four-shard outcomes to OUT.npz."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.core import arena as jarena
    from repro.core.engine import PulseEngine as JEngine
    from repro.core.structures import btree as jbtree
    from repro.core.structures import hash_table as jhash
    from repro.core.structures import linked_list as jlist
    from repro.core.structures import skiplist as jskip
    from repro.serving import admission as jadm
    from repro.serving import traversal_service as jsvc
except ImportError:  # the card's machine has no JAX; its gpu test needs none
    jax = None
from repro_torch.core import arena as tarena
from repro_torch.core import isa as tisa
from repro_torch.core import routing as trouting
from repro_torch.core import verify as tverify
from repro_torch.core.engine import PulseEngine as TEngine
from repro_torch.core.iterator import STATUS_DONE, STATUS_SHED
from repro_torch.core.structures import btree as tbtree
from repro_torch.core.structures import hash_table as thash
from repro_torch.core.structures import isa_programs as tprogs
from repro_torch.core.structures import linked_list as tlist
from repro_torch.core.structures import skiplist as tskip
from repro_torch.serving import admission as tadm
from repro_torch.serving import traversal_service as tsvc
from repro_torch.serving.batching import DeviceRunner, QuantumWork

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")
N_BUCKETS = 32


# -------------------------------- scenarios -----------------------------------
#
# A scenario is (arena arrays, specs(pkg), request tuples): the arena built
# on the host, the specs built from either package's structures, and the
# requests as (req_id, structure, query, tenant, arrive_round, value,
# deadline_ms) tuples.


def _mods(pkg):
    if pkg == "jax":
        return dict(list=jlist, btree=jbtree, hash=jhash, skip=jskip, svc=jsvc, adm=jadm,
                    heads=jnp.asarray)
    return dict(list=tlist, btree=tbtree, hash=thash, skip=tskip, svc=tsvc, adm=tadm,
                heads=lambda a: torch.as_tensor(np.asarray(a)))


def _builder(cap, W, P):
    from repro_torch.core.arena import ArenaBuilder

    return ArenaBuilder(cap, W, num_shards=P, policy="interleaved" if P > 1 else "sequential")


def _arrays(arena):
    return tuple(np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x).copy()
                 for x in (arena.data, arena.bounds, arena.perms, arena.heap))


def mixed_scenario(P, seed=9, n=128, n_list=32, n_req=160, updates=True):
    """The four structures of ``test_serving_traversals._mixed_service``
    on one heap (the list cut to ``n_list`` keys: at P = 4 every hop of a
    list walk crosses), a B+tree update tenant (``updates``) on 16
    reserved keys that no read draws, 10% absent keys, three tenants,
    arrivals over ten rounds."""
    rng = np.random.default_rng(seed)
    b = _builder(2048, 20, P)
    lkeys = np.arange(n_list, dtype=np.int32)
    head = tlist.build_into(b, lkeys, rng.integers(0, 10**6, n_list).astype(np.int32))
    bkeys = rng.choice(np.arange(10**4, 10**5), n, replace=False).astype(np.int32)
    root, _ = tbtree.build_into(b, bkeys, rng.integers(0, 10**6, n).astype(np.int32))
    hkeys = rng.choice(np.arange(10**5, 2 * 10**5), n, replace=False).astype(np.int32)
    heads = thash.build_into(b, hkeys, rng.integers(0, 10**6, n).astype(np.int32), N_BUCKETS)
    skeys = rng.choice(np.arange(2 * 10**5, 3 * 10**5), n, replace=False).astype(np.int32)
    shead = tskip.build_into(b, skeys, rng.integers(0, 10**6, n).astype(np.int32))
    arrays = _arrays(b.finish(device=CPU))

    def specs(pkg):
        m = _mods(pkg)
        Spec = m["svc"].StructureSpec
        out = {
            "list": Spec(m["list"].find_iterator(), (head,)),
            "btree": Spec(m["btree"].find_iterator(), (root,), group="btree"),
            "hash": Spec(m["hash"].find_iterator(N_BUCKETS), (m["heads"](heads),)),
            "skip": Spec(m["skip"].find_iterator(), (shead,)),
        }
        if updates:
            out["btree_up"] = Spec(m["btree"].update_iterator(), (root,), group="btree",
                                   takes_value=True)
        return out

    keys = {"list": lkeys, "btree": bkeys[:-16], "hash": hkeys, "skip": skeys}
    names = ("list", "btree", "hash", "skip") + (("btree_up",) if updates else ())
    reqs, up = [], 0
    for i in range(n_req):
        s = names[i % len(names)]
        if s == "btree_up":
            q, v = int(bkeys[n - 16 + up % 16]), 7000 + i
            up += 1
        else:
            ks = keys[s]
            q = int(ks[rng.integers(0, len(ks))]) if rng.random() > 0.1 else 5 * 10**6
            v = 0
        reqs.append((i, s, q, f"t{i % 3}", i // 16, v, None))
    return arrays, specs, reqs


def rw_scenario(P):
    """``test_serving_traversals.test_service_mixed_read_write_tenants``:
    list inserts and deletes, hash inserts, and reads of both."""
    b = _builder(512, 4, P)
    keys = np.arange(100, 132, dtype=np.int32)
    head = tlist.build_into(b, keys, keys * 2)
    sent = thash.build_writable(b, np.arange(200, 216, dtype=np.int32),
                                np.arange(16, dtype=np.int32), 8)
    arrays = _arrays(b.finish(device=CPU))

    def specs(pkg):
        m = _mods(pkg)
        Spec = m["svc"].StructureSpec
        return {
            "list": Spec(m["list"].find_iterator(), (head,), group="list"),
            "list_ins": Spec(m["list"].insert_iterator(), (head,), group="list",
                             takes_value=True),
            "list_del": Spec(m["list"].delete_iterator(), (head,), group="list"),
            "hash": Spec(m["hash"].find_iterator(8), (m["heads"](sent),), group="hash"),
            "hash_ins": Spec(m["hash"].insert_iterator(8), (m["heads"](sent),), group="hash",
                             takes_value=True),
        }

    reqs = []
    for k in range(300, 308):
        reqs.append((len(reqs), "list_ins", k, "w", 0, k * 3, None))
    for k in (104, 110, 300, 305):
        reqs.append((len(reqs), "list", k, "r", 0, 0, None))
    for k in (106, 115):
        reqs.append((len(reqs), "list_del", k, "w", 0, 0, None))
    for k in range(400, 406):
        reqs.append((len(reqs), "hash_ins", k, "w", 0, k + 9, None))
    for k in (400, 403, 205):
        reqs.append((len(reqs), "hash", k, "r", 0, 0, None))
    return arrays, specs, reqs


def list_scenario(P=1, n=96, tenants=3, every=10, n_req=50, stride=13):
    """``test_async_service._list_service``'s list with its request stream."""
    keys = np.arange(n, dtype=np.int32)
    b = _builder(((n + P - 1) // P) * P, 4, P)
    head = tlist.build_into(b, keys, (keys * 7 + 1).astype(np.int32))
    arrays = _arrays(b.finish(device=CPU))

    def specs(pkg):
        m = _mods(pkg)
        return {"list": m["svc"].StructureSpec(m["list"].find_iterator(), (head,))}

    reqs = [(i, "list", int(keys[(i * stride) % n]), f"t{i % tenants}", i // every, 0, None)
            for i in range(n_req)]
    return arrays, specs, reqs


def btree_rw_scenario(P=1, n=48):
    """``test_async_service.test_async_matches_sync_with_writes_single_node``."""
    keys = (np.arange(n, dtype=np.int32) * 2).astype(np.int32)
    ar, root, _ = tbtree.build(keys, (keys * 5 + 3).astype(np.int32), num_shards=P,
                               policy="interleaved" if P > 1 else "sequential", device=CPU)
    arrays = _arrays(ar)

    def specs(pkg):
        m = _mods(pkg)
        Spec = m["svc"].StructureSpec
        return {"bt": Spec(m["btree"].find_iterator(), (root,), group="b"),
                "bt_up": Spec(m["btree"].update_iterator(), (root,), group="b",
                              takes_value=True)}

    reqs = []
    for i in range(30):
        if i % 3 == 1:
            reqs.append((i, "bt_up", int(keys[(i * 7) % n]), "default", i // 6, 1000 + i, None))
        else:
            reqs.append((i, "bt", int(keys[(i * 11) % n]), "default", i // 6, 0, None))
    return arrays, specs, reqs


SCENARIOS = {"mixed": mixed_scenario, "rw": rw_scenario, "list": list_scenario,
             "btree_rw": btree_rw_scenario}


# --------------------------------- serving -------------------------------------


def _requests(pkg, tuples):
    R = _mods(pkg)["adm"].TraversalRequest
    return [R(i, s, q, tenant=t, arrive_round=a, value=v, deadline_ms=d)
            for i, s, q, t, a, v, d in tuples]


def _engine(pkg, arrays, P):
    if pkg == "jax":
        ar = jarena.make_arena(arrays[0], bounds=arrays[1], perms=arrays[2], heap=arrays[3])
        mesh = jax.make_mesh((P,), ("mem",)) if P > 1 else None
        return JEngine(ar, mesh=mesh)
    ar = tarena.arena_from_numpy(*arrays, device=CPU)
    return TEngine(ar, mesh=trouting.EmulatedMesh(P, CPU) if P > 1 else None)


def serve(pkg, scenario, P=1, *, drive=None, scenario_kw=None, **svc_kw):
    """One service run: ``(requests, metrics, final engine arena)``.
    ``drive(svc, reqs)`` replaces ``svc.run(reqs)`` (it must close)."""
    arrays, specs, tuples = SCENARIOS[scenario](P, **(scenario_kw or {}))
    engine = _engine(pkg, arrays, P)
    if pkg == "jax":
        svc_kw.setdefault("backend", "xla")
    svc = _mods(pkg)["svc"].PulseService(engine, specs(pkg), **svc_kw)
    reqs = _requests(pkg, tuples)
    if drive is None:
        m = svc.run(reqs)
    else:
        m = drive(svc, reqs)
    return reqs, m, engine.arena


SKIP_METRICS = ("wall_s", "latencies_ms", "per_tenant", "recovery_ms_total")


def outcome(reqs, m, arena):
    """Everything the two services must agree on, as numpy arrays."""
    S = max((len(r.result) for r in reqs if r.result is not None), default=1)
    res = np.full((len(reqs), S), -7, np.int64)
    for i, r in enumerate(reqs):
        if r.result is not None:
            res[i, : len(r.result)] = np.asarray(r.result)
    counts = {f.name: getattr(m, f.name) for f in dataclasses.fields(m)
              if f.name not in SKIP_METRICS}
    counts["per_tenant"] = {t: v["completed"] for t, v in sorted(m.per_tenant.items())}
    counts["latencies"] = len(m.latencies_ms)
    return {
        "req": np.array([[r.req_id, r.status, r.iters, r.admit_round, r.finish_round,
                          r.preemptions] for r in reqs], np.int64),
        "result": res,
        "metrics": np.asarray(json.dumps(counts, sort_keys=True)),
        "data": np.asarray(arena.data.cpu() if isinstance(arena.data, torch.Tensor)
                           else arena.data),
        "heap": np.asarray(arena.heap.cpu() if isinstance(arena.heap, torch.Tensor)
                           else arena.heap),
    }


def assert_same(want, got, tag=""):
    for k in ("req", "result", "data", "heap"):
        np.testing.assert_array_equal(want[k], got[k], err_msg=f"{tag}: {k}")
    assert json.loads(str(want["metrics"])) == json.loads(str(got["metrics"])), tag


_JAX = {}


def jax_outcome(scenario, P=1, **kw):
    """The JAX service's outcome, once per process and arguments."""
    key = (scenario, P, json.dumps(kw, sort_keys=True))
    if key not in _JAX:
        _JAX[key] = outcome(*serve("jax", scenario, P, **kw))
    return _JAX[key]


# ----------------------------- one node: parity --------------------------------


@needs_jax
@pytest.mark.parametrize("pipeline", ["sync", "async"])
@pytest.mark.parametrize("backend", ["kernel", "reference"])
def test_mixed_heap_matches_jax_at_one_node(backend, pipeline):
    """Four read structures on one heap, and with the reference backend a
    B+tree update tenant beside them (the kernel backend is read-only, in
    both packages): the port's service, sync and async, against the JAX
    service on its plain executor."""
    kw = dict(slots_per_structure=8, quantum=4,
              scenario_kw=dict(updates=backend == "reference"))
    want = jax_outcome("mixed", **kw)
    reqs, m, ar = serve("torch", "mixed", backend=backend, pipeline=pipeline, **kw)
    assert_same(want, outcome(reqs, m, ar), f"{backend}/{pipeline}")
    assert m.completed == len(reqs)
    if backend == "reference":
        assert m.commits > 0 and m.writes_retired == 32


@needs_jax
@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_read_write_tenants_match_jax_at_one_node(pipeline):
    """Inserts and deletes under the group barrier, then reads that see
    them; the final arena bit-equal to the JAX service's."""
    want = jax_outcome("rw", slots_per_structure=8, quantum=8)
    reqs, m, ar = serve("torch", "rw", pipeline=pipeline, slots_per_structure=8, quantum=8)
    assert_same(want, outcome(reqs, m, ar), pipeline)
    assert m.completed == len(reqs) and m.commits > 0 and m.writes_retired == 16
    for r in reqs:
        if r.structure == "list" and r.query >= 300:
            assert r.result[1] == r.query * 3
        if r.structure == "hash" and r.query >= 400:
            assert r.result[1] == r.query + 9


@needs_jax
@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_btree_updates_sync_and_async_match_jax(pipeline):
    """``test_async_matches_sync_with_writes_single_node``: reads and
    in-place updates of one B+tree, quantum 6."""
    want = jax_outcome("btree_rw", slots_per_structure=4, quantum=6)
    reqs, m, ar = serve("torch", "btree_rw", pipeline=pipeline, slots_per_structure=4,
                        quantum=6)
    assert_same(want, outcome(reqs, m, ar), pipeline)


@needs_jax
@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_list_stream_matches_jax(pipeline):
    """``test_async_matches_sync_bit_identical``'s stream: 50 requests of
    three tenants over five rounds, quantum 4."""
    want = jax_outcome("list", slots_per_structure=8, quantum=4)
    reqs, m, ar = serve("torch", "list", pipeline=pipeline, slots_per_structure=8, quantum=4)
    assert_same(want, outcome(reqs, m, ar), pipeline)
    assert m.completed == 50


@needs_jax
def test_continuations_span_rounds_as_in_jax():
    """A deep walk at quantum 4 resumes as a MAXED continuation round after
    round and ends with the exact hop count; the shallow one retires first."""
    kw = dict(scenario_kw=dict(n_req=0), slots_per_structure=4, quantum=4)

    def deep(pkg):
        R = _mods(pkg)["adm"].TraversalRequest
        reqs = [R(0, "list", 95), R(1, "list", 2)]
        return serve(pkg, "list", drive=lambda svc, _: svc.run(reqs), **kw)[1], reqs

    (jm, jr), (tm, tr) = deep("jax"), deep("torch")
    for a, b in zip(jr, tr):
        assert (a.status, a.iters, a.admit_round, a.finish_round) == (
            b.status, b.iters, b.admit_round, b.finish_round)
        np.testing.assert_array_equal(a.result, b.result)
    r_deep, r_shallow = tr
    assert r_deep.status == STATUS_DONE and bool(r_deep.result[2])
    assert r_deep.finish_round - r_deep.admit_round >= 2
    assert r_deep.iters == 96 and r_shallow.iters < r_deep.iters
    assert (jm.rounds, jm.engine_calls, jm.lane_iters) == (tm.rounds, tm.engine_calls,
                                                          tm.lane_iters)


@needs_jax
def test_backfill_and_tenant_fairness_match_jax():
    """More requests than slots retire through backfill (two slots, eleven
    requests), and a flooding tenant does not starve a trickle one: both as
    in the JAX service, request by request."""
    backfill = dict(scenario_kw=dict(n_req=11, tenants=1, every=100, stride=3),
                    slots_per_structure=2, quantum=8)
    want = jax_outcome("list", **backfill)
    got = outcome(*serve("torch", "list", **backfill))
    assert_same(want, got, "backfill")
    assert json.loads(str(got["metrics"]))["rounds"] > 1

    def flood(pkg):
        R = _mods(pkg)["adm"].TraversalRequest
        reqs = ([R(i, "list", i % 16, tenant="flood") for i in range(12)]
                + [R(100 + i, "list", (5 * i) % 16, tenant="trickle") for i in range(3)])
        m = serve(pkg, "list", drive=lambda svc, _: svc.run(reqs),
                  scenario_kw=dict(n_req=0), slots_per_structure=2, quantum=64)[1]
        return reqs, m

    (jr, jm), (tr, tm) = flood("jax"), flood("torch")
    assert [(r.finish_round, r.iters) for r in jr] == [(r.finish_round, r.iters) for r in tr]
    assert tm.per_tenant["trickle"]["completed"] == 3
    trickle = max(r.finish_round for r in tr if r.tenant == "trickle")
    assert trickle < max(r.finish_round for r in tr if r.tenant == "flood")


@needs_jax
def test_edf_preemption_matches_jax():
    """``test_edf_preemption_evicts_and_resumes``: two deep best-effort walks
    fill the group, an urgent deadline evicts one continuation, which
    resumes from its saved state; both services evict the same request."""

    def drive_for(pkg):
        R = _mods(pkg)["adm"].TraversalRequest

        def drive(svc, _):
            deep = [R(i, "list", 95 - i, tenant="bulk") for i in range(2)]
            for r in deep:
                svc.submit(r)
            svc.step()
            urgent = R(9, "list", 1, tenant="rt", deadline_ms=60_000.0)
            svc.submit(urgent)
            m = svc.run()
            drive.reqs = deep + [urgent]
            return m

        return drive

    outs = {}
    for pkg in ("jax", "torch"):
        d = drive_for(pkg)
        _, m, _ = serve(pkg, "list", drive=d, scenario_kw=dict(n_req=0),
                        slots_per_structure=2, quantum=4, preempt=True)
        outs[pkg] = (d.reqs, m)
    (jr, jm), (tr, tm) = outs["jax"], outs["torch"]
    for a, b in zip(jr, tr):
        assert (a.status, a.iters, a.admit_round, a.finish_round, a.preemptions) == (
            b.status, b.iters, b.admit_round, b.finish_round, b.preemptions)
        np.testing.assert_array_equal(a.result, b.result)
    assert tm.preempted == jm.preempted >= 1 and tm.completed == 3
    for r in tr:
        assert r.status == STATUS_DONE and int(r.result[1]) == int(r.query) * 7 + 1


# ----------------------------- four shards: parity -----------------------------

MESH_RUNS = [("mixed", dict(scenario_kw=dict(n_req=80), slots_per_structure=8, quantum=4)),
             ("rw", dict(slots_per_structure=8, quantum=8))]


def _jax_mesh_script(out_path):
    """Script mode: the JAX service on a mesh of four host devices (sync,
    schedule "auto") for every MESH_RUNS scenario, to ``out_path``."""
    assert jax.device_count() == 4, jax.devices()
    arrays = {}
    for scenario, kw in MESH_RUNS:
        for k, v in outcome(*serve("jax", scenario, 4, **kw)).items():
            arrays[f"{scenario}/{k}"] = v
    np.savez(out_path, **arrays)


@pytest.fixture(scope="module", autouse=True)
def _jax_mesh_run(tmp_path_factory):
    """Starts the JAX package's four-device run in a subprocess as the
    module starts, so it overlaps the one-node tests; yields (process,
    output path)."""
    if jax is None:
        yield None
        return
    out = tmp_path_factory.mktemp("jax_service_mesh") / "outcomes.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen([sys.executable, str(Path(__file__)), str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_mesh_outcomes(_jax_mesh_run):
    if _jax_mesh_run is None:
        pytest.skip("needs the JAX package")
    proc, out = _jax_mesh_run
    stdout, stderr = proc.communicate(timeout=400)
    assert proc.returncode == 0, f"STDOUT:\n{stdout}\nSTDERR:\n{stderr}"
    got = dict(np.load(out))
    return {s: {k: got[f"{s}/{k}"] for k in ("req", "result", "metrics", "data", "heap")}
            for s, _ in MESH_RUNS}


@needs_jax
@pytest.mark.parametrize("pipeline", ["sync", "async"])
@pytest.mark.parametrize("scenario", [s for s, _ in MESH_RUNS])
def test_service_on_four_shards_matches_jax(scenario, pipeline, jax_mesh_outcomes):
    """Over ``EmulatedMesh(4)`` against the JAX service on four devices
    (schedule "auto": the pipelined loop in both), sync on "auto" and
    async on "fused" (results and counts do not depend on the schedule):
    every request, every metric count (supersteps, wire words, commits),
    the final arena; one runner a group (the budget is a device operand),
    so no group builds twice."""
    kw = dict(MESH_RUNS)[scenario]
    trouting.reset_executable_caches()
    schedule = "auto" if pipeline == "sync" else "fused"
    reqs, m, ar = serve("torch", scenario, 4, pipeline=pipeline, schedule=schedule, **kw)
    assert_same(jax_mesh_outcomes[scenario], outcome(reqs, m, ar), f"{scenario}/{pipeline}")
    assert m.supersteps > 0 and m.wire_words > 0
    groups = {r.structure for r in reqs}
    assert trouting.CACHE_STATS.traces == trouting.CACHE_STATS.misses == len(groups)


def test_slo_sizing_on_four_shards_builds_one_runner_a_group():
    """SLO sizing picks quanta in [2, 64] round by round; every group's
    device loop is built once whatever the quantum, and every read finds
    its key."""
    trouting.reset_executable_caches()
    reqs, m, _ = serve("torch", "mixed", 4, scenario_kw=dict(n_req=60), slots_per_structure=8,
                       quantum=4, min_quantum=2, max_quantum=64, pipeline="async")
    assert m.completed == len(reqs)
    assert 2 <= m.quantum_min_used < m.quantum_max_used <= 64
    groups = {r.structure for r in reqs}
    assert trouting.CACHE_STATS.traces == trouting.CACHE_STATS.misses == len(groups)
    assert trouting.CACHE_STATS.hits == m.engine_calls - len(groups)
    for r in reqs:
        if r.structure != "btree_up":
            assert bool(r.result[2]) == (r.query != 5 * 10**6), (r.structure, r.query)


# ----------------------- properties held without JAX ---------------------------


def _list_svc(pipeline="sync", **kw):
    arrays, specs, _ = list_scenario()
    eng = _engine("torch", arrays, 1)
    kw.setdefault("slots_per_structure", 8)
    return tsvc.PulseService(eng, specs("torch"), quantum=4, pipeline=pipeline, **kw)


def _req(i, q, **kw):
    return tadm.TraversalRequest(i, "list", q, **kw)


def test_slo_quantum_ramps_to_its_bound_and_shrinks_under_pressure():
    svc = _list_svc("async", min_quantum=2, max_quantum=64)
    m = svc.run([_req(i, 95) for i in range(4)])
    assert m.completed == 4 and m.quantum_max_used == 64
    assert 2 <= m.quantum_min_used <= m.quantum_max_used
    svc = _list_svc("sync", min_quantum=2, max_quantum=256)
    svc._ms_per_iter, svc._cur_quantum = 50.0, 256
    svc.submit(_req(0, 1, deadline_ms=10.0))
    svc.step()
    assert svc.metrics.quantum_min_used == 2
    m = _list_svc("async").run([_req(0, 95)])
    assert m.quantum_min_used == m.quantum_max_used == 4  # the fixed default


def test_bounded_queue_sheds_and_rate_limit_isolates_a_flood():
    svc = _list_svc("async", slots_per_structure=4, max_pending=8, rate_limit_rps=1e6)
    reqs = [_req(i, i % 8, deadline_ms=60_000.0) for i in range(64)]
    m = svc.run(reqs)
    assert m.shed > 0 and m.completed + m.shed == 64 and m.queue_depth_max <= 8
    shed = [r for r in reqs if r.status == STATUS_SHED]
    assert len(shed) == m.shed and all(r.result is None for r in shed)
    assert m.deadlines_missed == 0 and m.deadline_hit_rate == 1.0
    svc = _list_svc("sync", rate_limit_rps=1.0, rate_limit_burst=3.0)
    flood = [_req(i, 1, tenant="flood") for i in range(20)]
    trickle = [_req(100 + i, 1, tenant="ok", arrive_round=i) for i in range(3)]
    m = svc.run(flood + trickle)
    assert svc.admission.shed_by_tenant.get("flood", 0) > 0
    assert svc.admission.shed_by_tenant.get("ok", 0) == 0
    assert all(r.status == STATUS_DONE for r in trickle) and m.completed + m.shed == 23


def test_device_runner_is_fifo_bounded_and_raises_on_the_producer():
    runner = DeviceRunner(depth=2).start()
    seen = []
    for i in range(8):
        runner.submit(QuantumWork(label=f"w{i}", run=lambda i=i: i * 10, apply=seen.append))
    runner.drain()
    assert seen == [i * 10 for i in range(8)] and runner.quanta_run == 8
    assert runner.max_queue_depth <= 2
    runner.close()

    def boom():
        raise RuntimeError("quantum failed")

    runner = DeviceRunner(depth=2).start()
    runner.submit(QuantumWork(label="bad", run=boom, apply=lambda r: None))
    with pytest.raises(RuntimeError, match="quantum failed"):
        runner.drain()
    runner.close()
    with pytest.raises(ValueError):
        DeviceRunner(depth=0)


def test_service_verifies_isa_specs_at_registration():
    """``test_verify.py``'s registration case: an ISA program built without
    its certificate and looping is rejected naming the structure; a
    certified one and a torch iterator register."""
    arrays, _, _ = list_scenario()
    eng = _engine("torch", arrays, 1)
    good = tprogs.list_find_program()
    code = good.code.copy()
    code[14] = [tisa.JNE, 3, 4, 5]
    bad = tisa.Program(code, good.scratch_words, good.node_words, name="looping_find")
    spec = tsvc.StructureSpec(tisa.as_pulse_iterator(bad, verify=False), (0,))
    with pytest.raises(tverify.VerifyError, match="looping_find") as ei:
        tsvc.PulseService(eng, {"lst": spec})
    assert "lst" in str(ei.value) and tverify.E_LOOP in ei.value.codes
    ok = tsvc.StructureSpec(tisa.as_pulse_iterator(good), (0,))
    assert "lst" in tsvc.PulseService(eng, {"lst": ok}).groups
    assert "lst" in tsvc.PulseService(
        eng, {"lst": tsvc.StructureSpec(tlist.find_iterator(), (0,))}).groups


def test_refusals_name_what_to_use():
    arrays, specs, _ = list_scenario()
    eng = _engine("torch", arrays, 1)
    with pytest.raises(ValueError, match="'reference'"):
        tsvc.PulseService(eng, specs("torch"), backend="xla")
    with pytest.raises(ValueError, match="backend"):
        tsvc.PulseService(eng, specs("torch"), backend="pallas")
    with pytest.raises(ValueError, match="pipeline"):
        tsvc.PulseService(eng, specs("torch"), pipeline="threads")
    svc = tsvc.PulseService(eng, specs("torch"))
    with pytest.raises(KeyError):
        svc.submit(tadm.TraversalRequest(0, "nope", 1))


# ---------------------------------- the card ------------------------------------


@pytest.mark.gpu
def test_async_fused_service_on_card_matches_cpu_copy():
    """The mixed heap over ``EmulatedMesh(4, "cuda")`` on the fused
    schedule, async, against the same service on a CPU copy: every request
    and metric count; one capture a group whatever the quantum."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with pytest -m gpu")
    arrays, specs, tuples = mixed_scenario(4)
    outs = {}
    for dev in ("cuda", CPU):
        trouting.reset_executable_caches()
        eng = TEngine(tarena.arena_from_numpy(*arrays, device=dev),
                      mesh=trouting.EmulatedMesh(4, dev))
        svc = tsvc.PulseService(eng, specs("torch"), slots_per_structure=8, quantum=4,
                                schedule="fused", pipeline="async")
        reqs = _requests("torch", tuples)
        m = svc.run(reqs)
        outs[dev] = outcome(reqs, m, eng.arena)
        if dev == "cuda":
            assert trouting.CACHE_STATS.traces == len({r.structure for r in reqs})
    assert_same(outs[CPU], outs["cuda"], "card vs CPU copy")


if __name__ == "__main__":
    _jax_mesh_script(sys.argv[1])
