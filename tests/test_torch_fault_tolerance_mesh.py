"""Port parity: fault-tolerant serving (item 8) on a mesh of eight shards,
``PulseService(..., fault_tolerance=...)`` over ``EmulatedMesh(8)`` against
the JAX service on eight host devices: the mixed workload.

The JAX side runs in one subprocess (this file run as a script, eight
devices in its environment alone), which calls the JAX serve bodies
directly: ``tests/helpers/elastic_checks.py``'s ``serve_rep`` and the body
of ``tests/helpers/ft_checks.py``'s service kill matrix (``serve`` of
``check_replication_service_matrix``, repeated here for both packages).
Each run's requests, ``ServiceMetrics`` counts and final arena must agree
with the port's, and the checks' own properties must hold.

Here, replication failover (``check_replication_failover``): a mixed
workload, shard 3 killed at call 4, superstep 2, failover replication; one
recovery, the standby shipped and verified every write quantum, reads
never retried, every result and the final arena equal to the failure-free
run's, the standby equal to the primary and the log recovering to the
resident arena at the end, sync and async.  This is also the mixed half of
``ft_checks``' service kill matrix at shard 3 (there with 6 dead rounds);
its other seven shards' mixed kills take half a minute each on the CPU
and are not run.

The reads-only runs (zero retries, the read half of the kill matrix, the
watchdog) are in ``tests/test_torch_fault_tolerance_reads.py``, which
shares this file's helpers and JAX script.
"""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

try:
    import jax
except ImportError:
    jax = None
from repro_torch.core import routing as trouting
from repro_torch.core.arena import ArenaBuilder
from repro_torch.core.engine import PulseEngine
from repro_torch.core.faults import FaultInjector, FaultPlan
from repro_torch.core.iterator import STATUS_DONE
from repro_torch.core.structures import linked_list
from repro_torch.distributed.arena_ft import (
    ArenaStore,
    FaultToleranceConfig,
    ReplicationConfig,
)
from repro_torch.serving.admission import TraversalRequest
from repro_torch.serving.traversal_service import PulseService, StructureSpec

from test_torch_traversal_service import assert_same, outcome  # noqa: E402

pytestmark = pytest.mark.skipif(jax is None, reason="needs the JAX package")
ROOT = Path(__file__).resolve().parents[1]
P = 8
KEYS = np.arange(100, 164, dtype=np.int32)
KILL = dict(kill_shard=3, kill_call=4, kill_superstep=2)
MATRIX_READS = (0, 2, 5, 7)  # the read half of ft_checks' kill matrix run here
CPU = "cpu"


def make_reqs(R, reads_only=False):
    """``elastic_checks.make_reqs`` (and ``ft_checks``' requests)."""
    reqs = []
    for i in range(36):
        if i % 4 == 2:
            if not reads_only:
                reqs.append(R(i, "list_ins", 1000 + i, value=i * 11, tenant="w",
                              arrive_round=i // 8))
        else:
            reqs.append(R(i, "list", int(KEYS[(i * 7) % len(KEYS)]), tenant="r",
                          arrive_round=i // 8))
    return reqs


def serve_port(tmp, plan, pipeline="sync", *, dead_rounds=3, watchdog=0.0, reads_only=False,
               ins_spec=True):
    """``elastic_checks.serve_rep`` on the port (``ins_spec=False``: the
    spec set of ``ft_checks``' read-only matrix, which has no insert spec).
    Returns ``(outcome, metrics, requests, service, store)``; the store is
    closed."""
    b = ArenaBuilder(512, 4, num_shards=P, policy="interleaved")
    head = linked_list.build_into(b, KEYS, KEYS * 2)
    inj = FaultInjector(FaultPlan(**plan)) if plan else None
    eng = PulseEngine(b.finish(device=CPU), mesh=trouting.EmulatedMesh(P, CPU),
                      fault_injector=inj)
    store = ArenaStore(tmp)
    ft = FaultToleranceConfig(store=store, snapshot_every=100, dead_rounds=dead_rounds,
                              replication=ReplicationConfig(policy="failover"),
                              watchdog_timeout_s=watchdog)
    specs = {"list": StructureSpec(linked_list.find_iterator(), (head,), group="list")}
    if ins_spec:
        specs["list_ins"] = StructureSpec(linked_list.insert_iterator(), (head,),
                                          group="list", takes_value=True)
    svc = PulseService(eng, specs, slots_per_structure=8, quantum=6, pipeline=pipeline,
                       fault_tolerance=ft)
    reqs = make_reqs(TraversalRequest, reads_only)
    m = svc.run(reqs)
    store.close()
    return outcome(reqs, m, eng.arena), m, reqs, svc, store


# ------------------------------- the JAX side ----------------------------------


def _jax_matrix_serve(tmp, plan):
    """The body of ``ft_checks.check_replication_service_matrix``'s
    ``serve`` with ``reads_only=True`` (dead_rounds 6, failover
    replication)."""
    from repro.core.arena import ArenaBuilder as JBuilder
    from repro.core.engine import PulseEngine as JEngine
    from repro.core.faults import FaultInjector as JInjector
    from repro.core.faults import FaultPlan as JPlan
    from repro.core.structures import linked_list as jlist
    from repro.distributed import arena_ft as jft
    from repro.serving.admission import TraversalRequest as JR
    from repro.serving.traversal_service import PulseService as JService
    from repro.serving.traversal_service import StructureSpec as JSpec

    b = JBuilder(512, 4, num_shards=P, policy="interleaved")
    head = jlist.build_into(b, KEYS, KEYS * 2)
    inj = JInjector(JPlan(**plan)) if plan else None
    eng = JEngine(b.finish(), mesh=jax.make_mesh((P,), ("mem",)), fault_injector=inj)
    ft = jft.FaultToleranceConfig(store=jft.ArenaStore(tmp), snapshot_every=100,
                                  dead_rounds=6,
                                  replication=jft.ReplicationConfig(policy="failover"))
    specs = {"list": JSpec(jlist.find_iterator(), (head,), group="list")}
    svc = JService(eng, specs, slots_per_structure=8, quantum=6, fault_tolerance=ft)
    reqs = make_reqs(JR, reads_only=True)
    m = svc.run(reqs)
    ft.store.close()
    return outcome(reqs, m, eng.arena)


JAX_GROUPS = {
    # tests/test_torch_fault_tolerance_mesh.py: the mixed workload
    "mixed": ("rep/ref", "rep/kill"),
    # tests/test_torch_fault_tolerance_reads.py: reads only
    "reads": ("ro/ref", "ro/kill", "mx-ro/ref") + tuple(f"mx-ro/{s}" for s in MATRIX_READS),
}


def _jax_script(out_path, group):
    """Script mode: the JAX runs of ``JAX_GROUPS[group]``, sync, to
    ``out_path``."""
    assert jax.device_count() == P, jax.devices()
    sys.path.insert(0, str(ROOT / "tests" / "helpers"))
    import elastic_checks as ec
    from repro.core.faults import FaultPlan as JPlan

    def matrix(plan):
        return lambda d: _jax_matrix_serve(d, plan)

    runs = {
        "rep/ref": lambda d: ec.serve_rep(d, None, "sync"),
        "rep/kill": lambda d: ec.serve_rep(d, JPlan(**KILL), "sync"),
        "ro/ref": lambda d: ec.serve_rep(d, None, "sync", reads_only=True),
        "ro/kill": lambda d: ec.serve_rep(d, JPlan(**KILL), "sync", dead_rounds=6,
                                          reads_only=True),
        "mx-ro/ref": matrix(None),
        **{f"mx-ro/{s}": matrix(dict(kill_shard=s, kill_call=4, kill_superstep=2))
           for s in MATRIX_READS},
    }
    arrays = {}
    for tag in JAX_GROUPS[group]:
        with tempfile.TemporaryDirectory() as d:
            got = runs[tag](d)
        if isinstance(got, tuple):  # serve_rep: (requests, metrics, arena, replicas)
            got = outcome(*got[:3])
        for k, v in got.items():
            arrays[f"{tag}/{k}"] = v
    np.savez(out_path, **arrays)


def start_jax_runs(tmp_path_factory, group):
    """Starts the JAX package's eight-device runs of ``group`` in a
    subprocess (this file as a script); returns (process, output path)."""
    out = tmp_path_factory.mktemp(f"jax_ft_{group}") / "outcomes.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={P}"
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen([sys.executable, str(Path(__file__)), str(out), group], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, out


def collect_jax_runs(proc, out):
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"STDOUT:\n{stdout}\nSTDERR:\n{stderr}"
    got = dict(np.load(out))
    tags = {k.rsplit("/", 1)[0] for k in got}
    return {t: {k: got[f"{t}/{k}"] for k in ("req", "result", "metrics", "data", "heap")}
            for t in tags}


@pytest.fixture(scope="module", autouse=True)
def _jax_run(tmp_path_factory):
    """Starts this file's JAX runs as the module starts, so they overlap
    the port's."""
    proc, out = start_jax_runs(tmp_path_factory, "mixed")
    yield proc, out
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_runs(_jax_run):
    return collect_jax_runs(*_jax_run)


def _metrics(o):
    return json.loads(str(o["metrics"]))


def same_results(got, ref, tag):
    np.testing.assert_array_equal(got["req"][:, 1], ref["req"][:, 1], err_msg=f"{tag}: status")
    np.testing.assert_array_equal(got["result"], ref["result"], err_msg=f"{tag}: result")
    np.testing.assert_array_equal(got["data"], ref["data"], err_msg=f"{tag}: data")


def _recovers_to_resident(svc, store, got):
    store2 = ArenaStore(store.dir)
    for name, g in svc.groups.items():
        if g.spec.writes:
            store2.register_iterator(name, g.spec.iterator)
    rec, _ = store2.recover(device=CPU)
    store2.close()
    np.testing.assert_array_equal(rec.data.numpy(), got["data"])
    np.testing.assert_array_equal(rec.heap.numpy(), got["heap"])


# --------------------------------- the tests -----------------------------------


@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_replication_failover_matches_jax(tmp_path, request, pipeline):
    got, m, reqs, svc, store = serve_port(tmp_path, KILL, pipeline)
    jax_runs = request.getfixturevalue("jax_runs")  # after the port's run: they overlap
    assert_same(jax_runs["rep/kill"], got, f"rep-failover/{pipeline}")
    ref = jax_runs["rep/ref"]
    assert m.recoveries == 1 and m.replica_quanta > 0
    assert _metrics(ref)["replica_quanta"] > 0
    for r in reqs:
        if r.tenant == "r":
            assert r.status == STATUS_DONE and r.retries == 0, (r.req_id, r.status, r.retries)
    assert m.completed == 36
    same_results(got, ref, "vs failure-free")
    np.testing.assert_array_equal(got["heap"], ref["heap"])
    svc._replicas.verify(svc.engine.arena)  # the standby still equals the primary
    _recovers_to_resident(svc, store, got)


if __name__ == "__main__":
    _jax_script(sys.argv[1], sys.argv[2])
