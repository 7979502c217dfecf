"""Port parity: fault-tolerant serving (item 8) on one node,
``PulseService(..., fault_tolerance=FaultToleranceConfig(...))`` against the
JAX package's service under the same fault plan.

The scenario is ``tests/test_fault_tolerance.py``'s ``_serve``: a list of
24 keys on four interleaved shards, a read tenant and an insert tenant,
quantum 6, baseline-only snapshots (so every recovery replays the log).
One heap, built with the port's builder, goes into both packages, and
every request (status, iters, result, admit and finish rounds), every
``ServiceMetrics`` count (retries and recoveries among them) and the final
``data`` and ``heap`` must agree:

  * a kill at call 8 (failover), the kill sweep at calls 2, 5 and 11, the
    retry budget spent (``retry_budget=0``), each sync and async;
  * fixed examples of the random-kill property, among them ``n_requests=
    9, write_mask=337, kill_call=1, kill_shard=0``: there the port equals
    JAX, heap included, and ``data`` and every request equal the
    failure-free run's, while shard 0's ``H_COMMITS`` is one higher.  The
    cause is the reference's retry policy, not recovery: a failed group is
    parked and admits no one until its backoff ends
    (``PulseService._admit``), so the retried batch forms differently (the
    insert that joined in the failure-free run's next round joins the
    retried batch instead), and more CAS races restage.  ``H_COMMITS``
    counts applied mutations, restaged ones included;
  * the log left by a run recovers to the resident arena;
  * the refusals: replication or the watchdog on one node raise
    ``ValueError``, as in the reference, and without fault tolerance a
    ``ShardFailure`` reaches the caller.

The mesh cases (eight shards, replication, the watchdog) are in
``tests/test_torch_fault_tolerance_mesh.py``.  The ``gpu`` test runs the
one-node service with a kill on the card against a CPU copy.
"""

import json

import numpy as np
import pytest
import torch

try:
    import jax

    from repro.core import arena as jarena
    from repro.core.engine import PulseEngine as JEngine
    from repro.core.faults import FaultInjector as JInjector
    from repro.core.faults import FaultPlan as JPlan
    from repro.core.structures import linked_list as jlist
    from repro.distributed import arena_ft as jft
    from repro.serving import admission as jadm
    from repro.serving import traversal_service as jsvc
except ImportError:  # the card's machine has no JAX; its gpu test needs none
    jax = None
from repro_torch.core import arena as tarena
from repro_torch.core import routing as trouting
from repro_torch.core.arena import H_COMMITS
from repro_torch.core.engine import PulseEngine as TEngine
from repro_torch.core.faults import FaultInjector as TInjector
from repro_torch.core.faults import FaultPlan as TPlan
from repro_torch.core.faults import ShardFailure
from repro_torch.core.iterator import STATUS_DONE, STATUS_RETRY
from repro_torch.core.structures import linked_list as tlist
from repro_torch.distributed import arena_ft as tft
from repro_torch.serving import admission as tadm
from repro_torch.serving import traversal_service as tsvc

from test_torch_traversal_service import assert_same, outcome  # noqa: E402

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")
CPU = "cpu"
P = 4
KEYS = np.arange(100, 124, dtype=np.int32)


def _heap():
    b = tarena.ArenaBuilder(256, 4, num_shards=P, policy="interleaved")
    head = tlist.build_into(b, KEYS, KEYS * 2)
    a = b.finish(device=CPU)
    return [x.numpy().copy() for x in (a.data, a.bounds, a.perms, a.heap)], head


def _requests(R, n_requests, write_mask, reads_only):
    out = []
    for i in range(n_requests):
        if write_mask is not None:
            writes = bool((write_mask >> i) & 1)
        else:
            writes = not reads_only and i % 4 == 2
        if writes:
            out.append(R(i, "list_ins", 500 + i, value=i * 3, tenant="w", arrive_round=i // 4))
        else:
            out.append(R(i, "list", int(KEYS[(i * 5) % len(KEYS)]), tenant="r",
                         arrive_round=i // 4))
    return out


def serve(pkg, tmp, plan=None, *, n_requests=16, retry_budget=5, reads_only=False,
          write_mask=None, pipeline="sync", device=CPU, ft_kw=None):
    """``_serve`` of ``tests/test_fault_tolerance.py`` in ``pkg`` (``plan``
    a dict of ``FaultPlan`` fields or None): ``(outcome, metrics, requests,
    service)``."""
    arrays, head = _heap()
    ft_kw = {"snapshot_every": 100, "retry_budget": retry_budget, **(ft_kw or {})}
    if pkg == "jax":
        eng = JEngine(jarena.make_arena(arrays[0], bounds=arrays[1], perms=arrays[2],
                                        heap=arrays[3]),
                      fault_injector=JInjector(JPlan(**plan)) if plan else None)
        ft = jft.FaultToleranceConfig(store=jft.ArenaStore(tmp), **ft_kw)
        lst, svc_mod, R, kw = jlist, jsvc, jadm.TraversalRequest, dict(backend="xla")
    else:
        eng = TEngine(tarena.arena_from_numpy(*arrays, device=device),
                      fault_injector=TInjector(TPlan(**plan)) if plan else None)
        ft = tft.FaultToleranceConfig(store=tft.ArenaStore(tmp), **ft_kw)
        lst, svc_mod, R, kw = tlist, tsvc, tadm.TraversalRequest, {}
    Spec = svc_mod.StructureSpec
    svc = svc_mod.PulseService(
        eng, {"list": Spec(lst.find_iterator(), (head,), group="list"),
              "list_ins": Spec(lst.insert_iterator(), (head,), group="list", takes_value=True)},
        slots_per_structure=4, quantum=6, fault_tolerance=ft, pipeline=pipeline, **kw)
    reqs = _requests(R, n_requests, write_mask, reads_only)
    m = svc.run(reqs)
    ft.store.close()
    return outcome(reqs, m, eng.arena), m, reqs, svc


_JAX = {}


def jax_outcome(tmp_path_factory, plan=None, **kw):
    """The JAX service's outcome and metrics, once per process and plan."""
    key = json.dumps([plan, kw], sort_keys=True)
    if key not in _JAX:
        o, m, _, _ = serve("jax", tmp_path_factory.mktemp("jax_ft"), plan, **kw)
        _JAX[key] = (o, m)
    return _JAX[key]


def _same_as_failure_free(got, ref, tag):
    """Every request's status and result, and the final data, equal the
    failure-free run's."""
    np.testing.assert_array_equal(got["req"][:, 1], ref["req"][:, 1], err_msg=f"{tag}: status")
    np.testing.assert_array_equal(got["result"], ref["result"], err_msg=f"{tag}: result")
    np.testing.assert_array_equal(got["data"], ref["data"], err_msg=f"{tag}: data")


# --------------------------------- parity -------------------------------------


@needs_jax
@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_failure_free_run_matches_jax(tmp_path, tmp_path_factory, pipeline):
    want, _ = jax_outcome(tmp_path_factory)
    got, m, reqs, svc = serve("torch", tmp_path, pipeline=pipeline)
    assert_same(want, got, pipeline)
    assert m.recoveries == m.retries == 0 and m.completed == len(reqs)
    # the baseline snapshot and one logged quantum a write quantum
    assert (tmp_path / "step_00000000" / "manifest.json").is_file()
    store = tft.ArenaStore(tmp_path)
    assert store.log.seq == len(store.log.quanta()) > 0
    store.close()


@needs_jax
@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_failover_matches_jax(tmp_path, tmp_path_factory, pipeline):
    """A kill mid-stream (shard 1, call 8): snapshot plus replay, a checked
    recovery and retried quanta, equal to the JAX service's run and, in
    every request and the final arena, to the failure-free run."""
    plan = dict(kill_shard=1, kill_call=8, kill_superstep=1)
    want, _ = jax_outcome(tmp_path_factory, plan)
    got, m, _, _ = serve("torch", tmp_path, plan, pipeline=pipeline)
    assert_same(want, got, pipeline)
    assert m.recoveries == 1 and m.retries > 0 and m.replayed_commits > 0
    assert m.mean_recovery_ms > 0
    ref, _ = jax_outcome(tmp_path_factory)
    _same_as_failure_free(got, ref, pipeline)
    np.testing.assert_array_equal(got["heap"], ref["heap"])


@needs_jax
@pytest.mark.parametrize("pipeline", ["sync", "async"])
@pytest.mark.parametrize("k", [2, 5, 11])
def test_kill_sweep_matches_jax(tmp_path, tmp_path_factory, k, pipeline):
    plan = dict(kill_shard=k % P, kill_call=k, kill_superstep=1)
    want, _ = jax_outcome(tmp_path_factory, plan)
    got, m, _, _ = serve("torch", tmp_path, plan, pipeline=pipeline)
    assert_same(want, got, f"kill@{k}/{pipeline}")
    assert m.recoveries == 1 and m.retries > 0
    ref, _ = jax_outcome(tmp_path_factory)
    _same_as_failure_free(got, ref, f"kill@{k}")
    np.testing.assert_array_equal(got["heap"], ref["heap"])


@needs_jax
@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_retry_budget_exhaustion_matches_jax(tmp_path, tmp_path_factory, pipeline):
    """``retry_budget=0``: the failed group's occupants retire STATUS_RETRY,
    later arrivals complete."""
    plan = dict(kill_shard=0, kill_call=1, kill_superstep=1)
    kw = dict(n_requests=8, retry_budget=0, reads_only=True)
    want, _ = jax_outcome(tmp_path_factory, plan, **kw)
    got, m, reqs, _ = serve("torch", tmp_path, plan, pipeline=pipeline, **kw)
    assert_same(want, got, pipeline)
    assert m.recoveries == 1 and m.retry_exhausted > 0 and m.retries >= m.retry_exhausted
    statuses = {int(r.status) for r in reqs}
    assert STATUS_RETRY in statuses and STATUS_DONE in statuses
    assert statuses <= {STATUS_RETRY, STATUS_DONE}


RANDOM_KILL_EXAMPLES = [(9, 337, 1, 0), (6, 0b110011, 2, 3), (10, 0b1000000001, 3, 1),
                        (8, 0, 10, 2)]


@needs_jax
@pytest.mark.parametrize("n_requests,write_mask,kill_call,kill_shard", RANDOM_KILL_EXAMPLES)
def test_random_kill_examples_match_jax(tmp_path, tmp_path_factory, n_requests, write_mask,
                                        kill_call, kill_shard):
    """Fixed examples of ``test_random_workload_random_kill_identity``: the
    port equals JAX under the kill, heap included, and every request and
    the final ``data`` equal the failure-free run's.  The heap's allocator
    registers do too; ``H_COMMITS`` may be higher after a kill (see the
    module docstring: the parked group's retried batch forms differently,
    and more CAS races restage), and at (9, 337, 1, 0) it is, by one on
    shard 0, in both packages."""
    plan = dict(kill_shard=kill_shard, kill_call=kill_call, kill_superstep=1)
    kw = dict(n_requests=n_requests, write_mask=write_mask)
    want, _ = jax_outcome(tmp_path_factory, plan, **kw)
    got, m, _, _ = serve("torch", tmp_path, plan, **kw)
    assert_same(want, got, "kill")
    ref, _ = jax_outcome(tmp_path_factory, None, **kw)
    if m.recoveries == 0:  # a kill past the run's end never fires
        assert m.retries == 0
        assert_same(ref, got, "no kill")
        return
    assert m.recoveries == 1 and m.completed == n_requests
    _same_as_failure_free(got, ref, "vs failure-free")
    cols = [c for c in range(got["heap"].shape[1]) if c != H_COMMITS]
    np.testing.assert_array_equal(got["heap"][:, cols], ref["heap"][:, cols])
    assert (got["heap"][:, H_COMMITS] >= ref["heap"][:, H_COMMITS]).all()
    if (n_requests, write_mask, kill_call, kill_shard) == (9, 337, 1, 0):
        extra = got["heap"][:, H_COMMITS] - ref["heap"][:, H_COMMITS]
        assert extra.tolist() == [1, 0, 0, 0]
        # the parked group: request 8 joined the retried insert batch
        rounds = {int(r[0]): (int(r[3]), int(r[4])) for r in got["req"]}
        ref_rounds = {int(r[0]): (int(r[3]), int(r[4])) for r in ref["req"]}
        assert rounds != ref_rounds


# ------------------------------ the log after a run ----------------------------


def test_log_recovers_the_resident_arena_after_a_kill(tmp_path):
    plan = dict(kill_shard=1, kill_call=8, kill_superstep=1)
    got, m, _, svc = serve("torch", tmp_path, plan, ft_kw=dict(snapshot_every=2))
    assert m.recoveries == 1
    store = tft.ArenaStore(tmp_path)
    store.register_iterator("list_ins", svc.groups["list_ins"].spec.iterator)
    rec, info = store.recover(device=CPU)
    store.close()
    for f in ("data", "heap"):
        np.testing.assert_array_equal(getattr(rec, f).numpy(), got[f])
    assert info.snapshot_seq > 0  # snapshots every two logged quanta


def test_backoff_is_seeded_and_parks_the_group(tmp_path):
    """The same seed gives the same rounds; another seed may not, but
    every request still completes with the same results."""
    plan = dict(kill_shard=1, kill_call=8, kill_superstep=1)
    a, ma, _, _ = serve("torch", tmp_path / "a", plan, ft_kw=dict(seed=3))
    b, mb, _, _ = serve("torch", tmp_path / "b", plan, ft_kw=dict(seed=3))
    assert_same(a, b, "same seed")
    c, mc, _, _ = serve("torch", tmp_path / "c", plan, ft_kw=dict(seed=4, backoff_base=4))
    np.testing.assert_array_equal(a["result"], c["result"])
    np.testing.assert_array_equal(a["data"], c["data"])
    assert mc.rounds > ma.rounds  # a longer backoff parks the group longer


# --------------------------------- refusals -----------------------------------


@pytest.mark.parametrize("pkg", ["torch", pytest.param("jax", marks=needs_jax)])
@pytest.mark.parametrize("what", ["replication", "watchdog"])
def test_one_node_refuses_replication_and_the_watchdog(tmp_path, pkg, what):
    ft_mod = jft if pkg == "jax" else tft
    kw = (dict(replication=ft_mod.ReplicationConfig()) if what == "replication"
          else dict(watchdog_timeout_s=0.05))
    match = "replication needs" if what == "replication" else "watchdog needs"
    with pytest.raises(ValueError, match=match):
        serve(pkg, tmp_path, ft_kw=kw)


def test_without_fault_tolerance_a_shard_failure_reaches_the_caller():
    arrays, head = _heap()
    eng = TEngine(tarena.arena_from_numpy(*arrays, device=CPU),
                  fault_injector=TInjector(TPlan(kill_shard=1, kill_call=1, kill_superstep=1)))
    svc = tsvc.PulseService(
        eng, {"list": tsvc.StructureSpec(tlist.find_iterator(), (head,))},
        slots_per_structure=4, quantum=6)
    with pytest.raises(ShardFailure):
        svc.run(_requests(tadm.TraversalRequest, 12, None, True))


def test_probe_is_a_verified_isa_program():
    """The watchdog's probe runs on the ISA route (``pulse_chase``'s
    interpreter on the card): a certified read-only program of three
    instructions that keeps the node's first word."""
    it = tsvc._PROBE_IT
    assert it.facts is not None and not it.mutates and it.n_instructions == 3
    arrays, _ = _heap()
    arena = tarena.arena_from_numpy(*arrays, device=CPU)
    lo = int(arena.bounds[2])
    rec, st = trouting.distributed_execute(
        it, arena, torch.tensor([lo], dtype=torch.int32), torch.zeros((1, 1), dtype=torch.int32),
        mesh=trouting.EmulatedMesh(P, CPU), max_iters=2, k_local=1, compact=True,
        schedule="dispatched")
    assert int(rec[0, trouting.F_STATUS]) == STATUS_DONE
    assert int(rec[0, trouting.F_SCRATCH]) == int(arena.data[lo, 0])


@needs_jax
def test_probe_counts_as_jax_probe():
    from repro.core import dispatch as jdispatch
    from repro_torch.core import dispatch as tdispatch

    for W in (4, 20):
        assert tdispatch.count_instructions(tsvc._PROBE_IT, W) == \
            jdispatch.count_instructions(jsvc._PROBE_IT, W) == tsvc._PROBE_IT.n_instructions


# ---------------------------------- the card ------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_one_node_kill_on_card_matches_cpu_copy(tmp_path, pipeline):
    """The one-node service with a kill at call 8, on the card (reads on
    ``pulse_chase``) and on a CPU copy: every request, every count, the
    final arena; the recovered arena lands on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with pytest -m gpu")
    plan = dict(kill_shard=1, kill_call=8, kill_superstep=1)
    card, m, _, svc = serve("torch", tmp_path / "card", plan, device="cuda", pipeline=pipeline)
    cpu, _, _, _ = serve("torch", tmp_path / "cpu", plan, pipeline=pipeline)
    assert_same(cpu, card, "card vs CPU copy")
    assert m.recoveries == 1 and svc.engine.arena.data.is_cuda
