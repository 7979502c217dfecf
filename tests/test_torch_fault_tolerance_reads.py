"""Port parity: fault-tolerant serving (item 8) on a mesh of eight shards,
reads only, against the JAX service on eight host devices (one
subprocess, ``tests/test_torch_fault_tolerance_mesh.py`` run as a script
for its "reads" group):

  * reads only with zero retries (``elastic_checks.
    check_readonly_zero_retry``): shard 3 killed at call 4, superstep 2;
    reads fan out to the replica while the primary is dead, sync and
    async;
  * the read half of ``ft_checks``' service kill matrix on shards 0, 2, 5
    and 7 (the time budget's cut of the eight; shard 3 is the case above
    with another spec set): one recovery, zero retries, every result equal
    to the failure-free run's;
  * the watchdog (``elastic_checks.check_watchdog_delay``), which reads
    the wall clock, held to its properties: a delayed straggler is
    probed, suspected and served around, with no retry and no recovery.
"""

import numpy as np
import pytest

from repro_torch.core.iterator import STATUS_DONE

from test_torch_fault_tolerance_mesh import (  # noqa: E402
    KILL,
    MATRIX_READS,
    assert_same,
    collect_jax_runs,
    jax,
    same_results,
    serve_port,
    start_jax_runs,
)

pytestmark = pytest.mark.skipif(jax is None, reason="needs the JAX package")


@pytest.fixture(scope="module", autouse=True)
def _jax_run(tmp_path_factory):
    """Starts this file's JAX runs as the module starts."""
    proc, out = start_jax_runs(tmp_path_factory, "reads")
    yield proc, out
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_runs(_jax_run):
    return collect_jax_runs(*_jax_run)


@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_readonly_zero_retry_matches_jax(tmp_path, request, pipeline):
    got, m, reqs, _, _ = serve_port(tmp_path, KILL, pipeline, dead_rounds=6, reads_only=True)
    jax_runs = request.getfixturevalue("jax_runs")
    assert_same(jax_runs["ro/kill"], got, f"zero-retry/{pipeline}")
    assert m.recoveries == 1 and m.failover_quanta >= 1
    assert m.retries == m.retry_exhausted == m.shed == 0
    assert all(r.status == STATUS_DONE and r.retries == 0 for r in reqs)
    same_results(got, jax_runs["ro/ref"], "vs failure-free")


@pytest.mark.parametrize("shard", MATRIX_READS)
def test_service_kill_matrix_reads_match_jax(tmp_path, request, shard):
    plan = dict(kill_shard=shard, kill_call=4, kill_superstep=2)
    got, m, reqs, _, _ = serve_port(tmp_path, plan, dead_rounds=6, reads_only=True,
                                    ins_spec=False)
    jax_runs = request.getfixturevalue("jax_runs")
    assert_same(jax_runs[f"mx-ro/{shard}"], got, f"matrix reads shard {shard}")
    assert m.recoveries == 1 and m.failover_quanta >= 1
    assert m.retries == m.retry_exhausted == 0
    assert all(r.status == STATUS_DONE and r.retries == 0 for r in reqs)
    same_results(got, jax_runs["mx-ro/ref"], "vs failure-free")


def test_watchdog_suspects_a_delayed_straggler(tmp_path, request):
    """Shard 2 sleeps a while each superstep it serves and never raises;
    the watchdog probes it, suspects it, and reads fan out to its replica,
    with no retry and no recovery, every result equal to the failure-free
    run's.  The wall clock decides the round of the suspicion, so the
    counts are not compared bit for bit.  ``elastic_checks`` sleeps 0.15 s
    against a 0.05 s timeout; a probe of the port's plain executor at P = 8
    can take tens of ms on a loaded CPU, so here 0.6 s against 0.3 s (the
    sleeps end once the shard is suspected, so the run is not longer)."""
    got, m, reqs, _, _ = serve_port(tmp_path, dict(delay_shard=2, delay_s=0.6),
                                    dead_rounds=1000, watchdog=0.3, reads_only=True)
    assert m.watchdog_probes > 0 and m.watchdog_suspects >= 1
    assert m.failover_quanta >= 1
    assert m.retries == m.recoveries == 0
    assert all(r.status == STATUS_DONE for r in reqs)
    jax_runs = request.getfixturevalue("jax_runs")
    np.testing.assert_array_equal(got["result"], jax_runs["ro/ref"]["result"])
