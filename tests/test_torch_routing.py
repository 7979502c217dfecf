"""Port parity: multi-shard routing on the dispatched schedule over the
dense fabric (the read path), and the superstep mode of ``pulse_chase``.

The same numpy inputs, made from a seed, go through the JAX package and
through the port on the CPU, and every int32 output must be bit-equal:
records (hops included) and every ``RoutingStats`` field.

  * The port's ``distributed_execute`` against the JAX package's
    ``sequential_commit_execute`` (read iterators, no mesh) at P = 2, 4 and
    8, compacted and not, on the five structures of
    ``tests/helpers/compaction_checks.py`` (rebuilt here from a seed): every
    field but ``schedule``.
  * Against the JAX ``distributed_execute`` in this process at P = 1, and at
    P = 4 in one subprocess: this file run as a script, with the four host
    devices in the subprocess's environment alone (JAX fixes its device
    count when it starts, and this process keeps one).
  * ``PulseEngine`` on an ``EmulatedMesh`` against the single-node engine
    (``schedule="auto"`` resolved as the JAX engine resolves it), the
    out-of-scope argument's ``NotImplementedError`` (the write path on a
    mesh, item 6(b), is ``tests/test_torch_routing_write.py``; replication
    and fault injection, item 6(d), ``tests/test_torch_replication.py`` and
    ``tests/test_torch_faults.py``), and the superstep mode's plain version
    against ``k_local`` calls of the JAX ``step_batch`` per shard, edge
    cases included.

The tests marked ``gpu`` (``pytest -m gpu`` on the card, which has no JAX)
hold the kernel's superstep mode against its plain version for the
interpreter and every native body, a routed batch on the card against a CPU
copy, and the wrapper against a host sync.

Run as a script (``python tests/test_torch_routing.py OUT.npz`` with
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

try:
    import jax
    import jax.numpy as jnp

    from repro.core import commit as jcommit
    from repro.core import engine as jengine
    from repro.core import isa as jisa
    from repro.core import iterator as jiter
    from repro.core import routing as jrouting
    from repro.core import translation as jtrans
    from repro.core.iterator import PulseIterator as JIterator
    from repro.core.structures import bst as jbst
    from repro.core.structures import btree as jbtree
    from repro.core.structures import hash_table as jhash
    from repro.core.structures import isa_programs as jprogs
    from repro.core.structures import linked_list as jlist
    from repro.core.structures import skiplist as jskip
except ImportError:  # the card's machine has no JAX; its gpu tests need none
    jax = None
from repro_torch.core import arena as tarena
from repro_torch.core import engine as tengine
from repro_torch.core import faults as tfaults
from repro_torch.core import isa as tisa
from repro_torch.core import iterator as titer
from repro_torch.core import routing as trouting
from repro_torch.core.iterator import PulseIterator as TIterator
from repro_torch.core.structures import bst as tbst
from repro_torch.core.structures import btree as tbtree
from repro_torch.core.structures import hash_table as thash
from repro_torch.core.structures import isa_programs as tprogs
from repro_torch.core.structures import linked_list as tlist
from repro_torch.core.structures import skiplist as tskip
from repro_torch.kernels.pulse_chase import ops as tops
from repro_torch.kernels.pulse_chase import ref as tref

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
STRUCTURES = ("list", "bst", "btree", "hash", "skip")
N_BUCKETS = 16
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")


# ------------------------------- inputs --------------------------------------


def _structure(name, P, seed=5, n=96, B=32):
    """(JAX iterator, port iterator, JAX arena, ptr0, scratch0, max_iters)
    of one of the five structures of ``compaction_checks._five_structures``,
    interleaved across ``P`` shards, with its hit/miss query mix; ptr0 and
    scratch0 as numpy."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 10**6, n).astype(np.int32)
    if name == "list":
        keys = np.arange(n, dtype=np.int32)
        ar, head = jlist.build(keys, vals, num_shards=P, policy="interleaved")
        jit_, tit = jlist.find_iterator(), tlist.find_iterator()
        q = np.concatenate([keys[rng.integers(0, n, B - 4)], np.full(4, 10**6)])
        p0, s0 = jit_.init(jnp.asarray(q.astype(np.int32)), head)
        return jit_, tit, ar, np.array(p0), np.array(s0), 4096
    keys = np.sort(rng.choice(np.arange(10**6), n, replace=False).astype(np.int32))
    q = np.concatenate([keys[: B // 2], rng.integers(10**6, 2 * 10**6, B // 2)])
    q = jnp.asarray(q.astype(np.int32))
    if name == "bst":
        ar, root, _ = jbst.build(keys, vals, num_shards=P, policy="interleaved")
        jit_, tit, arg, max_iters = jbst.find_iterator(), tbst.find_iterator(), root, 256
    elif name == "btree":
        ar, root, _ = jbtree.build(keys, vals, num_shards=P, policy="interleaved")
        jit_, tit, arg, max_iters = jbtree.find_iterator(), tbtree.find_iterator(), root, 64
    elif name == "hash":
        ar, heads = jhash.build(keys, vals, N_BUCKETS, num_shards=P, policy="interleaved")
        jit_, tit = jhash.find_iterator(N_BUCKETS), thash.find_iterator(N_BUCKETS)
        arg, max_iters = jnp.asarray(heads), 1024
    else:
        ar, head = jskip.build(keys, vals, num_shards=P, policy="interleaved")
        jit_, tit, arg, max_iters = jskip.find_iterator(), tskip.find_iterator(), head, 1024
    p0, s0 = jit_.init(q, arg)
    return jit_, tit, ar, np.array(p0), np.array(s0), max_iters


def _hash_isa(P, seed=5):
    """The hash table with the ISA ``hash_find`` program (a verified
    read-only certificate, so the access check can be elided)."""
    _, _, ar, p0, s0, max_iters = _structure("hash", P, seed)
    jit_ = jisa.as_pulse_iterator(jprogs.hash_find_program())
    tit = tisa.as_pulse_iterator(tprogs.hash_find_program())
    return jit_, tit, ar, p0, s0, max_iters


def _carry(jar, perms=None):
    fields = [np.asarray(x) for x in (jar.data, jar.bounds, jar.perms, jar.heap)]
    if perms is not None:
        fields[2] = np.asarray(perms, np.int32)
    return tarena.arena_from_numpy(*fields, device=CPU)


def _with_perms(jar, perms):
    return dataclasses.replace(jar, perms=jnp.asarray(perms, jnp.int32))


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


def _run_port(tit, tar, p0, s0, P, **kw):
    return trouting.distributed_execute(
        tit, tar, torch.from_numpy(p0), torch.from_numpy(s0),
        mesh=trouting.EmulatedMesh(P, CPU), **kw)


# ------------------- (a) against the JAX sequential commit --------------------


@needs_jax
@pytest.mark.parametrize("compact", [True, False], ids=["compact", "uncompacted"])
@pytest.mark.parametrize("P", [2, 4, 8])
@pytest.mark.parametrize("name", STRUCTURES)
def test_distributed_matches_jax_sequential_commit(name, P, compact):
    """Records and every RoutingStats field but ``schedule`` equal the JAX
    package's sequential executor; the plain chase and the kernel's plain
    version give the same run."""
    jit_, tit, jar, p0, s0, max_iters = _structure(name, P)
    jrec, jst = jcommit.sequential_commit_execute(
        jit_, jar, p0, s0, max_iters=max_iters, compact=compact)
    tar = _carry(jar)
    for backend in ("reference", "kernel"):
        rec, st = _run_port(tit, tar, p0, s0, P, max_iters=max_iters, compact=compact,
                            local_backend=backend)
        assert rec.dtype == torch.int32 and rec.device.type == CPU
        np.testing.assert_array_equal(jrec, rec, err_msg=f"records ({backend})")
        _assert_stats_equal(jst, st, skip=("schedule",))
        assert jst.schedule == "sequential-oracle" and st.schedule == "dispatched"
    if compact and P == 4:  # the run crossed shards and skipped the fabric
        assert st.local_only_steps > 0 and st.crossings.sum() > 0


@needs_jax
@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("name", ["list", "hash"])
def test_distributed_matches_jax_sequential_commit_on_a_padded_batch(name, P):
    """A batch that is not a multiple of P: the placement pads it with
    EMPTY records, and nothing else changes."""
    jit_, tit, jar, p0, s0, max_iters = _structure(name, P, B=30)
    jrec, jst = jcommit.sequential_commit_execute(jit_, jar, p0, s0, max_iters=max_iters,
                                                  compact=True)
    rec, st = _run_port(tit, _carry(jar), p0, s0, P, max_iters=max_iters, compact=True)
    assert rec.shape[0] == 30
    np.testing.assert_array_equal(jrec, rec)
    _assert_stats_equal(jst, st, skip=("schedule",))


# ----------------- (b) against the JAX executor at P = 1 ----------------------


@needs_jax
@pytest.mark.parametrize("compact", [True, False], ids=["compact", "uncompacted"])
@pytest.mark.parametrize("name", ["list", "btree", "hash"])
def test_distributed_matches_jax_distributed_at_one_shard(name, compact):
    """In this process JAX sees one device: the mesh of one shard."""
    jit_, tit, jar, p0, s0, max_iters = _structure(name, 1)
    mesh = jax.make_mesh((1,), ("mem",))
    jrec, jst = jrouting.distributed_execute(
        jit_, jar, jnp.asarray(p0), jnp.asarray(s0), mesh=mesh, max_iters=max_iters,
        compact=compact)
    rec, st = _run_port(tit, _carry(jar), p0, s0, 1, max_iters=max_iters, compact=compact)
    np.testing.assert_array_equal(np.asarray(jrec), rec)
    _assert_stats_equal(jst, st)


@needs_jax
def test_axis_name_passed_or_left_out_and_a_wrong_one(P=4):
    """``axis_name`` naming the mesh's axis gives the call without it, bit
    for bit, through ``distributed_execute`` and ``PulseEngine``, as in the
    JAX package at one shard (this process's one device); a name the mesh
    lacks raises in both packages."""
    jit_, tit, jar, p0, s0, max_iters = _structure("list", 1)
    jmesh = jax.make_mesh((1,), ("shards",))
    jrec, _ = jrouting.distributed_execute(
        jit_, jar, jnp.asarray(p0), jnp.asarray(s0), mesh=jmesh, axis_name="shards",
        max_iters=max_iters, compact=True)
    with pytest.raises(Exception):
        jrouting.distributed_execute(jit_, jar, jnp.asarray(p0), jnp.asarray(s0), mesh=jmesh,
                                     axis_name="mem", max_iters=max_iters, compact=True)
    tmesh = trouting.EmulatedMesh(1, CPU, axis_name="shards")
    got, _ = trouting.distributed_execute(
        tit, _carry(jar), torch.as_tensor(p0), torch.as_tensor(s0), mesh=tmesh,
        axis_name="shards", max_iters=max_iters, compact=True)
    np.testing.assert_array_equal(np.asarray(jrec), got)
    with pytest.raises(ValueError, match="axis"):
        trouting.distributed_execute(tit, _carry(jar), torch.as_tensor(p0),
                                     torch.as_tensor(s0), mesh=tmesh, max_iters=max_iters)
    _, tit, jar, p0, s0, max_iters = _structure("hash", P)
    tar = _carry(jar)
    run = dict(max_iters=max_iters, compact=True)
    base, bst = _run_port(tit, tar, p0, s0, P, **run)
    named, nst = _run_port(tit, tar, p0, s0, P, axis_name="mem", **run)
    assert torch.equal(base, named)
    _assert_stats_equal(bst, nst)
    p0, s0 = torch.from_numpy(p0), torch.from_numpy(s0)
    eng = tengine.PulseEngine(tar, mesh=trouting.EmulatedMesh(P, CPU, axis_name="mem_x"),
                              axis_name="mem_x")
    assert eng.axis_name == "mem_x"
    res = eng.execute(tit, p0, s0, schedule="dispatched", **run)
    assert torch.equal(res.scratch, base[:, trouting.F_SCRATCH:])
    wrong = tengine.PulseEngine(tar, mesh=trouting.EmulatedMesh(P, CPU), axis_name="mem_x")
    with pytest.raises(ValueError, match="axis"):
        wrong.execute(tit, p0, s0, **run)


# ------------- (c) against the JAX executor on four devices -------------------

# (case id, structure, distributed_execute keyword arguments, shard 1's perms)
MESH_CASES = (
    [(f"{n}-{c}", n, dict(compact=c == "compact"), None)
     for n in STRUCTURES for c in ("compact", "uncompacted")]
    + [("list-return_to_cpu", "list", dict(return_to_cpu=True, compact=True), None),
       ("btree-return_to_cpu", "btree", dict(return_to_cpu=True), None),
       ("hash_isa-elided", "hash_isa", dict(compact=True), None),
       ("hash_isa-probed", "hash_isa", dict(compact=True, elide_access_check=False), None),
       ("list-revoked", "list", dict(compact=True), 2)]  # shard 1 writable, not readable
)


def _case_inputs(structure, P, perm1):
    jit_, tit, jar, p0, s0, max_iters = (
        _hash_isa(P) if structure == "hash_isa" else _structure(structure, P))
    if perm1 is not None:
        perms = np.asarray(jar.perms).copy()
        perms[1] = perm1
        jar = _with_perms(jar, perms)
    return jit_, tit, jar, p0, s0, max_iters


def _stats_json(st):
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        out[f.name] = v.tolist() if isinstance(v, np.ndarray) else v
    return json.dumps(out)


def _jax_mesh_script(out_path):
    """Script mode: every MESH_CASES case through the JAX package's
    ``distributed_execute`` on four host devices; inputs and outputs to
    ``out_path``."""
    assert jax.device_count() == 4, jax.devices()
    mesh = jax.make_mesh((4,), ("mem",))
    arrays = {}
    for cid, structure, kw, perm1 in MESH_CASES:
        jit_, _, jar, p0, s0, max_iters = _case_inputs(structure, 4, perm1)
        rec, st = jrouting.distributed_execute(
            jit_, jar, jnp.asarray(p0), jnp.asarray(s0), mesh=mesh, max_iters=max_iters,
            schedule="dispatched", **kw)
        arrays[f"{cid}/records"] = np.asarray(rec)
        arrays[f"{cid}/stats"] = np.asarray(_stats_json(st))
    np.savez(out_path, **arrays)


@pytest.fixture(scope="module")
def jax_mesh_results(tmp_path_factory):
    """The JAX package's four-device results, from one subprocess whose
    environment alone carries the device count."""
    if jax is None:
        pytest.skip("needs the JAX package")
    out = tmp_path_factory.mktemp("jax_mesh") / "results.npz"
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
def test_distributed_matches_jax_on_four_devices(case, jax_mesh_results):
    """Dense dispatched schedule, compacted and not, the return_to_cpu
    ablation, the access check elided and kept, and a shard that does not
    grant reads: records and every RoutingStats field equal."""
    cid, structure, kw, perm1 = case
    _, tit, jar, p0, s0, max_iters = _case_inputs(structure, 4, perm1)
    rec, st = _run_port(tit, _carry(jar), p0, s0, 4, max_iters=max_iters, **kw)
    np.testing.assert_array_equal(jax_mesh_results[f"{cid}/records"], rec)
    want = json.loads(str(jax_mesh_results[f"{cid}/stats"]))
    got = json.loads(_stats_json(st))
    assert got == want
    if perm1 is not None:
        assert (rec[:, trouting.F_STATUS] == titer.STATUS_FAULT).any()


# ------------------------------- (d) the engine -------------------------------


@needs_jax
@pytest.mark.parametrize("backend", ["reference", "kernel"])
@pytest.mark.parametrize("name", STRUCTURES)
def test_engine_on_a_mesh_matches_single_node(name, backend):
    """``PulseEngine(mesh=EmulatedMesh(4, "cpu")).execute`` gives the
    single-node engine's ptr, scratch, status and iters; ``schedule="auto"``
    resolves as the JAX engine resolves it for the same iterator, P and
    ``k_local`` (its overlap model)."""
    jit_, tit, jar, p0, s0, max_iters = _structure(name, 4)
    tar = _carry(jar)
    p0, s0 = torch.from_numpy(p0), torch.from_numpy(s0)
    one = tengine.PulseEngine(tar).execute(tit, p0, s0, max_iters=max_iters,
                                           force_offload=True)
    eng = tengine.PulseEngine(tar, mesh=trouting.EmulatedMesh(4, CPU))
    res = eng.execute(tit, p0, s0, max_iters=max_iters, force_offload=True, backend=backend)
    for f in ("ptr", "scratch", "status", "iters"):
        assert torch.equal(getattr(one, f), getattr(res, f)), f
    assert isinstance(res.stats, trouting.RoutingStats)
    want = jengine.PulseEngine(jar)._resolve_schedule(jit_, "auto", True, 4)
    assert res.stats.schedule == want and res.stats.fabric == "dense"
    assert res.stats.fused == (want != "dispatched")
    assert res.stats.supersteps > 1 and res.stats.crossings.sum() > 0


@needs_jax
def test_engine_on_a_mesh_passes_its_knobs_and_the_kill():
    """``k_local``, ``compact`` and ``return_to_cpu`` reach the executor
    (the JAX package's sequential run at the same knobs, on the dispatched
    schedule, whose stats carry the per-superstep lists), and a targeted
    kill fires before the named superstep."""
    jit_, tit, jar, p0, s0, max_iters = _structure("list", 4)
    tar = _carry(jar)
    for kw in (dict(k_local=2, compact=False), dict(k_local=8, compact=True)):
        jrec, jst = jcommit.sequential_commit_execute(jit_, jar, p0, s0, max_iters=max_iters,
                                                      **kw)
        res = tengine.PulseEngine(tar, mesh=trouting.EmulatedMesh(4, CPU)).execute(
            tit, torch.from_numpy(p0), torch.from_numpy(s0), max_iters=max_iters,
            force_offload=True, schedule="dispatched", **kw)
        _assert_stats_equal(jst, res.stats, skip=("schedule",))
        assert torch.equal(res.iters, torch.from_numpy(jrec[:, trouting.F_ITERS].copy()))
    ablate = tengine.PulseEngine(tar, mesh=trouting.EmulatedMesh(4, CPU)).execute(
        tit, torch.from_numpy(p0), torch.from_numpy(s0), max_iters=max_iters,
        force_offload=True, return_to_cpu=True)
    assert ablate.stats.local_only_steps == 0
    assert ablate.stats.crossings.sum() > res.stats.crossings.sum()
    inj = tfaults.FaultInjector(tfaults.FaultPlan(kill_shard=2, kill_call=0, kill_superstep=3))
    eng = tengine.PulseEngine(tar, mesh=trouting.EmulatedMesh(4, CPU), fault_injector=inj)
    with pytest.raises(tfaults.ShardFailure) as exc:
        eng.execute(tit, torch.from_numpy(p0), torch.from_numpy(s0), max_iters=max_iters,
                    force_offload=True)
    assert exc.value.superstep == 3 and exc.value.shard == 2


@needs_jax
@pytest.mark.parametrize("P", [1, 4], ids=["one_node", "mesh4"])
def test_engine_takes_the_reference_callers_keywords(P):
    """The keywords the reference's ``PulseService`` passes to
    ``execute`` (``fused``, ``schedule``, ``fabric``, ``replication``) give
    the call without them, bit for bit, on one node and on a mesh of four:
    ``fused=True`` resolves ``"auto"`` as the JAX engine does,
    ``fused=False`` to the dispatched schedule; a healthy replication
    context runs the read batch on the dispatched schedule with the same
    records, and on the write path it is not used, as in the reference."""
    jit_, tit, jar, p0, s0, max_iters = _structure("hash", P)
    tar = _carry(jar)
    mesh = trouting.EmulatedMesh(P, CPU) if P > 1 else None
    p0, s0 = torch.from_numpy(p0), torch.from_numpy(s0)
    run = dict(max_iters=max_iters, force_offload=True, compact=True)
    base = tengine.PulseEngine(tar, mesh=mesh).execute(tit, p0, s0, **run)
    disp = tengine.PulseEngine(tar, mesh=mesh).execute(tit, p0, s0, schedule="dispatched",
                                                       **run)
    want = jengine.PulseEngine(jar)._resolve_schedule(jit_, "auto", True, 4)
    plan = trouting.make_replica_plan(P)
    ctx = trouting.ReplicaContext(plan, tar.data.clone(), np.zeros(P, bool))
    if P > 1:
        assert base.stats.schedule == want and disp.stats.schedule == "dispatched"
        assert base.stats.supersteps == disp.stats.supersteps
        assert base.stats.total_wire_words == disp.stats.total_wire_words
    for fused, rep in ((True, None), (False, None), (True, ctx)):
        res = tengine.PulseEngine(tar, mesh=mesh).execute(
            tit, p0, s0, fused=fused, schedule="auto", fabric="dense", replication=rep, **run)
        for f in ("ptr", "scratch", "status", "iters"):
            assert torch.equal(getattr(base, f), getattr(res, f)), (fused, f)
        if P > 1:
            # the same schedule as the call without the keywords, or the
            # dispatched one: every field equal to that run's
            _assert_stats_equal(base.stats if fused and rep is None else disp.stats, res.stats)
    wit = tlist.insert_iterator()
    w0 = torch.zeros((p0.shape[0], wit.scratch_words), dtype=torch.int32)
    wres = [tengine.PulseEngine(tar, mesh=mesh).execute(wit, p0, w0, fused=True,
                                                        replication=r, **run)
            for r in (None, ctx)]
    assert torch.equal(wres[0].status, wres[1].status)
    assert torch.equal(wres[0].arena.data, wres[1].arena.data)


@needs_jax
def test_too_few_supersteps_raise_as_in_the_jax_package():
    jit_, tit, jar, p0, s0, max_iters = _structure("list", 4)
    with pytest.raises(RuntimeError, match="still ACTIVE"):
        jcommit.sequential_commit_execute(jit_, jar, p0, s0, max_iters=max_iters,
                                          max_supersteps=3)
    with pytest.raises(RuntimeError, match="still ACTIVE"):
        _run_port(tit, _carry(jar), p0, s0, 4, max_iters=max_iters, max_supersteps=3)


@needs_jax
def test_profiler_spans_split_a_call():
    """Under the profiler a call shows its placement, one span per
    superstep, and in each its chase, its switch and its read of the
    counters, and its decode."""
    from torch.profiler import ProfilerActivity, profile

    _, tit, jar, p0, s0, max_iters = _structure("list", 4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, st = _run_port(tit, _carry(jar), p0, s0, 4, max_iters=max_iters, compact=True)
    calls = {e.key: e.count for e in prof.key_averages() if e.key.startswith("routing.")}
    n = st.supersteps
    assert calls == {"routing.place": 1, "routing.superstep": n, "routing.chase": n,
                     "routing.switch": n, "routing.counters": n, "routing.decode": 1}


def test_mesh_and_arena_must_agree():
    ar = tarena.make_arena(np.zeros((8, 4), np.int32), num_shards=2, device=CPU)
    it = tlist.find_iterator()
    p0, s0 = torch.zeros(2, dtype=torch.int32), torch.zeros((2, it.scratch_words),
                                                            dtype=torch.int32)
    with pytest.raises(ValueError, match="shards"):
        trouting.distributed_execute(it, ar, p0, s0, mesh=trouting.EmulatedMesh(4, CPU))
    with pytest.raises(ValueError, match="mesh is on"):
        trouting.distributed_execute(it, ar, p0, s0, mesh=trouting.EmulatedMesh(2, "cuda"))
    with pytest.raises(ValueError, match="local_backend"):
        trouting.distributed_execute(it, ar, p0, s0, mesh=trouting.EmulatedMesh(2, CPU),
                                     local_backend="xla")
    with pytest.raises(ValueError, match="at least one"):
        trouting.EmulatedMesh(0, CPU)


# --------------------------- (e) out of scope ---------------------------------


def _deferred_calls():
    """(id, sub-item, callable) for every argument outside items 6(a)-(d)
    (the write path on a mesh: ``tests/test_torch_routing_write.py``; the
    fused and pipelined schedules and the ring fabric:
    ``tests/test_torch_routing_fused.py`` and ``test_item_6c_calls`` below;
    replication and fault injection: ``tests/test_torch_replication.py``
    and ``tests/test_torch_faults.py``)."""
    ar = tarena.make_arena(np.zeros((8, 4), np.int32), num_shards=2, device=CPU)
    it = tlist.find_iterator()
    mesh = trouting.EmulatedMesh(2, CPU)
    p0 = torch.zeros(2, dtype=torch.int32)
    s0 = torch.zeros((2, it.scratch_words), dtype=torch.int32)

    return [
        ("engine_other_mesh", "6(e)",
         lambda: tengine.PulseEngine(ar, mesh=object()).execute(it, p0, s0)),
    ]


DEFERRED = [(c[0], c[1]) for c in _deferred_calls()]


@pytest.mark.parametrize("case", DEFERRED, ids=[c[0] for c in DEFERRED])
def test_out_of_scope_arguments_raise_naming_their_item(case):
    cid, item = case
    fn = {c[0]: c[2] for c in _deferred_calls()}[cid]
    with pytest.raises(NotImplementedError, match=rf"item {item[0]}\({item[2]}\)"):
        fn()


ITEM_6C_CALLS = ("fused", "pipelined", "ring", "superstep_ring", "exchange_ring", "engine_fused",
                 "engine_ring")


@pytest.mark.parametrize("case", ITEM_6C_CALLS)
def test_item_6c_calls(case):
    """The calls that raised naming item 6(c) before it was ported now run,
    each equal to the dispatched dense run of the same batch (a list of 64
    keys over two shards): records and stats but ``schedule``, ``fused``,
    ``fabric`` and the aggregates; the superstep and the exchange bit for
    bit."""
    g = np.random.default_rng(7)
    keys = np.arange(64, dtype=np.int32)
    ar, head = tlist.build(keys, g.integers(0, 10**6, 64).astype(np.int32), num_shards=2,
                           policy="interleaved", device=CPU)
    it = tlist.find_iterator()
    p0, s0 = it.init(torch.from_numpy(np.r_[keys[::3], 10**6].astype(np.int32)), head)
    mesh = trouting.EmulatedMesh(2, CPU)
    run = dict(max_iters=256, compact=True)
    base, bst = trouting.distributed_execute(it, ar, p0, s0, mesh=mesh, **run)
    eng = tengine.PulseEngine(ar, mesh=mesh)
    if case in ("superstep_ring", "exchange_ring"):
        pools, _ = trouting.place_requests(p0, s0, 2)
        kw = dict(k_local=2, max_iters=256, local_backend="reference")
        want = trouting.make_superstep(it, 2, **kw)(pools, ar.data, ar.bounds, ar.perms)
        got = trouting.make_superstep(it, 2, fabric="ring", **kw)(pools, ar.data, ar.bounds,
                                                                 ar.perms)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        kept, send, _ = trouting._route_decide(want[0], ar.bounds, 2, return_to_cpu=False)
        assert torch.equal(trouting._exchange(send, 2, fabric="ring"),
                           trouting._exchange(send, 2, fabric="dense"))
        return
    schedule = {"fused": "fused", "pipelined": "pipelined", "engine_fused": "fused"}.get(
        case, "dispatched")
    fabric = "ring" if case in ("ring", "engine_ring") else "dense"
    if case.startswith("engine"):
        res = eng.execute(it, p0, s0, schedule=schedule, fabric=fabric, force_offload=True,
                          **run)
        rec, st = None, res.stats
        assert torch.equal(res.ptr, base[:, trouting.F_PTR])
        assert torch.equal(res.status, base[:, trouting.F_STATUS])
    else:
        rec, st = trouting.distributed_execute(it, ar, p0, s0, mesh=mesh, schedule=schedule,
                                               fabric=fabric, **run)
        assert torch.equal(rec, base)
    assert (st.schedule, st.fabric, st.fused) == (schedule, fabric, schedule != "dispatched")
    assert st.supersteps == bst.supersteps and st.total_wire_words == bst.total_wire_words
    assert st.local_only_steps == bst.local_only_steps
    np.testing.assert_array_equal(st.crossings, bst.crossings)
    assert st.ring_hops == (st.supersteps - st.local_only_steps if fabric == "ring" else 0)


# ------------------ (f) the superstep mode's plain version --------------------

SUPERSTEP_CASES = ("null_on_last_step", "max_iters_inside", "no_read_shard", "remote_untouched",
                   "hash_mixed")
W_LIST = 4  # rows of the walk's list (KEY, VALUE, NEXT, pad)


def _walk_program(isa_mod):
    """An ISA walk that ends only on its key: an absent key walks off the
    list's tail onto NULL without finishing."""
    a = isa_mod.Asm(scratch_words=1, node_words=W_LIST, name="walk_isa")
    a.loads(0, 0)
    a.loadn(1, 0)
    a.jne(0, 1, "miss")
    a.ret()
    a.label("miss")
    a.loadn(2, 2)
    a.next_iter(2)
    return isa_mod.as_pulse_iterator(a.finish(), verify=False)


def _walk_torch():
    """The same walk as a torch iterator of each package."""
    j = JIterator(scratch_words=1, next_fn=lambda n, p, s: (n[2], s),
                  end_fn=lambda n, p, s: (n[0] == s[0], s), name="walk") if jax else None
    t = TIterator(scratch_words=1, next_fn=lambda n, p, s: (n[:, 2], s),
                  end_fn=lambda n, p, s: (n[:, 0] == s[:, 0], s), name="walk")
    return j, t


def _superstep_case(case, route, seed=3, P=4, L=24):
    """(JAX iterator or None, port iterator, data, bounds, perms, pool (P, L,
    R), k_local, max_iters) for one edge case of the superstep mode."""
    g = np.random.default_rng(seed)
    if case == "hash_mixed":
        keys = np.sort(g.choice(10**5, 200, replace=False)).astype(np.int32)
        ar, heads = thash.build(keys, keys * 3, N_BUCKETS, num_shards=P, policy="interleaved",
                                device=CPU)
        tit = thash.find_iterator(N_BUCKETS)
        q = torch.from_numpy(np.concatenate([keys[g.integers(0, 200, 40)],
                                             g.integers(10**5, 2 * 10**5, 8)]).astype(np.int32))
        p0, s0 = tit.init(q, torch.as_tensor(heads))
        if route == "isa":
            jit_ = jisa.as_pulse_iterator(jprogs.hash_find_program()) if jax else None
            tit = tisa.as_pulse_iterator(tprogs.hash_find_program())
        else:
            jit_ = jhash.find_iterator(N_BUCKETS) if jax else None
        data, bounds, perms = ar.data, ar.bounds, ar.perms
        pools, _ = trouting.place_requests(p0, s0, P)
        # a mid-run state: some records done, some nearly out of budget
        flat = pools.reshape(-1, pools.shape[2])
        live = torch.nonzero(flat[:, trouting.F_STATUS] == titer.STATUS_ACTIVE).flatten()
        pick = torch.from_numpy(g.permutation(len(live))[:8])
        flat[live[pick[:3]], trouting.F_STATUS] = titer.STATUS_DONE
        flat[live[pick[3:]], trouting.F_ITERS] = torch.tensor([5, 6, 7, 2, 9], dtype=torch.int32)
        return jit_, tit, data, bounds, perms, pools, 4, 8

    # a list of 32 nodes in shard 0, another in shard 1, of a 4-shard arena
    per, n = 40, 32
    data = np.zeros((P * per, W_LIST), np.int32)
    for s in (0, 1):
        base = s * per
        data[base : base + n, 0] = 1000 * (s + 1) + np.arange(n)
        data[base : base + n, 1] = np.arange(n) * 7
        data[base : base + n, 2] = np.append(np.arange(base + 1, base + n), -1)
    bounds = torch.arange(P + 1, dtype=torch.int32) * per
    perms = torch.full((P,), tarena.PERM_READ | tarena.PERM_WRITE, dtype=torch.int32)
    if route == "isa":
        jit_ = _walk_program(jisa) if jax else None
        tit = _walk_program(tisa)
    else:
        jit_, tit = _walk_torch()
    R = trouting.record_width(1)
    pool = np.zeros((P, L, R), np.int32)
    pool[..., trouting.F_STATUS] = titer.STATUS_EMPTY
    rows = []  # (shard, ptr, target, iters, status)
    absent = 99
    for j in range(n - 6, n):  # NULL on step 1..6 of the walk (after the last, 4th step)
        rows.append((0, j, absent, 0, titer.STATUS_ACTIVE))
    rows += [(0, 5, 1000 + 7, 0, titer.STATUS_ACTIVE), (0, 3, absent, 2, titer.STATUS_DONE)]
    rows += [(1, per + 2, 2000 + 30, 0, titer.STATUS_ACTIVE),
             (1, per + 28, 2000 + 30, 0, titer.STATUS_ACTIVE)]
    if case == "max_iters_inside":
        rows += [(0, 1, absent, 6, titer.STATUS_ACTIVE), (0, 2, absent, 7, titer.STATUS_ACTIVE),
                 (0, 4, absent, 8, titer.STATUS_ACTIVE), (2, per + 1, absent, 10,
                                                          titer.STATUS_ACTIVE),
                 (3, 1, absent, 9, titer.STATUS_ACTIVE), (3, -1, absent, 8, titer.STATUS_ACTIVE)]
    if case in ("remote_untouched", "no_read_shard"):
        rows += [(2, 7, absent, 1, titer.STATUS_ACTIVE), (3, per + 9, absent, 3,
                                                          titer.STATUS_ACTIVE),
                 (1, 4, absent, 0, titer.STATUS_ACTIVE), (2, -1, absent, 0,
                                                          titer.STATUS_ACTIVE),
                 (3, 10 * per, absent, 0, titer.STATUS_ACTIVE)]
    slot = [0] * P
    for i, (s, p, tgt, it_, st) in enumerate(rows):
        r = pool[s, slot[s]]
        slot[s] += 1
        r[trouting.F_ID], r[trouting.F_HOME], r[trouting.F_PTR] = i, (i * 3) % P, p
        r[trouting.F_STATUS], r[trouting.F_ITERS], r[trouting.F_HOPS] = st, it_, i % 5
        r[trouting.F_SCRATCH] = tgt
    if case == "no_read_shard":
        perms[0] = tarena.PERM_WRITE
    max_iters = 10 if case == "max_iters_inside" else 1 << 20
    return jit_, tit, torch.from_numpy(data), bounds, perms, torch.from_numpy(pool), 4, max_iters


def _jax_superstep(jit_, data, bounds, perms, pool, k_local, max_iters):
    """``k_local`` calls of the JAX ``step_batch`` per shard, over that
    shard's rows (``routing._local_superstep`` with the plain chase)."""
    out = pool.copy()
    b = np.asarray(bounds)
    F = jrouting
    step = jax.jit(lambda rows, p, sc, st, it_, lo, hi, ok: jiter.step_batch(
        jit_, rows, p, sc, st, it_, max_iters=max_iters, local_lo=lo, local_hi=hi, perm_ok=ok))
    for s in range(pool.shape[0]):
        lo, hi = int(b[s]), int(b[s + 1])
        perm_ok = jtrans.check_access(jnp.asarray(perms), jnp.int32(s), tarena.PERM_READ)
        st = (jnp.asarray(out[s, :, F.F_PTR]), jnp.asarray(out[s, :, F.F_SCRATCH:]),
              jnp.asarray(out[s, :, F.F_STATUS]), jnp.asarray(out[s, :, F.F_ITERS]))
        for _ in range(k_local):
            st = step(jnp.asarray(data[lo:hi]), *st, jnp.int32(lo), jnp.int32(hi), perm_ok)
        out[s, :, F.F_PTR], out[s, :, F.F_SCRATCH:] = np.asarray(st[0]), np.asarray(st[1])
        out[s, :, F.F_STATUS], out[s, :, F.F_ITERS] = np.asarray(st[2]), np.asarray(st[3])
    return out


@needs_jax
@pytest.mark.parametrize("route", ["torch", "isa"])
@pytest.mark.parametrize("case", SUPERSTEP_CASES)
def test_superstep_plain_version_matches_jax_step_batch(case, route):
    """The plain version of the superstep mode, and the port's plain chase,
    equal ``k_local`` calls of the JAX ``step_batch`` per shard."""
    jit_, tit, data, bounds, perms, pool, k_local, max_iters = _superstep_case(case, route)
    want = _jax_superstep(jit_, data.numpy(), bounds.numpy(), perms.numpy(), pool.numpy(),
                          k_local, max_iters)
    got = tref.chase_superstep_reference(
        data, pool, bounds, perms, tops.iterator_logic(tit), k_local,
        scratch_words=tit.scratch_words, max_iters=max_iters)
    np.testing.assert_array_equal(want, got.numpy())
    plain = trouting._local_superstep(tit, pool, data, bounds, perms, k_local=k_local,
                                      max_iters=max_iters, backend="reference")
    np.testing.assert_array_equal(want, plain.numpy())
    wrapped = tops.pulse_chase_superstep(data, pool, bounds, perms,
                                         logic_fn=tops.iterator_logic(tit), k_local=k_local,
                                         max_iters=max_iters)
    assert torch.equal(wrapped, got)
    # the budget as a device operand (the device-resident loops' form)
    budget = torch.tensor(max_iters, dtype=torch.int32)
    for fn in (lambda b: tops.pulse_chase_superstep(
                   data, pool, bounds, perms, logic_fn=tops.iterator_logic(tit),
                   k_local=k_local, max_iters=b),
               lambda b: trouting._local_superstep(tit, pool, data, bounds, perms,
                                                   k_local=k_local, max_iters=b,
                                                   backend="reference")):
        assert torch.equal(fn(budget), got)
    _check_edge(case, pool.numpy(), got.numpy(), bounds.numpy())


def _check_edge(case, before, after, bounds):
    """The edge each case is there for really occurs."""
    F, st = trouting, after[..., trouting.F_STATUS]
    if case == "null_on_last_step":  # NULL after the 4th step: still ACTIVE, into the switch
        assert ((st == titer.STATUS_ACTIVE) & (after[..., F.F_PTR] == -1)).sum() == 1
        assert (st == titer.STATUS_FAULT).sum() >= 3
    elif case == "max_iters_inside":
        assert (st == titer.STATUS_MAXED).sum() >= 4
        assert after[2, 0, F.F_ITERS] == 10 and st[2, 0] == titer.STATUS_MAXED  # remote, spent
        assert after[3, 0, F.F_ITERS] == 9 and st[3, 0] == titer.STATUS_ACTIVE  # remote, left
    elif case == "no_read_shard":
        faulted = (before[0, :, F.F_STATUS] == titer.STATUS_ACTIVE) & (st[0] == titer.STATUS_FAULT)
        assert faulted.sum() >= 7 and (after[0, :, F.F_ITERS] == before[0, :, F.F_ITERS]).all()
    elif case == "remote_untouched":
        rec = after[2, 0]
        assert rec[F.F_PTR] == 7 and rec[F.F_STATUS] == titer.STATUS_ACTIVE
        np.testing.assert_array_equal(before[3, 0], after[3, 0])
        own = (after[..., F.F_PTR] >= bounds[:-1, None]) & (after[..., F.F_PTR] < bounds[1:, None])
        assert ((st == titer.STATUS_ACTIVE) & ~own & (after[..., F.F_PTR] >= 0)).sum() >= 3


# --------------------------------- the card -----------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with pytest -m gpu")


def _card_structure(body, P=4, n=3000, B=2048, seed=11):
    """(arena on the card, iterator, ptr0, scr0) of the structure whose
    iterator runs on ``body``, interleaved over ``P`` shards."""
    g = np.random.default_rng(seed)
    keys = np.sort(g.choice(10**6, n, replace=False)).astype(np.int32)
    vals = g.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    q = torch.from_numpy(np.concatenate([keys[g.integers(0, n, B - B // 8)],
                                         g.integers(10**6, 2 * 10**6, B // 8)]).astype(np.int32))
    kw = dict(num_shards=P, policy="interleaved", device="cuda")
    if body in ("list_find", "list_sum"):
        ar, head = tlist.build(keys[:256], vals[:256], **kw)
        it = tlist.find_iterator() if body == "list_find" else tlist.sum_iterator()
        p0, s0 = it.init(q.cuda(), head) if body == "list_find" else it.init(
            torch.full((B,), head, dtype=torch.int32, device="cuda"))
    elif body in ("hash_find", "isa"):
        ar, heads = thash.build(keys, vals, 64, **kw)
        it = thash.find_iterator(64)
        p0, s0 = it.init(q.cuda(), torch.as_tensor(heads).cuda())
        if body == "isa":
            it = tisa.as_pulse_iterator(tprogs.hash_find_program())
    elif body == "bst_find":
        ar, root, _ = tbst.build(keys, vals, **kw)
        it = tbst.find_iterator()
        p0, s0 = it.init(q.cuda(), root)
    elif body in ("btree_find", "btree_range_agg"):
        ar, root, _ = tbtree.build(keys, vals, **kw)
        if body == "btree_find":
            it = tbtree.find_iterator()
            p0, s0 = it.init(q.cuda(), root)
        else:
            it = tbtree.range_aggregate_iterator()
            lo = q.cuda()
            p0, s0 = it.init(lo, lo + 20_000, root)
    else:
        ar, head = tskip.build(keys, vals, **kw)
        it = tskip.find_iterator()
        p0, s0 = it.init(q.cuda(), head)
    return ar, it, p0, s0


CARD_BODIES = ["isa", "list_find", "list_sum", "hash_find", "bst_find", "btree_find",
               "btree_range_agg", "skiplist_find"]


@pytest.mark.gpu
@pytest.mark.parametrize("body", CARD_BODIES)
def test_superstep_kernel_matches_plain_on_card(body):
    """Every superstep of a routed run, and a perturbed pool (budgets
    spent, a revoked shard, the access check elided), on the kernel and on
    its plain version, on the same CUDA tensors; the kernel also with the
    budget given as a device tensor, at two budgets."""
    _card()
    ar, it, p0, s0 = _card_structure(body)
    logic = tops.iterator_logic(it)
    assert (logic.program is not None) == (body == "isa")
    assert body == "isa" or logic.native.name == body
    pools, _ = trouting.place_requests(p0, s0.reshape(p0.shape[0], -1), 4)
    route = trouting.make_superstep(it, 4, k_local=4, max_iters=64, local_backend="reference")
    g = torch.Generator(device="cpu").manual_seed(0)
    for step in range(6):
        flat = pools.reshape(-1, pools.shape[2])
        iters = torch.randint(0, 70, (flat.shape[0],), generator=g, dtype=torch.int32).cuda()
        variants = [(pools, ar.perms, False, 64), (pools, ar.perms, True, 64),
                    (torch.cat([flat[:, :trouting.F_ITERS], iters[:, None],
                                flat[:, trouting.F_ITERS + 1:]], 1).reshape(pools.shape),
                     ar.perms, False, 64),
                    (pools, torch.tensor([3, 0, 3, 2], dtype=torch.int32, device="cuda"),
                     False, 1 << 30)]
        for pool, perms, elide, max_iters in variants:
            got = tops.pulse_chase_superstep(ar.data, pool, ar.bounds, perms, logic_fn=logic,
                                             k_local=4, max_iters=max_iters,
                                             elide_access_check=elide)
            want = tref.chase_superstep_reference(
                ar.data, pool, ar.bounds, perms, logic, 4, scratch_words=it.scratch_words,
                max_iters=max_iters, elide=elide)
            # the budget as a device tensor, which the kernel reads
            budget = torch.tensor(max_iters, dtype=torch.int32, device="cuda")
            via = tops.pulse_chase_superstep(ar.data, pool, ar.bounds, perms, logic_fn=logic,
                                             k_local=4, max_iters=budget,
                                             elide_access_check=elide)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (body, step, elide, max_iters)
            assert torch.equal(via, want), (body, step, elide, max_iters, "device budget")
        pools = route(pools, ar.data, ar.bounds, ar.perms)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["isa", "torch"])
@pytest.mark.parametrize("case", [c for c in SUPERSTEP_CASES if c != "hash_mixed"])
def test_superstep_edge_cases_on_card(case, route):
    """The edge cases of the plain version's CPU test, on the kernel (the
    ISA walk on the interpreter; the torch walk has no kernel body and
    raises)."""
    _card()
    _, tit, data, bounds, perms, pool, k_local, max_iters = _superstep_case(case, route)
    args = [t.cuda() for t in (data, pool, bounds, perms)]
    logic = tops.iterator_logic(tit)
    if route == "torch":
        with pytest.raises(ValueError, match="ISA"):
            tops.pulse_chase_superstep(args[0], args[1], args[2], args[3], logic_fn=logic,
                                       k_local=k_local, max_iters=max_iters)
        return
    got = tops.pulse_chase_superstep(args[0], args[1], args[2], args[3], logic_fn=logic,
                                     k_local=k_local, max_iters=max_iters)
    want = tref.chase_superstep_reference(data, pool, bounds, perms, logic, k_local,
                                          scratch_words=1, max_iters=max_iters)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("body", ["hash_find", "btree_find", "isa"])
def test_distributed_execute_on_card_matches_cpu_copy(body, compact):
    """A routed batch on the card (one launch per superstep) equals the same
    call on a CPU copy of the arena: records and every stats field."""
    _card()
    ar, it, p0, s0 = _card_structure(body)
    before = tops.pulse_chase.launches
    rec, st = trouting.distributed_execute(it, ar, p0, s0, mesh=trouting.EmulatedMesh(4),
                                           max_iters=4096, compact=compact)
    assert tops.pulse_chase.launches - before == st.supersteps
    cpu = tarena.arena_from_numpy(*(t.cpu().numpy() for t in (ar.data, ar.bounds, ar.perms,
                                                             ar.heap)), device=CPU)
    crec, cst = trouting.distributed_execute(it, cpu, p0.cpu(), s0.cpu(),
                                             mesh=trouting.EmulatedMesh(4, CPU),
                                             max_iters=4096, compact=compact)
    assert rec.is_cuda and torch.equal(rec.cpu(), crec)
    _assert_stats_equal(cst, st)
    assert st.crossings.sum() > 0


@pytest.mark.gpu
def test_superstep_wrapper_makes_no_host_sync():
    """One launch, counted, with nothing read on the host."""
    _card()
    ar, it, p0, s0 = _card_structure("btree_find")
    pools, _ = trouting.place_requests(p0, s0, 4)
    logic = tops.iterator_logic(it)
    tops.pulse_chase_superstep(ar.data, pools, ar.bounds, ar.perms, logic_fn=logic, k_local=4,
                               max_iters=64)
    torch.cuda.synchronize()
    before = tops.pulse_chase.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = tops.pulse_chase_superstep(ar.data, pools, ar.bounds, ar.perms, logic_fn=logic,
                                         k_local=4, max_iters=64)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tops.pulse_chase.launches == before + 1
    assert out.shape == pools.shape and out.is_cuda
    empty = pools[:, :0]
    assert tops.pulse_chase_superstep(ar.data, empty, ar.bounds, ar.perms, logic_fn=logic,
                                      k_local=4, max_iters=64).shape == empty.shape
    assert tops.pulse_chase.launches == before + 1  # an empty pool launches nothing


if __name__ == "__main__":
    _jax_mesh_script(sys.argv[1])
