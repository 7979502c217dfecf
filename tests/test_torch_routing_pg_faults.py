"""Port parity: replication, kills and the straggler on memory nodes as
processes (ROADMAP queue 1, item 2) -- ``distributed_execute`` and
``PulseEngine`` over a ``routing.ProcessGroupMesh`` of Gloo ranks on the
CPU, with a ``ReplicaContext`` or a ``FaultInjector`` -- and the replica
window of ``pulse_chase``'s superstep mode with a shard offset.

The inputs are ``tests/test_torch_routing_pg.py``'s (the JAX package's
builders, from a seed): ``hash_find`` interleaved, ``btree_find``
sequential, the hash read/write mix and the B+tree updates.  Three
executors run them and every int32 output must be bit-equal:

  * the port on a ``ProcessGroupMesh`` of 4 and of 2 ranks: this file run
    as a script (``python tests/test_torch_routing_pg_faults.py world P
    IN.npz OUT_DIR``), a world of P ranks started by
    ``distributed.world.spawn``, each rank writing what it saw;
  * the port on ``EmulatedMesh(P, "cpu")`` in this process;
  * the JAX package's ``distributed_execute`` on four host devices in one
    subprocess (``python tests/test_torch_routing_pg_faults.py jax
    OUT.npz``, four devices in its environment alone), for every policy on
    the hash table, one on the B+tree, the reads' kills and a write's
    killed call (``JAX_SKIP``: the rest would compile for seconds each).

The cases: replicated reads under every policy (``failover`` with each
primary dead in turn, ``spread`` healthy and with a dead primary,
``primary``), a kill on a read and on a write batch (every rank raises the
same ``ShardFailure``; a write's caller keeps its arena), a kill on a
later call, and the straggler, whose sleeps are recorded instead of slept
(``routing._straggle``): only rank ``delay_shard`` sleeps, before the
supersteps in which the emulated mesh's sleeps, and as often as the JAX
package's.  ``PulseEngine`` passes both through.

On the CPU the plain superstep takes the replica window with a shard
offset: one shard's pool over its own rows and its holder slice of the
replica rows equals its part of the all-shards call.  The ``gpu`` test
holds the kernel's windowed offset launch against the plain version."""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import engine as tengine
from repro_torch.core import faults as tfaults
from repro_torch.core import routing as trouting
from repro_torch.core.iterator import STATUS_DONE
from repro_torch.distributed import world
from repro_torch.kernels.pulse_chase import ops as chase_ops
from repro_torch.kernels.pulse_chase import ref as chase_ref

from test_torch_routing_pg import (  # noqa: E402
    _env,
    _jax_inputs,
    _mid_run_pools,
    _port_case,
    _stats_json,
    write_inputs,
)

CPU = "cpu"
HAS_JAX = importlib.util.find_spec("jax") is not None
needs_jax = pytest.mark.skipif(not HAS_JAX, reason="needs the JAX package")
WORLD_TIMEOUT = 90.0

# (case id, input kind, policy, dead shards): replicated reads at P = 4
REP_CASES = ([(f"hash-failover-dead{d}", "hash", "failover", (d,)) for d in range(4)]
             + [("hash-spread", "hash", "spread", ()),
                ("hash-spread-dead1", "hash", "spread", (1,)),
                ("hash-primary", "hash", "primary", ()),
                ("btree_seq-failover-dead2", "btree_seq", "failover", (2,)),
                ("btree_seq-spread-dead3", "btree_seq", "spread", (3,)),
                ("btree_seq-primary", "btree_seq", "primary", ())])
REP_CASES_2 = [("hash-failover-dead0", "hash", "failover", (0,)),
               ("hash-spread-dead1", "hash", "spread", (1,))]
# (case id, input kind, FaultPlan keywords): each run on two calls of a fresh injector
KILL_CASES = [
    ("hash-kill-superstep3", "hash", dict(kill_shard=2, kill_call=0, kill_superstep=3)),
    ("hash-kill-call1", "hash", dict(kill_shard=1, kill_call=1, kill_superstep=2)),
    ("hash_rw-kill-superstep2", "hash_mixed_rw", dict(kill_shard=3, kill_superstep=2)),
    ("btree_update-kill-superstep1", "btree_update", dict(kill_shard=0, kill_superstep=1)),
]
# (case id, input kind, delay shard, (policy, dead shards) or None)
DELAY_CASES = [("hash-delay1", "hash", 1, None),
               ("hash-delay2-failover-dead2", "hash", 2, ("failover", (2,))),
               ("hash-delay0-spread", "hash", 0, ("spread", ())),
               ("btree_seq-delay3", "btree_seq", 3, None)]
DELAY_S = 0.01
# what the JAX run leaves out for its time (each new policy or iterator a
# compile of seconds): it covers every policy on the hash table, one on the
# B+tree, the reads' kills and a write's killed call
JAX_SKIP = {"btree_seq-spread-dead3", "btree_seq-primary", "btree_update-kill-superstep1",
            "btree_seq-delay3"}
JAX_REP_CASES = [c for c in REP_CASES if c[0] not in JAX_SKIP]


# --------------------------------- the runs -----------------------------------


def rep_rows(plan, data, bounds):
    """Holder ``r``'s rows of the arena's layout hold ``primary_map[r]``'s."""
    data, bounds = np.asarray(data), np.asarray(bounds)
    rows = np.zeros_like(data)
    for holder, p in enumerate(plan.primary_map):
        if p >= 0:
            rows[bounds[holder]:bounds[holder + 1]] = data[bounds[p]:bounds[p + 1]]
    return rows


def _context(routing_mod, data, bounds, P, policy, dead):
    plan = routing_mod.make_replica_plan(P, policy=policy)
    mask = np.zeros(P, bool)
    mask[list(dead)] = True
    return routing_mod.ReplicaContext(plan=plan, rep_rows=rep_rows(plan, data, bounds),
                                      dead_mask=mask)


def _rep_runs(d, mesh, cases):
    out = {}
    for cid, kind, policy, dead in cases:
        it, ar, p0, s0, max_iters = _port_case(d, kind)
        ctx = _context(trouting, d[f"{kind}/data"], d[f"{kind}/bounds"], mesh.num_shards,
                       policy, dead)
        rec, st = trouting.distributed_execute(it, ar, p0, s0, mesh=mesh, max_iters=max_iters,
                                               compact=True, replication=ctx)
        out[f"rep/{cid}/records"] = rec.numpy()
        out[f"rep/{cid}/stats"] = np.asarray(_stats_json(st))
    return out


def _kill_runs(d, mesh):
    """Each kill case on two calls of one injector: what each call did
    (records, or the raised shard and superstep), and whether a write's
    arena came back unchanged."""
    out = {}
    for cid, kind, plan in KILL_CASES:
        it, ar, p0, s0, max_iters = _port_case(d, kind)
        before = (ar.data.clone(), ar.heap.clone())
        inj = tfaults.FaultInjector(tfaults.FaultPlan(**plan))
        for call in range(2):
            try:
                got = trouting.distributed_execute(it, ar, p0, s0, mesh=mesh,
                                                   max_iters=max_iters, compact=True,
                                                   fault_injector=inj)
                out[f"kill/{cid}/{call}/records"] = got[0].numpy()
            except tfaults.ShardFailure as e:
                out[f"kill/{cid}/{call}/raised"] = np.asarray([e.shard, e.superstep])
        out[f"kill/{cid}/unchanged"] = np.asarray(
            torch.equal(ar.data, before[0]) and torch.equal(ar.heap, before[1]))
    return out


def _delay_runs(d, mesh):
    """Each straggler case with ``routing._straggle`` recording the
    superstep of each sleep instead of sleeping."""
    out = {}
    real = trouting._straggle
    for cid, kind, shard, rep in DELAY_CASES:
        it, ar, p0, s0, max_iters = _port_case(d, kind)
        ctx = (None if rep is None else _context(trouting, d[f"{kind}/data"],
                                                 d[f"{kind}/bounds"], mesh.num_shards, *rep))
        sleeps = []
        trouting._straggle = lambda s, step: sleeps.append((s, step))
        try:
            rec, st = trouting.distributed_execute(
                it, ar, p0, s0, mesh=mesh, max_iters=max_iters, compact=True,
                replication=ctx, fault_injector=tfaults.FaultInjector(
                    tfaults.FaultPlan(delay_shard=shard, delay_s=DELAY_S)))
        finally:
            trouting._straggle = real
        assert all(s == DELAY_S for s, _ in sleeps), sleeps
        out[f"delay/{cid}/sleeps"] = np.asarray([step for _, step in sleeps], np.int64)
        out[f"delay/{cid}/records"] = rec.numpy()
        out[f"delay/{cid}/supersteps"] = np.asarray(st.supersteps)
    return out


def _engine_runs(d, mesh):
    """``PulseEngine.execute`` with a replica context (failover, shard 1
    dead), and a write batch killed at its second superstep."""
    it, ar, p0, s0, max_iters = _port_case(d, "hash")
    ctx = _context(trouting, d["hash/data"], d["hash/bounds"], mesh.num_shards, "failover", (1,))
    res = tengine.PulseEngine(ar, mesh=mesh).execute(it, p0, s0, max_iters=max_iters,
                                                     replication=ctx)
    out = {f"engine/rep/{f}": getattr(res, f).numpy()
           for f in ("ptr", "scratch", "status", "iters")}
    out["engine/rep/stats"] = np.asarray(_stats_json(res.stats))
    it, ar, p0, s0, max_iters = _port_case(d, "hash_mixed_rw")
    eng = tengine.PulseEngine(ar, mesh=mesh, fault_injector=tfaults.FaultInjector(
        tfaults.FaultPlan(kill_shard=2, kill_superstep=2)))
    try:
        eng.execute(it, p0, s0, max_iters=max_iters)
        out["engine/kill"] = np.asarray([-1, -1])
    except tfaults.ShardFailure as e:
        out["engine/kill"] = np.asarray([e.shard, e.superstep])
    out["engine/kill_kept_arena"] = np.asarray(eng.arena is ar)
    return out


def run_all(d, mesh):
    rep = REP_CASES if mesh.num_shards == 4 else REP_CASES_2
    out = _rep_runs(d, mesh, rep)
    if mesh.num_shards == 4:
        out.update(_kill_runs(d, mesh))
        out.update(_delay_runs(d, mesh))
        out.update(_engine_runs(d, mesh))
    return out


def _world_rank(rank, world_size, in_path, out_dir):
    d = dict(np.load(in_path))
    mesh = trouting.ProcessGroupMesh(device=CPU)
    np.savez(Path(out_dir) / f"rank{rank}.npz", **run_all(d, mesh))


def _jax_script(out_path):
    """Script mode: the replicated reads, the kills and the straggler's
    sleep count through the JAX package's ``distributed_execute`` on four
    host devices, dispatched, on the inputs ``write_inputs`` makes (the
    same seeded builders as the worlds'); outputs to ``out_path``."""
    import jax
    import jax.numpy as jnp

    from repro.core import arena as jarena
    from repro.core import faults as jfaults
    from repro.core import routing as jrouting

    assert jax.device_count() == 4, jax.devices()
    mesh = jax.sharding.Mesh(np.array(jax.devices()), ("mem",))
    in_path = Path(out_path).with_suffix(".inputs.npz")
    write_inputs(4, in_path)
    d = dict(np.load(in_path))
    iters = {}

    def case(kind):
        if kind not in iters:  # one iterator a kind: its compiled supersteps are reused
            iters[kind] = _jax_inputs(kind, 4)[0]
        ar = jarena.make_arena(d[f"{kind}/data"], bounds=d[f"{kind}/bounds"],
                               perms=d[f"{kind}/perms"], heap=d[f"{kind}/heap"])
        return iters[kind], ar, jnp.asarray(d[f"{kind}/p0"]), jnp.asarray(d[f"{kind}/s0"])

    run = dict(mesh=mesh, compact=True, schedule="dispatched")
    out = {}
    for cid, kind, policy, dead in JAX_REP_CASES:
        it, ar, p0, s0 = case(kind)
        ctx = _context(jrouting, d[f"{kind}/data"], d[f"{kind}/bounds"], 4, policy, dead)
        rec, st = jrouting.distributed_execute(it, ar, p0, s0, max_iters=int(d[f"{kind}/max_iters"]),
                                               replication=ctx, **run)
        out[f"rep/{cid}/records"] = np.asarray(rec)
        out[f"rep/{cid}/stats"] = np.asarray(_stats_json(st))
    for cid, kind, plan in KILL_CASES:
        if cid in JAX_SKIP:
            continue
        it, ar, p0, s0 = case(kind)
        inj = jfaults.FaultInjector(jfaults.FaultPlan(**plan))
        # a write's killed call alone: the call after it compiles the write path again
        for call in range(1 if it.mutates else 2):
            try:
                got = jrouting.distributed_execute(it, ar, p0, s0,
                                                   max_iters=int(d[f"{kind}/max_iters"]),
                                                   fault_injector=inj, **run)
                out[f"kill/{cid}/{call}/records"] = np.asarray(got[0])
            except jfaults.ShardFailure as e:
                out[f"kill/{cid}/{call}/raised"] = np.asarray([e.shard, e.superstep])
    real = jrouting.time.sleep
    for cid, kind, shard, rep in DELAY_CASES:
        if cid in JAX_SKIP:
            continue
        it, ar, p0, s0 = case(kind)
        ctx = (None if rep is None else _context(jrouting, d[f"{kind}/data"],
                                                 d[f"{kind}/bounds"], 4, *rep))
        sleeps = []
        jrouting.time.sleep = sleeps.append  # counted, not slept
        try:
            jrouting.distributed_execute(
                it, ar, p0, s0, max_iters=int(d[f"{kind}/max_iters"]), replication=ctx,
                fault_injector=jfaults.FaultInjector(
                    jfaults.FaultPlan(delay_shard=shard, delay_s=DELAY_S)), **run)
        finally:
            jrouting.time.sleep = real
        out[f"delay/{cid}/count"] = np.asarray(len(sleeps))
    np.savez(out_path, **out)


# -------------------------------- fixtures -----------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worlds of 4 and 2 ranks and the JAX package's four-device run,
    started together as subprocesses; the emulated mesh's runs meanwhile."""
    if not HAS_JAX:
        pytest.skip("needs the JAX package")
    tmp = tmp_path_factory.mktemp("routing_pg_faults")
    jax_out = tmp / "jax.npz"
    procs = {"jax": subprocess.Popen(  # the longest: started first
        [sys.executable, str(Path(__file__)), "jax", str(jax_out)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    inputs = {}
    for P in (4, 2):
        inputs[P] = tmp / f"inputs{P}.npz"
        write_inputs(P, inputs[P])
    for P in (4, 2):
        out = tmp / f"world{P}"
        out.mkdir()
        procs[P] = subprocess.Popen(
            [sys.executable, str(Path(__file__)), "world", str(P), str(inputs[P]), str(out)],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    loaded = {P: dict(np.load(inputs[P])) for P in (4, 2)}
    emulated = {P: run_all(loaded[P], trouting.EmulatedMesh(P, CPU)) for P in (4, 2)}
    for key, proc in procs.items():
        try:
            log, _ = proc.communicate(timeout=WORLD_TIMEOUT + 60)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        assert proc.returncode == 0, f"{key}:\n{log}"
    return dict(inputs=loaded, emulated=emulated, jax=dict(np.load(jax_out)),
                ranks={P: [dict(np.load(tmp / f"world{P}" / f"rank{r}.npz")) for r in range(P)]
                       for P in (4, 2)})


def _equal(want, got, key):
    if want[key].dtype.kind == "U":
        assert json.loads(str(got[key])) == json.loads(str(want[key])), key
    else:
        np.testing.assert_array_equal(want[key], got[key], err_msg=key)


# --------------------------- the process group --------------------------------


@needs_jax
@pytest.mark.parametrize("P,case", [(4, c) for c in REP_CASES] + [(2, c) for c in REP_CASES_2],
                         ids=[f"P4-{c[0]}" for c in REP_CASES] + [f"P2-{c[0]}" for c in REP_CASES_2])
def test_replicated_reads_every_rank_equals_the_emulated_mesh(P, case, runs):
    """Records and every ``RoutingStats`` field: every rank equals
    ``EmulatedMesh(P)``, and every read finds what the healthy run finds."""
    cid = case[0]
    for rank in runs["ranks"][P]:
        for f in ("records", "stats"):
            _equal(runs["emulated"][P], rank, f"rep/{cid}/{f}")
    rec = runs["ranks"][P][0][f"rep/{cid}/records"]
    assert (rec[:, trouting.F_STATUS] == STATUS_DONE).all()


@needs_jax
@pytest.mark.parametrize("case", JAX_REP_CASES, ids=[c[0] for c in JAX_REP_CASES])
def test_replicated_reads_equal_jax_on_four_devices(case, runs):
    cid = case[0]
    for f in ("records", "stats"):
        _equal(runs["jax"], runs["ranks"][4][0], f"rep/{cid}/{f}")


@needs_jax
@pytest.mark.parametrize("case", KILL_CASES, ids=[c[0] for c in KILL_CASES])
def test_a_kill_fires_on_every_rank(case, runs):
    """Every rank raises the same ``ShardFailure`` before the same
    superstep of the same call, as the emulated mesh and the JAX package
    do; the other call's records are theirs; a write's caller keeps the
    pre-call arena."""
    cid, _, plan = case
    raised = 0
    emulated = runs["emulated"][4]
    for call in range(2):
        for key in (f"kill/{cid}/{call}/raised", f"kill/{cid}/{call}/records"):
            if key in emulated:
                raised += key.endswith("raised")
                for rank in runs["ranks"][4]:
                    _equal(emulated, rank, key)
                    if key in runs["jax"]:
                        _equal(runs["jax"], rank, key)
    assert raised == 1
    killed = f"kill/{cid}/{plan.get('kill_call', 0)}/raised"
    assert runs["ranks"][4][0][killed].tolist() == [plan["kill_shard"], plan["kill_superstep"]]
    if cid not in JAX_SKIP:
        assert killed in runs["jax"]
    for rank in runs["ranks"][4]:
        assert bool(rank[f"kill/{cid}/unchanged"])


@needs_jax
@pytest.mark.parametrize("case", DELAY_CASES, ids=[c[0] for c in DELAY_CASES])
def test_the_straggler_sleeps_on_its_rank_alone(case, runs):
    """Rank ``delay_shard`` sleeps before exactly the supersteps in which
    the emulated mesh's straggler sleeps, as many times as the JAX
    package's; no other rank sleeps; the records are the emulated mesh's."""
    cid, _, shard, rep = case
    want = runs["emulated"][4][f"delay/{cid}/sleeps"]
    if cid not in JAX_SKIP:
        assert len(want) == int(runs["jax"][f"delay/{cid}/count"])
    for r, rank in enumerate(runs["ranks"][4]):
        got = rank[f"delay/{cid}/sleeps"]
        np.testing.assert_array_equal(got, want if r == shard else [], err_msg=f"rank {r}")
        _equal(runs["emulated"][4], rank, f"delay/{cid}/records")
    steps = int(runs["emulated"][4][f"delay/{cid}/supersteps"])
    if rep is not None and shard in rep[1]:
        assert len(want) == 0  # dead, its replica serves its reads
    else:
        assert 0 < len(want) <= steps


@needs_jax
@pytest.mark.parametrize("what", ["replication", "kill"])
def test_engine_passes_replication_and_faults_through(what, runs):
    for rank in runs["ranks"][4]:
        if what == "replication":
            for f in ("ptr", "scratch", "status", "iters", "stats"):
                _equal(runs["emulated"][4], rank, f"engine/rep/{f}")
        else:
            assert rank["engine/kill"].tolist() == [2, 2]
            assert bool(rank["engine/kill_kept_arena"])


# --------------------- the replica window with a shard offset -------------------

# (id, policy, dead shards): a dead primary, a dead holder (shard 3 holds 1's rows)
WINDOW_VARIANTS = [("failover-dead1", "failover", (1,)), ("failover-dead0-holder", "failover", (0, 2)),
                   ("spread", "spread", ()), ("spread-dead2", "spread", (2,)),
                   ("spread-dead-holder3", "spread", (3,)), ("primary", "primary", ())]


def _window_inputs(policy, dead, device=CPU):
    ar, it, pools = _mid_run_pools()
    ctx = _context(trouting, ar.data.numpy(), ar.bounds.numpy(), 4, policy, dead)
    plan = ctx.plan
    rep = (torch.from_numpy(ctx.rep_rows).to(device),
           torch.tensor(plan.primary_map, dtype=torch.int32, device=device),
           torch.from_numpy(ctx.dead_mask).to(device), policy)
    return ar, it, pools, rep


@pytest.mark.parametrize("k_local", [1, 4])
@pytest.mark.parametrize("variant", WINDOW_VARIANTS, ids=[v[0] for v in WINDOW_VARIANTS])
def test_plain_superstep_takes_the_replica_window_with_an_offset(variant, k_local):
    """Each shard's pool over its own rows and its holder slice of the
    replica rows (``shard0``, ``row0``) equals that shard's part of the
    all-shards call with the replica rows in the arena's layout, through
    the plain version and the wrapper's CPU route."""
    _, policy, dead = variant
    ar, it, pools, rep = _window_inputs(policy, dead)
    logic = chase_ops.iterator_logic(it)
    run = dict(logic_fn=logic, k_local=k_local, max_iters=1024, rep=rep)
    whole = chase_ops.pulse_chase_superstep(ar.data, pools, ar.bounds, ar.perms, **run)
    edges = ar.bounds.tolist()
    assert not torch.equal(whole, pools)
    for s in range(4):
        lo, hi = edges[s], edges[s + 1]
        mine = (rep[0][lo:hi].clone(), *rep[1:])
        kw = dict(run, rep=mine, shard0=s, row0=lo)
        got = chase_ops.pulse_chase_superstep(ar.data[lo:hi].clone(), pools[s:s + 1],
                                              ar.bounds, ar.perms, **kw)
        assert torch.equal(got[0], whole[s]), s
        plain = chase_ref.chase_superstep_reference(
            ar.data[lo:hi].clone(), pools[s:s + 1], ar.bounds, ar.perms, logic, k_local,
            scratch_words=it.scratch_words, max_iters=1024, rep=mine, shard0=s, row0=lo)
        assert torch.equal(plain, got), s


@pytest.mark.parametrize("variant", WINDOW_VARIANTS[:3], ids=[v[0] for v in WINDOW_VARIANTS[:3]])
def test_reference_backend_reads_the_holder_slice(variant):
    """``_local_superstep``'s plain chase (``step_batch`` per shard) over one
    shard's rows and holder slice equals its part of the all-shards call."""
    _, policy, dead = variant
    ar, it, pools, rep = _window_inputs(policy, dead)
    run = dict(k_local=2, max_iters=1024, backend="reference")
    whole = trouting._local_superstep(it, pools, ar.data, ar.bounds, ar.perms, rep=rep, **run)
    edges = ar.bounds.tolist()
    for s in range(4):
        lo, hi = edges[s], edges[s + 1]
        got = trouting._local_superstep(it, pools[s:s + 1], ar.data[lo:hi], ar.bounds, ar.perms,
                                        rep=(rep[0][lo:hi], *rep[1:]), shard0=s, row0=lo, **run)
        assert torch.equal(got[0], whole[s]), s


# ---------------------------------- the card ----------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("k_local", [1, 4])
@pytest.mark.parametrize("variant", WINDOW_VARIANTS, ids=[v[0] for v in WINDOW_VARIANTS])
def test_superstep_kernel_takes_the_replica_window_with_an_offset_on_card(variant, k_local):
    """The kernel's offset launch with a holder slice equals the plain
    version and its part of the all-shards windowed launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with pytest -m gpu")
    _, policy, dead = variant
    ar, it, pools, rep = _window_inputs(policy, dead)
    dev = "cuda"
    crep = (rep[0].to(dev), rep[1].to(dev), rep[2].to(dev), policy)
    data, bounds, perms, cpools = (t.to(dev) for t in (ar.data, ar.bounds, ar.perms, pools))
    logic = chase_ops.iterator_logic(it)
    run = dict(logic_fn=logic, k_local=k_local, max_iters=1024)
    whole = chase_ops.pulse_chase_superstep(data, cpools, bounds, perms, rep=crep, **run)
    edges = ar.bounds.tolist()
    for s in range(4):
        lo, hi = edges[s], edges[s + 1]
        mine = (crep[0][lo:hi].contiguous(), *crep[1:])
        got = chase_ops.pulse_chase_superstep(data[lo:hi].contiguous(),
                                              cpools[s:s + 1].contiguous(), bounds, perms,
                                              rep=mine, shard0=s, row0=lo, **run)
        plain = chase_ref.chase_superstep_reference(
            ar.data[lo:hi].clone(), pools[s:s + 1], ar.bounds, ar.perms, logic, k_local,
            scratch_words=it.scratch_words, max_iters=1024,
            rep=(rep[0][lo:hi].clone(), *rep[1:]), shard0=s, row0=lo)
        assert torch.equal(got.cpu(), plain), s
        assert torch.equal(got[0], whole[s]), s


if __name__ == "__main__":
    if sys.argv[1] == "world":
        world.spawn(_world_rank, int(sys.argv[2]), (sys.argv[3], sys.argv[4]),
                    timeout=WORLD_TIMEOUT)
    else:
        _jax_script(sys.argv[2])
