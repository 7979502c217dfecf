"""Port parity: memory nodes as processes (item 6(e)) -- ``distributed_execute``
and ``PulseEngine`` over a ``routing.ProcessGroupMesh``, each memory node a
rank of a ``torch.distributed`` Gloo process group on the CPU, and the two
kernels' shard offset (a launch over one rank's own pool and rows).

The same numpy inputs, made from a seed with the JAX package's builders,
go through three executors, and every int32 output must be bit-equal:

  * the port on a ``ProcessGroupMesh`` of 4 and of 2 ranks: this file run
    as a script (``python tests/test_torch_routing_pg.py world P IN.npz
    OUT_DIR``), which starts a world of P ranks (``distributed.world.spawn``,
    spawn start method, a loopback TCP store) and writes each rank's
    records, ``RoutingStats`` and, for writes, final ``data`` and ``heap``;
  * the port on ``EmulatedMesh(P, "cpu")`` in this process;
  * the JAX package's ``distributed_execute`` on a 4-device mesh
    (``jax.sharding.Mesh`` of host devices), in one subprocess: this file
    run as a script (``python tests/test_torch_routing_pg.py jax OUT.npz``)
    with four host devices in its environment alone.

The cases: ``hash_find`` (interleaved placement) and ``btree_find``
(sequential placement), on the dense and the ring fabric, compacted and
not, ``return_to_cpu``, the loss mask (``FaultPlan(drop_prob=0.4,
drop_seed=7)``), the kernel's plain version as the local chase, a write
batch of finds, inserts and deletes, and a B+tree update batch.  Every rank
must return the same results; the engine on the process group resolves
``"auto"`` to ``"dispatched"`` (a departure from the reference, whose
records it keeps); each refusal (the device-resident schedules) names its
entry of ROADMAP queue 1; a rank that raises ends its world within the
timeout.  Replication, kills, the straggler, the service and its live
reshard are ``tests/test_torch_routing_pg_faults.py``'s,
``tests/test_torch_service_pg.py``'s and ``tests/test_torch_reshard_pg.py``'s.

On the CPU the plain versions of both kernels take a shard offset: one
shard's pool over its own rows equals that shard's slice of the all-shards
call, bit for bit.  The tests marked ``gpu`` hold the kernels' offset mode
against the plain versions on the card."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import arena as tarena
from repro_torch.core import engine as tengine
from repro_torch.core import faults as tfaults
from repro_torch.core import routing as trouting
from repro_torch.core.structures import btree as tbtree
from repro_torch.core.structures import hash_table as thash
from repro_torch.distributed import world
from repro_torch.kernels.pulse_chase import ops as chase_ops
from repro_torch.kernels.pulse_chase import ref as chase_ref
from repro_torch.kernels.pulse_commit import ops as commit_ops
from repro_torch.kernels.pulse_commit import ref as commit_ref

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parents[0]
CPU = "cpu"
HAS_JAX = importlib.util.find_spec("jax") is not None
needs_jax = pytest.mark.skipif(not HAS_JAX, reason="needs the JAX package")
N_BUCKETS = 16  # tests/test_torch_routing.py's and test_torch_write_path.py's
WORLD_TIMEOUT = 90.0  # seconds a world may run
LOSS = dict(drop_prob=0.4, drop_seed=7)  # tests/helpers/ft_checks.py's plan

# the port's iterator of each input kind; a rank builds its own
ITERATORS = {
    "hash": lambda: thash.find_iterator(N_BUCKETS),
    "btree_seq": tbtree.find_iterator,
    "hash_mixed_rw": lambda: thash.rw_iterator(N_BUCKETS),
    "btree_update": tbtree.update_iterator,
}
# (case id, input kind, distributed_execute keywords; "loss" adds the plan)
CASES = [
    ("hash-dense-compact", "hash", dict(compact=True)),
    ("hash-dense-uncompacted", "hash", dict(compact=False)),
    ("hash-ring-compact", "hash", dict(compact=True, fabric="ring")),
    ("hash-dense-kernel", "hash", dict(compact=True, local_backend="kernel")),
    ("hash-return_to_cpu", "hash", dict(return_to_cpu=True)),
    ("hash-lossy-dense", "hash", dict(compact=True, loss=True)),
    ("hash-lossy-ring", "hash", dict(compact=True, fabric="ring", loss=True)),
    ("btree_seq-dense-compact", "btree_seq", dict(compact=True)),
    ("btree_seq-ring-uncompacted", "btree_seq", dict(compact=False, fabric="ring")),
    ("hash_rw-dense-compact", "hash_mixed_rw", dict(compact=True)),
    ("hash_rw-ring-uncompacted", "hash_mixed_rw", dict(compact=False, fabric="ring")),
    ("hash_rw-lossy-dense", "hash_mixed_rw", dict(compact=True, loss=True)),
    ("btree_update-dense-compact", "btree_update", dict(compact=True)),
]
WRITES = ("hash_mixed_rw", "btree_update")
ENGINE_CASES = ("hash", "hash_mixed_rw")  # PulseEngine.execute on the group, "auto"
REFUSALS = {  # refusal -> the item of ROADMAP queue 1 it names
    "fused": 1, "pipelined": 1, "fused_flag": 1, "engine_fused": 1}


# --------------------------------- inputs ------------------------------------


def _btree_sequential(P, seed=5, n=96, B=32):
    """``test_torch_routing._structure("btree", P)``'s keys and queries on a
    B+tree placed ``sequential`` (range partitioning)."""
    import jax.numpy as jnp

    from repro.core.structures import btree as jbtree

    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 10**6, n).astype(np.int32)
    keys = np.sort(rng.choice(np.arange(10**6), n, replace=False).astype(np.int32))
    q = np.concatenate([keys[: B // 2], rng.integers(10**6, 2 * 10**6, B // 2)])
    ar, root, _ = jbtree.build(keys, vals, num_shards=P, policy="sequential")
    it = jbtree.find_iterator()
    p0, s0 = it.init(jnp.asarray(q.astype(np.int32)), root)
    return it, ar, np.array(p0), np.array(s0), 64


def _jax_inputs(kind, P):
    """(JAX iterator, JAX arena, ptr0, scratch0 as numpy, max_iters) of one
    input kind at P shards, from the JAX package's builders."""
    sys.path.insert(0, str(TESTS))
    if kind == "hash":
        from test_torch_routing import _structure

        jit_, _, jar, p0, s0, max_iters = _structure("hash", P)
        return jit_, jar, p0, s0, max_iters
    if kind == "btree_seq":
        return _btree_sequential(P)
    from test_torch_routing_write import _phases

    jar, [(_, jit_, _, jargs, _, max_iters)] = _phases(kind, P)
    p0, s0 = jit_.init(*jargs)
    return jit_, jar, np.asarray(p0), np.asarray(s0), max_iters


def write_inputs(P, path):
    """Every input kind at P shards as numpy arrays, into ``path``."""
    arrays = {}
    for kind in ITERATORS:
        _, jar, p0, s0, max_iters = _jax_inputs(kind, P)
        for f in ("data", "bounds", "perms", "heap"):
            arrays[f"{kind}/{f}"] = np.asarray(getattr(jar, f))
        arrays[f"{kind}/p0"], arrays[f"{kind}/s0"] = p0, s0
        arrays[f"{kind}/max_iters"] = np.asarray(max_iters)
    np.savez(path, **arrays)


def _port_case(d, kind):
    ar = tarena.arena_from_numpy(*(d[f"{kind}/{f}"] for f in ("data", "bounds", "perms",
                                                              "heap")), device=CPU)
    return (ITERATORS[kind](), ar, torch.from_numpy(d[f"{kind}/p0"]),
            torch.from_numpy(d[f"{kind}/s0"]), int(d[f"{kind}/max_iters"]))


def _run_kw(kw, faults):
    kw = dict(kw)
    if kw.pop("loss", False):
        kw["fault_injector"] = faults.FaultInjector(faults.FaultPlan(**LOSS))
    return kw


def _stats_json(st):
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        out[f.name] = v.tolist() if isinstance(v, np.ndarray) else v
    out["total_wire_words"], out["ring_hops"] = st.total_wire_words, st.ring_hops
    return json.dumps(out)


def _outputs(cid, out):
    arrays = {f"{cid}/records": out[0].cpu().numpy(), f"{cid}/stats": np.asarray(
        _stats_json(out[1]))}
    if len(out) == 3:
        arrays[f"{cid}/data"] = out[2].data.cpu().numpy()
        arrays[f"{cid}/heap"] = out[2].heap.cpu().numpy()
    return arrays


def run_cases(d, mesh):
    """Every case through ``distributed_execute`` on ``mesh``: the arrays
    ``_outputs`` names."""
    arrays = {}
    for cid, kind, kw in CASES:
        it, ar, p0, s0, max_iters = _port_case(d, kind)
        out = trouting.distributed_execute(it, ar, p0, s0, mesh=mesh, max_iters=max_iters,
                                           **_run_kw(kw, tfaults))
        arrays.update(_outputs(cid, out))
    return arrays


# ------------------------------- the worlds ----------------------------------


def _refusals(d, mesh):
    """Every refusal on the process group: name -> its message."""
    it, ar, p0, s0, max_iters = _port_case(d, "hash")
    run = dict(mesh=mesh, max_iters=max_iters)
    calls = {
        "fused": lambda: trouting.distributed_execute(it, ar, p0, s0, schedule="fused", **run),
        "pipelined": lambda: trouting.distributed_execute(it, ar, p0, s0, schedule="pipelined",
                                                          **run),
        "fused_flag": lambda: trouting.distributed_execute(it, ar, p0, s0, fused=True, **run),
        "engine_fused": lambda: tengine.PulseEngine(ar, mesh=mesh).execute(
            it, p0, s0, max_iters=max_iters, schedule="fused"),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = "ran"
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def _world_rank(rank, world_size, in_path, out_dir):
    """One memory node: every case, the engine, and (rank 0 of the world of
    2) the refusals; its outputs to ``out_dir/rank{rank}.npz``."""
    d = dict(np.load(in_path))
    mesh = trouting.ProcessGroupMesh.from_env(device=CPU)  # the group is already joined
    assert mesh.rank == rank and mesh.num_shards == world_size
    arrays = run_cases(d, mesh)
    for kind in ENGINE_CASES:
        it, ar, p0, s0, max_iters = _port_case(d, kind)
        res = tengine.PulseEngine(ar, mesh=mesh).execute(it, p0, s0, max_iters=max_iters)
        for f in ("ptr", "scratch", "status", "iters"):
            arrays[f"engine/{kind}/{f}"] = getattr(res, f).numpy()
        arrays[f"engine/{kind}/stats"] = np.asarray(_stats_json(res.stats))
        if res.arena is not None:
            arrays[f"engine/{kind}/data"] = res.arena.data.numpy()
            arrays[f"engine/{kind}/heap"] = res.arena.heap.numpy()
    if world_size == 2:
        arrays["refusals"] = np.asarray(json.dumps(_refusals(d, mesh)))
    np.savez(Path(out_dir) / f"rank{rank}.npz", **arrays)


def _raising_rank(rank, world_size):
    """Rank 1 raises at once; rank 0 waits in a barrier for it."""
    if rank == 1:
        raise ValueError("rank 1 stops its world")
    dist.barrier()


def _world_script(P, in_path, out_dir):
    """Script mode: a world of P ranks over every case; with P = 2, then a
    world whose rank 1 raises, timed."""
    seconds = world.spawn(_world_rank, P, (in_path, out_dir), timeout=WORLD_TIMEOUT)
    report = dict(seconds=seconds)
    if P == 2:
        t0 = time.monotonic()
        try:
            world.spawn(_raising_rank, 2, timeout=WORLD_TIMEOUT)
            report["raised"] = None
        except RuntimeError as e:
            report["raised"] = str(e)
        report["raise_seconds"] = time.monotonic() - t0
    (Path(out_dir) / "report.json").write_text(json.dumps(report))


def _jax_script(out_path):
    """Script mode: every case through the JAX package's
    ``distributed_execute`` on four host devices; outputs to ``out_path``."""
    import jax
    import jax.numpy as jnp

    from repro.core import faults as jfaults
    from repro.core import routing as jrouting

    assert jax.device_count() == 4, jax.devices()
    mesh = jax.sharding.Mesh(np.array(jax.devices()), ("mem",))
    arrays, inputs = {}, {}
    for cid, kind, kw in CASES:
        if kind not in inputs:  # one iterator a kind: its compiled supersteps are reused
            inputs[kind] = _jax_inputs(kind, 4)
        jit_, jar, p0, s0, max_iters = inputs[kind]
        kw = {k: v for k, v in kw.items() if k != "local_backend"}
        out = jrouting.distributed_execute(
            jit_, jar, jnp.asarray(p0), jnp.asarray(s0), mesh=mesh, max_iters=max_iters,
            schedule="dispatched", **_run_kw(kw, jfaults))
        arrays[f"{cid}/records"] = np.asarray(out[0])
        arrays[f"{cid}/stats"] = np.asarray(_stats_json(out[1]))
        if len(out) == 3:
            arrays[f"{cid}/data"] = np.asarray(out[2].data)
            arrays[f"{cid}/heap"] = np.asarray(out[2].heap)
    np.savez(out_path, **arrays)


# -------------------------------- fixtures -----------------------------------


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worlds of 4 and 2 ranks and the JAX package's four-device run,
    started together as subprocesses and each waited for with a timeout;
    the emulated mesh's results meanwhile.  {"emulated": {P: arrays},
    "ranks": {P: [arrays of each rank]}, "report": {P: dict}, "jax":
    arrays}."""
    if not HAS_JAX:
        pytest.skip("needs the JAX package")
    tmp = tmp_path_factory.mktemp("routing_pg")
    jax_out = tmp / "jax.npz"
    procs = {"jax": subprocess.Popen(  # the longest: started first
        [sys.executable, str(Path(__file__)), "jax", str(jax_out)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    inputs = {}
    for P in (4, 2):
        inputs[P] = tmp / f"inputs{P}.npz"
        write_inputs(P, inputs[P])
        out = tmp / f"world{P}"
        out.mkdir()
        procs[P] = subprocess.Popen(
            [sys.executable, str(Path(__file__)), "world", str(P), str(inputs[P]), str(out)],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    emulated = {P: run_cases(dict(np.load(inputs[P])), trouting.EmulatedMesh(P, CPU))
                for P in (4, 2)}
    for key, proc in procs.items():
        try:
            log, _ = proc.communicate(timeout=WORLD_TIMEOUT + 60)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        assert proc.returncode == 0, f"{key}:\n{log}"
    return dict(
        emulated=emulated, inputs={P: dict(np.load(inputs[P])) for P in (4, 2)},
        ranks={P: [dict(np.load(tmp / f"world{P}" / f"rank{r}.npz")) for r in range(P)]
               for P in (4, 2)},
        report={P: json.loads((tmp / f"world{P}" / "report.json").read_text())
                for P in (4, 2)},
        jax=dict(np.load(jax_out)))


def _assert_case_equal(want, got, cid):
    np.testing.assert_array_equal(want[f"{cid}/records"], got[f"{cid}/records"])
    assert json.loads(str(got[f"{cid}/stats"])) == json.loads(str(want[f"{cid}/stats"]))
    for f in ("data", "heap"):
        if f"{cid}/{f}" in want:
            np.testing.assert_array_equal(want[f"{cid}/{f}"], got[f"{cid}/{f}"], err_msg=f)


# --------------------------- the process group --------------------------------


@needs_jax
@pytest.mark.parametrize("P", [4, 2])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_every_rank_equals_the_emulated_mesh(case, P, runs):
    """Records, every ``RoutingStats`` field (the per-superstep lists, wire
    words and ring hops included) and a write's final arena: every rank of
    the process group equals ``EmulatedMesh(P)``."""
    cid, kind, kw = case
    for rank in runs["ranks"][P]:
        _assert_case_equal(runs["emulated"][P], rank, cid)
    st = json.loads(str(runs["ranks"][P][0][f"{cid}/stats"]))
    assert st["schedule"] == "dispatched" and st["fabric"] == kw.get("fabric", "dense")
    if kw.get("compact") and P == 4 and kind == "hash":
        assert st["local_only_steps"] > 0 or st["supersteps"] > 1


@needs_jax
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_process_group_equals_jax_on_four_devices(case, runs):
    """The JAX package's ``distributed_execute`` on four devices, dispatched:
    records, every stat, a write's final data and heap, bit for bit."""
    cid = case[0]
    _assert_case_equal(runs["jax"], runs["ranks"][4][0], cid)


@needs_jax
@pytest.mark.parametrize("P", [4, 2])
@pytest.mark.parametrize("kind", ENGINE_CASES)
def test_engine_on_the_process_group(kind, P, runs):
    """``PulseEngine(arena, mesh=ProcessGroupMesh()).execute`` with
    ``schedule="auto"`` runs the dispatched schedule (the departure) and
    gives every rank the emulated mesh's dispatched results; a write swaps
    in the same committed arena."""
    it, ar, p0, s0, max_iters = _port_case(runs["inputs"][P], kind)
    want = tengine.PulseEngine(ar, mesh=trouting.EmulatedMesh(P, CPU)).execute(
        it, p0, s0, max_iters=max_iters, schedule="dispatched")
    for rank in runs["ranks"][P]:
        for f in ("ptr", "scratch", "status", "iters"):
            np.testing.assert_array_equal(getattr(want, f).numpy(), rank[f"engine/{kind}/{f}"])
        assert json.loads(str(rank[f"engine/{kind}/stats"])) == json.loads(
            _stats_json(want.stats))
        if want.arena is not None:
            np.testing.assert_array_equal(want.arena.data.numpy(), rank[f"engine/{kind}/data"])
            np.testing.assert_array_equal(want.arena.heap.numpy(), rank[f"engine/{kind}/heap"])
    assert want.stats.schedule == "dispatched"


@needs_jax
@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_name_their_entry(name, runs):
    """The fused and pipelined schedules on a process group raise
    ``NotImplementedError`` naming their entry of ROADMAP queue 1; none
    runs something else (replication, kills, the straggler, the service
    and its live reshard run: ``test_torch_routing_pg_faults.py``,
    ``test_torch_service_pg.py``, ``test_torch_reshard_pg.py``)."""
    msg = json.loads(str(runs["ranks"][2][0]["refusals"]))[name]
    assert f"ROADMAP queue 1, item {REFUSALS[name]}" in msg, msg


@needs_jax
def test_a_rank_that_raises_ends_its_world(runs):
    report = runs["report"][2]
    # whichever rank's error the launcher met first: rank 1's own, or rank
    # 0's, whose barrier lost its peer
    assert report["raised"] is not None
    assert report["raised"].startswith("a rank of the world of 2 raised")
    assert report["raise_seconds"] < WORLD_TIMEOUT
    assert max(r["seconds"] for r in runs["report"].values()) < WORLD_TIMEOUT


def test_a_world_that_outlives_its_timeout_is_killed(monkeypatch):
    """``spawn`` raises ``TimeoutError`` for a world still running at its
    timeout, after killing every rank (its processes are stand-ins here:
    nothing joins)."""
    class _Proc:
        alive = True

        def is_alive(self):
            return self.alive

        def kill(self):
            self.alive = False

        def join(self):
            pass

    procs = [_Proc(), _Proc()]

    class _Ctx:
        processes = procs

        def join(self, timeout):
            time.sleep(timeout)
            return False

    monkeypatch.setattr(world.mp, "start_processes", lambda *a, **k: _Ctx())
    with pytest.raises(TimeoutError, match="still running"):
        world.spawn(_raising_rank, 2, timeout=0.3)
    assert not any(p.alive for p in procs)


def test_a_process_group_mesh_needs_a_group():
    if dist.is_initialized():
        pytest.skip("this process already joined a process group")
    with pytest.raises(ValueError, match="init"):
        trouting.ProcessGroupMesh(device=CPU)


# ------------------------ the kernels' shard offset ---------------------------


def _mid_run_pools(P=4, advance=2, seed=3):
    """A hash table over P shards (interleaved), its batch placed and
    ``advance`` routed supersteps on: (arena, iterator, pools)."""
    g = np.random.default_rng(seed)
    keys = np.sort(g.choice(np.arange(10**6), 192, replace=False)).astype(np.int32)
    ar, heads = thash.build(keys, g.integers(0, 10**6, 192).astype(np.int32), N_BUCKETS,
                            num_shards=P, policy="interleaved", device=CPU)
    it = thash.find_iterator(N_BUCKETS)
    q = np.concatenate([keys[::3], g.integers(10**6, 2 * 10**6, 16)]).astype(np.int32)
    p0, s0 = it.init(torch.from_numpy(q), torch.as_tensor(heads))
    pools, _ = trouting.place_requests(p0, s0, P)
    step = trouting.make_superstep(it, P, k_local=2, max_iters=1024, drain_done=True)
    for _ in range(advance):
        pools = step(pools, ar.data, ar.bounds, ar.perms)[0]
    return ar, it, pools


@pytest.mark.parametrize("k_local", [1, 4])
def test_chase_superstep_plain_version_takes_one_shard(k_local):
    """Each shard's pool over its own rows (``shard0``, ``row0``) gives that
    shard's slice of the all-shards call, through the wrapper's CPU route
    and the plain version."""
    ar, it, pools = _mid_run_pools()
    logic = chase_ops.iterator_logic(it)
    run = dict(logic_fn=logic, k_local=k_local, max_iters=1024)
    whole = chase_ops.pulse_chase_superstep(ar.data, pools, ar.bounds, ar.perms, **run)
    assert not torch.equal(whole, pools)
    edges = ar.bounds.tolist()
    for s in range(ar.num_shards):
        mine = ar.data[edges[s]:edges[s + 1]].clone()
        got = chase_ops.pulse_chase_superstep(mine, pools[s:s + 1], ar.bounds, ar.perms,
                                              shard0=s, row0=edges[s], **run)
        assert torch.equal(got[0], whole[s]), s
        plain = chase_ref.chase_superstep_reference(
            mine, pools[s:s + 1], ar.bounds, ar.perms, logic, k_local,
            scratch_words=it.scratch_words, max_iters=1024, shard0=s, row0=edges[s])
        assert torch.equal(plain, got)


def _commit_pools(P, W, seed):
    sys.path.insert(0, str(TESTS))
    from test_torch_routing_write import _card_pools

    return _card_pools(P, W, seed)


def _commit_one_shard_vs_all(commit, data, heap, bounds, perms, pools, S):
    """The all-shards ``pulse_commit_staged`` and ``commit`` over each
    shard's pool, heap row and rows: (all-shards results, per-shard list)."""
    whole = [torch.from_numpy(x.copy()) for x in (pools, data, heap)]
    b, pm = torch.from_numpy(bounds), torch.from_numpy(perms)
    commit_ref.pulse_commit_staged(*whole, b, pm, scratch_words=S)
    per = []
    for s in range(pools.shape[0]):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        mine = [torch.from_numpy(x.copy()) for x in (pools[s:s + 1], data[lo:hi],
                                                     heap[s:s + 1])]
        commit(*mine, b, pm, scratch_words=S, shard0=s, row0=lo)
        per.append(mine)
    return whole, per


@pytest.mark.parametrize("W", [4, 20])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_commit_staged_plain_version_takes_one_shard(W, seed):
    """Each shard's commit phase over its own pool, heap row and rows
    equals its slice of the all-shards phase: pools, rows and heap row, bit
    for bit (stores and CASes racing on few rows, FREEs, ALLOCs popping a
    free list threaded through a twice-freed row, write-revoked shards,
    shards out of rows), through the wrapper's CPU route."""
    data, heap, bounds, perms, pools, S = _commit_pools(4, W, seed)
    whole, per = _commit_one_shard_vs_all(commit_ops.pulse_commit, data, heap, bounds, perms,
                                          pools, S)
    assert not torch.equal(whole[0], torch.from_numpy(pools))
    for s, (p, d, h) in enumerate(per):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        assert torch.equal(p[0], whole[0][s]), s
        assert torch.equal(d, whole[1][lo:hi]), s
        assert torch.equal(h[0], whole[2][s]), s


def test_commit_offset_key_orders_as_the_global_key():
    """``commit_key`` with an offset sorts each shard's records as the
    global key does."""
    data, heap, bounds, perms, pools, S = _commit_pools(4, 4, 5)
    t = torch.from_numpy(pools)
    b = torch.from_numpy(bounds)
    whole = commit_ref.commit_key(t, b, scratch_words=S, capacity=data.shape[0])
    for s in range(4):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        mine = commit_ref.commit_key(t[s:s + 1], b, scratch_words=S, capacity=hi - lo,
                                     shard0=s, row0=lo)
        assert torch.equal(torch.sort(mine[0], stable=True).indices,
                           torch.sort(whole[s], stable=True).indices)


# ---------------------------------- the card ----------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with pytest -m gpu")


@pytest.mark.gpu
@pytest.mark.parametrize("k_local", [1, 4])
def test_superstep_kernel_takes_one_shard_on_card(k_local):
    """The kernel's offset launch over one shard's pool and rows equals the
    plain version and the all-shards launch's slice."""
    _card()
    ar, it, pools = _mid_run_pools()
    dev = "cuda"
    data, bounds, perms, pools = (t.to(dev) for t in (ar.data, ar.bounds, ar.perms, pools))
    logic = chase_ops.iterator_logic(it)
    run = dict(logic_fn=logic, k_local=k_local, max_iters=1024)
    whole = chase_ops.pulse_chase_superstep(data, pools, bounds, perms, **run)
    edges = ar.bounds.tolist()
    for s in range(ar.num_shards):
        mine = data[edges[s]:edges[s + 1]].clone()
        got = chase_ops.pulse_chase_superstep(mine, pools[s:s + 1].contiguous(), bounds, perms,
                                              shard0=s, row0=edges[s], **run)
        plain = chase_ref.chase_superstep_reference(
            mine.cpu(), pools[s:s + 1].cpu(), ar.bounds, ar.perms, logic, k_local,
            scratch_words=it.scratch_words, max_iters=1024, shard0=s, row0=edges[s])
        assert torch.equal(got.cpu(), plain), s
        assert torch.equal(got[0], whole[s]), s


@pytest.mark.gpu
@pytest.mark.parametrize("W", [4, 20])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_commit_kernel_takes_one_shard_on_card(W, seed):
    """``pulse_commit``'s kernels over one shard's pool, heap row and rows
    equal the all-shards plain version's slice."""
    _card()
    data, heap, bounds, perms, pools, S = _commit_pools(4, W, seed)
    whole, _ = _commit_one_shard_vs_all(commit_ref.pulse_commit_staged, data, heap, bounds,
                                        perms, pools, S)
    b, pm = torch.from_numpy(bounds).cuda(), torch.from_numpy(perms).cuda()
    for s in range(4):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        mine = [torch.from_numpy(x.copy()).cuda() for x in (pools[s:s + 1], data[lo:hi],
                                                            heap[s:s + 1])]
        commit_ops.pulse_commit(*mine, b, pm, scratch_words=S, shard0=s, row0=lo)
        assert torch.equal(mine[0][0].cpu(), whole[0][s]), s
        assert torch.equal(mine[1].cpu(), whole[1][lo:hi]), s
        assert torch.equal(mine[2][0].cpu(), whole[2][s]), s


if __name__ == "__main__":
    if sys.argv[1] == "world":
        _world_script(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        _jax_script(sys.argv[2])
