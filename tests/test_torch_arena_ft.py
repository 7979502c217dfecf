"""Port parity: fault-tolerant arenas (item 8), ``repro_torch.distributed.
arena_ft`` against the JAX package's.

  * the durability cases of ``tests/test_fault_tolerance.py``: snapshot
    round trip, log replay bit-identical, a crash mid-save, a torn tail,
    corruption mid-file, a replay that diverges from the log;
  * the compaction cases of ``tests/test_elastic.py``: a snapshot compacts
    the log, the seq survives a reopen, a crash mid-truncate, a truncate
    below the watermark;
  * across the packages: the same write quanta give the same log lines,
    and a snapshot directory and log written by the JAX ``ArenaStore``
    recover in the port to the JAX recovery's arena, and the other way
    round (the same iterator names registered in both);
  * ``ReplicaSet``: ``apply_quantum``, ``verify`` and ``rep_rows`` against
    the JAX one, and the standby's shadow unchanged by writes to the
    primary (tensors are mutable; the shadow is the standby's own copy).

Recovery and the standby replay through the sequential commit, or over a
mesh through ``distributed_execute`` (the service's choice on a mesh);
both are held to the JAX package's sequential replay.

One heap, built with the port's builder, goes into both packages.
"""

import json

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from repro.core import arena as jarena
    from repro.core import commit as jcommit
    from repro.core import routing as jrouting
    from repro.core.structures import linked_list as jlist
    from repro.distributed import arena_ft as jft
except ImportError:
    jnp = None
from repro_torch.core import commit as tcommit
from repro_torch.core import routing as trouting
from repro_torch.core.arena import H_COMMITS, H_EPOCH, ArenaBuilder, arena_from_numpy
from repro_torch.core.engine import PulseEngine
from repro_torch.core.structures import linked_list as tlist
from repro_torch.distributed import arena_ft as tft
from repro_torch.distributed.arena_ft import (
    ArenaStore,
    CommitLog,
    RecoveryError,
    ReplicaSet,
    ReplicationError,
)

needs_jax = pytest.mark.skipif(jnp is None, reason="needs the JAX package")
CPU = "cpu"
P = 4
KEYS = np.arange(100, 108, dtype=np.int32)
FIELDS = ("data", "bounds", "perms", "heap")


def _build():
    b = ArenaBuilder(256, 4, num_shards=P, policy="interleaved")
    head = tlist.build_into(b, KEYS, KEYS * 2)
    return b.finish(device=CPU), head


def _np(arena, field):
    x = getattr(arena, field)
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_arenas(a, b, tag=""):
    for f in FIELDS:
        np.testing.assert_array_equal(_np(a, f), _np(b, f), err_msg=f"{tag}: {f}")


def _to_jax(arena):
    return jarena.make_arena(_np(arena, "data"), bounds=_np(arena, "bounds"),
                             perms=_np(arena, "perms"), heap=_np(arena, "heap"))


def _quantum(pkg, it, keys, head):
    """``(ptr0, scratch0)`` of an insert batch in ``pkg``'s types."""
    keys = np.asarray(keys, np.int32)
    if pkg == "jax":
        return it.init(jnp.asarray(keys), jnp.asarray(keys * 2), head)
    return it.init(torch.from_numpy(keys), torch.from_numpy(keys * 2), head)


def _log_writes(store, arena, head, n_quanta=3, base=900):
    """``n_quanta`` insert quanta through the port's sequential commit,
    each logged; returns the final arena and the commits."""
    it = tlist.insert_iterator()
    store.register_iterator("list_ins", it)
    store.ensure_baseline(arena)
    commits = 0
    for q in range(n_quanta):
        p0, s0 = _quantum("torch", it, np.arange(2, dtype=np.int32) + base + 10 * q, head)
        _, st, arena = tcommit.sequential_commit_execute(it, arena, p0, s0, max_iters=4096)
        store.log_quantum("list_ins", p0, s0, max_iters=4096, k_local=4, compact=True,
                          commits=st.commits, epochs=st.epochs)
        commits += st.commits
    return arena, commits


# ----------------------------- snapshot layer --------------------------------


def test_snapshot_roundtrip(tmp_path):
    arena, head = _build()
    store = ArenaStore(tmp_path)
    assert store.snapshot(arena, log_seq=0) == 0
    snap = store.load_snapshot(device=CPU)
    assert snap.log_seq == 0 and snap.epoch == int(_np(arena, "heap")[:, H_EPOCH].sum())
    _assert_arenas(snap.arena, arena)
    assert snap.arena.data.dtype == torch.int32 and snap.arena.data.device.type == CPU
    it = tlist.insert_iterator()
    p0, s0 = _quantum("torch", it, np.arange(4) + 900, head)
    _, _, ar2 = tcommit.sequential_commit_execute(it, arena, p0, s0, max_iters=4096)
    store.snapshot(ar2, log_seq=5)
    snap2 = store.load_snapshot(device=CPU)
    assert snap2.log_seq == 5
    _assert_arenas(snap2.arena, ar2)
    assert store.load_snapshot(step=0, device=CPU).log_seq == 0  # until gc'd
    assert store.snapshots_taken == 2
    store.close()


def _mesh(on_mesh):
    return trouting.EmulatedMesh(P, CPU) if on_mesh else None


@pytest.mark.parametrize("on_mesh", [False, True], ids=["sequential", "mesh"])
def test_log_replay_recovery_bit_identical(tmp_path, on_mesh):
    """The log written by the sequential commit replays to the same arena
    through either executor: the sequential commit, or
    ``distributed_execute`` over the mesh (pulse_commit's plain version
    here), with the same commit and epoch deltas."""
    arena, head = _build()
    store = ArenaStore(tmp_path)
    cur, commits = _log_writes(store, arena, head)
    rec, info = store.recover(device=CPU, mesh=_mesh(on_mesh))
    assert info.replayed_quanta == 3 and info.replayed_commits == commits > 0
    assert info.snapshot_seq == 0 and info.log_seq == 3 and info.wall_s > 0
    _assert_arenas(rec, cur)
    store.close()


def test_recover_refuses_a_mesh_of_another_width(tmp_path):
    arena, head = _build()
    store = ArenaStore(tmp_path)
    _log_writes(store, arena, head, n_quanta=1)
    with pytest.raises(RecoveryError, match="has 4 shards, the mesh 2"):
        store.recover(device=CPU, mesh=trouting.EmulatedMesh(2, CPU))
    store.close()


def test_crash_mid_save_leaves_prior_snapshot_live(tmp_path):
    arena, head = _build()
    store = ArenaStore(tmp_path)
    cur, _ = _log_writes(store, arena, head, n_quanta=1, base=700)
    # a crash mid-snapshot: the data file written, manifest and LATEST not
    partial = tmp_path / f"step_{store.log.seq:08d}"
    partial.mkdir()
    np.savez(partial / f"shard_{store.mgr.host_id}.npz", garbage=np.zeros(3))
    assert store.mgr.latest_step() == 0
    assert store.load_snapshot(device=CPU).log_seq == 0
    rec, info = store.recover(device=CPU)
    assert info.replayed_quanta == 1
    _assert_arenas(rec, cur)
    store.close()


# ------------------------------ commit log -----------------------------------


def test_commit_log_torn_tail_tolerated(tmp_path):
    path = tmp_path / "log.jsonl"
    log = CommitLog(path)
    assert log.append({"a": 1}) == 1 and log.append({"a": 2}) == 2
    log.close()
    with open(path, "a", encoding="utf-8") as f:
        f.write('{"seq": 3, "a":')  # a crash mid-append: torn, no newline
    log2 = CommitLog(path)
    assert [e["seq"] for e in log2.entries()] == [1, 2] and log2.seq == 2
    assert log2.append({"a": 3}) == 3
    log2.close()


def test_commit_log_mid_file_corruption_raises(tmp_path):
    path = tmp_path / "log.jsonl"
    path.write_text('{"seq": 1}\nGARBAGE\n{"seq": 3}\n', encoding="utf-8")
    with pytest.raises(RecoveryError, match="corrupt commit log"):
        CommitLog(path)


def test_recovery_detects_log_replay_divergence(tmp_path):
    arena, head = _build()
    store = ArenaStore(tmp_path)
    _log_writes(store, arena, head, n_quanta=1, base=600)
    store.close()
    log_path = tmp_path / "commit_log.jsonl"
    entries = [json.loads(ln) for ln in log_path.read_text().splitlines()]
    entries[-1]["commits"] += 1
    log_path.write_text("".join(json.dumps(e) + "\n" for e in entries))
    store2 = ArenaStore(tmp_path)
    store2.register_iterator("list_ins", tlist.insert_iterator())
    with pytest.raises(RecoveryError, match="replay diverged"):
        store2.recover(device=CPU)
    store2.close()


def test_registration_and_log_refusals(tmp_path):
    arena, _ = _build()
    store = ArenaStore(tmp_path)
    it = tlist.insert_iterator()
    store.register_iterator("ins", it)
    store.register_iterator("ins", it)  # the same iterator again is fine
    with pytest.raises(ValueError, match="already registered"):
        store.register_iterator("ins", tlist.insert_iterator())
    with pytest.raises(ValueError, match="unregistered"):
        store.log_quantum("nope", [1], [[0]], max_iters=1, k_local=4, compact=True,
                          commits=0, epochs=0)
    with pytest.raises(RecoveryError, match="no arena snapshot"):
        store.load_snapshot(device=CPU)
    store.ensure_baseline(arena)
    store.log.append({"it": "other", "ptr0": [0], "scratch0": [[0]], "max_iters": 1,
                      "k_local": 4, "compact": True, "commits": 0, "epochs": 0})
    with pytest.raises(RecoveryError, match="unregistered iterator"):
        store.recover(device=CPU)
    store.close()


# --------------------------- commit-log compaction ---------------------------


def test_snapshot_compacts_log_and_seq_survives(tmp_path):
    arena, head = _build()
    store = ArenaStore(tmp_path)
    cur, _ = _log_writes(store, arena, head)
    assert len(store.log.quanta()) == 3 and store.log.seq == 3
    store.snapshot(cur)
    assert store.log.quanta() == []
    assert store.log.entries() == [{"seq": 3, "kind": "truncated"}]
    assert store.log.seq == 3
    rec, info = store.recover(device=CPU)
    assert info.replayed_quanta == 0
    _assert_arenas(rec, cur)
    store.close()
    store2 = ArenaStore(tmp_path)
    assert store2.log.seq == 3
    assert store2.log.append({"kind": "noop"}) == 4  # no folded seq reused
    store2.close()


def test_crash_mid_truncate_keeps_old_log(tmp_path):
    arena, head = _build()
    store = ArenaStore(tmp_path)
    cur, _ = _log_writes(store, arena, head)
    log_path = store.log.path
    # truncate_through died before os.replace: the survivor file exists
    tmp = log_path.with_name(log_path.name + ".tmp")
    tmp.write_text('{"seq": 3, "kind": "truncated"}\n')
    store.close()
    reopened = CommitLog(log_path)
    assert len(reopened.quanta()) == 3 and reopened.seq == 3
    reopened.close()
    store2 = ArenaStore(tmp_path)
    store2.register_iterator("list_ins", tlist.insert_iterator())
    rec, info = store2.recover(device=CPU)
    assert info.replayed_quanta == 3
    _assert_arenas(rec, cur)
    store2.snapshot(rec)
    assert store2.log.quanta() == [] and store2.log.seq == 3
    store2.close()


def test_truncate_noop_below_watermark(tmp_path):
    arena, head = _build()
    store = ArenaStore(tmp_path)
    _log_writes(store, arena, head)
    assert store.log.truncate_through(0) == 0
    assert len(store.log.quanta()) == 3
    assert store.log.truncate_through(2) == 2
    assert [e["seq"] for e in store.log.quanta()] == [3] and store.log.seq == 3
    store.close()


# ---------------------------- across the packages -----------------------------


def _write_history(pkg, tmp, arena, head, *, snapshot_after=None):
    """Three insert quanta through ``pkg``'s sequential commit into
    ``pkg``'s store, a snapshot after quantum ``snapshot_after``; returns
    the store (open) and the final arena."""
    mod, com, lst = (jft, jcommit, jlist) if pkg == "jax" else (tft, tcommit, tlist)
    store = mod.ArenaStore(tmp)
    it = lst.insert_iterator()
    store.register_iterator("list_ins", it)
    cur = _to_jax(arena) if pkg == "jax" else arena
    store.ensure_baseline(cur)
    for q in range(3):
        p0, s0 = _quantum(pkg, it, np.arange(3, dtype=np.int32) + 800 + 10 * q, head)
        _, st, cur = com.sequential_commit_execute(it, cur, p0, s0, max_iters=4096)
        seq = store.log_quantum("list_ins", p0, s0, max_iters=4096, k_local=4, compact=True,
                                commits=st.commits, epochs=st.epochs)
        if q == snapshot_after:
            store.snapshot(cur, seq)
    return store, cur


@needs_jax
def test_same_quanta_log_the_same_lines(tmp_path):
    arena, head = _build()
    js, _ = _write_history("jax", tmp_path / "j", arena, head)
    ts, _ = _write_history("torch", tmp_path / "t", arena, head)
    js.close()
    ts.close()
    assert (tmp_path / "j" / "commit_log.jsonl").read_text() == \
        (tmp_path / "t" / "commit_log.jsonl").read_text()
    for name in ("manifest.json",):
        assert (tmp_path / "j" / "step_00000000" / name).read_text() == \
            (tmp_path / "t" / "step_00000000" / name).read_text()


@needs_jax
@pytest.mark.parametrize("on_mesh", [False, True], ids=["sequential", "mesh"])
@pytest.mark.parametrize("snapshot_after", [None, 1])
def test_jax_store_recovers_in_port(tmp_path, snapshot_after, on_mesh):
    arena, head = _build()
    js, jcur = _write_history("jax", tmp_path, arena, head, snapshot_after=snapshot_after)
    jrec, jinfo = js.recover()
    js.close()
    ts = ArenaStore(tmp_path)
    ts.register_iterator("list_ins", tlist.insert_iterator())
    trec, tinfo = ts.recover(device=CPU, mesh=_mesh(on_mesh))
    ts.close()
    _assert_arenas(trec, jrec, "port vs JAX recovery")
    _assert_arenas(trec, jcur, "port recovery vs JAX resident")
    for f in ("snapshot_seq", "log_seq", "replayed_quanta", "replayed_commits"):
        assert getattr(tinfo, f) == getattr(jinfo, f), f
    assert tinfo.replayed_quanta == (3 if snapshot_after is None else 1)


@needs_jax
@pytest.mark.parametrize("snapshot_after", [None, 0])
def test_port_store_recovers_in_jax(tmp_path, snapshot_after):
    arena, head = _build()
    ts, tcur = _write_history("torch", tmp_path, arena, head, snapshot_after=snapshot_after)
    trec, tinfo = ts.recover(device=CPU)
    ts.close()
    js = jft.ArenaStore(tmp_path)
    js.register_iterator("list_ins", jlist.insert_iterator())
    jrec, jinfo = js.recover()
    js.close()
    _assert_arenas(trec, jrec, "JAX vs port recovery")
    _assert_arenas(jrec, tcur, "JAX recovery vs port resident")
    assert (jinfo.replayed_quanta, jinfo.replayed_commits) == (tinfo.replayed_quanta,
                                                               tinfo.replayed_commits)


# ------------------------------ replication ----------------------------------


def _rep_history(pkg, arena, head, primaries=None, on_mesh=False):
    """A ReplicaSet of ``pkg`` fed two insert quanta (the port's over the
    mesh when ``on_mesh``); returns (set, final primary arena, rep_rows
    after each quantum)."""
    mod, com, lst, rt = (jft, jcommit, jlist, jrouting) if pkg == "jax" else (
        tft, tcommit, tlist, trouting)
    plan = rt.make_replica_plan(P, primaries, policy="failover")
    cur = _to_jax(arena) if pkg == "jax" else arena
    rs = mod.ReplicaSet(plan, cur) if pkg == "jax" else mod.ReplicaSet(plan, cur,
                                                                      mesh=_mesh(on_mesh))
    it = lst.insert_iterator()
    rows = [np.asarray(rs.rep_rows().cpu() if pkg == "torch" else rs.rep_rows())]
    for q in range(2):
        p0, s0 = _quantum(pkg, it, np.arange(3, dtype=np.int32) + 500 + 10 * q, head)
        _, _, cur = com.sequential_commit_execute(it, cur, p0, s0, max_iters=4096)
        rs.apply_quantum(it, p0, s0, max_iters=4096, k_local=4, compact=True)
        rs.verify(cur)
        rows.append(np.asarray(rs.rep_rows().cpu() if pkg == "torch" else rs.rep_rows()))
    return rs, cur, rows


@needs_jax
@pytest.mark.parametrize("on_mesh", [False, True], ids=["sequential", "mesh"])
@pytest.mark.parametrize("primaries", [None, (1,)])
def test_replica_set_matches_jax(primaries, on_mesh):
    arena, head = _build()
    trs, tcur, trows = _rep_history("torch", arena, head, primaries, on_mesh)
    jrs, jcur, jrows = _rep_history("jax", arena, head, primaries)
    for i, (a, b) in enumerate(zip(trows, jrows)):
        np.testing.assert_array_equal(a, b, err_msg=f"rep_rows after {i} quanta")
    _assert_arenas(trs.shadow, jrs.shadow, "shadow")
    _assert_arenas(tcur, jcur, "primary")
    assert trs.quanta_applied == jrs.quanta_applied == 2
    # a diverged primary fails verify in both
    bad = _np(tcur, "data").copy()
    p = trs.plan.replicated[0]
    bad[int(_np(tcur, "bounds")[p])] += 1
    diverged = arena_from_numpy(bad, _np(tcur, "bounds"), _np(tcur, "perms"),
                                _np(tcur, "heap"), device=CPU)
    with pytest.raises(ReplicationError, match=f"replica of shard {p}"):
        trs.verify(diverged)
    with pytest.raises(jft.ReplicationError):
        jrs.verify(_to_jax(diverged))


def test_shadow_unchanged_by_writes_to_the_primary():
    """The standby owns its tensors: an engine write on the primary, and an
    in-place store into the primary's tensors, leave the shadow and the
    replica rows as they were."""
    arena, head = _build()
    plan = trouting.make_replica_plan(P, policy="failover")
    rs = ReplicaSet(plan, arena)
    before = {f: _np(rs.shadow, f).copy() for f in FIELDS}
    rows = rs.rep_rows()
    rows_before = rows.clone()
    assert rs.rep_rows() is rows  # reused until the next shipped quantum
    eng = PulseEngine(arena)
    it = tlist.insert_iterator()
    p0, s0 = _quantum("torch", it, np.arange(3) + 950, head)
    res = eng.execute(it, p0, s0, max_iters=4096)
    assert int(_np(res.arena, "heap")[:, H_COMMITS].sum()) > 0
    arena.data[:] = -5
    arena.heap[:] = -5
    for f in FIELDS:
        np.testing.assert_array_equal(_np(rs.shadow, f), before[f], err_msg=f)
    assert torch.equal(rs.rep_rows(), rows_before)
    rs.apply_quantum(it, p0, s0, max_iters=4096, k_local=4, compact=True)
    assert rs.rep_rows() is not rows
    rs.verify(res.arena)
    fresh, _ = _build()
    rs.reset(fresh)
    assert rs.quanta_applied == 0 and rs.shadow.data is not fresh.data
    _assert_arenas(rs.shadow, fresh)


def test_rep_rows_refuses_a_range_too_small():
    b = ArenaBuilder(64, 4, num_shards=P, policy="interleaved")
    tlist.build_into(b, KEYS[:8], KEYS[:8])
    arena = b.finish(device=CPU)
    bounds = _np(arena, "bounds").copy()
    bounds[1] -= 4  # shard 0 smaller than its mirror, shard 1
    small = arena_from_numpy(_np(arena, "data"), bounds, _np(arena, "perms"),
                             _np(arena, "heap"), device=CPU)
    rs = ReplicaSet(trouting.make_replica_plan(P, (2,)), small)  # held by shard 0
    with pytest.raises(ReplicationError, match="cannot mirror"):
        rs.rep_rows()


# ---------------------------------- the card ------------------------------------


@pytest.mark.gpu
def test_mesh_replay_on_card_runs_pulse_commit(tmp_path):
    """On a mesh arena on the card, the standby and recovery replay each
    quantum through ``distributed_execute``, its commit phases on the
    ``pulse_commit`` kernel, to the sequential commit's arena."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with pytest -m gpu")
    from repro_torch.kernels.pulse_commit import ops as commit_ops

    arena, head = _build()
    store = ArenaStore(tmp_path)
    cur, _ = _log_writes(store, arena, head)
    card = arena_from_numpy(*(_np(arena, f) for f in FIELDS), device="cuda")
    mesh = trouting.EmulatedMesh(P, "cuda")
    rs = ReplicaSet(trouting.make_replica_plan(P, policy="failover"), card, mesh=mesh)
    it = store._iterators["list_ins"]
    n0 = commit_ops.pulse_commit.launches
    for e in store.log.quanta():
        rs.apply_quantum(it, np.asarray(e["ptr0"], np.int32),
                         np.asarray(e["scratch0"], np.int32).reshape(len(e["ptr0"]), -1),
                         max_iters=e["max_iters"], k_local=e["k_local"], compact=e["compact"])
    rec, info = store.recover(device="cuda", mesh=mesh)
    assert commit_ops.pulse_commit.launches > n0
    assert rec.data.is_cuda and info.replayed_quanta == 3
    _assert_arenas(rs.shadow, cur, "standby on the card")
    _assert_arenas(rec, cur, "recovery on the card")
    store.close()
