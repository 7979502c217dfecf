"""Port parity: elastic arenas for traversal serving (item 7's part of item
8): ``arena.remap_shards``, ``distributed.sharding.VersionedOwnerMap``,
``distributed.elastic.ReshardPlanner``, ``PulseEngine.reshard`` and the
service's live reshard, against the JAX package.

  * ``remap_shards`` bit-equal to the JAX one (``data``, ``bounds``,
    ``perms``, ``heap``) on a grow with carved free chains, a shrink with
    a bump hole, a round trip, the register split, and the refusals
    (``tests/test_elastic.py:80-145``); traversals answer alike after it;
  * the owner map and the planner on the same sequences
    (``tests/test_elastic.py:148-206``);
  * the live 4 -> 8 reshard of ``tests/helpers/elastic_checks.py:227``
    (a BST with reads and in-place updates, the reshard requested at round
    3), sync and async, read-only and read-write: every request and metric
    count equal to the JAX service's on eight host devices (one subprocess:
    this file run as a script, started as the module starts), and equal to
    a cold run at eight shards on the remapped arena.

Run as a script (``python tests/test_torch_elastic.py OUT.npz`` with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``) it writes the JAX
package's outcomes to OUT.npz."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
try:
    import jax

    from repro.core import arena as jarena
    from repro.core.engine import PulseEngine as JEngine
    from repro.core.structures import bst as jbst
    from repro.distributed import elastic as jelastic
    from repro.distributed import sharding as jsharding
    from repro.serving import admission as jadm
    from repro.serving import traversal_service as jsvc
except ImportError:
    jax = None
from repro_torch.core import arena as tarena
from repro_torch.core import commit as tcommit
from repro_torch.core import routing as trouting
from repro_torch.core.engine import PulseEngine as TEngine
from repro_torch.core.structures import bst as tbst
from repro_torch.core.structures import linked_list as tlist
from repro_torch.distributed import elastic as telastic
from repro_torch.distributed import sharding as tsharding
from repro_torch.serving import admission as tadm
from repro_torch.serving import traversal_service as tsvc

from test_torch_traversal_service import assert_same, outcome  # noqa: E402

pytestmark = pytest.mark.skipif(jax is None, reason="needs the JAX package")
ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
KEYS = np.arange(100, 124, dtype=np.int32)
BST_KEYS = np.arange(100, 164, dtype=np.int32)


def _jax_arena(ar):
    data, bounds, perms, heap = (x.cpu().numpy() for x in (ar.data, ar.bounds, ar.perms, ar.heap))
    return jarena.make_arena(data, bounds=bounds, perms=perms, heap=heap)


def _fields(ar):
    return [np.asarray(getattr(ar, f).cpu() if isinstance(getattr(ar, f), torch.Tensor)
                       else getattr(ar, f)) for f in ("data", "bounds", "perms", "heap")]


def _assert_arenas_equal(j, t, tag=""):
    for f, a, b in zip(("data", "bounds", "perms", "heap"), _fields(j), _fields(t)):
        np.testing.assert_array_equal(a, b, err_msg=f"{tag}: {f}")


def _list_arena(P, policy="interleaved", deletes=()):
    """``test_elastic._build``'s list (24 keys in a 256-row heap), with
    ``deletes`` applied by the port's commit (bit-equal to the JAX one,
    ``tests/test_torch_write_path.py``) to carve free chains; the JAX arena
    and the port's."""
    b = tarena.ArenaBuilder(256, 4, num_shards=P, policy=policy)
    head = tlist.build_into(b, KEYS, KEYS * 2)
    tar = b.finish(device=CPU)
    if len(deletes):
        it = tlist.delete_iterator()
        p0, s0 = it.init(torch.from_numpy(np.asarray(deletes, np.int32)), head)
        _, _, tar = tcommit.sequential_commit_execute(it, tar, p0, s0, max_iters=4096)
    return _jax_arena(tar), tar, head


def _find(arena, head):
    it = tlist.find_iterator()
    p0, s0 = it.init(torch.from_numpy(KEYS), head)
    rec, _ = tcommit.sequential_commit_execute(it, arena, p0, s0, max_iters=4096)
    rec = np.asarray(rec)
    return rec[:, [trouting.F_ID, trouting.F_PTR, trouting.F_STATUS, trouting.F_ITERS]
               + list(range(trouting.F_SCRATCH, rec.shape[1]))]


# ------------------------------- remap_shards -----------------------------------

# deletes of non-adjacent keys: adjacent ones race on one link and retry
# for many supersteps
REMAPS = [  # (id, P, policy, deleted keys, target shard counts in turn)
    ("grow_free_chains", 4, "interleaved", KEYS[3:15:2], (8,)),
    ("grow_sequential", 4, "sequential", KEYS[2:18:2], (8,)),
    ("round_trip", 4, "interleaved", KEYS[2:18:2], (8, 4)),
    ("shrink_bump_hole", 8, "interleaved", KEYS[5:13:2], (4,)),
    ("shrink_twice", 8, "sequential", (), (4, 2)),
    ("grow_twice", 2, "interleaved", KEYS[1::3], (4, 8)),
]


@pytest.mark.parametrize("case", REMAPS, ids=[c[0] for c in REMAPS])
def test_remap_shards_matches_jax(case):
    _, P, policy, deletes, targets = case
    jar, tar, head = _list_arena(P, policy, deletes)
    want_find = _find(tar, head)
    for q in targets:
        jar, tar2 = jarena.remap_shards(jar, q), tarena.remap_shards(tar, q)
        _assert_arenas_equal(jar, tar2, f"-> {q}")
        assert tar2.num_shards == q and tar2.data.device == tar.data.device
        np.testing.assert_array_equal(_find(tar2, head), want_find)
        tar = tar2


def test_remap_round_trip_gives_the_arena_back():
    _, tar, _ = _list_arena(4, deletes=KEYS[2:18:2])
    back = tarena.remap_shards(tarena.remap_shards(tar, 8), 4)
    _assert_arenas_equal(tar, back)


def test_remap_splits_the_allocator_registers():
    jar, tar, _ = _list_arena(4)
    h_old, b_old = tar.heap.numpy(), tar.bounds.numpy()
    h_new = tarena.remap_shards(tar, 8).heap.numpy()
    for s in range(4):
        for w in (tarena.H_EPOCH, tarena.H_COMMITS):
            assert h_new[2 * s, w] == h_new[2 * s + 1, w] == h_old[s, w]
        mid = (int(b_old[s]) + int(b_old[s + 1])) // 2
        bump = int(h_old[s, tarena.H_BUMP])
        child = 2 * s if bump <= mid else 2 * s + 1
        assert int(h_new[child, tarena.H_BUMP]) == bump


def test_remap_refuses_what_jax_refuses():
    jar, tar, _ = _list_arena(4)
    assert tarena.remap_shards(tar, 4) is tar and jarena.remap_shards(jar, 4) is jar
    for bad in (3, 16, 0):
        for fn, ar in ((jarena.remap_shards, jar), (tarena.remap_shards, tar)):
            with pytest.raises(ValueError):
                fn(ar, bad)
    jp, tp = _list_arena(8)[:2]
    perms = tp.perms.clone()
    perms[1] = tarena.PERM_READ
    with pytest.raises(ValueError, match="permission"):
        tarena.remap_shards(tarena.Arena(tp.data, tp.bounds, perms, tp.heap), 4)
    with pytest.raises(ValueError, match="permission"):
        jarena.remap_shards(jarena.make_arena(np.asarray(jp.data), bounds=np.asarray(jp.bounds),
                                              perms=perms.numpy(), heap=np.asarray(jp.heap)), 4)


def test_engine_reshard_installs_the_arena_and_drops_the_schedules():
    _, tar, head = _list_arena(4)
    eng = TEngine(tar, mesh=trouting.EmulatedMesh(4, CPU, axis_name="mem"))
    it = tlist.find_iterator()
    p0, s0 = it.init(torch.from_numpy(KEYS), head)
    before = eng.execute(it, p0, s0, max_iters=4096)
    assert eng._schedule_cache
    grown = tarena.remap_shards(tar, 8)
    eng.reshard(grown, trouting.EmulatedMesh(8, CPU))
    assert eng.arena is grown and eng.mesh.num_shards == 8 and not eng._schedule_cache
    after = eng.execute(it, p0, s0, max_iters=4096)
    for f in ("ptr", "scratch", "status", "iters"):
        assert torch.equal(getattr(before, f), getattr(after, f)), f
    eng.reshard(tar)  # the mesh stays when none is given
    assert eng.arena is tar and eng.mesh.num_shards == 8


# ----------------------------- owner map, planner -------------------------------


def _owner_map_run(mod):
    m = mod.VersionedOwnerMap([0, 64, 128, 192, 256])
    out = [m.epoch, int(m.current.owner_of(70)), m.current.owner_of([-1, 0, 63, 255, 256,
                                                                     1000]).tolist()]
    ep = m.advance([0, 32, 64, 96, 128, 160, 192, 224, 256])
    out += [ep.epoch, m.epoch, ep.num_shards, ep.bounds]
    out += [m.forward_shard(s, from_epoch=0) for s in range(4)]
    out += [m.forward_shard(s, from_epoch=1, to_epoch=0) for s in range(8)]
    out.append(m.forward_mask([False, True, False, True], from_epoch=0).tolist())
    out.append(m.forward_mask([True] + [False] * 7, from_epoch=1, to_epoch=0).tolist())
    ep2 = m.advance([0, 64, 128, 192, 256])
    out += [ep2.epoch, m.forward_shard(5, from_epoch=1), m.at(1).bounds]
    for bad in (lambda: m.advance([0, 32, 64, 96, 120]), lambda: m.at(7),
                lambda: m.forward_shard(8, from_epoch=1),
                lambda: m.forward_mask([True], from_epoch=0)):
        try:
            bad()
            out.append("no error")
        except (ValueError, KeyError) as e:
            out.append(type(e).__name__)
    return out


def test_owner_map_matches_jax():
    assert _owner_map_run(jsharding) == _owner_map_run(tsharding)


def _planner_run(mod):
    pl = mod.ReshardPlanner()
    out = [pl.phase]

    def attempt(fn):
        try:
            fn()
            out.append("ok")
        except (ValueError, RuntimeError) as e:
            out.append(type(e).__name__)

    attempt(lambda: pl.request(6, current=4, rnd=0))
    attempt(lambda: pl.request(8, current=4, rnd=3))
    out += [pl.phase, pl.target]
    attempt(lambda: pl.request(16, current=8, rnd=4))
    attempt(lambda: pl.complete(rnd=4, old_shards=4, owner_epoch=1))
    out += [pl.should_cutover(in_flight=2), pl.should_cutover(in_flight=1),
            pl.should_cutover(in_flight=0), pl.phase, pl.should_cutover(in_flight=0)]
    ev = pl.complete(rnd=7, old_shards=4, owner_epoch=1)
    out += [pl.phase, pl.target, ev.requested_round, ev.cutover_round, ev.old_shards,
            ev.new_shards, ev.owner_epoch, ev.drain_rounds, len(pl.events)]
    attempt(lambda: pl.request(2, current=4, rnd=9))
    out += [pl.target, pl.phase]
    return out


def test_reshard_planner_matches_jax():
    assert _planner_run(jelastic) == _planner_run(telastic)


# ------------------------------- the live reshard --------------------------------

RESHARD_RUNS = [(p, w) for p in ("sync", "async") for w in (True, False)]


def bst_reqs(mod, n=40, writes=True):
    """``elastic_checks.bst_reqs``: reads, and every fourth request an
    alloc-free update (the committed state does not depend on the
    partition)."""
    reqs = []
    for i in range(n):
        if writes and i % 4 == 3:
            k = int(BST_KEYS[(i * 5) % len(BST_KEYS)])
            reqs.append(mod.TraversalRequest(i, "bst_upd", k, value=9000 + i, tenant="w",
                                             arrive_round=i // 6))
        else:
            reqs.append(mod.TraversalRequest(i, "bst", int(BST_KEYS[(i * 7) % len(BST_KEYS)]),
                                             tenant="r", arrive_round=i // 6))
    return reqs


def _bst4():
    b = tarena.ArenaBuilder(512, 4, num_shards=4, policy="interleaved")
    root, _ = tbst.build_into(b, BST_KEYS, BST_KEYS * 2)
    return b.finish(device=CPU), root


def serve_reshard(pkg, nshards, pipeline, *, reshard_at=None, writes=True):
    """``elastic_checks.serve_reshard``: the BST service at ``nshards``
    (the 4-shard build, or its remap at 8), the reshard to 8 requested at
    round ``reshard_at``.  Returns the outcome."""
    tar, root = _bst4()
    if nshards == 8:
        tar = tarena.remap_shards(tar, 8)
    if pkg == "jax":
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:nshards]), ("mem",))
        eng, svc_mod, adm, bst = JEngine(_jax_arena(tar), mesh=mesh), jsvc, jadm, jbst
    else:
        eng = TEngine(tar, mesh=trouting.EmulatedMesh(nshards, CPU))
        svc_mod, adm, bst = tsvc, tadm, tbst
    svc = svc_mod.PulseService(
        eng, {"bst": svc_mod.StructureSpec(bst.find_iterator(), (root,), group="bst"),
              "bst_upd": svc_mod.StructureSpec(bst.update_iterator(), (root,), group="bst",
                                               takes_value=True)},
        slots_per_structure=8, quantum=6, pipeline=pipeline)
    reqs = bst_reqs(adm, writes=writes)
    for r in reqs:
        svc.submit(r)
    try:
        while svc._busy():
            if reshard_at is not None and svc.metrics.rounds == reshard_at:
                svc.request_reshard(8)
            if svc.metrics.rounds > 10000:
                raise RuntimeError("no drain")
            svc.step()
    finally:
        svc.close()
        svc._drain_emit()
    return outcome(reqs, svc.metrics, eng.arena)


def _jax_script(out_path):
    """Script mode: the JAX live reshard (4 -> 8 at round 3) and the cold
    run at 8, sync, with and without writes, on eight host devices."""
    assert jax.device_count() == 8, jax.devices()
    arrays = {}
    for writes in (True, False):
        for tag, kw in (("live", dict(nshards=4, reshard_at=3)), ("cold", dict(nshards=8))):
            got = serve_reshard("jax", pipeline="sync", writes=writes, **kw)
            for k, v in got.items():
                arrays[f"{tag}/{writes}/{k}"] = v
    np.savez(out_path, **arrays)


@pytest.fixture(scope="module", autouse=True)
def _jax_run(tmp_path_factory):
    """Starts the JAX package's eight-device run as the module starts."""
    if jax is None:
        yield None
        return
    out = tmp_path_factory.mktemp("jax_elastic") / "outcomes.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen([sys.executable, str(Path(__file__)), str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_outcomes(_jax_run):
    proc, out = _jax_run
    stdout, stderr = proc.communicate(timeout=400)
    assert proc.returncode == 0, f"STDOUT:\n{stdout}\nSTDERR:\n{stderr}"
    got = dict(np.load(out))
    keys = ("req", "result", "metrics", "data", "heap")
    return {(tag, w): {k: got[f"{tag}/{w}/{k}"] for k in keys}
            for tag in ("live", "cold") for w in (True, False)}


@pytest.mark.parametrize("run", RESHARD_RUNS, ids=[f"{p}-{'rw' if w else 'ro'}"
                                                   for p, w in RESHARD_RUNS])
def test_live_reshard_matches_jax_and_a_cold_run(run, jax_outcomes):
    """The live 4 -> 8 reshard: every request and metric count equal to the
    JAX service's (sync; async equals sync), one reshard, the arena at 8
    shards; and every result, the final arena and the commits equal to a
    cold run at 8 shards on the remapped arena (the heap's epoch and commit
    registers differ where early quanta committed at 4, as in the JAX
    check)."""
    pipeline, writes = run
    live = serve_reshard("torch", 4, pipeline, reshard_at=3, writes=writes)
    assert_same(jax_outcomes[("live", writes)], live, f"live/{pipeline}/{writes}")
    metrics = json.loads(str(live["metrics"]))
    assert metrics["reshards"] == 1
    cold = serve_reshard("torch", 8, pipeline, writes=writes)
    assert_same(jax_outcomes[("cold", writes)], cold, f"cold/{pipeline}/{writes}")
    np.testing.assert_array_equal(live["result"], cold["result"])
    np.testing.assert_array_equal(live["data"], cold["data"])
    np.testing.assert_array_equal(live["heap"][:, :2], cold["heap"][:, :2])
    assert (live["req"][:, 1] == 1).all()  # every request DONE
    cold_m = json.loads(str(cold["metrics"]))
    assert metrics["commits"] == cold_m["commits"]
    assert (metrics["commits"] > 0) == writes


if __name__ == "__main__":
    _jax_script(sys.argv[1])
