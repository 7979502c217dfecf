"""Port parity: checkpoints and failure detection (item 8),
``repro_torch.distributed.checkpoint`` and the detectors of
``repro_torch.distributed.elastic`` against the JAX package's.

  * ``CheckpointManager`` round trips a nested tree of int32 and f32
    tensors, sync and async; a checkpoint written by the JAX manager
    restores in the port and one written by the port restores in JAX (one
    device, in this process); the leaves follow ``jax.tree_util``'s
    flatten order and paths;
  * the crash, gc and async cases of ``tests/test_checkpoint_ft.py`` on a
    tensor tree (its training state is item 11's);
  * ``plan_mesh_shape``, ``HeartbeatMonitor`` with ``ElasticCoordinator``
    and ``ShardFailureDetector``'s targeted suspect, each against the JAX
    one on the same inputs;
  * a bfloat16 leaf round trips bit for bit (its 2-byte words, as the JAX
    package writes them; ``test_torch_training.py`` holds the bytes
    against the JAX package's).
"""

import json

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.distributed import checkpoint as jckpt
    from repro.distributed import elastic as jelastic
except ImportError:
    jax = None
from repro_torch.distributed import checkpoint as tckpt
from repro_torch.distributed import elastic as telastic

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")


def _tree(seed=0):
    """A nested tree of int32 and f32 tensors with a None, a tuple, and
    dict keys whose insertion order is not sorted ("10" sorts before "9")."""
    g = np.random.default_rng(seed)
    i32 = lambda *s: torch.from_numpy(g.integers(-2**31, 2**31 - 1, s).astype(np.int32))
    f32 = lambda *s: torch.from_numpy(g.standard_normal(s).astype(np.float32))
    return {
        "params": {"w": f32(4, 3), "b": f32(3), "layers": [{"k": f32(2, 2)}, {"k": f32(2, 2)}]},
        "opt": (i32(5), None, {"mu": f32(4, 3), "count": i32()}),
        "9": i32(2, 2),
        "10": f32(1),
        "empty": None,
    }


def _numpy(tree):
    return [x.numpy() for x in tckpt.tree_leaves(tree)]


def _assert_trees_equal(a, b):
    la, lb = tckpt.tree_leaves(a), tckpt.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())


@pytest.mark.parametrize("async_save", [False, True])
def test_round_trip_nested_tree(tmp_path, async_save):
    state = _tree()
    ck = tckpt.CheckpointManager(tmp_path, async_save=async_save)
    ck.save(state, 3, extra={"data_step": 17})
    ck.wait()
    like = _tree(seed=1)
    got, extra, step = ck.restore(like)
    assert step == 3 and extra == {"data_step": 17}
    _assert_trees_equal(got, state)
    assert got["opt"][1] is None and got["empty"] is None
    assert isinstance(got["opt"], tuple) and list(got) == list(state)
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json").read_text())
    assert manifest["dtypes"][0] in ("int32", "float32")
    assert all(not d.startswith("torch") for d in manifest["dtypes"])


def test_save_copies_to_the_host_before_returning(tmp_path):
    """The state may change right after ``save`` returns; the async write
    must not see that."""
    state = _tree()
    want = [x.clone() for x in tckpt.tree_leaves(state)]
    ck = tckpt.CheckpointManager(tmp_path, async_save=True)
    ck.save(state, 1)
    for x in tckpt.tree_leaves(state):
        x.add_(1)
    ck.wait()
    got, _, _ = ck.restore(state)
    for a, b in zip(tckpt.tree_leaves(got), want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _jax_tree(tree):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), tree,
                                  is_leaf=lambda x: isinstance(x, torch.Tensor))


@needs_jax
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_flatten_order_and_paths_match_jax(seed):
    tree = _tree(seed)
    if seed == 1:
        tree = [tree, (tree["9"], {"z": tree["10"], "a": tree["9"]})]
    elif seed == 2:
        tree = {"x": None, "y": [], "z": {"b": tree["9"], "a": [tree["10"], None]}}
    elif seed == 3:
        tree = tree["9"]
    jt = _jax_tree(tree)
    j_leaves = jax.tree_util.tree_leaves(jt)
    assert tckpt.tree_paths(tree) == jckpt._tree_paths(jt)
    t_leaves = tckpt.tree_leaves(tree)
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@needs_jax
def test_jax_checkpoint_restores_in_port(tmp_path):
    state = _tree()
    jck = jckpt.CheckpointManager(tmp_path, async_save=False)
    jck.save(_jax_tree(state), 7, extra={"rng": [1, 2]})
    got, extra, step = tckpt.CheckpointManager(tmp_path).restore(_tree(seed=5), device="cpu")
    assert (step, extra) == (7, {"rng": [1, 2]})
    _assert_trees_equal(got, state)


@needs_jax
def test_port_checkpoint_restores_in_jax(tmp_path):
    state = _tree()
    tck = tckpt.CheckpointManager(tmp_path, async_save=True)
    tck.save(state, 9, extra={"k": "v"})
    tck.wait()
    jgot, extra, step = jckpt.CheckpointManager(tmp_path).restore(_jax_tree(_tree(seed=4)))
    assert (step, extra) == (9, {"k": "v"})
    for a, b in zip(jax.tree_util.tree_leaves(jgot), _numpy(state)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    jm = json.loads((tmp_path / "step_00000009" / "manifest.json").read_text())
    assert jm["paths"] == jckpt._tree_paths(jgot)


def test_crash_during_save_never_corrupts(tmp_path):
    state = _tree()
    ck = tckpt.CheckpointManager(tmp_path / "ckpt", async_save=False)
    ck.save(state, 1)
    # a crash mid-save of step 2: a partial temp dir, LATEST never flipped
    tmp = ck.dir / ".tmp_save_crashed"
    tmp.mkdir()
    (tmp / "shard_0.npz").write_bytes(b"garbage")
    # and a step dir without its manifest
    (ck.dir / "step_00000002").mkdir()
    assert ck.latest_step() == 1 and ck.all_steps() == [1]
    restored, _, step = ck.restore(state)
    assert step == 1
    _assert_trees_equal(restored, state)


def test_gc_keeps_last_k(tmp_path):
    ck = tckpt.CheckpointManager(tmp_path, async_save=False, keep=2)
    state = _tree()
    for s in (1, 2, 3, 4):
        ck.save(state, s)
    assert sorted(ck.all_steps()) == [3, 4] and ck.latest_step() == 4


def test_async_save_matches_sync(tmp_path):
    state = _tree()
    ck_a = tckpt.CheckpointManager(tmp_path / "a", async_save=True)
    ck_b = tckpt.CheckpointManager(tmp_path / "b", async_save=False)
    ck_a.save(state, 5)
    ck_b.save(state, 5)
    ck_a.wait()
    ra, _, _ = ck_a.restore(state)
    rb, _, _ = ck_b.restore(state)
    _assert_trees_equal(ra, rb)
    for name in ("manifest.json",):
        assert ((tmp_path / "a" / "step_00000005" / name).read_text()
                == (tmp_path / "b" / "step_00000005" / name).read_text())


def test_restore_refuses_a_tree_of_another_size(tmp_path):
    ck = tckpt.CheckpointManager(tmp_path, async_save=False)
    with pytest.raises(FileNotFoundError):
        ck.restore(_tree())
    ck.save(_tree(), 1)
    with pytest.raises(ValueError, match="leaves"):
        ck.restore({"only": torch.zeros(1)})


def test_bf16_leaf_is_refused_naming_training(tmp_path):
    """Training (ROADMAP item 11) lifted the refusal: a bfloat16 leaf is
    saved as its words, ``"bfloat16"`` in the manifest, and restored to
    ``torch.bfloat16`` bit for bit."""
    ck = tckpt.CheckpointManager(tmp_path, async_save=False)
    w = torch.tensor([1.0, -2.5, 3.1415, 1e-30, float("inf")], dtype=torch.bfloat16)
    ck.save({"w": w}, 1)
    assert ck.latest_step() == 1
    manifest = json.loads((tmp_path / "step_00000001" / "manifest.json").read_text())
    assert manifest["dtypes"] == ["bfloat16"] and manifest["shapes"] == [[5]]
    back, _, _ = ck.restore({"w": torch.zeros(1)})
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16), w.view(torch.int16))


# ------------------------------- elastic ------------------------------------


@needs_jax
@pytest.mark.parametrize("n,mp,pods", [(512, 16, 2), (256, 16, 2), (480, 16, 2), (16, 16, 1),
                                       (96, 8, 4), (28, 2, 1), (30, 2, 4)])
def test_plan_mesh_shape_matches_jax(n, mp, pods):
    assert telastic.plan_mesh_shape(n, model_parallel=mp, prefer_pods=pods) == \
        jelastic.plan_mesh_shape(n, model_parallel=mp, prefer_pods=pods)


def test_plan_mesh_shrink_keeps_model_axis():
    shape, names, used = telastic.plan_mesh_shape(512, model_parallel=16, prefer_pods=2)
    assert shape == (2, 16, 16) and names == ("pod", "data", "model") and used == 512
    shape, _, used = telastic.plan_mesh_shape(480, model_parallel=16, prefer_pods=2)
    assert shape[-1] == 16 and used == 480
    with pytest.raises(ValueError, match="model axis"):
        telastic.plan_mesh_shape(8, model_parallel=16)


def _coordinator_run(mod):
    clock = [0.0]
    mon = mod.HeartbeatMonitor(num_hosts=8, timeout_s=10.0, clock=lambda: clock[0])
    coord = mod.ElasticCoordinator(mon, model_parallel=2, devices_per_host=4, prefer_pods=1)
    for h in range(8):
        mon.beat(h)
    clock[0] = 5.0
    first = coord.check(step=10, current_shape=(16, 2))
    clock[0] = 20.0
    for h in range(8):
        if h != 3:
            mon.beat(h)
    clock[0] = 29.0  # host 3 last beat at 0: 29 > 10 s; the rest fresh
    ev = coord.check(step=20, current_shape=(16, 2))
    return first, ev, mon.healthy_hosts()


def test_heartbeat_and_coordinator():
    first, ev, healthy = _coordinator_run(telastic)
    assert first is None
    assert ev is not None and ev.lost_hosts == [3] and ev.kind == "shrink"
    assert ev.new_shape[-1] == 2  # the model axis kept
    assert ev.new_shape[0] * ev.new_shape[1] <= 28  # 7 hosts x 4 devices
    assert healthy == [0, 1, 2, 4, 5, 6, 7]


@needs_jax
def test_heartbeat_and_coordinator_match_jax():
    t_first, t_ev, t_healthy = _coordinator_run(telastic)
    j_first, j_ev, j_healthy = _coordinator_run(jelastic)
    assert t_first is j_first is None and t_healthy == j_healthy
    for f in ("step", "kind", "old_shape", "new_shape", "lost_hosts"):
        assert getattr(t_ev, f) == getattr(j_ev, f), f


def test_detector_suspect_is_targeted():
    """A suspect mid-round advances the clock; the other shards' beats
    advance with it, or the next sweep takes every shard."""
    det = telastic.ShardFailureDetector(8)
    det.beat_all(5)
    det.suspect(3, rnd=6)
    assert det.sweep() == [3] and det.dead_shards() == [3]
    det.beat_all(7)
    assert det.sweep() == [] and det.dead_shards() == [3]
    det.revive(3)
    assert det.dead_shards() == []
    det.suspect(1, rnd=8)
    det.suspect(6, rnd=8)
    assert sorted(det.sweep()) == [1, 6] and sorted(det.dead_shards()) == [1, 6]


def _detector_trace(mod, seed):
    g = np.random.default_rng(seed)
    det = mod.ShardFailureDetector(8, timeout_rounds=int(g.integers(0, 3)))
    out = []
    rnd = 0
    for _ in range(60):
        op = int(g.integers(0, 4))
        if op == 0:
            rnd += 1
            det.beat_all(rnd)
        elif op == 1:
            det.suspect(int(g.integers(0, 8)), rnd + int(g.integers(0, 2)))
        elif op == 2:
            out.append(sorted(det.sweep()))
        else:
            det.revive(int(g.integers(0, 8)))
        out.append(sorted(det.dead_shards()))
    return out


@needs_jax
@pytest.mark.parametrize("seed", range(4))
def test_detector_matches_jax_on_seeded_sequences(seed):
    """beat_all, suspect, sweep and revive drawn from a seed, with timeouts
    of 0-2 rounds: the same dead shards after every operation."""
    assert _detector_trace(telastic, seed) == _detector_trace(jelastic, seed)
