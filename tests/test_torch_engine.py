"""Port parity, the slice end to end: ``PulseEngine.execute`` single node.

Each structure is built in the JAX package and carried over with
``arena_from_numpy``; both engines run the same queries.  The port's
``"kernel"`` backend (the kernel's plain version under the wave scheduler,
on the CPU) and its ``"reference"`` backend must equal the JAX ``"xla"``
backend on ptr, scratch, status and iters.  Iterators written in torch must
also equal the JAX ``"kernel"`` backend (Pallas in interpret mode), which
cannot take ISA-backed iterators (their program is a captured constant).
The port's ISA iterators are held against the JAX ``"xla"`` result of the
native iterator: the JAX engine gives its ISA and native iterators the same
result (``tests/test_core_isa.py``), and the port's VM is held against the
JAX VM in ``tests/test_torch_isa.py``."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import arena as jarena
from repro.core import engine as jengine
from repro.core import isa as jisa
from repro.core import iterator as jiter
from repro.core.structures import bst as jbst
from repro.core.structures import btree as jbtree
from repro.core.structures import hash_table as jhash
from repro.core.structures import isa_programs as jprogs
from repro.core.structures import linked_list as jlist
from repro_torch.core import arena as tarena
from repro_torch.core import engine as tengine
from repro_torch.core import isa as tisa
from repro_torch.core import iterator as titer
from repro_torch.core.structures import bst as tbst
from repro_torch.core.structures import btree as tbtree
from repro_torch.core.structures import hash_table as thash
from repro_torch.core.structures import isa_programs as tprogs
from repro_torch.core.structures import linked_list as tlist
from repro_torch.kernels.pulse_chase import ops as tops

CPU = "cpu"
FIELDS = ("ptr", "scratch", "status", "iters")
RNG_SEED = 5


def _carry(jar, perms=None):
    fields = [np.asarray(x) for x in (jar.data, jar.bounds, jar.perms, jar.heap)]
    if perms is not None:
        fields[2] = np.asarray(perms, np.int32)
    return tarena.arena_from_numpy(*fields, device=CPU)


def _with_perms(jar, perms):
    return dataclasses.replace(jar, perms=jnp.asarray(perms, jnp.int32))


def _assert_same(jres, tres, what):
    for f in FIELDS:
        a, b = np.asarray(getattr(jres, f)), getattr(tres, f)
        assert b.dtype == torch.int32 and b.device.type == CPU, (what, f)
        np.testing.assert_array_equal(a, b.numpy(), err_msg=f"{what}: {f}")


def _case(name):
    """(JAX arena, JAX native iterator, port native iterator, program name,
    ptr0, scratch0) with stored and absent keys and one NULL lane."""
    jar, ji, ti, prog, p0, s0 = _built_case(name)
    return jar, ji, ti, prog, p0.copy(), s0.copy()


@functools.lru_cache(maxsize=None)
def _built_case(name):
    rng = np.random.default_rng(RNG_SEED)
    keys = rng.choice(np.arange(10**5), size=256, replace=False).astype(np.int32)
    vals = rng.integers(0, 10**6, 256).astype(np.int32)
    q = np.concatenate([keys[:24], rng.integers(10**5, 10**6, 8).astype(np.int32)])
    if name == "list":
        jar, head = jlist.build(keys[:48], vals[:48])
        ji, ti = jlist.find_iterator(), tlist.find_iterator()
        p0, s0 = ji.init(jnp.asarray(np.concatenate([keys[:48:2], q[24:]])), head)
    elif name == "hash":
        jar, heads = jhash.build(keys, vals, 8)
        ji, ti = jhash.find_iterator(8), thash.find_iterator(8)
        p0, s0 = ji.init(jnp.asarray(q), jnp.asarray(heads))
    elif name == "bst":
        jar, root, _ = jbst.build(keys, vals)
        ji, ti = jbst.find_iterator(), tbst.find_iterator()
        p0, s0 = ji.init(jnp.asarray(q), root)
    else:
        jar, root, _ = jbtree.build(keys, vals)
        ji, ti = jbtree.find_iterator(), tbtree.find_iterator()
        p0, s0 = ji.init(jnp.asarray(q), root)
    p0 = np.asarray(p0).copy()
    p0[3] = -1
    return jar, ji, ti, f"{name}_find", p0, np.array(s0)


@pytest.mark.parametrize("name", ["list", "hash", "bst", "btree"])
def test_execute_matches_jax_engine(name):
    jar, ji, ti, prog, p0, s0 = _case(name)
    tar = _carry(jar)
    jeng, teng = jengine.PulseEngine(jar), tengine.PulseEngine(tar)

    jx = jeng.execute(ji, p0, s0, max_iters=4096, backend="xla")
    jk = jeng.execute(ji, p0, s0, max_iters=4096, backend="kernel")
    for backend in ("kernel", "reference"):
        tr = teng.execute(ti, torch.from_numpy(p0), torch.from_numpy(s0), max_iters=4096,
                          backend=backend)
        _assert_same(jx, tr, f"native {backend} vs xla")
        _assert_same(jk, tr, f"native {backend} vs jax kernel")
    assert teng.execute(ti, p0, s0, max_iters=4096).stats is None  # CPU default

    # the unrolled btree program (N=68) fails the offload test t_c <= eta*t_d
    # and would run at the CPU node on a CPU arena: force the accelerator path
    tisa_it = tisa.as_pulse_iterator(tprogs.all_programs()[prog])
    for backend in ("kernel", "reference"):
        tr = teng.execute(tisa_it, p0, s0, max_iters=4096, backend=backend,
                          force_offload=True)
        _assert_same(jx, tr, f"isa {backend} vs xla")
        if backend == "kernel":
            tk = tr
    assert isinstance(tk.stats, tops.WaveStats) and tk.stats.chunks >= 1
    assert (tk.status.numpy() == titer.STATUS_DONE).sum() == len(p0) - 1
    assert tk.status.numpy()[3] == titer.STATUS_FAULT


def test_stateful_iterators_match():
    """Scratch-pad aggregation: list sums over a pooled heap and B+tree
    range aggregation (sum/min/max/count, wrapping in int32), plus the BST
    finalize step."""
    rng = np.random.default_rng(2)
    b = jarena.ArenaBuilder(400, 20)
    heads = [jlist.build_into(b, np.arange(n), rng.integers(-(2**30), 2**30, n))
             for n in (1, 5, 40)]
    keys = rng.choice(np.arange(10**4), size=300, replace=False).astype(np.int32)
    vals = rng.integers(-(2**31), 2**31 - 1, 300).astype(np.int32)
    broot, _ = jbtree.build_into(b, keys, vals)
    jar = b.finish()
    tar = _carry(jar)
    lo = rng.integers(0, 10**4, 24).astype(np.int32)
    hi = (lo + rng.integers(0, 3000, 24)).astype(np.int32)
    cases = [
        (jlist.sum_iterator(), tlist.sum_iterator(), (np.asarray(heads, np.int32),)),
        (jbtree.range_aggregate_iterator(), tbtree.range_aggregate_iterator(),
         (lo, hi, broot)),
    ]
    jeng, teng = jengine.PulseEngine(jar), tengine.PulseEngine(tar)
    for ji, ti, args in cases:
        p0, s0 = ji.init(*(jnp.asarray(a) for a in args))
        tp0, ts0 = ti.init(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                             for a in args))
        np.testing.assert_array_equal(np.asarray(p0), tp0.numpy())
        np.testing.assert_array_equal(np.asarray(s0), ts0.numpy())
        jx = jeng.execute(ji, np.asarray(p0), np.asarray(s0), max_iters=4096, backend="xla")
        for backend in ("kernel", "reference"):
            _assert_same(jx, teng.execute(ti, tp0, ts0, max_iters=4096, backend=backend),
                         f"{ti.name} {backend}")
    agg = teng.execute(cases[1][1], *cases[1][1].init(torch.from_numpy(lo),
                                                      torch.from_numpy(hi), broot))
    want = tbtree.ref_range_aggregate(keys, vals, lo, hi)
    assert want == jbtree.ref_range_aggregate(keys, vals, lo, hi)
    got = agg.scratch.numpy()[:, tbtree.RA_SUM:].astype(np.int64)
    got[:, 0] %= 2**32
    assert [tuple(map(int, r)) for r in got] == want

    jar, ji, ti, _, p0, s0 = _case("bst")
    jr = jengine.PulseEngine(jar).execute(ji, p0, s0, max_iters=4096, backend="xla")
    tr = tengine.PulseEngine(_carry(jar)).execute(ti, p0, s0, max_iters=4096)
    jv, jf = jbst.result(jnp.asarray(jr.scratch))
    tv, tf = tbst.result(tr.scratch)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())


def test_oracles_match():
    rng = np.random.default_rng(4)
    keys = rng.choice(np.arange(10**4), size=200, replace=False).astype(np.int32)
    keys[7] = keys[3]  # a duplicate key: the later value wins
    vals = rng.integers(0, 10**6, 200).astype(np.int32)
    q = np.concatenate([keys[:50], rng.integers(10**4, 2 * 10**4, 20)]).astype(np.int32)
    assert tbtree.ref_find(keys, vals, q) == jbtree.ref_find(keys, vals, q)
    assert tbst.ref_find(keys, vals, q) == jbst.ref_find(keys, vals, q)
    assert thash.ref_find(keys, vals, 16, q) == jhash.ref_find(keys, vals, 16, q)
    assert tlist.ref_find(keys[:30], vals[:30], q) == jlist.ref_find(keys[:30], vals[:30], q)
    np.testing.assert_array_equal(thash.hash_fn(q, 16), jhash.hash_fn(q, 16))
    np.testing.assert_array_equal(
        thash.hash_fn(torch.from_numpy(q), 16).numpy(),
        np.asarray(jhash.hash_fn(jnp.asarray(q), 16)),
    )
    np.testing.assert_array_equal(thash._np_hash(q, 16), jhash._np_hash(q, 16))
    assert thash.hash_fn(-5, 7) == jhash.hash_fn(-5, 7)


def test_maxed_continuation_and_resume():
    """A budget cut leaves MAXED lanes that resume from (ptr, scratch) and
    end where one long run ends; every backend agrees on the cut."""
    keys = np.arange(32, dtype=np.int32)
    jar, head = jlist.build(keys, keys * 7)
    tar = _carry(jar)
    q = np.concatenate([keys[::2], [999]]).astype(np.int32)
    p0, s0 = jlist.find_iterator().init(jnp.asarray(q), head)
    p0, s0 = np.array(p0), np.array(s0)
    jeng, teng = jengine.PulseEngine(jar), tengine.PulseEngine(tar)
    jx = jeng.execute(jlist.find_iterator(), p0, s0, max_iters=10, backend="xla")
    assert (np.asarray(jx.status) == jiter.STATUS_MAXED).any()
    for ti in (tlist.find_iterator(),
               tisa.as_pulse_iterator(tprogs.list_find_program())):
        for backend in ("kernel", "reference"):
            cut = teng.execute(ti, p0, s0, max_iters=10, backend=backend)
            _assert_same(jx, cut, f"{ti.name} {backend} budget cut")
            rest = teng.execute(ti, cut.ptr, cut.scratch, max_iters=4096, backend=backend)
            full = teng.execute(ti, p0, s0, max_iters=4096, backend=backend)
            maxed = cut.status == titer.STATUS_MAXED
            assert torch.equal(rest.scratch[maxed], full.scratch[maxed])
            assert torch.equal((cut.iters + rest.iters)[maxed], full.iters[maxed])
            assert (full.status == titer.STATUS_DONE).all()
    st = np.array([0, 1, 2, 3, 4, 2, -2], np.int32)
    np.testing.assert_array_equal(np.asarray(jiter.resume(st)),
                                  titer.resume(torch.from_numpy(st)).numpy())


def test_step_batch_matches_on_shard_window_and_perm_mask():
    jar, ji, ti, _, p0, s0 = _case("hash")
    tar = _carry(jar)
    st = np.zeros(len(p0), np.int32)
    st[[5, 6]] = [jiter.STATUS_DONE, jiter.STATUS_MAXED]
    it = np.arange(len(p0), dtype=np.int32)
    perm = np.arange(len(p0)) % 3 != 0
    j = jiter.step_batch(ji, jar.data, jnp.asarray(p0), jnp.asarray(s0), jnp.asarray(st),
                         jnp.asarray(it), max_iters=20, local_lo=16, local_hi=200,
                         perm_ok=jnp.asarray(perm))
    t = titer.step_batch(ti, tar.data, torch.from_numpy(p0), torch.from_numpy(s0),
                         torch.from_numpy(st), torch.from_numpy(it), max_iters=20,
                         local_lo=16, local_hi=200, perm_ok=torch.from_numpy(perm))
    for f, a, b in zip(FIELDS, j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f)


def test_cpu_node_path_trace_and_dispatch_match():
    jar, ji, ti, prog, p0, s0 = _case("hash")
    tar = _carry(jar)
    jeng, teng = jengine.PulseEngine(jar), tengine.PulseEngine(tar)
    # (LRU size, iteration budget): a cache that hits, then a budget cut
    for jit_, tit, configs in (
        (ji, ti, ((16, 4096),)),
        (jisa.as_pulse_iterator(jprogs.all_programs()[prog]),
         tisa.as_pulse_iterator(tprogs.all_programs()[prog]), ((4, 3),)),
    ):
        assert dataclasses.asdict(jeng.dispatch(jit_)) == dataclasses.asdict(
            teng.dispatch(tit))
        for cache_nodes, budget in configs:
            jr = jeng.execute(jit_, p0, s0, max_iters=budget, force_offload=False,
                              cache_nodes=cache_nodes)
            tr = teng.execute(tit, p0, s0, max_iters=budget, force_offload=False,
                              cache_nodes=cache_nodes)
            assert not jr.offloaded and not tr.offloaded
            _assert_same(jr, tr, f"cpu_node {tit.name} {cache_nodes}")
            assert (jr.stats.total_fetches, jr.stats.cache_hits, jr.stats.misses) == (
                tr.stats.total_fetches, tr.stats.cache_hits, tr.stats.misses)
            np.testing.assert_array_equal(jr.stats.per_request_iters,
                                          tr.stats.per_request_iters)


def test_card_arena_traverses_on_the_card_whatever_the_dispatch_model(monkeypatch):
    """On an arena on the card, an iterator the dispatch model declines
    (the 68-instruction btree program) still runs on the card by default,
    with the decision reported; the host-side cpu_node baseline runs only
    on request.  Checked with a fake card test and the plain backend."""
    jar, ji, ti, prog, p0, s0 = _case("btree")
    tit = tisa.as_pulse_iterator(tprogs.all_programs()[prog])
    jx = jengine.PulseEngine(jar).execute(ji, p0, s0, max_iters=4096, backend="xla")
    teng = tengine.PulseEngine(_carry(jar))
    assert not teng.dispatch(tit).offload
    assert not teng.execute(tit, p0, s0, max_iters=4096, backend="reference").offloaded
    monkeypatch.setattr(tengine, "_on_card", lambda t: True)
    tr = teng.execute(tit, p0, s0, max_iters=4096, backend="reference")
    assert tr.offloaded and tr.stats is None
    assert dataclasses.asdict(tr.decision) == dataclasses.asdict(teng.dispatch(tit))
    _assert_same(jx, tr, "card default")
    assert not teng.execute(tit, p0, s0, max_iters=4096, backend="reference",
                            force_offload=False).offloaded


def test_revoked_shard_faults_on_both():
    """Two shards, shard 0 unreadable: lanes walking into it FAULT.  The
    kernel path detects faults between depth quanta, so it is held against
    the JAX kernel path, the reference executor against the JAX xla one."""
    rng = np.random.default_rng(1)
    keys = rng.choice(np.arange(10**5), size=96, replace=False).astype(np.int32)
    jar, heads = jhash.build(keys, keys + 1, 5, num_shards=2)
    jar = _with_perms(jar, [0, 3])
    tar = _carry(jar)
    p0, s0 = jhash.find_iterator(5).init(jnp.asarray(keys[:32]), jnp.asarray(heads))
    p0, s0 = np.array(p0), np.array(s0)
    jeng, teng = jengine.PulseEngine(jar), tengine.PulseEngine(tar)
    ji, ti = jhash.find_iterator(5), thash.find_iterator(5)
    jx = jeng.execute(ji, p0, s0, max_iters=4096, backend="xla")
    jk = jeng.execute(ji, p0, s0, max_iters=4096, backend="kernel")
    assert (np.asarray(jx.status) == jiter.STATUS_FAULT).any()
    _assert_same(jx, teng.execute(ti, p0, s0, max_iters=4096, backend="reference"), "ref")
    tk = teng.execute(ti, p0, s0, max_iters=4096, backend="kernel")
    _assert_same(jk, tk, "kernel")
    tki = teng.execute(tisa.as_pulse_iterator(tprogs.hash_find_program()), p0, s0,
                       max_iters=4096, backend="kernel")
    np.testing.assert_array_equal(tki.status.numpy(), tk.status.numpy())
    # the verified read-only program may not elide the probe on this arena
    assert not tengine.can_elide_access_check(
        tisa.as_pulse_iterator(tprogs.hash_find_program()), tar)
    assert tengine.can_elide_access_check(
        tisa.as_pulse_iterator(tprogs.hash_find_program()), _carry(jar, [1, 3]))


@pytest.mark.parametrize("max_iters", [10, 16, 4096])
def test_faults_and_budget_cut_match_jax_kernel_backend(max_iters):
    """A revoked shard, a NULL entry and a budget cut off the depth quantum
    (max_iters 10, quantum 8): the port's kernel backend (one run, its plain
    version here) equals the JAX engine's kernel backend, for the torch
    iterator and the ISA one."""
    rng = np.random.default_rng(1)
    keys = rng.choice(np.arange(10**5), size=96, replace=False).astype(np.int32)
    jar, heads = jhash.build(keys, keys + 1, 5, num_shards=2)
    jar = _with_perms(jar, [0, 3])
    p0, s0 = jhash.find_iterator(5).init(jnp.asarray(keys[:32]), jnp.asarray(heads))
    p0, s0 = np.array(p0), np.array(s0)
    p0[3] = -1
    jk = jengine.PulseEngine(jar).execute(jhash.find_iterator(5), p0, s0, max_iters=max_iters,
                                          backend="kernel")
    statuses = set(np.asarray(jk.status).tolist())
    assert jiter.STATUS_FAULT in statuses
    if max_iters == 10:
        assert jiter.STATUS_MAXED in statuses
    teng = tengine.PulseEngine(_carry(jar))
    for ti in (thash.find_iterator(5), tisa.as_pulse_iterator(tprogs.hash_find_program())):
        _assert_same(jk, teng.execute(ti, p0, s0, max_iters=max_iters, backend="kernel",
                                      force_offload=True), f"{ti.name} at {max_iters}")


def test_kernel_backend_with_torch_iterator_on_cuda_raises(monkeypatch):
    """The kernel backend on a CUDA arena runs a structure's own iterator on
    its native body, in one launch with the fault check on the device, and
    raises for an ad-hoc torch iterator that has no body; checked with a
    fake CUDA test (no card)."""
    jar, ji, ti, prog, p0, s0 = _case("hash")
    monkeypatch.setattr(tops, "_on_cuda", lambda t: True)
    calls = []

    def spy(arena, ptr, scratch, status, iters, code, num_steps, *, body="isa", quantum=1,
            fault=None):
        calls.append(dict(body=body, code=code, iters=iters, steps=num_steps,
                          quantum=quantum, fault=fault))
        z = torch.zeros_like(ptr)
        return ptr, scratch, status + 1, z, z.bool()

    monkeypatch.setattr(tops._kernel, "launch", spy)
    eng = tengine.PulseEngine(_carry(jar))
    before = tops.pulse_chase.launches
    res = eng.execute(thash.find_iterator(8), p0, s0, max_iters=4096, backend="kernel")
    assert tops.pulse_chase.launches == before + 1 and len(calls) == 1
    call = calls[0]
    assert (call["body"], call["code"], call["iters"]) == ("hash_find", None, None)
    assert (call["steps"], call["quantum"]) == (4096, 8)
    assert isinstance(call["fault"], tops.FaultCheck) and call["fault"].cap == jar.capacity
    assert (res.status.numpy() == titer.STATUS_DONE).all() and res.stats.chunks == 1
    adhoc = dataclasses.replace(ti, name="hash_find_adhoc")
    with pytest.raises(ValueError, match="ISA"):
        eng.execute(adhoc, p0, s0, backend="kernel")
    assert len(calls) == 1


def test_deferred_paths_raise():
    """An unknown backend and a mesh (item 6) raise; a mutating iterator
    takes the write path, whose read-only exits (the kernel backend, the
    CPU node) raise as in the JAX package."""
    jar, ji, ti, prog, p0, s0 = _case("list")
    eng = tengine.PulseEngine(_carry(jar))
    with pytest.raises(ValueError, match="backend"):
        eng.execute(ti, p0, s0, backend="xla")
    mut = tlist.insert_iterator()
    with pytest.raises(ValueError, match="read-only"):
        eng.execute(mut, p0, s0, backend="kernel")
    with pytest.raises(ValueError, match="force_offload=False"):
        eng.execute(mut, p0, s0, force_offload=False)
    with pytest.raises(ValueError, match="backend"):
        eng.execute(mut, p0, s0, backend="xla")
    two = tarena.make_arena(np.zeros((8, 4), np.int32), num_shards=2, device=CPU)
    with pytest.raises(NotImplementedError, match="item 6"):
        tengine.PulseEngine(two, mesh=object()).execute(ti, p0[:2], s0[:2])
    with pytest.raises(NotImplementedError, match="item 6"):
        tengine.PulseEngine(two, mesh=object()).execute(mut, p0[:2], s0[:2])


def test_arena_entry_points_default_to_the_card():
    """With no card and no device=, creating state fails; it never quietly
    lands on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        tarena.make_arena(np.zeros((4, 4), np.int32))
    with pytest.raises((RuntimeError, AssertionError)):
        tlist.build(np.arange(4), np.arange(4))
