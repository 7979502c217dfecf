"""Port parity: the fat-pointer skip list (``core/structures/skiplist.py``)
and its native ``pulse_chase`` body.

The same numpy keys, made from a seed, build the skip list in both
packages; the arenas, ``find_iterator``'s results, the plain version of the
``skiplist_find`` body (``ref.chase_reference`` with the iterator as its
logic) against the JAX Pallas kernel in interpret mode, and the sequential
commit of the insert and delete iterators at one and eight shards (the
``tests/helpers/write_checks.py`` workload) must be bit-equal.

The tests marked ``gpu`` (``pytest -m gpu`` on the card, which has no JAX)
hold the CUDA kernel's ``skiplist_find`` body against its plain version
through both entry points."""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from repro.core import commit as jcommit
    from repro.core import iterator as jiter
    from repro.core.arena import ArenaBuilder as JBuilder
    from repro.core.structures import skiplist as jskip
    from repro.kernels.pulse_chase import ops as jops
except ImportError:  # the card's machine has no JAX; its gpu tests need none
    jnp = None
from repro_torch.core import arena as tarena
from repro_torch.core import commit as tcommit
from repro_torch.core import engine as tengine
from repro_torch.core import iterator as titer
from repro_torch.core import routing as trouting
from repro_torch.core.structures import skiplist as tskip
from repro_torch.kernels.pulse_chase import kernel as tkernel
from repro_torch.kernels.pulse_chase import ops as tops
from repro_torch.kernels.pulse_chase import ref as tref

CPU = "cpu"
FIELDS = ("ptr", "scratch", "status", "iters")


def _carry(jar):
    return tarena.arena_from_numpy(
        *(np.asarray(x) for x in (jar.data, jar.bounds, jar.perms, jar.heap)), device=CPU)


def _keys(rng, n):
    return np.sort(rng.choice(np.arange(0, 10 * n, 2), n, replace=False)).astype(np.int32)


def test_level_of_matches():
    i = np.arange(5000)
    want = [jskip._level_of(int(x)) for x in i]
    np.testing.assert_array_equal(tskip._level_of(i), want)
    assert [tskip._level_of(int(x)) for x in i[:200]] == want[:200]
    assert max(want) == tskip.LEVELS - 1


@pytest.mark.parametrize("n,P", [(1, 1), (40, 1), (777, 1), (40, 8)])
def test_builder_matches(n, P):
    rng = np.random.default_rng(n)
    keys = rng.permutation(_keys(rng, n))  # the builder sorts
    vals = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    if P == 1:
        jar, jh = jskip.build(keys, vals)
        tar, th = tskip.build(keys, vals, device=CPU)
    else:
        jb = JBuilder(256, jskip.NODE_WORDS, num_shards=P, policy="interleaved")
        tb = tarena.ArenaBuilder(256, tskip.NODE_WORDS, num_shards=P, policy="interleaved")
        jh, th = jskip.build_into(jb, keys, vals), tskip.build_into(tb, keys, vals)
        jar, tar = jb.finish(), tb.finish(device=CPU)
    assert jh == th
    for f in ("data", "bounds", "perms", "heap"):
        np.testing.assert_array_equal(np.asarray(getattr(jar, f)), getattr(tar, f).numpy(), f)


def _find_case(rng, n=600, B=96):
    keys = _keys(rng, n)
    vals = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    q = np.concatenate([rng.choice(keys, B // 2), rng.integers(0, 10 * n, B // 2) | 1,
                        [keys[0], keys[-1], -5, 2**31 - 1]]).astype(np.int32)
    jar, head = jskip.build(keys, vals)
    return keys, vals, q, jar, head


def test_find_iterator_matches():
    keys, vals, q, jar, head = _find_case(np.random.default_rng(1))
    jit_, tit = jskip.find_iterator(), tskip.find_iterator()
    jp, js = jit_.init(jnp.asarray(q), head)
    tp, ts = tit.init(torch.from_numpy(q), head)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    jout = jiter.execute_batched(jit_, jar, jp, js, max_iters=4096)
    tout = titer.execute_batched(tit, _carry(jar), tp, ts, max_iters=4096)
    for f, a, b in zip(FIELDS, jout, tout):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f)
    want = tskip.ref_find(keys, vals, q)
    assert want == jskip.ref_find(keys, vals, q)
    got = [(int(s[1]), int(s[2])) for s in tout[1].numpy()]
    assert got == want
    # the engine's kernel backend runs the body's plain version on the CPU
    res = tengine.PulseEngine(_carry(jar)).execute(tit, tp, ts, max_iters=4096, backend="kernel")
    for f, b in zip(FIELDS, tout):
        assert torch.equal(getattr(res, f), b), f


@pytest.mark.parametrize("steps", [1, 5, 40])
def test_body_plain_version_matches_pallas_interpret(steps):
    """``ref.chase_reference`` with the skiplist_find logic -- the plain
    version of the kernel's native body -- equals the JAX Pallas kernel in
    interpret mode, with counts accumulated on top of nonzero ones and a
    retired lane."""
    keys, vals, q, jar, head = _find_case(np.random.default_rng(2), n=300, B=28)
    jit_, tit = jskip.find_iterator(), tskip.find_iterator()
    jp, js = jit_.init(jnp.asarray(q), head)
    st0 = np.zeros(len(q), np.int32)
    st0[3] = 1
    it0 = np.arange(len(q), dtype=np.int32)
    jout = jops.pulse_chase(jar.data, jp, js, st0, it0, logic_fn=jops.iterator_logic(jit_),
                            num_steps=steps, use_pallas=True, interpret=True)
    tp, ts = tit.init(torch.from_numpy(q), head)
    logic = tops.iterator_logic(tit)
    assert logic.native is tkernel.NATIVE_BODIES["skiplist_find"]
    tout = tref.chase_reference(_carry(jar).data, tp, ts, torch.from_numpy(st0),
                                torch.from_numpy(it0), logic, steps)
    for f, a, b in zip(FIELDS, jout, tout):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f)


def skiplist_insert_delete(P, seed=11):
    """The write_checks skip-list workload (``tests/helpers/write_checks.py``,
    ``check_skiplist_insert_delete``): a 40-key list interleaved over ``P``
    shards; racing inserts of absent odd keys, then racing deletes of every
    other inserted key (victims never adjacent).  Returns ``(JAX arena,
    head, keys, newk, phases)``, each phase ``(name, JAX iterator, port
    iterator, init arguments as numpy)``."""
    rng = np.random.default_rng(seed)
    n = 40
    keys = np.sort(rng.choice(np.arange(0, 5000, 2), n, replace=False)).astype(np.int32)
    pol = "interleaved" if P > 1 else "sequential"
    jb = JBuilder(256, jskip.NODE_WORDS, num_shards=P, policy=pol)
    head = jskip.build_into(jb, keys, keys * 2)
    newk = (keys[:16] + 1).astype(np.int32)
    phases = [("insert", jskip.insert_iterator(), tskip.insert_iterator(),
               (newk, newk * 2, head)),
              ("delete", jskip.delete_iterator(), tskip.delete_iterator(), (newk[::2], head))]
    return jb.finish(), head, keys, newk, phases


def phase_inits(args):
    """The same init arguments for the JAX iterator and the port's."""
    return ([jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args],
            [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args])


@pytest.mark.parametrize("P", [1, 8])
def test_insert_then_delete_commit_matches(P):
    """The write_checks skip-list workload: racing inserts of absent odd
    keys, then racing deletes of every other inserted key (victims never
    adjacent), each phase through both packages' sequential commit."""
    jar, head, keys, newk, phases = skiplist_insert_delete(P)
    arenas = []
    for phase, jit_, tit, args in phases:
        jargs, targs = phase_inits(args)
        jp, js = jit_.init(*jargs)
        tp, ts = tit.init(*targs)
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        np.testing.assert_array_equal(np.asarray(js), ts.numpy())
        tin = _carry(jar)
        jrec, jst, jar2 = jcommit.sequential_commit_execute(jit_, jar, jp, js, max_iters=4096)
        trec, tst, tar2 = tcommit.sequential_commit_execute(tit, tin, tp, ts, max_iters=4096)
        np.testing.assert_array_equal(jrec, trec, err_msg=phase)
        for f in ("supersteps", "routed_per_step", "active_per_step", "wire_words_per_step",
                  "capacity_per_step", "local_only_steps", "commits", "epochs", "schedule"):
            assert getattr(jst, f) == getattr(tst, f), (phase, f)
        np.testing.assert_array_equal(jst.crossings, tst.crossings)
        np.testing.assert_array_equal(np.asarray(jar2.data), tar2.data.numpy(), phase)
        np.testing.assert_array_equal(np.asarray(jar2.heap), tar2.heap.numpy(), phase)
        assert (trec[:, trouting.F_STATUS] == titer.STATUS_DONE).all()
        jar = jar2
        arenas.append(tar2)
    res_col = trouting.F_SCRATCH + tskip.SD_RES
    assert (trec[:, res_col] == 1).all()
    # the read path on the final arena: survivors found, victims gone
    fit = tskip.find_iterator()
    want_in = np.concatenate([keys, newk[1::2]])
    for qk, found in ((want_in, 1), (newk[::2], 0)):
        fp, fs = fit.init(torch.from_numpy(qk), head)
        _, scr, _, _ = titer.execute_batched(fit, arenas[-1], fp, fs, max_iters=4096)
        assert (scr[:, 2].numpy() == found).all()


# ---------------------------------- the card ----------------------------------


def _card_case(rng, n=3000, B=1024):
    keys = _keys(rng, n)
    vals = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    q = np.concatenate([rng.choice(keys, B // 2), rng.integers(0, 10 * n, B // 2) | 1])
    ar, head = tskip.build(keys, vals, device="cuda")
    it = tskip.find_iterator()
    p0, s0 = it.init(torch.from_numpy(q.astype(np.int32)).cuda(), head)
    p0[1], p0[5] = -1, ar.capacity + 3
    st0 = torch.zeros_like(p0)
    st0[7] = 1
    return ar, it, p0, s0, st0


@pytest.mark.gpu
def test_skiplist_body_matches_plain_on_card():
    """The fixed-depth entry point: one launch, bit-equal to the plain
    version at depths below, at and past the traversals' ends."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with pytest -m gpu")
    ar, it, p0, s0, st0 = _card_case(np.random.default_rng(5))
    logic = tops.iterator_logic(it)
    assert logic.native is tkernel.NATIVE_BODIES["skiplist_find"]
    for steps in (1, 4, 40):
        before = tops.pulse_chase.launches
        got = tops.pulse_chase(ar.data, p0, s0, st0, logic_fn=logic, num_steps=steps)
        assert tops.pulse_chase.launches == before + 1
        want = tref.chase_reference(ar.data, p0, s0, st0, torch.zeros_like(p0), logic, steps)
        torch.cuda.synchronize()
        for f, a, b in zip(FIELDS, want, got):
            assert torch.equal(a, b), (steps, f)


@pytest.mark.gpu
@pytest.mark.parametrize("max_steps,quantum", [(64, 8), (13, 4)])
def test_skiplist_run_matches_reference_on_card(max_steps, quantum):
    """The whole-traversal entry point with a fault check (the first quarter
    revoked), equal to ``chase_run_reference``; then the engine's
    ``execute`` launches once and finds every stored key."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with pytest -m gpu")
    ar, it, p0, s0, st0 = _card_case(np.random.default_rng(6))
    logic = tops.iterator_logic(it)
    cap = ar.capacity
    check = tops.FaultCheck(torch.tensor([0, cap // 4, cap], dtype=torch.int32).cuda(),
                            torch.tensor([0, 1], dtype=torch.int32).cuda(), cap)
    before = tops.pulse_chase.launches
    got = tops.pulse_chase_run(ar.data, p0, s0, st0, logic_fn=logic, max_steps=max_steps,
                               depth_quantum=quantum, fault_fn=check)
    assert tops.pulse_chase.launches == before + 1
    want = tref.chase_run_reference(ar.data, p0, s0, st0, logic, max_steps, quantum, check)
    torch.cuda.synchronize()
    for f, a, b in zip(FIELDS[:3], want[:3], got[:3]):
        assert torch.equal(a, b), f
    assert torch.equal(want[3], got[3].retire_step) and torch.equal(want[4], got[3].faulted)
    eng = tengine.PulseEngine(ar)
    before = tops.pulse_chase.launches
    res = eng.execute(it, p0[8:], s0[8:], max_iters=4096)
    assert tops.pulse_chase.launches == before + 1
    assert (res.scratch[: 512 - 8, 2] == 1).all() and (res.scratch[512 - 8:, 2] == 0).all()
