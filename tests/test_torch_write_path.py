"""Port parity: the write path (staged mutations, the store class of the VM,
the sequential commit, the mutating iterators and the engine's write path).

The same numpy inputs, made from a seed, go through the JAX package and
through the port on the CPU, and every int32 output must be bit-equal:
``mut_step_batch``'s five outputs, the store-class VM's staged mutation,
and ``sequential_commit_execute``'s records, every ``RoutingStats`` field and
the final ``data`` and ``heap`` -- at one shard on the workloads of
``tests/test_write_path.py``, and at one and eight shards on the workloads
that ``tests/helpers/write_checks.py`` builds (the sequential commit needs
no mesh).  The skip list's workloads are in ``tests/test_torch_skiplist.py``.

The test marked ``gpu`` (``pytest -m gpu`` on the card, which has no JAX)
runs one write batch through ``PulseEngine`` on the card and on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.core import commit as jcommit
    from repro.core import engine as jengine
    from repro.core import faults as jfaults
    from repro.core import isa as jisa
    from repro.core import iterator as jiter
    from repro.core import routing as jrouting
    from repro.core.arena import ArenaBuilder as JBuilder
    from repro.core.arena import make_arena as jmake_arena
    from repro.core.structures import bst as jbst
    from repro.core.structures import btree as jbtree
    from repro.core.structures import hash_table as jhash
    from repro.core.structures import isa_programs as jprogs
    from repro.core.structures import linked_list as jlist
except ImportError:  # the card's machine has no JAX; its gpu test needs none
    jax = None
from repro_torch.core import arena as tarena
from repro_torch.core import commit as tcommit
from repro_torch.core import engine as tengine
from repro_torch.core import faults as tfaults
from repro_torch.core import isa as tisa
from repro_torch.core import iterator as titer
from repro_torch.core import routing as trouting
from repro_torch.core.structures import bst as tbst
from repro_torch.core.structures import btree as tbtree
from repro_torch.core.structures import hash_table as thash
from repro_torch.core.structures import isa_programs as tprogs
from repro_torch.core.structures import linked_list as tlist

CPU = "cpu"
INT_MIN = -(2**31)


def _carry(jar, perms=None):
    fields = [np.asarray(x) for x in (jar.data, jar.bounds, jar.perms, jar.heap)]
    if perms is not None:
        fields[2] = np.asarray(perms, np.int32)
    return tarena.arena_from_numpy(*fields, device=CPU)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_stats_equal(js, ts):
    names = [f.name for f in dataclasses.fields(js)]
    assert names == [f.name for f in dataclasses.fields(ts)]
    for name in names:
        a, b = getattr(js, name), getattr(ts, name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, (name, a, b)
    assert js.total_wire_words == ts.total_wire_words and js.ring_hops == ts.ring_hops


def _both_commit(jit_, tit, jar, jinit, tinit, *, max_iters, **kw):
    """Both packages' sequential commit from one pre-state; the outputs must
    be bit-equal.  Returns the JAX package's (records, stats, arena)."""
    jp0, js0 = jinit
    tp0, ts0 = tinit
    np.testing.assert_array_equal(np.asarray(jp0), _np(tp0), err_msg="init ptr")
    np.testing.assert_array_equal(np.asarray(js0), _np(ts0), err_msg="init scratch")
    tar = _carry(jar)
    data_before = tar.data.clone()
    jout = jcommit.sequential_commit_execute(jit_, jar, jp0, js0, max_iters=max_iters, **kw)
    tout = tcommit.sequential_commit_execute(tit, tar, tp0, ts0, max_iters=max_iters, **kw)
    assert len(jout) == len(tout)
    assert tout[0].dtype == np.int32
    np.testing.assert_array_equal(jout[0], tout[0], err_msg="records")
    _assert_stats_equal(jout[1], tout[1])
    if len(jout) == 3:
        np.testing.assert_array_equal(np.asarray(jout[2].data), tout[2].data.numpy())
        np.testing.assert_array_equal(np.asarray(jout[2].heap), tout[2].heap.numpy())
        assert torch.equal(tar.data, data_before)  # the input is never modified
    return jout


# --------------------------- mut_step_batch ----------------------------------


def _list_case(n=32, cap=128, P=1):
    b = JBuilder(cap, 4, num_shards=P, policy="interleaved" if P > 1 else "sequential")
    keys = np.arange(100, 100 + n, dtype=np.int32)
    head = jlist.build_into(b, keys, keys * 2)
    return b.finish(), head, keys


@pytest.mark.parametrize("case", ["insert_budget", "rw_local_range", "no_permission"])
def test_mut_step_batch_matches(case):
    """Every step's (ptr, scratch, status, iters, mut) equal, with the stall
    rule, the done gate, the exhausted budget and never MAXED while staged."""
    jar, head, keys = _list_case()
    W = jar.node_words
    if case == "insert_budget":
        jit_, tit = jlist.insert_iterator(), tlist.insert_iterator()
        newk = np.arange(6, dtype=np.int32) + 700
        jinit, tinit = jit_.init(newk, newk, head), tit.init(newk, newk, head)
        kw = dict(max_iters=2)
    else:
        jit_, tit = jlist.rw_iterator(), tlist.rw_iterator()
        ops = np.array([1, 0, 2, 0, 1, 0, 2, 1], np.int32)
        qk = np.where(ops == 1, np.arange(8) + 900, keys[[3, 5, 7, 9, 11, 13, 15, 17]])
        qk = qk.astype(np.int32)
        qv = np.arange(8, dtype=np.int32)
        jinit, tinit = jit_.init(ops, qk, qv, head), tit.init(ops, qk, qv, head)
        kw = (dict(max_iters=64, local_lo=0, local_hi=20) if case == "rw_local_range"
              else dict(max_iters=64, perm_ok=False))
    B = len(np.asarray(jinit[0]))
    state = [np.asarray(jinit[0]), np.asarray(jinit[1]),
             np.zeros(B, np.int32), np.zeros(B, np.int32),
             np.zeros((B, tarena.mut_width(W)), np.int32)]
    assert tarena.mut_width(W) == W + tarena.MUT_EXTRA == W + 4
    tstate = [torch.from_numpy(x.copy()) for x in state]
    jstate = [jnp.asarray(x) for x in state]
    jstep = jax.jit(lambda *a: jiter.mut_step_batch(jit_, jar.data, *a, **kw))
    data = torch.from_numpy(np.array(jar.data))
    for step in range(48):
        jstate = list(jstep(*jstate))
        tstate = list(titer.mut_step_batch(tit, data, *tstate, **kw))
        for name, a, b in zip(("ptr", "scratch", "status", "iters", "mut"), jstate, tstate):
            assert b.dtype == torch.int32, name
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f"{name} @{step}")
        if case == "insert_budget":
            # the commit never runs here: staged records stay ACTIVE, stalled
            st, mut = tstate[2].numpy(), tstate[4].numpy()
            assert (mut[st == titer.STATUS_MAXED, 0] == 0).all()
    if case == "insert_budget":
        assert (tstate[2].numpy() == titer.STATUS_MAXED).any()


# ------------------------------ the store class -------------------------------

_MUT_OPS = [
    jisa.LOADN, jisa.LOADS, jisa.STORES, jisa.ADD, jisa.MOVI, jisa.MOVE, jisa.GETPTR,
    jisa.JEQ, jisa.JLT, jisa.JMP, jisa.STOREN, jisa.ALLOC, jisa.SETPTR, jisa.FREE,
] if jax is not None else []


def _random_mut_program(rng, T, W, S):
    """A random forward-jump-only program that reaches the store class, with
    node indices over the whole row (so at W = 40 some are >= 32) and a few
    out of range (the VM clamps them)."""
    rows = []
    for i in range(T - 1):
        op = int(rng.choice(_MUT_OPS))
        a, b = (int(x) for x in rng.integers(0, jisa.NUM_REGS, 2))
        if op in (jisa.JEQ, jisa.JLT, jisa.JMP):
            imm = int(rng.integers(i + 1, T + 1))
        elif op in (jisa.LOADN, jisa.STOREN, jisa.SETPTR):
            imm = int(rng.integers(-2, W + 3))
        elif op in (jisa.LOADS, jisa.STORES, jisa.ALLOC):
            imm = int(rng.integers(0, S))
        elif op == jisa.MOVI:
            imm = int(rng.choice([rng.integers(-50, 50), INT_MIN, -1]))
        else:
            imm = int(rng.integers(0, jisa.NUM_REGS))
        rows.append([op, a, b, imm])
    rows.append([int(rng.choice([jisa.RETURN, jisa.NEXT_ITER])),
                 int(rng.integers(0, jisa.NUM_REGS)), 0, 0])
    return np.asarray(rows, np.int32)


_JAX_MUT_VM = (jax.jit(jax.vmap(jisa.run_iteration_mut, in_axes=(None, 0, 0, 0)))
               if jax is not None else None)


def _both_mut_vms(code, nodes, ptr, scr):
    jd, jp, js, jm = _JAX_MUT_VM(jnp.asarray(code), nodes, ptr, scr)
    td, tp, ts, tm = tisa.run_iteration_mut(
        code, torch.from_numpy(nodes), torch.from_numpy(ptr), torch.from_numpy(scr))
    return (jd, jp, js, *jm), (td, tp, ts, *tm)


@pytest.mark.parametrize("W", [4, 40])
def test_store_class_vm_matches_on_random_programs(W):
    """The staged mutation (op, target, mask, expect, data) of every lane
    equals the JAX VM's, at W = 40 with node indices >= 32 too: the int32
    mask bit ``1 << k`` is 0 there in both."""
    rng = np.random.default_rng(W)
    S, B, T = 3, 24, 12
    wide = 0
    for _ in range(30):
        code = _random_mut_program(rng, T, W, S)
        nodes = rng.integers(-60, 60, (B, W)).astype(np.int32)
        ptr = rng.integers(0, 100, B).astype(np.int32)
        scr = rng.integers(-60, 60, (B, S)).astype(np.int32)
        jout, tout = _both_mut_vms(code, nodes, ptr, scr)
        for name, a, b in zip(("done", "ptr", "scratch", "m_op", "m_tgt", "m_mask",
                               "m_expect", "m_data"), jout, tout):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f"{name}\n{code}")
        wide += int(((code[:, 0] == jisa.STOREN) & (code[:, 3] >= 32)).any())
    assert W == 4 or wide > 0  # the shift past the word was exercised


def _wide_store_program(asm_mod, words):
    """Stage one STORE of words 31 and 35 (value 7), then finish on the
    iteration after its commit (SP[0] flags the second visit)."""
    a = asm_mod.Asm(scratch_words=1, node_words=40, name="wide_store")
    a.loads(0, 0)
    a.movi(1, 1)
    a.jeq(0, 1, "done")
    a.stores(0, 1)
    a.movi(2, 7)
    for w in words:
        a.storen(w, 2)
    a.getptr(3)
    a.next_iter(3)
    a.label("done")
    a.ret()
    return a.finish()


@pytest.mark.parametrize("words", [(31, 35), (30, 35), (33,)])
def test_commit_widens_a_mask_with_bit_31_by_sign(words):
    """A mask with bit 31 set is widened by sign in the commit, so it also
    writes words 32..W-1 (from the staged image, zeros but word 35 here);
    without bit 31 nothing past word 31 is written."""
    b = JBuilder(16, 40)
    b.alloc(16)
    b.write(np.arange(16), np.full((16, 40), 5, np.int32))
    jar = b.finish()
    jit_ = jisa.as_pulse_iterator(_wide_store_program(jisa, words), verify=False)
    tit = tisa.as_pulse_iterator(_wide_store_program(tisa, words), verify=False)
    assert jit_.mutates and tit.mutates
    p0 = np.array([2, 5, 9], np.int32)
    s0 = np.zeros((3, 1), np.int32)
    _, st, jout = _both_commit(jit_, tit, jar, (p0, s0), (torch.from_numpy(p0),
                                                           torch.from_numpy(s0)), max_iters=16)
    row = np.asarray(jout.data)[5]
    if 31 in words:
        assert row[31] == 7 and row[35] == 7 and (row[32:35] == 0).all() and (row[36:] == 0).all()
    else:
        assert (row[32:] == 5).all() and st.commits == 3


@pytest.mark.parametrize("name", ["storen", "alloc", "setptr", "free"])
def test_vm_store_class_ops_match(name):
    """The four store-class cases of tests/test_write_path.py, one lane each,
    in both VMs."""
    def prog(m):
        a = m.Asm(scratch_words=2, node_words=4)
        if name == "storen":
            a.movi(1, 42)
            a.storen(2, 1)
            a.movi(2, 5)
            a.next_iter(2)
        elif name == "alloc":
            a.movi(1, 7)
            a.storen(0, 1)
            a.alloc(1)
            a.getptr(2)
            a.next_iter(2)
        elif name == "setptr":
            a.movi(1, 33)
            a.movi(2, 11)
            a.setptr(2, 1, 2)
            a.getptr(3)
            a.next_iter(3)
        else:
            a.movi(1, 13)
            a.free(1)
            a.ret()
        return a.finish()

    jp, tp = prog(jisa), prog(tisa)
    np.testing.assert_array_equal(jp.code, tp.code)
    assert jp.mutates and tp.mutates
    nodes = np.arange(8, dtype=np.int32).reshape(2, 4)
    jout, tout = _both_mut_vms(tp.code, nodes, np.array([9, 4], np.int32),
                               np.zeros((2, 2), np.int32))
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ------------------------ the sequential commit, one shard --------------------


def _small_list(n=12, cap=64):
    b = JBuilder(cap, 4)
    keys = np.arange(100, 100 + n, dtype=np.int32)
    head = jlist.build_into(b, keys, keys * 2)
    return b.finish(), head, keys


def test_insert_then_find():
    jar, head, keys = _small_list()
    newk = np.array([7, 8, 9], np.int32)
    jit_, tit = jlist.insert_iterator(), tlist.insert_iterator()
    rec, st, jar2 = _both_commit(jit_, tit, jar, jit_.init(newk, newk * 5, head),
                                 tit.init(newk, newk * 5, head), max_iters=200)
    assert (rec[:, trouting.F_STATUS] == titer.STATUS_DONE).all()
    assert st.commits >= 2 * len(newk)
    # the committed arena, read back through the port's read path
    fit = tlist.find_iterator()
    fp, fs = fit.init(torch.from_numpy(newk), head)
    _, scr, _, _ = titer.execute_batched(fit, _carry(jar2), fp, fs, max_iters=200)
    np.testing.assert_array_equal(scr[:, 1].numpy(), newk * 5)


def test_delete_frees_and_realloc_reuses():
    jar, head, keys = _small_list()
    dk = np.array([keys[3], keys[7]], np.int32)
    jd, td = jlist.delete_iterator(), tlist.delete_iterator()
    rec, _, jar2 = _both_commit(jd, td, jar, jd.init(dk, head), td.init(dk, head),
                                max_iters=200)
    assert (rec[:, trouting.F_SCRATCH + tlist.RW_RES] == 1).all()
    heap = np.asarray(jar2.heap)
    assert heap[0, tarena.H_FREE] != tarena.NULL
    ji, ti = jlist.insert_iterator(), tlist.insert_iterator()
    k, v = np.array([999], np.int32), np.array([1], np.int32)
    rec2, _, jar3 = _both_commit(ji, ti, jar2, ji.init(k, v, head), ti.init(k, v, head),
                                 max_iters=200)
    assert int(rec2[0, trouting.F_SCRATCH + tlist.RW_RES]) == int(heap[0, tarena.H_FREE])
    assert int(np.asarray(jar3.heap)[0, tarena.H_BUMP]) == int(heap[0, tarena.H_BUMP])


def test_interleaved_rw_single_shard():
    jar, head, keys = _small_list(n=16, cap=128)
    ops = np.array([1, 0, 1, 0, 1, 0, 1, 0], np.int32)
    qk = np.where(ops == 1, np.arange(8) + 500, keys[:8]).astype(np.int32)
    qv = (np.arange(8) + 40).astype(np.int32)
    jit_, tit = jlist.rw_iterator(), tlist.rw_iterator()
    rec, _, _ = _both_commit(jit_, tit, jar, jit_.init(ops, qk, qv, head),
                             tit.init(ops, qk, qv, head), max_iters=500)
    scr = rec[:, trouting.F_SCRATCH:]
    assert (scr[ops == 0, tlist.RW_RES] == 1).all()


def test_maxed_budget_single_shard():
    """A budget that runs out mid-insert: MAXED records with no payload."""
    jar, head, _ = _small_list(n=32, cap=128)
    newk = np.arange(4, dtype=np.int32) + 700
    jit_, tit = jlist.insert_iterator(), tlist.insert_iterator()
    rec, _, _ = _both_commit(jit_, tit, jar, jit_.init(newk, newk, head),
                             tit.init(newk, newk, head), max_iters=9)
    assert (rec[:, trouting.F_STATUS] == titer.STATUS_MAXED).any()


@pytest.mark.parametrize("route", ["torch", "isa"])
def test_bst_update_torch_and_isa(route):
    """``bst.update_iterator`` and the ISA ``bst_update_program`` through
    ``as_pulse_iterator``, each equal to its JAX counterpart, and the ISA
    route equal to the torch one."""
    rng = np.random.default_rng(21)
    keys = np.sort(rng.choice(np.arange(10**4), 48, replace=False).astype(np.int32))
    b = JBuilder(64, 4)
    root, _ = jbst.build_into(b, keys, np.arange(48, dtype=np.int32))
    jar = b.finish()
    q = np.concatenate([keys[:10], [77777]]).astype(np.int32)
    nv = (np.arange(len(q)) + 300).astype(np.int32)
    jtr, ttr = jbst.update_iterator(), tbst.update_iterator()
    init = (jtr.init(q, nv, root), ttr.init(torch.from_numpy(q), torch.from_numpy(nv), root))
    if route == "isa":
        jit_ = jisa.as_pulse_iterator(jprogs.bst_update_program())
        tit = tisa.as_pulse_iterator(tprogs.bst_update_program())
        rec, _, _ = _both_commit(jit_, tit, jar, *init, max_iters=200)
        rec_t, _, _ = _both_commit(jtr, ttr, jar, *init, max_iters=200)
        np.testing.assert_array_equal(rec, rec_t)
    else:
        rec, _, _ = _both_commit(jtr, ttr, jar, *init, max_iters=200)
    assert rec[-1, trouting.F_SCRATCH + tbst.U_FOUND] == 0


# ------------------- the write_checks workloads, 1 and 8 shards --------------


def _builders(P, cap, W):
    pol = "interleaved" if P > 1 else "sequential"
    return JBuilder(cap, W, num_shards=P, policy=pol), tarena.ArenaBuilder(
        cap, W, num_shards=P, policy=pol)


def _assert_same_arena(jar, tar):
    for f in ("data", "bounds", "perms", "heap"):
        np.testing.assert_array_equal(np.asarray(getattr(jar, f)), getattr(tar, f).numpy(), f)


def _chain_mixed_rw(P, rng):
    n, B = 64, 48
    keys = np.arange(10, 10 + n, dtype=np.int32)
    jb, tb = _builders(P, 256, 4)
    head = jlist.build_into(jb, keys, keys * 3)
    assert tlist.build_into(tb, keys, keys * 3) == head
    jar = jb.finish()
    _assert_same_arena(jar, tb.finish(device=CPU))
    ops = np.tile([1, 0, 2, 0], B // 4).astype(np.int32)
    # victim discipline: every 4th middle key (no list-adjacent victims)
    del_keys = keys[4 : 4 + 4 * (B // 4) : 4]
    find_keys = keys[np.setdiff1d(rng.permutation(n)[:B], np.arange(4, n, 4))][: B // 2]
    qk = np.empty(B, np.int32)
    qk[ops == 1] = np.arange(B // 4) + 1000
    qk[ops == 2] = del_keys[: B // 4]
    qk[ops == 0] = np.resize(find_keys, B // 2)
    qv = (np.arange(B) + 7).astype(np.int32)
    return (jlist.rw_iterator(), tlist.rw_iterator(), jar, (ops, qk, qv, head), 4096)


def _hash_mixed_rw(P, rng):
    n, B, NB = 48, 32, 16
    keys = rng.choice(np.arange(100, 10_000), n, replace=False).astype(np.int32)
    jb, tb = _builders(P, 256, 4)
    sent = jhash.build_writable(jb, keys, keys + 1, NB)
    np.testing.assert_array_equal(thash.build_writable(tb, keys, keys + 1, NB), sent)
    jar = jb.finish()
    _assert_same_arena(jar, tb.finish(device=CPU))
    ops = np.tile([1, 0, 2, 0], B // 4).astype(np.int32)
    # one delete per bucket; inserts into buckets with no delete
    kb = jhash._np_hash(keys, NB)
    del_keys, used = [], set()
    for k, bk in zip(keys, kb):
        if int(bk) not in used:
            del_keys.append(int(k))
            used.add(int(bk))
        if len(del_keys) == B // 4:
            break
    ins_keys, cand = [], 20_000
    while len(ins_keys) < B // 4:
        if int(jhash._np_hash(np.asarray([cand], np.int32), NB)[0]) not in used:
            ins_keys.append(cand)
        cand += 1
    find_keys = [int(k) for k in keys if int(k) not in set(del_keys)][: B // 2]
    qk = np.empty(B, np.int32)
    qk[ops == 1] = ins_keys
    qk[ops == 2] = del_keys
    qk[ops == 0] = np.resize(np.asarray(find_keys, np.int32), B // 2)
    qv = (np.arange(B) + 5).astype(np.int32)
    return (jhash.rw_iterator(NB), thash.rw_iterator(NB), jar, (ops, qk, qv, sent), 4096)


def _tree_update(mod_j, mod_t, W):
    def make(P, rng):
        n = 96
        keys = np.sort(rng.choice(np.arange(10**5), n, replace=False)).astype(np.int32)
        vals = np.arange(n, dtype=np.int32)
        jb, tb = _builders(P, 256, W)
        root, _ = mod_j.build_into(jb, keys, vals)
        assert mod_t.build_into(tb, keys, vals)[0] == root
        jar = jb.finish()
        _assert_same_arena(jar, tb.finish(device=CPU))
        # three writers race on keys[0]: the commit order decides the survivor
        q = np.concatenate([[keys[0]] * 3, keys[1:20], keys[-2:]]).astype(np.int32)
        nv = (np.arange(len(q)) + 9000).astype(np.int32)
        return (mod_j.update_iterator(), mod_t.update_iterator(), jar, (q, nv, root), 1024)
    return make


def _perm_fault(P, rng):
    n = 32
    jb = JBuilder(128, 4, num_shards=P, policy="interleaved" if P > 1 else "sequential")
    keys = np.arange(10, 10 + n, dtype=np.int32)
    head = jlist.build_into(jb, keys, keys)
    data = jb.data.copy()
    heap = np.asarray(jb.finish().heap)
    # write revoked on every shard: every ALLOC commit faults
    jar = jmake_arena(data, num_shards=P, perms=[1] * P, heap=heap)
    k = np.arange(8, dtype=np.int32) + 500
    return (jlist.insert_iterator(), tlist.insert_iterator(), jar,
            (k, np.arange(8, dtype=np.int32), head), 512)


def _alloc_exhaustion(P, rng):
    n = 16
    cap = ((n + P - 1) // P) * P  # exactly full after the build
    jb = JBuilder(cap, 4, num_shards=P, policy="interleaved" if P > 1 else "sequential")
    keys = np.arange(10, 10 + n, dtype=np.int32)
    head = jlist.build_into(jb, keys, keys)
    k = np.arange(4, dtype=np.int32) + 900
    return (jlist.insert_iterator(), tlist.insert_iterator(), jb.finish(),
            (k, np.arange(4, dtype=np.int32), head), 512)


WORKLOADS = {
    "chain_mixed_rw": _chain_mixed_rw,
    "hash_mixed_rw": _hash_mixed_rw,
    "bst_update": _tree_update(jbst, tbst, 4) if jax is not None else None,
    "btree_update": _tree_update(jbtree, tbtree, 20) if jax is not None else None,
    "perm_fault": _perm_fault,
    "alloc_exhaustion": _alloc_exhaustion,
}


@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("name", list(WORKLOADS))
def test_write_checks_workloads_match(name, P):
    jit_, tit, jar, args, max_iters = WORKLOADS[name](P, np.random.default_rng(11))
    targs = [torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray) else a for a in args]
    rec, st, jout = _both_commit(jit_, tit, jar, jit_.init(*args), tit.init(*targs),
                                 max_iters=max_iters)
    status = rec[:, trouting.F_STATUS]
    if name in ("perm_fault", "alloc_exhaustion"):
        assert (status == titer.STATUS_FAULT).all()
        np.testing.assert_array_equal(np.asarray(jout.data), np.asarray(jar.data))
    else:
        assert (status == titer.STATUS_DONE).all() and st.commits > 0
    if P > 1 and name == "chain_mixed_rw":
        assert st.crossings.sum() > 0 and st.total_wire_words > 0


def test_read_only_iterator_and_replication():
    """A read-only iterator gives (records, stats) as in the JAX package,
    and so does the read fan-out to replicas (item 6(d)): failover with
    shard 3 dead, records (hops included) and every stat bit-equal."""
    jar, head, keys = _list_case(P=8)
    q = keys[::3].copy()
    jit_, tit = jlist.find_iterator(), tlist.find_iterator()
    out = _both_commit(jit_, tit, jar, jit_.init(jnp.asarray(q), head),
                       tit.init(torch.from_numpy(q), head), max_iters=4096)
    assert len(out) == 2 and out[1].supersteps > 1
    data, bounds = np.asarray(jar.data), np.asarray(jar.bounds)
    dead = np.zeros(8, bool)
    dead[3] = True
    ctx = []
    for mod in (jrouting, trouting):
        plan = mod.make_replica_plan(8)
        rows = np.zeros_like(data)
        for h, p in enumerate(plan.primary_map):
            rows[bounds[h]:bounds[h + 1]] = data[bounds[p]:bounds[p + 1]]
        ctx.append(mod.ReplicaContext(plan, rows, dead))
    jrec, jst = jcommit.sequential_commit_execute(jit_, jar, *jit_.init(jnp.asarray(q), head),
                                                  max_iters=4096, replication=ctx[0])
    trec, tst = tcommit.sequential_commit_execute(tit, _carry(jar),
                                                  *tit.init(torch.from_numpy(q), head),
                                                  max_iters=4096, replication=ctx[1])
    np.testing.assert_array_equal(jrec, trec)
    assert tst.supersteps == jst.supersteps and tst.routed_per_step == jst.routed_per_step
    np.testing.assert_array_equal(jrec[:, trouting.F_STATUS], out[0][:, trouting.F_STATUS])


# --------------------------------- the engine ---------------------------------


def test_engine_swaps_in_the_committed_arena():
    """``PulseEngine.execute`` of a mutating iterator (the default backend)
    equals the JAX engine's, swaps its arena, leaves the input untouched,
    and reports the commit trace."""
    jar, head, keys = _small_list(n=16, cap=128)
    ops = np.array([1, 0, 2, 0, 1], np.int32)
    qk = np.array([500, keys[2], keys[5], keys[9], 501], np.int32)
    qv = np.arange(5, dtype=np.int32)
    jit_, tit = jlist.rw_iterator(), tlist.rw_iterator()
    jeng = jengine.PulseEngine(jar)
    jres = jeng.execute(jit_, *jit_.init(ops, qk, qv, head), max_iters=500)
    tar = _carry(jar)
    before = (tar.data.clone(), tar.heap.clone())
    teng = tengine.PulseEngine(tar)
    tres = teng.execute(tit, *tit.init(ops, qk, qv, head), max_iters=500)
    for f in ("ptr", "scratch", "status", "iters"):
        np.testing.assert_array_equal(np.asarray(getattr(jres, f)), getattr(tres, f).numpy(), f)
    _assert_stats_equal(jres.stats, tres.stats)
    assert teng.arena is tres.arena and teng.arena is not tar
    np.testing.assert_array_equal(np.asarray(jeng.arena.data), tres.arena.data.numpy())
    np.testing.assert_array_equal(np.asarray(jeng.arena.heap), tres.arena.heap.numpy())
    assert torch.equal(tar.data, before[0]) and torch.equal(tar.heap, before[1])
    tr = tres.commit_trace
    assert len(tr.chase_s) == tres.stats.supersteps == len(tr.h2d_bytes)
    assert sum(tr.rows_written) > 0
    # the read path on the swapped arena finds the insert, not the delete
    fit = tlist.find_iterator()
    res = teng.execute(fit, *fit.init(torch.tensor([500, 501, int(keys[5])]), head),
                       max_iters=500)
    np.testing.assert_array_equal(res.scratch[:, 2].numpy(), [1, 1, 0])


def test_engine_fault_injector_kill_leaves_the_arena():
    """A kill before superstep 3 raises in both packages, and neither engine
    publishes a partial arena."""
    jar, head, keys = _small_list(n=16, cap=128)
    newk = np.array([800, 801], np.int32)
    plan = jfaults.FaultPlan(kill_shard=0, kill_call=1, kill_superstep=3)
    jit_, tit = jlist.insert_iterator(), tlist.insert_iterator()
    tar = _carry(jar)
    teng = tengine.PulseEngine(tar, fault_injector=tfaults.FaultInjector(
        tfaults.FaultPlan(**dataclasses.asdict(plan))))
    jeng = jengine.PulseEngine(jar, fault_injector=jfaults.FaultInjector(plan))
    fit = tlist.find_iterator()
    teng.execute(fit, *fit.init(torch.from_numpy(newk), head), max_iters=100)  # call 0
    jfit = jlist.find_iterator()
    jeng.execute(jfit, *jfit.init(jnp.asarray(newk), head), max_iters=100)
    for eng, it, init, failure in ((jeng, jit_, jit_.init(newk, newk, head),
                                    jfaults.ShardFailure),
                                   (teng, tit, tit.init(newk, newk, head),
                                    tfaults.ShardFailure)):
        with pytest.raises(failure) as e:
            eng.execute(it, *init, max_iters=100)
        assert e.value.superstep == 3
    assert teng.arena is tar and jeng.arena is jar
    np.testing.assert_array_equal(tar.data.numpy(), np.asarray(jar.data))
    # the kill fires once: the next call commits
    res = teng.execute(tit, *tit.init(newk, newk, head), max_iters=100)
    assert (res.status.numpy() == titer.STATUS_DONE).all() and teng.arena is res.arena


# ---------------------------------- the card ----------------------------------


@pytest.mark.gpu
def test_write_batch_on_card_matches_cpu():
    """One mixed find/insert/delete batch over a writable hash table through
    ``PulseEngine.execute`` on a CUDA arena (the chase on the card) and on a
    CPU copy: records, stats, final data and heap bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with pytest -m gpu")
    rng = np.random.default_rng(3)
    NB, n = 64, 2000
    keys = rng.choice(np.arange(10**6), n, replace=False).astype(np.int32)
    b = tarena.ArenaBuilder(n + NB + 512, 4)
    sent = thash.build_writable(b, keys, keys + 1, NB)
    kb = thash._np_hash(keys, NB)
    victims = np.array([keys[np.flatnonzero(kb == bk)[0]] for bk in range(0, NB, 2)], np.int32)
    ins = np.arange(2 * 10**6, 2 * 10**6 + 256, dtype=np.int32)
    finds = rng.choice(np.setdiff1d(keys, victims), 512).astype(np.int32)
    ops = np.concatenate([np.zeros(512), np.ones(256), np.full(len(victims), 2)]).astype(np.int32)
    qk = np.concatenate([finds, ins, victims]).astype(np.int32)
    it = thash.rw_iterator(NB)
    results = []
    for dev in ("cuda", "cpu"):
        ar = b.finish(device=dev)
        eng = tengine.PulseEngine(ar)
        res = eng.execute(it, *it.init(ops, qk, qk * 3, sent), max_iters=4096)
        results.append((res, eng.arena))
    (g, ga), (c, ca) = results
    assert ga.data.is_cuda and g.ptr.is_cuda
    for f in ("ptr", "scratch", "status", "iters"):
        assert torch.equal(getattr(g, f).cpu(), getattr(c, f)), f
    assert torch.equal(ga.data.cpu(), ca.data) and torch.equal(ga.heap.cpu(), ca.heap)
    assert (g.stats.supersteps, g.stats.commits, g.stats.epochs) == (
        c.stats.supersteps, c.stats.commits, c.stats.epochs)
    assert (c.status == titer.STATUS_DONE).all()
