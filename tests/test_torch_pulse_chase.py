"""Port parity: the pulse_chase kernel's plain version and the wave scheduler.

On the CPU the port's ``pulse_chase`` runs its plain version
(``ref.chase_reference``); it must equal the JAX package's Pallas kernel in
interpret mode bit for bit on the ``tests/test_kernels.py`` workloads.

ISA-backed logic is held against the JAX package's ``use_pallas=False``
path (its ``chase_reference``) instead: the interpreted Pallas kernel
refuses it (``pallas_call`` raises ``ValueError: ... captures constants``,
because the program's code array is closed over by the logic), and
``tests/test_kernels.py`` already holds that path equal to the kernel.

The CUDA kernel itself is held against the plain version on the card by
the test marked ``gpu`` (``pytest -m gpu`` there)."""

import dataclasses
import re

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from repro.core import isa as jisa
    from repro.core.structures import btree as jbtree
    from repro.core.structures import hash_table as jhash
    from repro.core.structures import isa_programs as jprogs
    from repro.core.structures import linked_list as jlist
    from repro.kernels.pulse_chase import ops as jops
except ImportError:  # the card's machine has no JAX; its gpu test needs none
    jnp = None
from repro_torch.core import arena as tarena
from repro_torch.core import isa as tisa
from repro_torch.core import iterator as titer
from repro_torch.core.structures import btree as tbtree
from repro_torch.core.structures import hash_table as thash
from repro_torch.core.structures import isa_programs as tprogs
from repro_torch.core.structures import linked_list as tlist
from repro_torch.kernels.pulse_chase import ops as tops
from repro_torch.kernels.pulse_chase import ref as tref

CPU = "cpu"
FIELDS = ("ptr", "scratch", "status", "iters")


def _to_torch_arena(jar):
    return tarena.arena_from_numpy(
        *(np.asarray(x) for x in (jar.data, jar.bounds, jar.perms, jar.heap)), device=CPU
    )


def _t(x):
    return torch.from_numpy(np.asarray(x, np.int32).copy())


def _assert_lanes_equal(jout, tout):
    for name, a, b in zip(FIELDS, jout, tout):
        assert b.dtype == torch.int32, name
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


def _btree_case(rng, n_keys, n_queries):
    keys = rng.choice(np.arange(10**5), size=n_keys, replace=False).astype(np.int32)
    values = rng.integers(0, 10**6, n_keys).astype(np.int32)
    jar, root, height = jbtree.build(keys, values)
    q = np.concatenate(
        [keys[: n_queries // 2], rng.integers(10**5, 10**6, n_queries // 2).astype(np.int32)]
    )
    return jar, root, height, q


@pytest.mark.parametrize("wave", [4, 8])
@pytest.mark.parametrize("n_keys,n_queries", [(128, 16), (512, 32)])
def test_plain_chase_matches_pallas_interpret_btree(wave, n_keys, n_queries):
    rng = np.random.default_rng(42 + n_keys + wave)
    jar, root, height, q = _btree_case(rng, n_keys, n_queries)
    jit_ = jbtree.find_iterator()
    ptr0, scr0 = jit_.init(jnp.asarray(q), root)
    st0 = np.zeros(n_queries, np.int32)
    jout = jops.pulse_chase(jar.data, ptr0, scr0, st0, logic_fn=jops.iterator_logic(jit_),
                            num_steps=height, wave=wave, use_pallas=True, interpret=True)
    tar = _to_torch_arena(jar)
    tit = tbtree.find_iterator()
    tp0, ts0 = tit.init(_t(q), root)
    np.testing.assert_array_equal(np.asarray(ptr0), tp0.numpy())
    np.testing.assert_array_equal(np.asarray(scr0), ts0.numpy())
    tout = tops.pulse_chase(tar.data, tp0, ts0, _t(st0), logic_fn=tops.iterator_logic(tit),
                            num_steps=height)
    _assert_lanes_equal(jout, tout)
    assert (tout[2] == 1).all()
    found = tout[1][:, 2].numpy()
    assert found[: n_queries // 2].all() and not found[n_queries // 2 :].any()


def test_plain_chase_matches_pallas_interpret_hash_chain():
    rng = np.random.default_rng(7)
    keys = rng.choice(np.arange(10**5), size=256, replace=False).astype(np.int32)
    values = rng.integers(0, 10**6, 256).astype(np.int32)
    jar, heads = jhash.build(keys, values, 32)
    q = np.concatenate([keys[:24], rng.integers(10**5, 10**6, 8).astype(np.int32)])
    jit_ = jhash.find_iterator(32)
    ptr0, scr0 = jit_.init(jnp.asarray(q), jnp.asarray(heads))
    st0 = np.zeros(32, np.int32)
    it0 = np.arange(32, dtype=np.int32)  # counts accumulate on top of these
    for steps in (3, 32):
        jout = jops.pulse_chase(jar.data, ptr0, scr0, st0, it0,
                                logic_fn=jops.iterator_logic(jit_), num_steps=steps,
                                use_pallas=True, interpret=True)
        tit = thash.find_iterator(32)
        tp0, ts0 = tit.init(_t(q), heads)
        tout = tops.pulse_chase(_to_torch_arena(jar).data, tp0, ts0, _t(st0), _t(it0),
                                logic_fn=tops.iterator_logic(tit), num_steps=steps)
        _assert_lanes_equal(jout, tout)


def _isa_case(name, rng):
    """(JAX arena, numpy ptr0/scr0) for an ISA find over its structure,
    including lanes that start NULL, past the arena's end, or retired."""
    keys = rng.choice(np.arange(10**5), size=300, replace=False).astype(np.int32)
    vals = rng.integers(0, 10**6, 300).astype(np.int32)
    q = np.concatenate([keys[:40], rng.integers(10**5, 10**6, 24).astype(np.int32)])
    if name in ("list_find",):
        jar, head = jlist.build(keys[:60], vals[:60])
        ptr0, scr0 = jlist.find_iterator().init(jnp.asarray(q), head)
    elif name == "hash_find":
        jar, heads = jhash.build(keys, vals, 16)
        ptr0, scr0 = jhash.find_iterator(16).init(jnp.asarray(q), jnp.asarray(heads))
    elif name == "bst_find":
        from repro.core.structures import bst as jbst

        jar, root, _ = jbst.build(keys, vals)
        ptr0, scr0 = jbst.find_iterator().init(jnp.asarray(q), root)
    else:
        jar, root, _ = jbtree.build(keys, vals)
        ptr0, scr0 = jbtree.find_iterator().init(jnp.asarray(q), root)
    ptr0 = np.asarray(ptr0).copy()
    ptr0[[1, 5]] = [-1, jar.capacity + 3]
    st0 = np.zeros(ptr0.shape[0], np.int32)
    st0[7] = 1
    return jar, ptr0, np.asarray(scr0), st0


@pytest.mark.parametrize("name", ["list_find", "hash_find", "bst_find", "btree_find"])
def test_plain_chase_matches_reference_on_isa_programs(name):
    rng = np.random.default_rng(len(name))
    jar, ptr0, scr0, st0 = _isa_case(name, rng)
    jprog = jprogs.all_programs()[name]
    jlogic = jops.iterator_logic(jisa.as_pulse_iterator(jprog))
    tlogic = tops.iterator_logic(tisa.as_pulse_iterator(tprogs.all_programs()[name]))
    assert tlogic.program is not None
    # a cut mid-traversal: lanes still running, done and faulted side by side
    # (whole traversals are held equal end to end in test_torch_engine.py)
    steps = 2 if name == "btree_find" else 6
    jout = jops.pulse_chase(jar.data, ptr0, scr0, st0, logic_fn=jlogic,
                            num_steps=steps, use_pallas=False)
    tout = tops.pulse_chase(_to_torch_arena(jar).data, _t(ptr0), _t(scr0), _t(st0),
                            logic_fn=tlogic, num_steps=steps)
    _assert_lanes_equal(jout, tout)
    assert (tout[2] == 0).any() and (tout[2] == 1).any()


def _fault_masks(cap, bounds, perms):
    def jfault(p):
        shard = np.searchsorted(bounds, p, side="right") - 1
        ok = perms[np.clip(shard, 0, perms.shape[0] - 1)] & 1
        return (p < 0) | (p >= cap) | (ok != 1)

    tb, tp = torch.tensor(bounds), torch.tensor(perms)

    def tfault(p):
        shard = torch.searchsorted(tb, p, right=True) - 1
        ok = tp[shard.clamp(0, tp.shape[0] - 1)] & 1
        return (p < 0) | (p >= cap) | (ok != 1)

    return jfault, tfault


def _assert_waves_equal(jres, tres):
    for name, a, b in zip(FIELDS[:3], jres[:3], tres[:3]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    js, ts = jres[3], tres[3]
    for f in dataclasses.fields(js):
        a, b = getattr(js, f.name), getattr(ts, f.name)
        if isinstance(b, torch.Tensor):
            b = b.numpy()
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f.name)
    assert js.savings == ts.savings


def _faulting_case():
    """The skewed, faulting case: hash chains over two shards with shard 0
    revoked, a NULL entry and one past the arena's end."""
    rng = np.random.default_rng(11)
    keys = rng.choice(np.arange(10**5), size=96, replace=False).astype(np.int32)
    vals = rng.integers(0, 10**6, 96).astype(np.int32)
    jar, heads = jhash.build(keys, vals, 5, num_shards=2)
    perms = np.array([0, 1], np.int32)
    q = np.concatenate([keys[:30], rng.integers(10**5, 10**6, 10).astype(np.int32)])
    ptr0, scr0 = jhash.find_iterator(5).init(jnp.asarray(q), jnp.asarray(heads))
    ptr0 = np.asarray(ptr0).copy()
    ptr0[[0, 3]] = [-1, 500]
    return jar, perms, ptr0, np.asarray(scr0), np.zeros(40, np.int32)


@pytest.mark.parametrize("use_isa", [False, True])
def test_waves_with_fault_fn_match_reference(use_isa):
    """Skewed chain depths, a revoked shard, NULL and out-of-range entries:
    ptr, scratch, status and every WaveStats field must agree."""
    jar, perms, ptr0, scr0, st0 = _faulting_case()
    jfault, tfault = _fault_masks(jar.capacity, np.asarray(jar.bounds), perms)
    if use_isa:
        jlogic = jops.iterator_logic(jisa.as_pulse_iterator(jprogs.hash_find_program()))
        tlogic = tops.iterator_logic(tisa.as_pulse_iterator(tprogs.hash_find_program()))
        kw = dict(use_pallas=False)
        configs = ((64, 8),)
    else:
        jlogic = jops.iterator_logic(jhash.find_iterator(5))
        tlogic = tops.iterator_logic(thash.find_iterator(5))
        kw = dict(use_pallas=True, interpret=True)
        configs = ((64, 8), (13, 4))
    for max_steps, quantum in configs:
        jres = jops.pulse_chase_waves(jar.data, ptr0, scr0, st0, logic_fn=jlogic,
                                      max_steps=max_steps, depth_quantum=quantum,
                                      fault_fn=jfault, **kw)
        tres = tops.pulse_chase_waves(_to_torch_arena(jar).data, _t(ptr0), _t(scr0),
                                      _t(st0), logic_fn=tlogic, max_steps=max_steps,
                                      depth_quantum=quantum, fault_fn=tfault)
        _assert_waves_equal(jres, tres)
        assert tres[3].chunks > 1 and tres[3].faulted.any()


@pytest.mark.parametrize("max_steps,quantum", [(64, 8), (13, 4), (10, 8), (16, 8), (0, 8)])
@pytest.mark.parametrize("use_isa", [False, True])
def test_run_reference_matches_jax_waves(use_isa, max_steps, quantum):
    """``pulse_chase_run`` (its plain version on the CPU) equals the JAX wave
    scheduler bit for bit: ptr, scratch, status, iters and faulted, with
    budgets on and off the quantum."""
    jar, perms, ptr0, scr0, st0 = _faulting_case()
    jfault, _ = _fault_masks(jar.capacity, np.asarray(jar.bounds), perms)
    tar = _to_torch_arena(jar)
    check = tops.FaultCheck(tar.bounds, torch.from_numpy(perms), tar.capacity)
    if use_isa:
        jlogic = jops.iterator_logic(jisa.as_pulse_iterator(jprogs.hash_find_program()))
        tlogic = tops.iterator_logic(tisa.as_pulse_iterator(tprogs.hash_find_program()))
        kw = dict(use_pallas=False)
    else:
        jlogic = jops.iterator_logic(jhash.find_iterator(5))
        tlogic = tops.iterator_logic(thash.find_iterator(5))
        kw = dict(use_pallas=True, interpret=True)
    jres = jops.pulse_chase_waves(jar.data, ptr0, scr0, st0, logic_fn=jlogic,
                                  max_steps=max_steps, depth_quantum=quantum,
                                  fault_fn=jfault, **kw)
    tres = tops.pulse_chase_run(tar.data, _t(ptr0), _t(scr0), _t(st0), logic_fn=tlogic,
                                max_steps=max_steps, depth_quantum=quantum, fault_fn=check)
    for name, a, b in zip(FIELDS[:3], jres[:3], tres[:3]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    js, ts = jres[3], tres[3]
    np.testing.assert_array_equal(js.retire_step, ts.retire_step.numpy(), err_msg="iters")
    np.testing.assert_array_equal(js.faulted, ts.faulted.numpy(), err_msg="faulted")
    assert ts.chunks == 1 and int(ts.lane_steps) == int(js.retire_step.sum())
    assert ts.faulted.any()
    if max_steps == 10:  # a budget cut: lanes left live keep status 0
        assert (tres[2] == 0).any()


def test_fault_check_gives_the_closure_mask():
    """``FaultCheck`` is the engine's old closure as data: the same mask on
    pointers that are negative, past the end, in a revoked shard or fine."""
    bounds = torch.tensor([0, 40, 100, 160], dtype=torch.int32)
    perms = torch.tensor([3, 0, 1], dtype=torch.int32)
    cap = 160
    p = torch.arange(-5, 170, dtype=torch.int32)

    def closure(p):  # the engine's fault_fn before it became data
        shard = torch.searchsorted(bounds, p, right=True) - 1
        ok = perms[shard.clamp(0, perms.shape[0] - 1)] & tarena.PERM_READ
        return (p < 0) | (p >= cap) | (ok != tarena.PERM_READ)

    got = tops.FaultCheck(bounds, perms, cap)(p)
    assert got.dtype == torch.bool and torch.equal(got, closure(p))
    assert got[5:45].logical_not().all() and got[45:105].all()
    write = tops.FaultCheck(bounds, perms, cap, need=tarena.PERM_WRITE)(p)
    assert write[5:45].logical_not().all() and write[105:165].all()


def _structure_iterators():
    """Every iterator the read-path structure modules make, by factory."""
    import inspect

    from repro_torch.core import structures

    out = []
    for mod_name in ("linked_list", "hash_table", "bst", "btree", "skiplist"):
        mod = getattr(structures, mod_name)
        for name, fn in inspect.getmembers(mod, inspect.isfunction):
            if name.endswith("_iterator") and fn.__module__ == mod.__name__:
                args = [8] * sum(p.default is inspect.Parameter.empty
                                 for p in inspect.signature(fn).parameters.values())
                out.append((mod, name, fn(*args)))
    return out


def test_native_bodies_cover_every_structure_iterator():
    """Each non-mutating iterator of ``core/structures/`` has a native body,
    found from the iterator itself, and the body's sizes are the module's."""
    from repro_torch.kernels.pulse_chase import kernel

    found = {}
    for mod, factory, it in _structure_iterators():
        if it.mutates:
            continue
        body = kernel.native_body(it)
        assert body is not None, f"{mod.__name__}.{factory}"
        assert (body.module, body.factory) == (mod, factory)
        assert body.scratch_words == it.scratch_words
        assert tops.iterator_logic(it).native is body
        found[it.name] = body
    assert set(found) == set(kernel.NATIVE_BODIES)
    assert kernel.BODIES == ("isa", *kernel.NATIVE_BODIES)
    isa_it = tisa.as_pulse_iterator(tprogs.hash_find_program())
    assert kernel.native_body(isa_it) is None and tops.iterator_logic(isa_it).native is None


def test_kernel_takes_its_layouts_from_the_structure_modules():
    """The node-word offsets, FANOUT, NULL and KEY_NOT_FOUND reach the
    kernel as -D defines equal to the modules' constants, and the source
    names every define it is given."""
    from repro_torch.core.structures import bst as tbst
    from repro_torch.kernels.pulse_chase import kernel

    d = kernel.LAYOUT_DEFINES
    assert d["PULSE_NULL"] == tarena.NULL == -1
    for prefix, mod in (("LIST", tlist), ("HASH", thash)):
        assert (d[f"{prefix}_KEY"], d[f"{prefix}_VALUE"], d[f"{prefix}_NEXT"]) == (
            mod.KEY, mod.VALUE, mod.NEXT)
        assert d[f"{prefix}_KEY_NOT_FOUND"] == mod.KEY_NOT_FOUND
    assert d["LIST_FIND_WORDS"] == tlist.SCRATCH_WORDS and d["LIST_SUM_WORDS"] == 2
    assert (d["BST_KEY"], d["BST_VALUE"], d["BST_LEFT"], d["BST_RIGHT"]) == (
        tbst.KEY, tbst.VALUE, tbst.LEFT, tbst.RIGHT)
    assert (d["BST_S_KEY"], d["BST_S_Y"], d["BST_S_YKEY"], d["BST_S_YVAL"]) == (
        tbst.S_KEY, tbst.S_Y, tbst.S_YKEY, tbst.S_YVAL)
    for name in ("FANOUT", "IS_LEAF", "NUM_KEYS", "KEYS0", "CHILD0", "VAL0", "NEXT_LEAF",
                 "KEY_NOT_FOUND", "INT_MIN", "INT_MAX", "RA_LO", "RA_HI", "RA_SUM", "RA_MIN",
                 "RA_MAX", "RA_COUNT", "RA_WORDS"):
        assert d[f"BTREE_{name}"] == getattr(tbtree, name), name
    assert d["BTREE_ROW"] == tbtree.NEXT_LEAF + 1 <= tbtree.NODE_WORDS
    from repro_torch.core.structures import skiplist as tskip

    for name in ("LEVELS", "KEY", "VALUE", "NPTR0", "KEY_NOT_FOUND"):
        assert d[f"SKIP_{name}"] == getattr(tskip, name), name
    assert d["SKIP_FIND_WORDS"] == tskip.SCRATCH_WORDS
    assert d["SKIP_ROW"] == tskip.NPTR0 + 2 * tskip.LEVELS <= tskip.NODE_WORDS
    assert {d[f"PULSE_BODY_{b.upper()}"] for b in kernel.BODIES} == set(range(len(kernel.BODIES)))
    flags = set(kernel.NVCC_FLAGS)
    assert all(f"-D{k}={v}" in flags for k, v in d.items())
    src = kernel._SRC.read_text()
    assert all(re.search(rf"\b{k}\b", src) for k in d), "a define the source never reads"


def _walk_program(asm_mod):
    """Follow NEXT with no end test: every lane walks off the list's tail,
    so a lane retires only by its pointer turning negative."""
    a = asm_mod.Asm(scratch_words=1, node_words=4, name="walk")
    a.loadn(0, 2)
    a.next_iter(0)
    return a.finish()


def test_walking_off_the_structure_retires_lanes():
    keys = np.arange(40, dtype=np.int32)
    jar, head = jlist.build(keys, keys)
    ptr0 = np.array([head, 5, 30, 39, -1, 12, 60, 0], np.int32)
    scr0 = np.zeros((8, 1), np.int32)
    st0 = np.zeros(8, np.int32)
    jlogic = jops.iterator_logic(jisa.as_pulse_iterator(_walk_program(jisa)))
    tlogic = tops.iterator_logic(tisa.as_pulse_iterator(_walk_program(tisa)))
    jout = jops.pulse_chase(jar.data, ptr0, scr0, st0, logic_fn=jlogic, num_steps=45,
                            use_pallas=False)
    tout = tops.pulse_chase(_to_torch_arena(jar).data, _t(ptr0), _t(scr0), _t(st0),
                            logic_fn=tlogic, num_steps=45)
    _assert_lanes_equal(jout, tout)
    assert (tout[2] == 1).all() and (tout[0] < 0).all()


def test_pad_ladder_matches():
    for n in (1, 7, 8, 9, 100, 4096, 4097):
        for wave in (4, 8):
            assert tops._pad_ladder(n, wave) == jops._pad_ladder(n, wave)


def test_cuda_tensor_with_torch_logic_raises_and_never_runs_plain(monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel or raises: a
    structure's own iterator reaches the launch with its native body, and
    logic with neither an ISA program nor a native body raises (checked with
    a fake CUDA test, no card)."""
    monkeypatch.setattr(tops, "_on_cuda", lambda t: True)

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(tops, "chase_reference", no_plain)
    monkeypatch.setattr(tops, "chase_run_reference", no_plain)
    bodies = []

    def spy(arena, ptr, scratch, status, iters, code, num_steps, *, body="isa", **kw):
        bodies.append((body, code))
        return ptr, scratch, status, iters

    monkeypatch.setattr(tops._kernel, "launch", spy)
    ar, head = tlist.build(np.arange(8), np.arange(8), device=CPU)
    it = tlist.find_iterator()
    p0, s0 = it.init(torch.arange(4, dtype=torch.int32), head)
    st0 = torch.zeros(4, dtype=torch.int32)
    before = tops.pulse_chase.launches
    tops.pulse_chase(ar.data, p0, s0, st0, logic_fn=tops.iterator_logic(it), num_steps=2)
    assert bodies == [("list_find", None)] and tops.pulse_chase.launches == before + 1
    borrowed = titer.PulseIterator(3, lambda n, p, s: (n[:, 2], s),
                                   lambda n, p, s: (n[:, 2] < 0, s), name="list_find")
    for adhoc in (dataclasses.replace(it, name="adhoc"), borrowed):
        with pytest.raises(ValueError, match="ISA"):
            tops.pulse_chase(ar.data, p0, s0, st0, logic_fn=tops.iterator_logic(adhoc),
                             num_steps=2)
    assert tops.pulse_chase.launches == before + 1


def test_kernel_launch_refuses_cpu_tensors():
    ar, _ = tlist.build(np.arange(8), np.arange(8), device=CPU)
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        from repro_torch.kernels.pulse_chase import kernel

        kernel.launch(ar.data, z, torch.zeros((4, 3), dtype=torch.int32), z, z,
                      torch.zeros((2, 4), dtype=torch.int32), 1)


def test_kernel_takes_its_opcodes_from_the_isa():
    """The CUDA source keeps no opcode numbering of its own: the build
    passes core.isa's as ``-DPULSE_OP_<NAME>`` defines (covered by the
    library's hash), and the source names exactly the read-class ops."""
    from repro_torch.kernels.pulse_chase import kernel

    used = set(re.findall(r"PULSE_OP_(\w+)", kernel._SRC.read_text()))
    assert used == {name for op, name in tisa.OP_NAMES.items() if op not in tisa._MUTATORS}
    defines = dict(flag[2:].split("=") for flag in kernel.OPCODE_DEFINES)
    want = {f"PULSE_OP_{name}": str(op) for op, name in tisa.OP_NAMES.items()}
    assert defines == {**want, "PULSE_LAST_OP": str(max(tisa.ALL_OPS))}
    assert set(kernel.OPCODE_DEFINES) <= set(kernel.NVCC_FLAGS)


def _port_case(name, rng, device):
    """The port's own structure, iterator and lanes for a read iterator,
    with lanes that start NULL, past the arena's end, or retired."""
    from repro_torch.core.structures import bst as tbst

    keys = rng.choice(np.arange(10**5), size=300, replace=False).astype(np.int32)
    vals = rng.integers(-(2**31), 2**31 - 1, 300).astype(np.int32)
    q = torch.from_numpy(
        np.concatenate([keys[:40], rng.integers(10**5, 10**6, 24).astype(np.int32)]))
    if name == "list_find":
        ar, head = tlist.build(keys[:60], vals[:60], device=device)
        it = tlist.find_iterator()
        p0, s0 = it.init(q, head)
    elif name == "list_sum":
        b = tarena.ArenaBuilder(300, 4)
        heads = [tlist.build_into(b, keys[i:i + n], vals[i:i + n])
                 for i, n in ((0, 1), (1, 5), (6, 90), (96, 200))]
        ar, it = b.finish(device=device), tlist.sum_iterator()
        p0, s0 = it.init(torch.tensor(heads * 16, dtype=torch.int32))
    elif name == "hash_find":
        ar, heads = thash.build(keys, vals, 16, device=device)
        it = thash.find_iterator(16)
        p0, s0 = it.init(q, heads)
    elif name == "bst_find":
        ar, root, _ = tbst.build(keys, vals, device=device)
        it = tbst.find_iterator()
        p0, s0 = it.init(q, root)
    elif name == "btree_find":
        ar, root, _ = tbtree.build(keys, vals, device=device)
        it = tbtree.find_iterator()
        p0, s0 = it.init(q, root)
    elif name == "skiplist_find":
        from repro_torch.core.structures import skiplist as tskip

        ar, head = tskip.build(keys, vals, device=device)
        it = tskip.find_iterator()
        p0, s0 = it.init(q, head)
    else:  # btree_range_agg
        ar, root, _ = tbtree.build(keys, vals, device=device)
        it = tbtree.range_aggregate_iterator()
        lo = torch.from_numpy(rng.integers(0, 10**5, 64).astype(np.int32))
        p0, s0 = it.init(lo, lo + torch.from_numpy(rng.integers(0, 3000, 64).astype(np.int32)),
                         root)
    p0[1], p0[5] = -1, ar.capacity + 3
    st0 = torch.zeros_like(p0)
    st0[7] = 1
    return ar, it, [x.to(device) for x in (p0, s0, st0)]


NATIVE = ["list_find", "list_sum", "hash_find", "bst_find", "btree_find", "btree_range_agg",
          "skiplist_find"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["list_find", "hash_find", "bst_find", "btree_find", "walk"]
                         + [f"native_{n}" for n in NATIVE])
def test_kernel_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with pytest -m gpu")
    if name == "walk":
        ar, _, lanes = _port_case("list_find", np.random.default_rng(4), "cuda")
        lanes[1] = lanes[1][:, :1].contiguous()
        it = tisa.as_pulse_iterator(_walk_program(tisa))
    elif name.startswith("native_"):
        ar, it, lanes = _port_case(name[len("native_"):], np.random.default_rng(len(name)),
                                   "cuda")
    else:
        ar, _, lanes = _port_case(name, np.random.default_rng(len(name)), "cuda")
        it = tisa.as_pulse_iterator(tprogs.all_programs()[name])
    logic = tops.iterator_logic(it)
    assert (logic.program is None) == name.startswith("native_")
    for steps in (1, 4, 70):
        before = tops.pulse_chase.launches
        got = tops.pulse_chase(ar.data, *lanes, logic_fn=logic, num_steps=steps)
        assert tops.pulse_chase.launches == before + 1
        want = tref.chase_reference(ar.data, *lanes, torch.zeros_like(lanes[0]), logic,
                                    steps)
        torch.cuda.synchronize()
        for f, a, b in zip(FIELDS, want, got):
            assert torch.equal(a, b), f


@pytest.mark.gpu
@pytest.mark.parametrize("max_steps,quantum", [(64, 8), (13, 4), (10, 8), (0, 8)])
@pytest.mark.parametrize("name", ["hash_find", "native_hash_find", "btree_find",
                                  "native_btree_range_agg"])
def test_run_matches_reference_on_card(name, max_steps, quantum):
    """``pulse_chase_run``: one launch, the fault check on the card, equal
    to its plain version on a faulting case (shard 0 revoked, NULL and
    out-of-range entries) with budgets on and off the quantum."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with pytest -m gpu")
    base = name[len("native_"):] if name.startswith("native_") else name
    ar, it, lanes = _port_case(base, np.random.default_rng(3), "cpu")
    data = ar.data.cuda()
    quarter = ar.capacity // 4  # revoked: chains walk into it, B+tree leaves lie in it
    check = tops.FaultCheck(torch.tensor([0, quarter, ar.capacity], dtype=torch.int32).cuda(),
                            torch.tensor([0, 1], dtype=torch.int32).cuda(), ar.capacity)
    if not name.startswith("native_"):
        it = tisa.as_pulse_iterator(tprogs.all_programs()[name])
    logic = tops.iterator_logic(it)
    lanes = [x.cuda() for x in lanes]
    before = tops.pulse_chase.launches
    got = tops.pulse_chase_run(data, *lanes, logic_fn=logic, max_steps=max_steps,
                               depth_quantum=quantum, fault_fn=check)
    assert tops.pulse_chase.launches == before + 1
    want = tref.chase_run_reference(data, *lanes, logic, max_steps, quantum, check)
    torch.cuda.synchronize()
    for f, a, b in zip(FIELDS[:3], want[:3], got[:3]):
        assert torch.equal(a, b), f
    assert torch.equal(want[3], got[3].retire_step) and torch.equal(want[4], got[3].faulted)
    assert got[3].faulted.any()
    with pytest.raises(ValueError, match="FaultCheck"):
        tops.pulse_chase_run(data, *lanes, logic_fn=logic, max_steps=max_steps,
                             fault_fn=lambda p: p < 0)
