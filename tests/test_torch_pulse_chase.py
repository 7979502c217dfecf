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


@pytest.mark.parametrize("use_isa", [False, True])
def test_waves_with_fault_fn_match_reference(use_isa):
    """Skewed chain depths, a revoked shard, NULL and out-of-range entries:
    ptr, scratch, status and every WaveStats field must agree."""
    rng = np.random.default_rng(11)
    keys = rng.choice(np.arange(10**5), size=96, replace=False).astype(np.int32)
    vals = rng.integers(0, 10**6, 96).astype(np.int32)
    jar, heads = jhash.build(keys, vals, 5, num_shards=2)
    # shard 0 revoked: chains start in shard 1 (the newest keys) and fault
    # when they walk into shard 0
    perms = np.array([0, 1], np.int32)
    q = np.concatenate([keys[:30], rng.integers(10**5, 10**6, 10).astype(np.int32)])
    ptr0, scr0 = jhash.find_iterator(5).init(jnp.asarray(q), jnp.asarray(heads))
    ptr0 = np.asarray(ptr0).copy()
    ptr0[[0, 3]] = [-1, 500]
    scr0 = np.asarray(scr0)
    st0 = np.zeros(40, np.int32)
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
    """On a CUDA tensor the wrapper launches the kernel or raises: logic
    without an ISA program raises (checked with a fake CUDA test, no card)."""
    monkeypatch.setattr(tops, "_on_cuda", lambda t: True)

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(tops, "chase_reference", no_plain)
    ar, head = tlist.build(np.arange(8), np.arange(8), device=CPU)
    it = tlist.find_iterator()
    p0, s0 = it.init(torch.arange(4, dtype=torch.int32), head)
    before = tops.pulse_chase.launches
    with pytest.raises(ValueError, match="ISA"):
        tops.pulse_chase(ar.data, p0, s0, torch.zeros(4, dtype=torch.int32),
                         logic_fn=tops.iterator_logic(it), num_steps=2)
    assert tops.pulse_chase.launches == before


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
    """The port's own structure and lanes for an ISA find, with lanes that
    start NULL, past the arena's end, or retired."""
    from repro_torch.core.structures import bst as tbst

    keys = rng.choice(np.arange(10**5), size=300, replace=False).astype(np.int32)
    vals = rng.integers(0, 10**6, 300).astype(np.int32)
    q = torch.from_numpy(
        np.concatenate([keys[:40], rng.integers(10**5, 10**6, 24).astype(np.int32)]))
    if name == "list_find":
        ar, head = tlist.build(keys[:60], vals[:60], device=device)
        p0, s0 = tlist.find_iterator().init(q, head)
    elif name == "hash_find":
        ar, heads = thash.build(keys, vals, 16, device=device)
        p0, s0 = thash.find_iterator(16).init(q, heads)
    elif name == "bst_find":
        ar, root, _ = tbst.build(keys, vals, device=device)
        p0, s0 = tbst.find_iterator().init(q, root)
    else:
        ar, root, _ = tbtree.build(keys, vals, device=device)
        p0, s0 = tbtree.find_iterator().init(q, root)
    p0[1], p0[5] = -1, ar.capacity + 3
    st0 = torch.zeros_like(p0)
    st0[7] = 1
    return ar, [x.to(device) for x in (p0, s0, st0)]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["list_find", "hash_find", "bst_find", "btree_find", "walk"])
def test_kernel_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the card with pytest -m gpu")
    if name == "walk":
        ar, lanes = _port_case("list_find", np.random.default_rng(4), "cuda")
        lanes[1] = lanes[1][:, :1].contiguous()
        prog = _walk_program(tisa)
    else:
        ar, lanes = _port_case(name, np.random.default_rng(len(name)), "cuda")
        prog = tprogs.all_programs()[name]
    logic = tops.iterator_logic(tisa.as_pulse_iterator(prog))
    for steps in (1, 4, 70):
        before = tops.pulse_chase.launches
        got = tops.pulse_chase(ar.data, *lanes, logic_fn=logic, num_steps=steps)
        assert tops.pulse_chase.launches == before + 1
        want = tref.chase_reference(ar.data, *lanes, torch.zeros_like(lanes[0]), logic,
                                    steps)
        torch.cuda.synchronize()
        for f, a, b in zip(FIELDS, want, got):
            assert torch.equal(a, b), f
