"""Port parity: PULSE ISA, batched VM, verifier and dispatch counts.

The port's VM runs one program for a whole batch of lanes; the JAX VM runs
one lane and is vmapped here.  Both must give the same (done, ptr, scratch)
bit for bit, on a seeded random-program generator (the op mix of
``tests/test_property.py``) and on DIV's edge cases.  Data crosses as numpy
arrays; the port runs on the CPU."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro.core import isa as jisa
from repro.core import verify as jverify
from repro.core.structures import bst as jbst
from repro.core.structures import btree as jbtree
from repro.core.structures import hash_table as jhash
from repro.core.structures import isa_programs as jprogs
from repro.core.structures import linked_list as jlist
from repro.core.structures import skiplist as jskip
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import isa as tisa
from repro_torch.core import verify as tverify
from repro_torch.core.structures import bst as tbst
from repro_torch.core.structures import btree as tbtree
from repro_torch.core.structures import hash_table as thash
from repro_torch.core.structures import isa_programs as tprogs
from repro_torch.core.structures import linked_list as tlist
from repro_torch.core.structures import skiplist as tskip

GOLDEN = Path(__file__).resolve().parent / "golden" / "pulse_verify"
INT_MIN, INT_MAX = -(2**31), 2**31 - 1

_OPS = [
    jisa.LOADN, jisa.LOADS, jisa.STORES, jisa.ADD, jisa.SUB, jisa.MUL,
    jisa.DIV, jisa.AND, jisa.OR, jisa.NOT, jisa.MOVE, jisa.MOVI,
    jisa.JEQ, jisa.JNE, jisa.JLT, jisa.JLE, jisa.JGT, jisa.JGE, jisa.JMP,
    jisa.GETPTR,
]
_JUMPS = (jisa.JEQ, jisa.JNE, jisa.JLT, jisa.JLE, jisa.JGT, jisa.JGE, jisa.JMP)


def _random_program(rng, T):
    """A random valid forward-jump-only program over 4 node words and 3
    scratch words, always terminated (tests/test_property.py's generator,
    drawn from a numpy seed)."""
    rows = []
    for i in range(T - 1):
        op = int(rng.choice(_OPS))
        a, b = (int(x) for x in rng.integers(0, jisa.NUM_REGS, 2))
        if op in _JUMPS:
            imm = int(rng.integers(i + 1, T + 1))  # forward only, T = fall off
        elif op == jisa.LOADN:
            imm = int(rng.integers(0, 4))
        elif op in (jisa.LOADS, jisa.STORES):
            imm = int(rng.integers(0, 3))
        elif op == jisa.MOVI:
            imm = int(rng.choice([rng.integers(-(2**20), 2**20 + 1), INT_MIN, INT_MAX, -1]))
        else:
            imm = int(rng.integers(0, jisa.NUM_REGS))
        rows.append([op, a, b, imm])
    rows.append([int(rng.choice([jisa.RETURN, jisa.NEXT_ITER])),
                 int(rng.integers(0, jisa.NUM_REGS)), 0, 0])
    return np.asarray(rows, np.int32)


def _lanes(rng, B, W, S):
    """Small values (so compares and jumps go both ways) mixed with int32
    extremes (so ADD/SUB/MUL wrap and DIV meets its edge cases)."""
    def draw(shape):
        small = rng.integers(-100, 101, shape)
        big = rng.choice(np.array([INT_MIN, INT_MAX, -1, 0, 1, 2**30, -(2**30) - 7]), shape)
        return np.where(rng.random(shape) < 0.25, big, small).astype(np.int32)

    return draw((B, W)), rng.integers(0, 100, B).astype(np.int32), draw((B, S))


_JAX_VM = jax.jit(jax.vmap(jisa.run_iteration, in_axes=(None, 0, 0, 0)))


def _both_vms(code, nodes, ptr, scr):
    jd, jp, js = (np.asarray(x) for x in _JAX_VM(jnp.asarray(code), nodes, ptr, scr))
    td, tp, ts = tisa.run_iteration(
        code, torch.from_numpy(nodes), torch.from_numpy(ptr), torch.from_numpy(scr)
    )
    return (jd, jp, js), (td.numpy(), tp.numpy(), ts.numpy())


@pytest.mark.parametrize("T", [3, 8, 14])
def test_batched_vm_matches_jax_vm_on_random_programs(T):
    rng = np.random.default_rng(T)
    for _ in range(25):
        code = _random_program(rng, T)
        jisa.validate(code, scratch_words=3, node_words=4)
        nodes, ptr, scr = _lanes(rng, 16, 4, 3)
        (jd, jp, js), (td, tp, ts) = _both_vms(code, nodes, ptr, scr)
        assert td.dtype == np.bool_ and tp.dtype == np.int32 and ts.dtype == np.int32
        np.testing.assert_array_equal(jd, td, err_msg=f"done\n{code}")
        np.testing.assert_array_equal(jp, tp, err_msg=f"ptr\n{code}")
        np.testing.assert_array_equal(js, ts, err_msg=f"scratch\n{code}")


def test_vm_alu_edge_cases_match():
    """DIV is floor division guarded at 0 (x/0 = 0) and INT_MIN / -1 wraps
    to INT_MIN; ADD/SUB/MUL wrap in int32."""
    a = jisa.Asm(scratch_words=4, node_words=2, name="alu")
    a.loadn(0, 0)
    a.loadn(1, 1)
    a.div(2, 0, 1)
    a.stores(0, 2)
    a.add(3, 0, 1)
    a.stores(1, 3)
    a.sub(3, 0, 1)
    a.stores(2, 3)
    a.mul(3, 0, 1)
    a.stores(3, 3)
    a.ret()
    code = a.finish().code
    pairs = np.array([
        (7, 2), (-7, 2), (7, -2), (-7, -2), (6, 3), (-6, 3), (5, 0), (0, 0),
        (INT_MIN, 0), (INT_MIN, -1), (INT_MIN, 1), (INT_MIN, 2), (INT_MAX, -1),
        (INT_MAX, INT_MAX), (INT_MIN, INT_MIN), (0, -3), (-1, INT_MIN), (1, INT_MIN),
        (INT_MAX, 2), (-(2**30), 4), (65537, 65537),
    ], np.int64).astype(np.int32)
    B = pairs.shape[0]
    (jd, jp, js), (td, tp, ts) = _both_vms(
        code, pairs, np.arange(B, dtype=np.int32), np.zeros((B, 4), np.int32)
    )
    np.testing.assert_array_equal(js, ts)
    np.testing.assert_array_equal(jd, td)
    assert ts[9, 0] == INT_MIN and ts[6, 0] == 0 and ts[1, 0] == -4


def test_floor_div32_matches_python_floor_division():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.integers(INT_MIN, INT_MAX, 500), [INT_MIN, INT_MIN, -9]])
    y = np.concatenate([rng.integers(-50, 50, 500), [-1, 0, 4]])
    got = tisa.floor_div32(torch.from_numpy(x.astype(np.int32)),
                           torch.from_numpy(y.astype(np.int32))).numpy()
    want = [0 if b == 0 else ((a // b + 2**31) % 2**32) - 2**31 for a, b in zip(x, y)]
    np.testing.assert_array_equal(got, np.asarray(want, np.int64).astype(np.int32))


PROGRAMS = ["list_find", "hash_find", "bst_find", "btree_find", "bst_update"]


@pytest.mark.parametrize("name", PROGRAMS)
def test_programs_disasm_and_facts_match(name):
    jp = jprogs.all_programs()[name]
    tp = tprogs.all_programs()[name]
    np.testing.assert_array_equal(jp.code, tp.code)
    assert (jp.scratch_words, jp.node_words, jp.name) == (tp.scratch_words, tp.node_words,
                                                           tp.name)
    assert jp.disasm() == tp.disasm()
    assert jp.mutates == tp.mutates
    assert tverify.annotate_disasm(tp) == jverify.annotate_disasm(jp)
    assert tverify.annotate_disasm(tp) == (GOLDEN / f"{name}.disasm").read_text()
    assert dataclasses.asdict(tverify.verify_program(tp)) == dataclasses.asdict(
        jverify.verify_program(jp)
    )
    assert tdispatch.isa_longest_path(tp) == jdispatch.isa_longest_path(jp)
    assert tisa.max_instructions_per_iteration(tp) == jisa.max_instructions_per_iteration(jp)


# (program, pc, replacement row): corrupted shipped programs
_MUTATIONS = [
    ("list_find", 3, [99, 0, 0, 0]),
    ("list_find", 5, [jisa.JNE, 0, 1, 99]),
    ("list_find", 0, [jisa.LOADS, 20, 0, 0]),
    ("list_find", 1, [jisa.LOADN, 1, 0, 7]),
    ("list_find", 6, [jisa.STORES, 2, 0, 9]),
    ("list_find", 9, [0, 0, 0, 0]),
    ("list_find", 14, [jisa.JNE, 3, 4, 5]),
    ("list_find", 5, [jisa.JMP, 0, 0, 10]),
    ("list_find", 0, [jisa.MOVE, 0, 7, 0]),
    ("bst_update", 13, [jisa.FREE, 9, 0, 0]),
    ("bst_update", 12, [jisa.SETPTR, 7, 0, 1]),
]


def _diags(ds):
    return [(d.code, d.pc, d.message) for d in ds]


def test_verifier_diagnostics_match_on_mutants_and_random_programs():
    progs = []
    for name, pc, row in _MUTATIONS:
        base = jprogs.all_programs()[name]
        code = base.code.copy()
        code[pc] = row
        progs.append((code, base.scratch_words, base.node_words))
    rng = np.random.default_rng(7)
    progs += [(_random_program(rng, int(rng.integers(2, 15))), 3, 4) for _ in range(60)]
    for code, S, W in progs:
        jf, jd = jverify.analyze_program(jisa.Program(code, S, W, "m"))
        tf, td = tverify.analyze_program(tisa.Program(code, S, W, "m"))
        assert _diags(jd) == _diags(td)
        assert (jf is None) == (tf is None)
        if jf is not None:
            assert dataclasses.asdict(jf) == dataclasses.asdict(tf)
        assert jverify.annotate_disasm(jisa.Program(code, S, W, "m")) == \
            tverify.annotate_disasm(tisa.Program(code, S, W, "m"))


def test_validate_and_assembler_reject_alike():
    bad = [
        (np.array([[jisa.JMP, 0, 0, 0], [jisa.RETURN, 0, 0, 0]], np.int32), 3, 4),
        (np.array([[jisa.JMP, 0, 0, 5], [jisa.RETURN, 0, 0, 0]], np.int32), 3, 4),
        (np.array([[jisa.LOADN, 0, 0, 4], [jisa.RETURN, 0, 0, 0]], np.int32), 3, 4),
        (np.array([[jisa.ADD, 0, 0, 16], [jisa.RETURN, 0, 0, 0]], np.int32), 3, 4),
        (np.array([[jisa.MOVI, 0, 0, 1]], np.int32), 3, 4),
    ]
    for code, S, W in bad:
        with pytest.raises(ValueError) as je:
            jisa.validate(code, S, W)
        with pytest.raises(ValueError) as te:
            tisa.validate(code, S, W)
        assert str(je.value) == str(te.value)
    a = tisa.Asm(3, 4)
    a.label("x")
    with pytest.raises(ValueError, match="duplicate label"):
        a.label("x")


def test_as_pulse_iterator_read_path_and_write_path_deferred():
    """Read programs get the fused ``step_fn``; a program that can reach the
    store class gets ``mut_fn`` (the write path), carrying its program."""
    it = tisa.as_pulse_iterator(tprogs.list_find_program())
    assert it.facts is not None and it.facts.read_only and not it.mutates
    assert it.step_fn.__wrapped_program__.name == "list_find_isa"
    upd = tisa.as_pulse_iterator(tprogs.bst_update_program())
    jupd = jisa.as_pulse_iterator(jprogs.bst_update_program())
    assert upd.mutates and upd.step_fn is None and upd.facts.mutates
    assert upd.mut_fn.__wrapped_program__.name == jupd.mut_fn.__wrapped_program__.name
    np.testing.assert_array_equal(upd.mut_fn.__wrapped_program__.code,
                                  jupd.mut_fn.__wrapped_program__.code)
    with pytest.raises(tverify.VerifyError):
        code = tprogs.list_find_program().code.copy()
        code[9] = [0, 0, 0, 0]
        tisa.as_pulse_iterator(tisa.Program(code, 3, 4))


def test_declared_instruction_counts_match_traced_counts():
    """Torch iterators declare the N the JAX package derives from a jaxpr."""
    pairs = [
        (jlist.find_iterator(), tlist.find_iterator(), 4),
        (jlist.sum_iterator(), tlist.sum_iterator(), 4),
        (jhash.find_iterator(64), thash.find_iterator(64), 4),
        (jbst.find_iterator(), tbst.find_iterator(), 4),
        (jbtree.find_iterator(), tbtree.find_iterator(), 20),
        (jbtree.range_aggregate_iterator(), tbtree.range_aggregate_iterator(), 20),
        (jskip.find_iterator(), tskip.find_iterator(), 12),
        # the write path's iterators: the reference counts their mut_fn
        (jlist.rw_iterator(), tlist.rw_iterator(), 4),
        (jlist.insert_iterator(), tlist.insert_iterator(), 4),
        (jlist.delete_iterator(), tlist.delete_iterator(), 4),
        (jhash.rw_iterator(64), thash.rw_iterator(64), 4),
        (jhash.insert_iterator(64), thash.insert_iterator(64), 4),
        (jhash.delete_iterator(64), thash.delete_iterator(64), 4),
        (jbst.update_iterator(), tbst.update_iterator(), 4),
        (jbtree.update_iterator(), tbtree.update_iterator(), 20),
        (jskip.insert_iterator(), tskip.insert_iterator(), 12),
        (jskip.delete_iterator(), tskip.delete_iterator(), 12),
    ]
    for jit_, tit, w in pairs:
        for words in (w, 64):
            assert tdispatch.count_instructions(tit, words) == \
                jdispatch.count_instructions(jit_, words), tit.name
            jd = jdispatch.offload_decision(jit_, words)
            td = tdispatch.offload_decision(tit, words)
            assert dataclasses.asdict(jd) == dataclasses.asdict(td)
    for name in PROGRAMS:
        jit_ = jisa.as_pulse_iterator(jprogs.all_programs()[name])
        tit = tisa.as_pulse_iterator(tprogs.all_programs()[name])
        assert tdispatch.count_instructions(tit, 20) == jdispatch.count_instructions(jit_, 20)
    with pytest.raises(ValueError, match="instruction count"):
        tdispatch.count_instructions(
            dataclasses.replace(tlist.find_iterator(), n_instructions=None), 4
        )
