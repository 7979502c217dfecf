"""Hand-assembled PULSE ISA programs for the ported structures (S4.1).

These are what the paper's LLVM backend would emit; they execute on the ISA
VM (``core.isa.run_iteration``) and are cross-validated against the traced
iterators in tests.  Bounded inner loops (e.g. the BTree key scan, Listing 8)
are unrolled to FANOUT compares, exactly as the dispatch engine requires
("loops that cannot be unrolled to a fixed number of instructions" are
rejected, S3).
"""

from __future__ import annotations

from repro_torch.core import isa
from repro_torch.core.structures import bst, btree, hash_table, linked_list

KEY_NOT_FOUND = linked_list.KEY_NOT_FOUND
NULL_IMM = -1


def list_find_program() -> isa.Program:
    """Listing 5 compiled by hand.  scratch: [key, value, found]."""
    a = isa.Asm(
        scratch_words=linked_list.SCRATCH_WORDS,
        node_words=linked_list.NODE_WORDS,
        name="list_find_isa",
    )
    # r0=search key, r1=node key, r2=node value, r3=node next, r4=NULL, r5=1
    a.loads(0, 0)
    a.loadn(1, linked_list.KEY)
    a.loadn(2, linked_list.VALUE)
    a.loadn(3, linked_list.NEXT)
    a.movi(4, NULL_IMM)
    a.jne(0, 1, "miss")
    # hit: scratch[1]=value, scratch[2]=1, return
    a.stores(1, 2)
    a.movi(5, 1)
    a.stores(2, 5)
    a.ret()
    a.label("miss")
    a.movi(5, KEY_NOT_FOUND)
    a.stores(1, 5)
    a.movi(5, 0)
    a.stores(2, 5)
    a.jne(3, 4, "cont")
    a.ret()  # next == NULL -> not found
    a.label("cont")
    a.next_iter(3)
    return a.finish()


def hash_find_program() -> isa.Program:
    """Listing 3 compiled by hand (identical body to list find -- the chain
    walk is the same; the bucket resolution happened in init() on the CPU
    node).  scratch: [key, value, found]."""
    p = list_find_program()
    return isa.Program(p.code, p.scratch_words, hash_table.NODE_WORDS, "hash_find_isa")


def bst_find_program() -> isa.Program:
    """Listing 11 compiled by hand.  scratch: [key, y_ptr, y_key, y_value]."""
    a = isa.Asm(
        scratch_words=bst.SCRATCH_WORDS, node_words=bst.NODE_WORDS, name="bst_find_isa"
    )
    # r0=key r1=node.key r2=node.value r3=left r4=right r5=NULL r6=cur r7=next
    a.loads(0, bst.S_KEY)
    a.loadn(1, bst.KEY)
    a.loadn(2, bst.VALUE)
    a.loadn(3, bst.LEFT)
    a.loadn(4, bst.RIGHT)
    a.movi(5, NULL_IMM)
    a.getptr(6)
    a.jle(0, 1, "go_left")
    a.move(7, 4)  # next = right
    a.jmp("advance")
    a.label("go_left")
    # y <- cur: remember lower-bound candidate
    a.stores(bst.S_Y, 6)
    a.stores(bst.S_YKEY, 1)
    a.stores(bst.S_YVAL, 2)
    a.move(7, 3)  # next = left
    a.label("advance")
    a.jne(7, 5, "cont")
    a.ret()  # next == NULL -> done, y is the answer
    a.label("cont")
    a.next_iter(7)
    return a.finish()


def btree_find_program() -> isa.Program:
    """Listing 9 compiled by hand, inner key loop unrolled to FANOUT
    (bounded-loop rule, S3).  scratch: [key, value, found]."""
    a = isa.Asm(scratch_words=3, node_words=btree.NODE_WORDS, name="btree_find_isa")
    F = btree.FANOUT
    # r0=key r1=is_leaf r2=num_keys r3=tmp key_i r4=i r5=const r6=child/val r7=1
    a.loads(0, 0)
    a.loadn(1, btree.IS_LEAF)
    a.loadn(2, btree.NUM_KEYS)
    a.movi(7, 1)
    # unrolled: find first i with (i < num_keys) and key <= keys[i]
    for i in range(F):
        a.movi(4, i)
        a.jge(4, 2, "after_scan")  # i >= num_keys -> i = num_keys
        a.loadn(3, btree.KEYS0 + i)
        a.jle(0, 3, f"found_{i}")
    a.label("after_scan")
    a.move(4, 2)  # i = num_keys
    a.jmp("descend")
    for i in range(F):
        a.label(f"found_{i}")
        a.movi(4, i)
        if i != F - 1:
            a.jmp("descend")
    a.label("descend")
    a.movi(5, 0)
    a.jne(1, 5, "leaf")  # is_leaf != 0 -> leaf handling
    # internal: child = children[i]; unrolled select
    for i in range(F + 1):
        a.movi(5, i)
        a.jne(4, 5, f"notc_{i}")
        a.loadn(6, btree.CHILD0 + i)
        a.next_iter(6)
        a.label(f"notc_{i}")
    a.ret()  # unreachable (i <= num_keys <= F)
    a.label("leaf")
    # leaf: exact-match probe at slot i (keys sorted; key <= keys[i])
    a.movi(5, KEY_NOT_FOUND)
    a.stores(1, 5)
    a.movi(5, 0)
    a.stores(2, 5)
    a.jge(4, 2, "done")  # i == num_keys -> miss
    for i in range(F):
        a.movi(5, i)
        a.jne(4, 5, f"notl_{i}")
        a.loadn(3, btree.KEYS0 + i)
        a.jne(0, 3, "done")
        a.loadn(6, btree.VAL0 + i)
        a.stores(1, 6)
        a.stores(2, 7)
        a.jmp("done")
        a.label(f"notl_{i}")
    a.label("done")
    a.ret()
    return a.finish()


def bst_update_program() -> isa.Program:
    """Write path: BST update-in-place via the store class (STOREN).

    Same state machine as ``bst.update_iterator``: descend (state 0), stage
    a STOREN of the VALUE word on the matching node, stall for the commit,
    then validate on the post-commit iteration (state 1) -- a foreign value
    means a racing writer won the (slot, id) order, so the program restages.
    scratch: [key, new_value, state, found].
    """
    a = isa.Asm(
        scratch_words=bst.U_WORDS, node_words=bst.NODE_WORDS, name="bst_update_isa"
    )
    # r0=key r1=node.key r2=node.value r3=left r4=right r5=NULL r6=new_value
    # r7=1 r8=state r9=cur r10=next r11=0
    a.loads(0, bst.U_KEY)
    a.loads(6, bst.U_VAL)
    a.loads(8, bst.U_ST)
    a.loadn(1, bst.KEY)
    a.loadn(2, bst.VALUE)
    a.loadn(3, bst.LEFT)
    a.loadn(4, bst.RIGHT)
    a.movi(5, NULL_IMM)
    a.movi(7, 1)
    a.getptr(9)
    a.jeq(8, 7, "validate")
    # state 0: descend or stage
    a.jne(0, 1, "descend")
    a.storen(bst.VALUE, 6)  # stage the write-back; commit applies it
    a.stores(bst.U_ST, 7)
    a.next_iter(9)  # stall at the node until the commit lands
    a.label("descend")
    a.jlt(0, 1, "left")
    a.move(10, 4)
    a.jmp("step")
    a.label("left")
    a.move(10, 3)
    a.label("step")
    a.jne(10, 5, "cont")
    a.movi(11, 0)
    a.stores(bst.U_FOUND, 11)
    a.ret()  # miss: next hop is NULL
    a.label("cont")
    a.next_iter(10)
    a.label("validate")
    a.jeq(2, 6, "ok")
    a.storen(bst.VALUE, 6)  # lost the commit race: restage
    a.next_iter(9)
    a.label("ok")
    a.stores(bst.U_FOUND, 7)
    a.ret()
    return a.finish()


def all_programs() -> dict[str, isa.Program]:
    return {
        "list_find": list_find_program(),
        "hash_find": hash_find_program(),
        "bst_find": bst_find_program(),
        "btree_find": btree_find_program(),
        "bst_update": bst_update_program(),
    }
