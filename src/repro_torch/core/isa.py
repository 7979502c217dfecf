"""PULSE ISA (paper S4.1, Table 2): a stripped RISC subset and its VM.

The instruction classes of Table 2 with the eBPF-style forward-jump-only
rule, a tiny assembler standing in for the paper's LLVM backend, and a
*batched* VM: ``run_iteration`` runs one iteration of one program for a
whole batch of lanes at once.  The VM is the plain version of the logic
that the ``pulse_chase`` CUDA kernel interprets per lane.

Register model (one iterator workspace, S4.2):
  r0..r15         general registers (zero at the start of every iteration)
  NODE[0..W-1]    the aggregated 256 B LOAD result (read via LOADN)
  SP[0..S-1]      scratch_pad words (LOADS/STORES)
  CUR_PTR         read via GETPTR; written only by NEXT_ITER(reg)

An iteration runs from pc=0 until NEXT_ITER (yield new cur_ptr) or RETURN
(traversal done).  HALT, or running past the last instruction, ends the
iteration with done = false and cur_ptr unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.arena import M_ALLOC, M_CAS, M_FREE, M_STORE, bit32, wrap32
from repro_torch.core.iterator import PulseIterator

# opcodes (Table 2, extended with the store class of the write path)
HALT = 0  # implicit safety stop
LOADN = 1  # rd <- NODE[imm]
LOADS = 2  # rd <- SP[imm]
STORES = 3  # SP[imm] <- rs1
ADD, SUB, MUL, DIV, AND, OR, NOT = 4, 5, 6, 7, 8, 9, 10  # ALU
MOVE = 11  # rd <- rs1
MOVI = 12  # rd <- imm
JEQ, JNE, JLT, JLE, JGT, JGE = 13, 14, 15, 16, 17, 18  # COMPARE+JUMP (fwd)
JMP = 19  # unconditional forward jump
NEXT_ITER = 20  # cur_ptr <- rs1; end iteration
RETURN = 21  # traversal done
GETPTR = 22  # rd <- CUR_PTR
# store class: each stages one mutation per iteration (write path)
STOREN = 23  # stage NODE[imm] <- rs1 write-back of the current node
ALLOC = 24  # stage a free-list claim; the commit deposits the address in SP[imm]
SETPTR = 25  # stage link swing (CAS): NODE[imm] <- rs1 iff NODE[imm] == rs2
FREE = 26  # stage free of the node addressed by rs1

NUM_REGS = 16
_JUMPS = (JEQ, JNE, JLT, JLE, JGT, JGE, JMP)
_TERMINALS = (NEXT_ITER, RETURN)
_MUTATORS = (STOREN, ALLOC, SETPTR, FREE)

OP_NAMES = {
    HALT: "HALT", LOADN: "LOADN", LOADS: "LOADS", STORES: "STORES",
    ADD: "ADD", SUB: "SUB", MUL: "MUL", DIV: "DIV", AND: "AND", OR: "OR",
    NOT: "NOT", MOVE: "MOVE", MOVI: "MOVI", JEQ: "JEQ", JNE: "JNE",
    JLT: "JLT", JLE: "JLE", JGT: "JGT", JGE: "JGE", JMP: "JMP",
    NEXT_ITER: "NEXT_ITER", RETURN: "RETURN", GETPTR: "GETPTR",
    STOREN: "STOREN", ALLOC: "ALLOC", SETPTR: "SETPTR", FREE: "FREE",
}
ALL_OPS = tuple(range(FREE + 1))  # dense opcode space; OP_NAMES is exhaustive
assert set(OP_NAMES) == set(ALL_OPS)


@dataclasses.dataclass(frozen=True)
class Program:
    """Encoded PULSE program: (T, 4) int32 rows of [op, a, b, imm]."""

    code: np.ndarray
    scratch_words: int
    node_words: int
    name: str = "isa_program"

    def __post_init__(self):
        # structural validation only; semantic checks are the verifier's job
        code = np.asarray(self.code)
        if code.ndim != 2 or code.shape[1] != 4:
            raise ValueError(
                f"program code must be (T, 4) [op, a, b, imm] rows, "
                f"got shape {code.shape}"
            )
        if code.shape[0] == 0:
            raise ValueError("empty program")
        if not np.issubdtype(code.dtype, np.integer):
            raise ValueError(f"program code must be integer, got {code.dtype}")
        if self.scratch_words < 0 or self.node_words < 1:
            raise ValueError(
                f"need scratch_words >= 0 and node_words >= 1, got "
                f"{self.scratch_words}/{self.node_words}"
            )
        object.__setattr__(self, "code", code.astype(np.int32, copy=False))

    def __len__(self) -> int:
        return self.code.shape[0]

    @property
    def mutates(self) -> bool:
        """True iff the program CONTAINS any store-class opcode (the
        conservative whole-array scan for unverified programs)."""
        return bool(np.isin(self.code[:, 0], _MUTATORS).any())

    def disasm(self) -> str:
        rows = []
        for i, (op, a, b, imm) in enumerate(self.code):
            rows.append(f"{i:3d}: {OP_NAMES.get(int(op), '?'):9s} a={a} b={b} imm={imm}")
        return "\n".join(rows)


class Asm:
    """Tiny assembler for PULSE programs (the LLVM-backend stand-in)."""

    def __init__(self, scratch_words: int, node_words: int, name="isa_program"):
        self.rows: list[list[int]] = []
        self.scratch_words = scratch_words
        self.node_words = node_words
        self.name = name
        self._labels: dict[str, int] = {}
        self._fixups: list[tuple[int, str]] = []

    def _emit(self, op, a=0, b=0, imm=0):
        self.rows.append([op, a, b, imm])
        return len(self.rows) - 1

    # memory / register ops
    def loadn(self, rd, idx):
        return self._emit(LOADN, rd, 0, idx)

    def loads(self, rd, idx):
        return self._emit(LOADS, rd, 0, idx)

    def stores(self, idx, rs):
        return self._emit(STORES, rs, 0, idx)

    def add(self, rd, rs1, rs2):
        return self._emit(ADD, rd, rs1, rs2)

    def sub(self, rd, rs1, rs2):
        return self._emit(SUB, rd, rs1, rs2)

    def mul(self, rd, rs1, rs2):
        return self._emit(MUL, rd, rs1, rs2)

    def div(self, rd, rs1, rs2):
        return self._emit(DIV, rd, rs1, rs2)

    def and_(self, rd, rs1, rs2):
        return self._emit(AND, rd, rs1, rs2)

    def or_(self, rd, rs1, rs2):
        return self._emit(OR, rd, rs1, rs2)

    def not_(self, rd, rs1):
        return self._emit(NOT, rd, rs1)

    def move(self, rd, rs1):
        return self._emit(MOVE, rd, rs1)

    def movi(self, rd, imm):
        return self._emit(MOVI, rd, 0, imm)

    def getptr(self, rd):
        return self._emit(GETPTR, rd)

    # store class (write path; each stages into the record's mutation payload)
    def storen(self, idx, rs):
        return self._emit(STOREN, rs, 0, idx)

    def alloc(self, scratch_idx):
        return self._emit(ALLOC, 0, 0, scratch_idx)

    def setptr(self, idx, rs_val, rs_expect):
        return self._emit(SETPTR, rs_val, rs_expect, idx)

    def free(self, rs):
        return self._emit(FREE, rs)

    # control flow -- forward only, via labels resolved at finish()
    def label(self, name: str):
        if name in self._labels:
            raise ValueError(
                f"duplicate label {name!r} (first defined at pc "
                f"{self._labels[name]}): a silent redefinition would "
                f"retarget every earlier jump"
            )
        self._labels[name] = len(self.rows)

    def _jump(self, op, a, b, target: str):
        idx = self._emit(op, a, b, 0)
        self._fixups.append((idx, target))
        return idx

    def jeq(self, rs1, rs2, target):
        return self._jump(JEQ, rs1, rs2, target)

    def jne(self, rs1, rs2, target):
        return self._jump(JNE, rs1, rs2, target)

    def jlt(self, rs1, rs2, target):
        return self._jump(JLT, rs1, rs2, target)

    def jle(self, rs1, rs2, target):
        return self._jump(JLE, rs1, rs2, target)

    def jgt(self, rs1, rs2, target):
        return self._jump(JGT, rs1, rs2, target)

    def jge(self, rs1, rs2, target):
        return self._jump(JGE, rs1, rs2, target)

    def jmp(self, target):
        return self._jump(JMP, 0, 0, target)

    def next_iter(self, rs_newptr):
        return self._emit(NEXT_ITER, rs_newptr)

    def ret(self):
        return self._emit(RETURN)

    def finish(self) -> Program:
        code = np.asarray(self.rows, np.int32).reshape(-1, 4)
        for idx, target in self._fixups:
            if target not in self._labels:
                raise ValueError(f"undefined label {target!r}")
            code[idx, 3] = self._labels[target]
        validate(code, self.scratch_words, self.node_words)
        return Program(code, self.scratch_words, self.node_words, self.name)


def validate(code: np.ndarray, scratch_words: int, node_words: int) -> None:
    """Static checks (the paper's eBPF-style rules, S4.1): forward-only
    jumps, register/scratch/node bounds, and a terminal last instruction."""
    T = code.shape[0]
    if T == 0:
        raise ValueError("empty program")
    for i, (op, a, b, imm) in enumerate(code):
        op = int(op)
        if op in _JUMPS:
            if int(imm) <= i:
                raise ValueError(
                    f"backward/self jump at pc={i} -> {int(imm)}: PULSE allows "
                    f"forward jumps only (S4.1); backward edges exist solely "
                    f"via NEXT_ITER"
                )
            if int(imm) > T:
                raise ValueError(f"jump target out of range at pc={i}")
        if op in (LOADN, STOREN, SETPTR) and not (0 <= int(imm) < node_words):
            raise ValueError(f"node index {int(imm)} out of range at pc={i}")
        if op in (LOADS, STORES, ALLOC) and not (0 <= int(imm) < scratch_words):
            raise ValueError(f"scratch index {int(imm)} out of range at pc={i}")
        for r in (int(a), int(b)):
            if op != HALT and not (0 <= r < NUM_REGS):
                raise ValueError(f"register {r} out of range at pc={i}")
        # three-register ALU forms read rs2 from the imm column
        if op in (ADD, SUB, MUL, DIV, AND, OR) and not (0 <= int(imm) < NUM_REGS):
            raise ValueError(f"register {int(imm)} out of range at pc={i}")
    if int(code[-1, 0]) not in _TERMINALS:
        raise ValueError("program must end in NEXT_ITER or RETURN")


def max_instructions_per_iteration(prog: Program) -> int:
    """Upper bound N on instructions per iteration (forward-only control flow
    bounds it by program length)."""
    return len(prog)


def floor_div32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The ISA's DIV on int32: floor division, ``x / 0 = 0`` and
    ``INT_MIN / -1 = INT_MIN`` (the quotient wraps)."""
    x64, y64 = x.long(), y.long()
    q = torch.div(x64, torch.where(y64 == 0, 1, y64), rounding_mode="floor")
    return wrap32(torch.where(y64 == 0, 0, q))


def _run_vm(code, nodes: torch.Tensor, ptr: torch.Tensor, scratch: torch.Tensor,
            mutating: bool):
    """One iteration of one program for a batch of lanes; with ``mutating``
    it also stages the store class into each lane's mutation payload."""
    dev = nodes.device
    code = torch.as_tensor(code).to(device=dev, dtype=torch.int32)
    T = code.shape[0]
    B, W = nodes.shape
    S = scratch.shape[1]
    ptr = ptr.to(torch.int32)
    regs = torch.zeros((B, NUM_REGS), dtype=torch.int32, device=dev)
    scr = scratch.to(torch.int32).clone()
    out_ptr = ptr.clone()
    pc = torch.zeros((B,), dtype=torch.int64, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    halted = torch.zeros((B,), dtype=torch.bool, device=dev)
    reg_ids = torch.arange(NUM_REGS, device=dev)
    scr_ids = torch.arange(S, device=dev)
    if mutating:
        mop, mtgt, mmask, mexp = (torch.zeros((B,), dtype=torch.int32, device=dev)
                                  for _ in range(4))
        mdata = torch.zeros((B, W), dtype=torch.int32, device=dev)
        word_ids = torch.arange(W, device=dev)

    def col(t, idx):
        return t.gather(1, idx.long()[:, None])[:, 0]

    for _ in range(T):
        live = ~halted & (pc < T)
        if not bool(live.any()):
            break
        row = code[pc.clamp(0, T - 1)]
        op = row[:, 0].clamp(0, FREE)
        a = row[:, 1].clamp(0, NUM_REGS - 1)
        b = row[:, 2].clamp(0, NUM_REGS - 1)
        imm = row[:, 3]
        imm_r = imm.clamp(0, NUM_REGS - 1)
        ra, rb, rimm = col(regs, a), col(regs, b), col(regs, imm_r)
        node_imm = col(nodes, imm.clamp(0, W - 1))
        scr_imm = col(scr, imm.clamp(0, S - 1)) if S else torch.zeros_like(imm)
        rb64, rimm64 = rb.long(), rimm.long()

        # value written to register a, per opcode
        val = torch.where(op == LOADN, node_imm, torch.zeros_like(rb))
        val = torch.where(op == LOADS, scr_imm, val)
        val = torch.where(op == ADD, wrap32(rb64 + rimm64), val)
        val = torch.where(op == SUB, wrap32(rb64 - rimm64), val)
        val = torch.where(op == MUL, wrap32(rb64 * rimm64), val)
        val = torch.where(op == DIV, floor_div32(rb, rimm), val)
        val = torch.where(op == AND, rb & rimm, val)
        val = torch.where(op == OR, rb | rimm, val)
        val = torch.where(op == NOT, ~rb, val)
        val = torch.where(op == MOVE, rb, val)
        val = torch.where(op == MOVI, imm, val)
        val = torch.where(op == GETPTR, ptr, val)
        writes = live & (
            ((op >= LOADN) & (op <= MOVI) & (op != STORES)) | (op == GETPTR)
        )
        regs = torch.where(
            writes[:, None] & (reg_ids[None, :] == a[:, None]), val[:, None], regs
        )
        if S:
            stores = live & (op == STORES)
            scr = torch.where(
                stores[:, None] & (scr_ids[None, :] == imm.clamp(0, S - 1)[:, None]),
                ra[:, None],
                scr,
            )
        if mutating:
            # STOREN accumulates a masked write-back image of the current
            # node (an ALLOC staged before keeps its op and target: the
            # image is the new node); ALLOC retargets the image at a fresh
            # slot whose address the commit deposits in SP[imm]; SETPTR
            # stages a CAS of NODE[imm] (expect rs2); FREE stages the
            # release of the node addressed by rs1
            storen, alloc = live & (op == STOREN), live & (op == ALLOC)
            setptr, free = live & (op == SETPTR), live & (op == FREE)
            word = imm.clamp(0, W - 1)
            bit = bit32(word)
            mdata = torch.where(
                (storen | setptr)[:, None] & (word_ids[None, :] == word[:, None]),
                ra[:, None], mdata)
            fresh_store = storen & (mop != M_ALLOC)
            mop = torch.where(fresh_store, M_STORE, mop)
            mtgt = torch.where(fresh_store, ptr, mtgt)
            mmask = torch.where(storen, mmask | bit, mmask)
            mop = torch.where(alloc, M_ALLOC,
                              torch.where(setptr, M_CAS, torch.where(free, M_FREE, mop)))
            mtgt = torch.where(alloc, imm, torch.where(setptr, ptr, torch.where(free, ra, mtgt)))
            mmask = torch.where(setptr, bit, torch.where(free, 0, mmask))
            mexp = torch.where(setptr, rb, torch.where(free, 0, mexp))

        taken = (
            ((op == JEQ) & (ra == rb)) | ((op == JNE) & (ra != rb))
            | ((op == JLT) & (ra < rb)) | ((op == JLE) & (ra <= rb))
            | ((op == JGT) & (ra > rb)) | ((op == JGE) & (ra >= rb))
            | (op == JMP)
        )
        next_pc = torch.where(taken, imm.long(), pc + 1)
        pc = torch.where(live, next_pc, pc)
        out_ptr = torch.where(live & (op == NEXT_ITER), ra, out_ptr)
        done = done | (live & (op == RETURN))
        halted = halted | (live & ((op == HALT) | (op == NEXT_ITER) | (op == RETURN)))
    if mutating:
        return done, out_ptr, scr, (mop, mtgt, mmask, mexp, mdata)
    return done, out_ptr, scr


def run_iteration(code, nodes: torch.Tensor, ptr: torch.Tensor, scratch: torch.Tensor):
    """One iteration of one program for a batch of lanes.

    ``code`` is the ``(T, 4)`` program (numpy or tensor), ``nodes`` ``(B,W)``,
    ``ptr`` ``(B,)`` and ``scratch`` ``(B,S)``, all int32.  Returns
    ``(done (B,) bool, new_ptr (B,), new_scratch (B,S))``.

    Each lane keeps its own ``pc``.  Jumps go forward only, so after at most
    ``T`` rounds every lane has halted or run past the end.  Each round
    applies every opcode's effect under a mask (``torch.where``); store-class
    opcodes stage nothing on the read path and only advance the pc.
    Arithmetic wraps in int32; register, node and scratch indices are
    clipped into range.
    """
    return _run_vm(code, nodes, ptr, scratch, False)


def run_iteration_mut(code, nodes: torch.Tensor, ptr: torch.Tensor, scratch: torch.Tensor):
    """The write path's VM: ``run_iteration`` that also returns each lane's
    staged mutation ``(m_op, m_tgt, m_mask, m_expect, m_data (B, W))``
    (M_NONE and zeros where a lane stages nothing).  The mask bit of word
    ``k`` is ``1 << k`` in int32, which is 0 for ``k >= 32``
    (``arena.bit32``)."""
    return _run_vm(code, nodes, ptr, scratch, True)


# NOTE on ALU encoding: rows are [op, rd, rs1, rs2-as-imm-field]; the
# three-register ALU forms read rs2 from the imm column (register index).


class IsaStep:
    """The fused read-path step of an ISA program: ``(nodes, ptr, scratch)
    -> (done, new_ptr, new_scratch)`` through the batched VM.  Carries the
    program as ``__wrapped_program__`` (the dispatch model's exact N and
    the code the ``pulse_chase`` kernel interprets)."""

    vm = staticmethod(run_iteration)

    def __init__(self, prog: Program):
        self.__wrapped_program__ = prog
        self._code: dict = {}

    def code_on(self, device) -> torch.Tensor:
        """The program's ``(T, 4)`` int32 code as a tensor on ``device``
        (built once per device)."""
        key = str(device)
        t = self._code.get(key)
        if t is None:
            t = torch.as_tensor(self.__wrapped_program__.code).to(device).contiguous()
            self._code[key] = t
        return t

    def __call__(self, nodes, ptr, scratch):
        return self.vm(self.code_on(nodes.device), nodes, ptr, scratch)


class IsaMutStep(IsaStep):
    """The mutating step of an ISA program (``PulseIterator.mut_fn``):
    ``(nodes, ptr, scratch) -> (done, new_ptr, new_scratch, staged)``
    through ``run_iteration_mut``."""

    vm = staticmethod(run_iteration_mut)


def as_pulse_iterator(
    prog: Program,
    *,
    verify: bool = True,
    node_ptr_slots=None,
    scratch_ptr_slots=None,
) -> PulseIterator:
    """Wrap an encoded program as a PulseIterator (the accelerator path).

    With ``verify=True`` (the default) the program is admitted through
    pulse-verify (``core.verify``): unsafe programs raise ``VerifyError``,
    accepted ones carry their ``ProgramFacts`` certificate.  ``verify=False``
    falls back to the conservative opcode scan (``Program.mutates``).

    Read-only programs supply the fused ``step_fn``; programs that can
    reach the store class supply ``mut_fn`` instead, so the executors route
    them through the commit path (``core.commit``).
    """
    facts = None
    if verify:
        from repro_torch.core import verify as verify_mod  # isa<->verify cycle

        facts = verify_mod.verify_program(
            prog,
            node_ptr_slots=node_ptr_slots,
            scratch_ptr_slots=scratch_ptr_slots,
        )
    mutates = facts.mutates if facts is not None else prog.mutates
    step_fn = IsaStep(prog)

    def next_fn(node, ptr, scratch):
        done, new_ptr, scr = step_fn(node, ptr, scratch)
        return new_ptr, scr

    def end_fn(node, ptr, scratch):
        done, new_ptr, scr = step_fn(node, ptr, scratch)
        return done, scr

    if mutates:
        return PulseIterator(
            scratch_words=prog.scratch_words,
            next_fn=next_fn,
            end_fn=end_fn,
            mut_fn=IsaMutStep(prog),
            name=prog.name,
            facts=facts,
        )
    return PulseIterator(
        scratch_words=prog.scratch_words,
        next_fn=next_fn,
        end_fn=end_fn,
        step_fn=step_fn,
        name=prog.name,
        facts=facts,
    )
