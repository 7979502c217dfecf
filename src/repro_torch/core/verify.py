"""pulse-verify: an eBPF-style static verifier for PULSE ISA programs.

The paper's safety story (S4.1) is that offloaded traversal functions are
admitted *without trusting the tenant* because the ISA is restricted enough
to verify.  ``isa.validate`` enforces the cheap syntactic subset (forward
jumps, index bounds, terminal-last); this module is the full admission
check: it builds a control-flow graph over the encoded instructions and
runs an abstract interpretation that either

  (a) **rejects** the program with instruction-level diagnostics --
      undefined opcodes, out-of-range jump targets / register / node-word /
      scratch indices, use of scratch registers before definition, more
      than one store-class mutation staged on a single iteration path,
      SETPTR / FREE / NEXT_ITER operands with no pointer provenance,
      CFG-unreachable code, reachable HALTs, paths that fall off the
      program end, and backward jumps that can loop without reaching
      NEXT_ITER / RETURN (per-iteration termination); or

  (b) **certifies** it with a :class:`ProgramFacts` record -- the
      reachability-based ``mutates`` / ``allocs`` / ``frees`` flags, the
      scratch words actually touched, the permission mask the program can
      ever need, and the longest instruction path per iteration.  The
      certificate threads through ``core.iterator`` / ``core.engine`` /
      ``core.routing`` / ``serving.traversal_service`` so verified
      read-only programs skip the mutation-payload record lanes and elide
      the per-hop access-table check (see ``engine.can_elide_access``).

Verification is per *iteration*: one activation of the logic pipeline runs
from pc 0 to NEXT_ITER / RETURN, so the CFG never includes the implicit
back edge through the memory pipeline.  Termination therefore reduces to
the reachable CFG being acyclic -- a refinement of the assembler's blanket
forward-jump-only rule (a backward jump that cannot close a cycle is
harmless; one that can is rejected with the jump's pc).

Pointer provenance is a four-point lattice per register / scratch slot:
UNINIT < {NUM, PTR} < ANY.  GETPTR yields PTR; MOVI and the ALU yield NUM;
LOADN / LOADS yield the declared slot class (``node_ptr_slots`` /
``scratch_ptr_slots``) or ANY when the caller declares nothing -- so
undeclared programs are only rejected for *forged* pointers (MOVI / ALU
values flowing into SETPTR, FREE, or NEXT_ITER), never for honest loads.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import isa
from repro_torch.core.arena import PERM_READ, PERM_WRITE

__all__ = [
    "Diagnostic",
    "VerifyError",
    "ProgramFacts",
    "analyze_program",
    "verify_program",
    "annotate_disasm",
]

# --------------------------------------------------------------------------
# diagnostic codes -- stable, machine-readable (the mutant corpus and the
# serving admission tests key on these strings; never rename casually)
E_EMPTY = "empty-program"
E_BAD_OPCODE = "bad-opcode"
E_JUMP_RANGE = "jump-out-of-range"
E_REG_RANGE = "register-out-of-range"
E_NODE_RANGE = "node-index-out-of-range"
E_SCRATCH_RANGE = "scratch-index-out-of-range"
E_FALLTHROUGH = "falls-off-end"
E_HALT = "halt-reachable"
E_LOOP = "unbounded-loop"
E_UNREACHABLE = "unreachable-code"
E_UNDEF_READ = "use-before-def"
E_DOUBLE_STAGE = "conflicting-stage"
E_PROVENANCE = "pointer-provenance"

ALL_CODES = (
    E_EMPTY, E_BAD_OPCODE, E_JUMP_RANGE, E_REG_RANGE, E_NODE_RANGE,
    E_SCRATCH_RANGE, E_FALLTHROUGH, E_HALT, E_LOOP, E_UNREACHABLE,
    E_UNDEF_READ, E_DOUBLE_STAGE, E_PROVENANCE,
)


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding, pointed at the offending instruction (pc = -1 for
    whole-program findings such as an empty code array)."""

    code: str
    pc: int
    message: str

    def __str__(self) -> str:
        where = f"pc={self.pc}" if self.pc >= 0 else "program"
        return f"[{self.code}] {where}: {self.message}"


class VerifyError(ValueError):
    """Structured rejection raised at registration / admission time.

    ``diagnostics`` carries every finding; ``codes`` is the tuple of their
    machine-readable code strings (what tests assert on).
    """

    def __init__(self, name: str, diagnostics):
        self.name = name
        self.diagnostics = tuple(diagnostics)
        lines = "\n  ".join(str(d) for d in self.diagnostics)
        super().__init__(
            f"pulse-verify rejected {name!r}: "
            f"{len(self.diagnostics)} finding(s)\n  {lines}"
        )

    @property
    def codes(self) -> tuple[str, ...]:
        return tuple(d.code for d in self.diagnostics)


@dataclasses.dataclass(frozen=True)
class ProgramFacts:
    """The verification certificate (hashable: rides executable cache keys).

    Attributes:
      name: the verified program's name.
      reachable_ops: opcodes at CFG-reachable pcs.
      mutates/allocs/frees: reachability-based store-class flags -- unlike
        ``Program.mutates`` (a whole-array opcode scan), dead store-class
        code cannot force a program onto the mutating path.
      scratch_words_used: 1 + highest scratch index a reachable
        LOADS/STORES/ALLOC touches (0 for scratch-free programs).
      perm_mask: the access the program can ever require (PERM_READ, plus
        PERM_WRITE iff it mutates) -- what admission must grant, and what
        the read-only specialization is allowed to assume.
      max_path_len: longest instruction path through one iteration (the
        dispatch engine's exact N for its t_c = t_i * N model).
    """

    name: str
    reachable_ops: frozenset[int]
    mutates: bool
    allocs: bool
    frees: bool
    scratch_words_used: int
    perm_mask: int
    max_path_len: int

    @property
    def read_only(self) -> bool:
        return not self.mutates

    def summary(self) -> str:
        kind = "mutating" if self.mutates else "read-only"
        perm = {PERM_READ: "R", PERM_READ | PERM_WRITE: "RW"}[self.perm_mask]
        extra = "".join(
            f" {flag}" for flag, on in (("allocs", self.allocs), ("frees", self.frees))
            if on
        )
        return (
            f"{kind}{extra}; perm={perm}; "
            f"scratch_used={self.scratch_words_used}; "
            f"max_path={self.max_path_len}"
        )


# --------------------------------------------------------------------------
# provenance lattice: join is bitwise-or, UNINIT is bottom, ANY is top
TAG_UNINIT = 0
TAG_NUM = 1
TAG_PTR = 2
TAG_ANY = TAG_NUM | TAG_PTR

# staged-mutation possibility set (bitmask over what _run_vm may have staged
# when control reaches a pc); transitions mirror the VM's staging semantics
# exactly -- an op is rejected iff the VM would silently clobber a prior
# stage on some path (SETPTR resets the mask, FREE/ALLOC retarget, ...).
SG_NONE = 1
SG_STORE = 2
SG_ALLOC = 4
SG_CAS = 8
SG_FREE = 16
_SG_NAMES = {
    SG_NONE: "none", SG_STORE: "STOREN", SG_ALLOC: "ALLOC",
    SG_CAS: "SETPTR", SG_FREE: "FREE",
}

_ALU_3REG = (isa.ADD, isa.SUB, isa.MUL, isa.DIV, isa.AND, isa.OR)
_COND_JUMPS = (isa.JEQ, isa.JNE, isa.JLT, isa.JLE, isa.JGT, isa.JGE)


def _stage_names(mask: int) -> str:
    return "/".join(name for bit, name in _SG_NAMES.items() if mask & bit)


def _reg_reads(op: int, a: int, b: int, imm: int):
    """Register indices an instruction reads (VM semantics, incl. the ALU's
    rs2-in-imm-field encoding)."""
    if op in _ALU_3REG:
        return (b, imm)
    if op in (isa.NOT, isa.MOVE):
        return (b,)
    if op in (isa.STORES, isa.STOREN, isa.FREE, isa.NEXT_ITER):
        return (a,)
    if op == isa.SETPTR:
        return (a, b)
    if op in _COND_JUMPS:
        return (a, b)
    return ()


def _reg_write(op: int, a: int):
    """The register an instruction defines, or None."""
    if op in (isa.LOADN, isa.LOADS, isa.MOVE, isa.MOVI, isa.GETPTR) or op in _ALU_3REG or op == isa.NOT:
        return a
    return None


def _successors(op: int, pc: int, imm: int):
    """CFG successor pcs.  Terminals end the iteration (no successors);
    HALT is handled separately (reachable HALTs are rejected)."""
    if op in (isa.NEXT_ITER, isa.RETURN, isa.HALT):
        return ()
    if op == isa.JMP:
        return (imm,)
    if op in _COND_JUMPS:
        return (imm, pc + 1)
    return (pc + 1,)


def _scan_syntax(code: np.ndarray, scratch_words: int, node_words: int):
    """Phase A: per-instruction syntactic checks over EVERY pc (reachable or
    not -- corrupted dead code is still corrupt).  Returns diagnostics;
    bad opcodes / jump targets make the CFG unbuildable, so callers stop
    there."""
    diags = []
    T = code.shape[0]
    for pc in range(T):
        op, a, b, imm = (int(x) for x in code[pc])
        if op not in isa.OP_NAMES:
            diags.append(Diagnostic(
                E_BAD_OPCODE, pc, f"undefined opcode {op}"
            ))
            continue
        name = isa.OP_NAMES[op]
        if op in isa._JUMPS and not (0 <= imm <= T):
            diags.append(Diagnostic(
                E_JUMP_RANGE, pc,
                f"{name} target {imm} outside [0, {T}]",
            ))
        regs = {
            "a": (a,) if op not in (isa.HALT, isa.JMP, isa.ALLOC) else (),
            "b": (b,) if op in _ALU_3REG + (isa.NOT, isa.MOVE, isa.SETPTR)
            + _COND_JUMPS else (),
            "imm(rs2)": (imm,) if op in _ALU_3REG else (),
        }
        for field, idxs in regs.items():
            for r in idxs:
                if not 0 <= r < isa.NUM_REGS:
                    diags.append(Diagnostic(
                        E_REG_RANGE, pc,
                        f"{name} {field}: register {r} outside "
                        f"[0, {isa.NUM_REGS})",
                    ))
        if op in (isa.LOADN, isa.STOREN, isa.SETPTR) and not (
            0 <= imm < node_words
        ):
            diags.append(Diagnostic(
                E_NODE_RANGE, pc,
                f"{name} node word {imm} outside [0, {node_words})",
            ))
        if op in (isa.LOADS, isa.STORES, isa.ALLOC) and not (
            0 <= imm < scratch_words
        ):
            diags.append(Diagnostic(
                E_SCRATCH_RANGE, pc,
                f"{name} scratch word {imm} outside [0, {scratch_words})",
            ))
    return diags


def _build_cfg(code: np.ndarray):
    """Phase B: reachability + termination over the per-iteration CFG.

    Returns ``(reachable: set[int], diags)``.  Diagnostics: paths that fall
    off the end (pc T is a virtual non-terminated exit), reachable HALTs,
    unreachable instructions, and back edges that close a cycle (the
    iteration could run forever without reaching NEXT_ITER / RETURN).
    """
    T = code.shape[0]
    diags = []
    succ = {}
    for pc in range(T):
        op, _, _, imm = (int(x) for x in code[pc])
        succ[pc] = _successors(op, pc, imm)

    # reachability from pc 0
    reachable: set[int] = set()
    stack = [0]
    while stack:
        pc = stack.pop()
        if pc in reachable or pc >= T:
            continue
        reachable.add(pc)
        stack.extend(succ[pc])

    for pc in sorted(reachable):
        op = int(code[pc, 0])
        if op == isa.HALT:
            diags.append(Diagnostic(
                E_HALT, pc,
                "HALT is reachable: the iteration would end without "
                "NEXT_ITER/RETURN and the record would spin in place",
            ))
        for s in succ[pc]:
            if s == T:
                diags.append(Diagnostic(
                    E_FALLTHROUGH, pc,
                    "execution can run past the last instruction without "
                    "reaching NEXT_ITER/RETURN",
                ))
    for pc in range(T):
        if pc not in reachable:
            diags.append(Diagnostic(
                E_UNREACHABLE, pc,
                f"{isa.OP_NAMES[int(code[pc, 0])]} is unreachable from pc 0",
            ))

    # cycle detection on the reachable subgraph (iterative DFS, colors):
    # a back edge means some iteration path never terminates
    WHITE, GRAY, BLACK = 0, 1, 2
    color = dict.fromkeys(reachable, WHITE)
    for root in sorted(reachable):
        if color[root] != WHITE:
            continue
        stack = [(root, iter([s for s in succ[root] if s < T]))]
        color[root] = GRAY
        while stack:
            pc, it_succ = stack[-1]
            advanced = False
            for s in it_succ:
                if color.get(s, BLACK) == GRAY:
                    diags.append(Diagnostic(
                        E_LOOP, pc,
                        f"jump to pc {s} closes a loop with no intervening "
                        f"NEXT_ITER/RETURN (unbounded iteration)",
                    ))
                elif color.get(s) == WHITE:
                    color[s] = GRAY
                    stack.append((s, iter([t for t in succ[s] if t < T])))
                    advanced = True
                    break
            if not advanced:
                color[pc] = BLACK
                stack.pop()
    return reachable, diags


def _topo_order(reachable, succ):
    """Kahn topological order of the (acyclic) reachable subgraph."""
    indeg = dict.fromkeys(reachable, 0)
    for pc in reachable:
        for s in succ[pc]:
            if s in indeg:
                indeg[s] += 1
    frontier = sorted(pc for pc, d in indeg.items() if d == 0)
    order = []
    while frontier:
        pc = frontier.pop(0)
        order.append(pc)
        for s in succ[pc]:
            if s in indeg:
                indeg[s] -= 1
                if indeg[s] == 0:
                    frontier.append(s)
        frontier.sort()
    return order


def _dataflow(code, reachable, *, scratch_words, node_ptr_slots,
              scratch_ptr_slots):
    """Phase C: abstract interpretation in topological order.

    Per-pc in-state = meet over predecessors of
      (defined-register bitmask [meet = intersection],
       register provenance tags [meet = lattice join],
       scratch provenance tags  [meet = lattice join],
       staged-mutation possibility set [meet = union]).

    One pass is exact because the reachable CFG is a DAG by the time this
    runs (cycles were rejected in phase B).
    """
    T = code.shape[0]
    succ = {}
    for pc in range(T):
        op, _, _, imm = (int(x) for x in code[pc])
        succ[pc] = tuple(s for s in _successors(op, pc, imm) if s < T)

    if node_ptr_slots is None:
        node_tag = None  # undeclared: every node word is ANY
    else:
        node_tag = {int(w): TAG_PTR for w in node_ptr_slots}
    if scratch_ptr_slots is None:
        scratch0 = [TAG_ANY] * scratch_words
    else:
        declared = {int(w) for w in scratch_ptr_slots}
        scratch0 = [
            TAG_PTR if w in declared else TAG_NUM for w in range(scratch_words)
        ]

    entry = (0, (TAG_UNINIT,) * isa.NUM_REGS, tuple(scratch0), SG_NONE)
    state: dict[int, tuple] = {0: entry}
    diags = []

    for pc in _topo_order(reachable, succ):
        st = state.get(pc)
        if st is None:  # pred had no out-state (shouldn't happen on a DAG)
            continue
        defined, rtags, stags, staged = st
        op, a, b, imm = (int(x) for x in code[pc])
        name = isa.OP_NAMES[op]

        # use-before-def on every register read
        ok_reads = True
        for r in _reg_reads(op, a, b, imm):
            if not defined & (1 << r):
                ok_reads = False
                diags.append(Diagnostic(
                    E_UNDEF_READ, pc,
                    f"{name} reads r{r} before any definition on some path",
                ))

        # pointer provenance: values flowing into the memory pipeline
        # (link swings, frees, the next hop) must be able to be pointers
        if ok_reads and op in (isa.SETPTR, isa.FREE, isa.NEXT_ITER):
            val = rtags[a]
            role = {
                isa.SETPTR: "staged link value",
                isa.FREE: "freed address",
                isa.NEXT_ITER: "next cur_ptr",
            }[op]
            if not val & TAG_PTR:
                diags.append(Diagnostic(
                    E_PROVENANCE, pc,
                    f"{name}: {role} r{a} has no pointer provenance "
                    f"(GETPTR/ALLOC/pointer-slot load), only "
                    f"{'numeric' if val else 'uninitialized'} values",
                ))

        # staging discipline: reject any op the VM would let silently
        # clobber (or be clobbered by) a previously staged mutation
        new_staged = staged
        if op == isa.STOREN:
            allowed = SG_NONE | SG_STORE | SG_ALLOC
            new_staged = (
                (SG_STORE if staged & (SG_NONE | SG_STORE) else 0)
                | (staged & SG_ALLOC)
            )
        elif op == isa.ALLOC:
            allowed = SG_NONE | SG_STORE
            new_staged = SG_ALLOC
        elif op == isa.SETPTR:
            allowed = SG_NONE
            new_staged = SG_CAS
        elif op == isa.FREE:
            allowed = SG_NONE
            new_staged = SG_FREE
        else:
            allowed = None
        if allowed is not None and staged & ~allowed:
            diags.append(Diagnostic(
                E_DOUBLE_STAGE, pc,
                f"{name} would clobber a mutation already staged on some "
                f"path ({_stage_names(staged & ~allowed)}): one staged "
                f"mutation per iteration",
            ))

        # transfer: register / scratch writes
        rtags = list(rtags)
        stags = list(stags)
        rd = _reg_write(op, a)
        if rd is not None and 0 <= rd < isa.NUM_REGS:
            defined |= 1 << rd
            if op == isa.GETPTR:
                rtags[rd] = TAG_PTR
            elif op in (isa.MOVI, isa.NOT) or op in _ALU_3REG:
                rtags[rd] = TAG_NUM
            elif op == isa.MOVE:
                rtags[rd] = rtags[b] if 0 <= b < isa.NUM_REGS else TAG_ANY
            elif op == isa.LOADN:
                if node_tag is None:
                    rtags[rd] = TAG_ANY
                else:
                    rtags[rd] = node_tag.get(imm, TAG_NUM)
            elif op == isa.LOADS:
                rtags[rd] = (
                    stags[imm] if 0 <= imm < scratch_words else TAG_ANY
                )
        if op == isa.STORES and 0 <= imm < scratch_words:
            stags[imm] = rtags[a] if 0 <= a < isa.NUM_REGS else TAG_ANY

        out = (defined, tuple(rtags), tuple(stags), new_staged)
        for s in succ[pc]:
            prev = state.get(s)
            if prev is None:
                state[s] = out
            else:
                state[s] = (
                    prev[0] & out[0],
                    tuple(x | y for x, y in zip(prev[1], out[1])),
                    tuple(x | y for x, y in zip(prev[2], out[2])),
                    prev[3] | out[3],
                )
    return diags


def _longest_path(code, reachable):
    """Longest instruction path through one iteration (exact on the DAG)."""
    T = code.shape[0]
    succ = {}
    for pc in range(T):
        op, _, _, imm = (int(x) for x in code[pc])
        succ[pc] = tuple(s for s in _successors(op, pc, imm) if s < T)
    depth = dict.fromkeys(reachable, 1)
    for pc in _topo_order(reachable, succ):
        for s in succ[pc]:
            if s in depth:
                depth[s] = max(depth[s], depth[pc] + 1)
    return max(depth.values(), default=0)


def analyze_program(
    prog,
    *,
    node_ptr_slots=None,
    scratch_ptr_slots=None,
):
    """Run the full verification pipeline without raising.

    Returns ``(facts, diagnostics)`` -- ``facts`` is None whenever
    ``diagnostics`` is non-empty.  ``node_ptr_slots`` / ``scratch_ptr_slots``
    optionally declare which node words / scratch slots hold pointers
    (declaring them makes the provenance lattice exact; leaving them None
    treats every loaded word as ANY, so only forged MOVI/ALU pointers are
    rejected).
    """
    code = np.asarray(prog.code)
    if code.size == 0:
        return None, [Diagnostic(E_EMPTY, -1, "program has no instructions")]

    diags = _scan_syntax(code, prog.scratch_words, prog.node_words)
    if any(d.code in (E_BAD_OPCODE, E_JUMP_RANGE) for d in diags):
        return None, diags  # CFG is unbuildable past this point

    reachable, cfg_diags = _build_cfg(code)
    diags.extend(cfg_diags)
    if any(d.code == E_LOOP for d in cfg_diags):
        return None, diags  # dataflow needs an acyclic reachable CFG

    diags.extend(_dataflow(
        code, reachable,
        scratch_words=prog.scratch_words,
        node_ptr_slots=node_ptr_slots,
        scratch_ptr_slots=scratch_ptr_slots,
    ))
    if diags:
        return None, diags

    reachable_ops = frozenset(int(code[pc, 0]) for pc in reachable)
    mutates = any(op in isa._MUTATORS for op in reachable_ops)
    scratch_used = 0
    for pc in sorted(reachable):
        op, _, _, imm = (int(x) for x in code[pc])
        if op in (isa.LOADS, isa.STORES, isa.ALLOC):
            scratch_used = max(scratch_used, imm + 1)
    facts = ProgramFacts(
        name=prog.name,
        reachable_ops=reachable_ops,
        mutates=mutates,
        allocs=isa.ALLOC in reachable_ops,
        frees=isa.FREE in reachable_ops,
        scratch_words_used=scratch_used,
        perm_mask=PERM_READ | (PERM_WRITE if mutates else 0),
        max_path_len=_longest_path(code, reachable),
    )
    return facts, []


def verify_program(prog, **kwargs) -> ProgramFacts:
    """Verify ``prog``; return its :class:`ProgramFacts` certificate or
    raise :class:`VerifyError` with instruction-pointed diagnostics."""
    facts, diags = analyze_program(prog, **kwargs)
    if diags:
        raise VerifyError(prog.name, diags)
    return facts


# --------------------------------------------------------------------------
# annotated disassembly (the CLI / golden-file format)

def _decode(op: int, a: int, b: int, imm: int) -> str:
    name = isa.OP_NAMES.get(op, f"?{op}")
    if op == isa.LOADN:
        return f"{name:9s} r{a} <- NODE[{imm}]"
    if op == isa.LOADS:
        return f"{name:9s} r{a} <- SP[{imm}]"
    if op == isa.STORES:
        return f"{name:9s} SP[{imm}] <- r{a}"
    if op in _ALU_3REG:
        return f"{name:9s} r{a} <- r{b}, r{imm}"
    if op == isa.NOT:
        return f"{name:9s} r{a} <- ~r{b}"
    if op == isa.MOVE:
        return f"{name:9s} r{a} <- r{b}"
    if op == isa.MOVI:
        return f"{name:9s} r{a} <- {imm}"
    if op in _COND_JUMPS:
        return f"{name:9s} r{a}, r{b} -> {imm}"
    if op == isa.JMP:
        return f"{name:9s} -> {imm}"
    if op == isa.NEXT_ITER:
        return f"{name:9s} r{a}"
    if op == isa.GETPTR:
        return f"{name:9s} r{a} <- CUR_PTR"
    if op == isa.STOREN:
        return f"{name:9s} NODE[{imm}] <- r{a}"
    if op == isa.ALLOC:
        return f"{name:9s} SP[{imm}] <- new"
    if op == isa.SETPTR:
        return f"{name:9s} NODE[{imm}] <- r{a} if == r{b}"
    if op == isa.FREE:
        return f"{name:9s} r{a}"
    return name  # HALT, RETURN


def annotate_disasm(prog, **kwargs) -> str:
    """Annotated disassembly + verdict, the ``tools/pulse_verify.py`` (and
    golden file) format: one line per instruction with the decoded operands,
    diagnostics attached to their pcs, and a header with the verdict."""
    facts, diags = analyze_program(prog, **kwargs)
    code = np.asarray(prog.code)
    by_pc: dict[int, list] = {}
    for d in diags:
        by_pc.setdefault(d.pc, []).append(d)

    lines = [
        f"program {prog.name}: {code.shape[0]} instrs, "
        f"scratch={prog.scratch_words}, node={prog.node_words}",
    ]
    if facts is not None:
        ops = "/".join(sorted(isa.OP_NAMES[o] for o in facts.reachable_ops))
        lines.append(f"verdict: OK  ({facts.summary()})")
        lines.append(f"reachable ops: {ops}")
    else:
        codes = "/".join(sorted({d.code for d in diags}))
        lines.append(f"verdict: REJECTED  ({len(diags)} finding(s): {codes})")
    for d in by_pc.get(-1, ()):
        lines.append(f"  !! {d}")
    for pc in range(code.shape[0]):
        op, a, b, imm = (int(x) for x in code[pc])
        lines.append(f"{pc:4d}: {_decode(op, a, b, imm)}")
        for d in by_pc.get(pc, ()):
            lines.append(f"      !! [{d.code}] {d.message}")
    return "\n".join(lines) + "\n"
