"""pulse_chase on Hopper: build, bind and launch the CUDA kernel.

The kernel (``src/repro_torch/csrc/pulse_chase.cu``) replaces the TPU
kernel ``src/repro/kernels/pulse_chase/kernel.py::_chase_kernel``.  It has
one step loop, templated on the body of one iteration: the interpreter of
the iterator's PULSE ISA program, or the native body of one of the
structures' iterators written in torch (``NATIVE_BODIES``).  What bounds
it on the card: dependent gathers, one per lane-step, so it is
latency-bound; its least time is the bytes bound (the row words a body
reads per executed lane-step plus the lane state in and out once, over
3.35 TB/s).  What the design does about it: one thread per lane and as
many resident lanes as the card holds, so the warp scheduler overlaps the
gathers of independent lanes; one launch runs a whole batch to its end.

The source is built and loaded by ``kernels._build`` (``nvcc`` for
``sm_90a``, a hashed library under ``build/kernels/``, ``ctypes``).  The
opcode numbering comes from ``core.isa`` and the structures' node layouts
from their modules, as ``-D`` defines, so the kernel has no copy of its
own.  A build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import types

import torch

from repro_torch.core import arena as _arena
from repro_torch.core import isa, routing
from repro_torch.core import iterator as _iterator
from repro_torch.core.arena import MAX_NODE_WORDS, PERM_READ
from repro_torch.core.structures import bst, btree, hash_table, linked_list, skiplist
from repro_torch.kernels import _build


@dataclasses.dataclass(frozen=True)
class NativeBody:
    """A structure's iterator written in torch that the kernel runs as a
    native body: the iterator's name, the module and factory that make it,
    its scratch-pad words and the words of a node row it reads."""

    name: str
    module: types.ModuleType
    factory: str
    scratch_words: int
    row_words: int


def _row(*offsets: int) -> int:
    return max(offsets) + 1


_BTREE_ROW = _row(btree.IS_LEAF, btree.NUM_KEYS, btree.KEYS0 + btree.FANOUT - 1,
                  btree.CHILD0 + btree.FANOUT, btree.VAL0 + btree.FANOUT - 1, btree.NEXT_LEAF)

NATIVE_BODIES = {
    b.name: b
    for b in (
        NativeBody("list_find", linked_list, "find_iterator", linked_list.SCRATCH_WORDS,
                   _row(linked_list.KEY, linked_list.VALUE, linked_list.NEXT)),
        NativeBody("list_sum", linked_list, "sum_iterator",
                   linked_list.sum_iterator().scratch_words,
                   _row(linked_list.VALUE, linked_list.NEXT)),
        NativeBody("hash_find", hash_table, "find_iterator", hash_table.SCRATCH_WORDS,
                   _row(hash_table.KEY, hash_table.VALUE, hash_table.NEXT)),
        NativeBody("bst_find", bst, "find_iterator", bst.SCRATCH_WORDS,
                   _row(bst.KEY, bst.VALUE, bst.LEFT, bst.RIGHT)),
        NativeBody("btree_find", btree, "find_iterator", btree.find_iterator().scratch_words,
                   _BTREE_ROW),
        NativeBody("btree_range_agg", btree, "range_aggregate_iterator", btree.RA_WORDS,
                   _BTREE_ROW),
        NativeBody("skiplist_find", skiplist, "find_iterator", skiplist.SCRATCH_WORDS,
                   _row(skiplist.KEY, skiplist.VALUE,
                        skiplist.NPTR0 + 2 * skiplist.LEVELS - 1)),
    )
}
BODIES = ("isa", *NATIVE_BODIES)  # the kernel's body ids, in this order


def native_body(it) -> NativeBody | None:
    """The native body of a structure's iterator written in torch, or None.

    An iterator qualifies by its name and by its ``next_fn``/``end_fn``
    being the ones its structure's factory makes, so an ad-hoc iterator
    that borrows a name does not."""
    body = NATIVE_BODIES.get(it.name)
    if body is None or it.step_fn is not None or it.scratch_words != body.scratch_words:
        return None
    prefix = f"{body.factory}.<locals>."
    for fn in (it.next_fn, it.end_fn):
        if (getattr(fn, "__module__", None) != body.module.__name__
                or not getattr(fn, "__qualname__", "").startswith(prefix)):
            return None
    return body


def _layout_defines() -> dict[str, int]:
    L, H, T, B, K = linked_list, hash_table, bst, btree, skiplist
    nb = NATIVE_BODIES
    return dict(
        PULSE_NULL=_arena.NULL,
        LIST_KEY=L.KEY, LIST_VALUE=L.VALUE, LIST_NEXT=L.NEXT,
        LIST_KEY_NOT_FOUND=L.KEY_NOT_FOUND,
        LIST_FIND_WORDS=nb["list_find"].scratch_words, LIST_FIND_ROW=nb["list_find"].row_words,
        LIST_SUM_WORDS=nb["list_sum"].scratch_words, LIST_SUM_ROW=nb["list_sum"].row_words,
        HASH_KEY=H.KEY, HASH_VALUE=H.VALUE, HASH_NEXT=H.NEXT,
        HASH_KEY_NOT_FOUND=H.KEY_NOT_FOUND,
        HASH_FIND_WORDS=nb["hash_find"].scratch_words, HASH_FIND_ROW=nb["hash_find"].row_words,
        BST_KEY=T.KEY, BST_VALUE=T.VALUE, BST_LEFT=T.LEFT, BST_RIGHT=T.RIGHT,
        BST_S_KEY=T.S_KEY, BST_S_Y=T.S_Y, BST_S_YKEY=T.S_YKEY, BST_S_YVAL=T.S_YVAL,
        BST_SCRATCH_WORDS=nb["bst_find"].scratch_words, BST_ROW=nb["bst_find"].row_words,
        BTREE_FANOUT=B.FANOUT, BTREE_IS_LEAF=B.IS_LEAF, BTREE_NUM_KEYS=B.NUM_KEYS,
        BTREE_KEYS0=B.KEYS0, BTREE_CHILD0=B.CHILD0, BTREE_VAL0=B.VAL0,
        BTREE_NEXT_LEAF=B.NEXT_LEAF, BTREE_KEY_NOT_FOUND=B.KEY_NOT_FOUND,
        BTREE_INT_MIN=B.INT_MIN, BTREE_INT_MAX=B.INT_MAX,
        BTREE_FIND_WORDS=nb["btree_find"].scratch_words, BTREE_ROW=_BTREE_ROW,
        BTREE_RA_LO=B.RA_LO, BTREE_RA_HI=B.RA_HI, BTREE_RA_SUM=B.RA_SUM,
        BTREE_RA_MIN=B.RA_MIN, BTREE_RA_MAX=B.RA_MAX, BTREE_RA_COUNT=B.RA_COUNT,
        BTREE_RA_WORDS=nb["btree_range_agg"].scratch_words,
        SKIP_LEVELS=K.LEVELS, SKIP_KEY=K.KEY, SKIP_VALUE=K.VALUE, SKIP_NPTR0=K.NPTR0,
        SKIP_KEY_NOT_FOUND=K.KEY_NOT_FOUND,
        SKIP_FIND_WORDS=nb["skiplist_find"].scratch_words, SKIP_ROW=nb["skiplist_find"].row_words,
        REC_PTR=routing.F_PTR, REC_STATUS=routing.F_STATUS, REC_ITERS=routing.F_ITERS,
        REC_SCRATCH=routing.F_SCRATCH,
        **{f"STATUS_{k}": getattr(_iterator, f"STATUS_{k}")
           for k in ("ACTIVE", "DONE", "MAXED", "FAULT")},
        **{f"PULSE_BODY_{name.upper()}": i for i, name in enumerate(BODIES)},
    )


LAYOUT_DEFINES = _layout_defines()
OPCODE_DEFINES = tuple(
    f"-DPULSE_OP_{name}={op}" for op, name in sorted(isa.OP_NAMES.items())
) + (f"-DPULSE_LAST_OP={max(isa.ALL_OPS)}",)
SOURCE = _build.KernelSource(
    "pulse_chase", _build.CSRC / "pulse_chase.cu",
    OPCODE_DEFINES + tuple(f"-D{k}={v}" for k, v in LAYOUT_DEFINES.items()),
)
_SRC = SOURCE.source
NVCC_FLAGS = SOURCE.flags

MAX_SCRATCH_WORDS = 32
MAX_PROGRAM_ROWS = 1024  # 16 KB of shared memory, decoded
MAX_FAULT_TABLE = 1024  # shard bases and permission words held in shared memory


class ChaseArgs(ctypes.Structure):
    """``ChaseArgs`` of the source: pointers first, then ints."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "arena", "code", "ptr_in", "scr_in", "st_in", "it_in", "ptr_out", "scr_out",
        "st_out", "it_out", "faulted_out", "bounds", "perms", "next_lane", "pool_in",
        "pool_out", "rep_rows", "primary_map", "dead_mask", "budget")] + [
        (n, ctypes.c_int) for n in (
            "cap", "W", "T", "B", "S", "num_steps", "quantum", "mode", "n_bounds", "n_perms",
            "check_cap", "need", "R", "L", "max_iters", "elide", "rep_spread", "shard0",
            "row0")]


MODE_FIXED, MODE_RUN, MODE_SUPERSTEP = 0, 1, 2  # ChaseArgs.mode


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = SOURCE.load()
    args = ctypes.POINTER(ChaseArgs)
    lib.pulse_chase_launch.argtypes = [ctypes.c_int, args, ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int)]
    lib.pulse_chase_launch.restype = ctypes.c_int
    lib.pulse_chase_blocks_per_sm.argtypes = [ctypes.c_int, args, ctypes.POINTER(ctypes.c_int)]
    lib.pulse_chase_blocks_per_sm.restype = ctypes.c_int
    lib.pulse_chase_error_string.argtypes = [ctypes.c_int]
    lib.pulse_chase_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, device: torch.device, ndim: int) -> None:
    if t.device != device:
        raise ValueError(f"pulse_chase: {name} is on {t.device}, the arena on {device}")
    if t.dtype != torch.int32:
        raise ValueError(f"pulse_chase: {name} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"pulse_chase: {name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"pulse_chase: {name} must be contiguous")


def _raise(lib, what: str, err: int) -> None:
    raise RuntimeError(f"pulse_chase {what} failed: CUDA error {err} "
                       f"({lib.pulse_chase_error_string(err).decode()})")


def launch(arena, ptr, scratch, status, iters, code, num_steps: int, *, body: str = "isa",
           quantum: int = 1, fault=None):
    """Launch the kernel once on PyTorch's current stream.  Does not
    synchronise.

    ``body`` is ``"isa"`` (``code`` is the program's ``(T, 4)`` code) or the
    name of a native body (``code`` is None).  With ``iters`` given, runs
    ``num_steps`` steps with the counts accumulated on top of ``iters`` and
    returns new ``(ptr, scratch, status, iters)``.  With ``iters=None``, runs
    every lane to its end within a budget of ``num_steps`` iterations (a
    NULL entry faults; ``fault``, an ``ops.FaultCheck`` or None, is checked
    every ``quantum`` iterations and at the budget) and returns new
    ``(ptr, scratch, status, iters, faulted)``."""
    dev = arena.device
    if dev.type != "cuda":
        raise ValueError(f"pulse_chase kernel needs CUDA tensors, got {dev}")
    run = iters is None
    lanes = [("arena", arena, 2), ("ptr", ptr, 1), ("scratch", scratch, 2),
             ("status", status, 1)]
    if not run:
        lanes.append(("iters", iters, 1))
    if body == "isa":
        lanes.append(("code", code, 2))
    for name, t, nd in lanes:
        _check(name, t, dev, nd)
    cap, W = arena.shape
    B, S = scratch.shape
    T = _check_body(body, code, W, S, cap)
    if not ptr.shape[0] == status.shape[0] == B or (not run and iters.shape[0] != B):
        raise ValueError("pulse_chase: lane tensors disagree on the batch size")
    if run and quantum < 1:
        raise ValueError(f"pulse_chase: depth quantum must be >= 1, got {quantum}")
    if not 0 <= num_steps < 2**31:
        raise ValueError(f"pulse_chase: num_steps {num_steps} out of range")

    a = ChaseArgs(cap=cap, W=W, T=T, B=B, S=S, num_steps=int(num_steps),
                  mode=MODE_RUN if run else MODE_FIXED, quantum=int(quantum) if run else 1)
    if fault is not None:
        if not run:
            raise ValueError("pulse_chase: a fault check needs iters=None (one whole run)")
        bounds, perms = fault.bounds, fault.perms
        for name, t in (("bounds", bounds), ("perms", perms)):
            _check(name, t, dev, 1)
        if not 0 < bounds.shape[0] <= MAX_FAULT_TABLE or not 0 < perms.shape[0] <= MAX_FAULT_TABLE:
            raise ValueError(f"pulse_chase: fault table of {bounds.shape[0]} bases and "
                             f"{perms.shape[0]} permission words (1-{MAX_FAULT_TABLE} each)")
        a.bounds, a.perms = bounds.data_ptr(), perms.data_ptr()
        a.n_bounds, a.n_perms = bounds.shape[0], perms.shape[0]
        a.check_cap, a.need = int(fault.cap), int(fault.need)
    outs = [torch.empty_like(ptr), torch.empty_like(scratch), torch.empty_like(status),
            torch.empty_like(ptr)]
    if run:
        outs.append(torch.empty(B, dtype=torch.bool, device=dev))
        iters_ptr, faulted_ptr = None, outs[4].data_ptr()
    else:
        iters_ptr, faulted_ptr = iters.data_ptr(), None
    a.arena, a.code = arena.data_ptr(), code.data_ptr() if body == "isa" else None
    a.ptr_in, a.scr_in, a.st_in, a.it_in = (ptr.data_ptr(), scratch.data_ptr(),
                                            status.data_ptr(), iters_ptr)
    a.ptr_out, a.scr_out, a.st_out, a.it_out = (o.data_ptr() for o in outs[:4])
    a.faulted_out = faulted_ptr
    _go(a, body, dev)
    return tuple(outs)


launch.last_grid = 0  # blocks of the last launch (the card's resident blocks, or fewer)


def launch_superstep(arena, pool, bounds, perms, code, k_local: int, *, body: str = "isa",
                     scratch_words: int, max_iters, elide: bool, rep=None, shard0: int = 0,
                     row0: int = 0):
    """Launch one routing superstep (mode 2) on PyTorch's current stream:
    ``k_local`` steps of every record of ``pool`` ((P, L, R) int32, shard
    ``s``'s records at ``pool[s]``) over the rows of its shard, ``bounds``
    ((P + 1,) shard bases) and ``perms`` ((P,) permission bits; a shard
    reads when it grants PERM_READ, or always with ``elide``) on the card.
    ``rep = (rep_rows, primary_map, dead_mask, policy)`` (replicated
    reads: (cap, W) int32 rows in the arena's layout, (P,) int32, (P,)
    bool, the ``ReplicaPlan`` policy) adds each shard's replica window.
    ``max_iters`` is an int, passed by value, or a one-element int32
    tensor on the card, which the kernel reads (a captured launch then
    takes whatever budget the tensor holds at replay).
    ``shard0`` and ``row0`` take one shard of the launch: ``pool`` holds
    shards ``shard0 ..`` of the ``perms.shape[0]`` that ``bounds`` and
    ``perms`` describe, and ``arena``'s first row is global row ``row0``,
    as is ``rep_rows``'s (a memory node's holder slice).
    Returns the new pool; reads nothing on the host and does not
    synchronise.  An empty pool raises: every call launches."""
    dev = arena.device
    if dev.type != "cuda":
        raise ValueError(f"pulse_chase kernel needs CUDA tensors, got {dev}")
    checks = [("arena", arena, 2), ("pool", pool, 3), ("bounds", bounds, 1), ("perms", perms, 1)]
    if body == "isa":
        checks.append(("code", code, 2))
    for name, t, nd in checks:
        _check(name, t, dev, nd)
    cap, W = arena.shape
    P, L, R = pool.shape
    S = int(scratch_words)
    T = _check_body(body, code, W, S, cap)
    if R < routing.F_SCRATCH + S:
        raise ValueError(f"pulse_chase: records of {R} words cannot hold {S} scratch words")
    n_shards = perms.shape[0]
    if (not 0 < n_shards < MAX_FAULT_TABLE or bounds.shape[0] != n_shards + 1
            or not 0 <= shard0 <= n_shards - P or row0 < 0):
        raise ValueError(f"pulse_chase: pools of shards {shard0}..{shard0 + P - 1} need a mesh "
                         f"of at least {shard0 + P} shards (1-{MAX_FAULT_TABLE - 1}), its "
                         f"bounds one more word, and a row offset >= 0; got {bounds.shape[0]} "
                         f"bounds, {n_shards} permission words, row {row0}")
    if not 0 < P * L or P * L * R >= 2**31 or not 0 <= k_local < 2**31:
        raise ValueError(f"pulse_chase: pool {tuple(pool.shape)} or k_local {k_local} out of "
                         "range")
    out = torch.empty_like(pool)
    on_card = isinstance(max_iters, torch.Tensor)
    if on_card and (max_iters.device != dev or max_iters.dtype != torch.int32
                    or max_iters.numel() != 1):
        raise ValueError(f"pulse_chase: a budget tensor must be one int32 word on {dev}, got "
                         f"{max_iters.dtype} {tuple(max_iters.shape)} on {max_iters.device}")
    a = ChaseArgs(cap=cap, W=W, T=T, B=P * L, S=S, num_steps=int(k_local), mode=MODE_SUPERSTEP,
                  quantum=1, n_bounds=n_shards + 1, n_perms=n_shards, need=PERM_READ, R=R, L=L,
                  max_iters=0 if on_card else int(min(max_iters, 2**31 - 1)),
                  elide=int(bool(elide)), shard0=int(shard0), row0=int(row0))
    if on_card:
        a.budget = max_iters.data_ptr()
    a.arena, a.code = arena.data_ptr(), code.data_ptr() if body == "isa" else None
    a.bounds, a.perms = bounds.data_ptr(), perms.data_ptr()
    a.pool_in, a.pool_out = pool.data_ptr(), out.data_ptr()
    if rep is not None:
        rep_rows, primary, dead, policy = rep
        for name, t, nd in (("rep_rows", rep_rows, 2), ("primary_map", primary, 1)):
            _check(name, t, dev, nd)
        if rep_rows.shape != arena.shape or primary.shape[0] != n_shards:
            raise ValueError(f"pulse_chase: replica rows {tuple(rep_rows.shape)} and primary "
                             f"map {tuple(primary.shape)} for an arena {tuple(arena.shape)} "
                             f"of {P} shards")
        if (dead.device != dev or dead.dtype != torch.bool or tuple(dead.shape) != (n_shards,)
                or not dead.is_contiguous()):
            raise ValueError(f"pulse_chase: dead_mask must be a contiguous ({n_shards},) bool "
                             f"tensor on {dev}, got {dead.dtype} {tuple(dead.shape)} on "
                             f"{dead.device}")
        a.rep_rows, a.primary_map, a.dead_mask = (rep_rows.data_ptr(), primary.data_ptr(),
                                                  dead.data_ptr())
        a.rep_spread = int(policy == "spread")
    _go(a, body, dev)
    return out


def _check_body(body: str, code, W: int, S: int, cap: int) -> int:
    """Check that ``body`` takes rows of ``W`` words and ``S`` scratch
    words; returns the program's rows (0 for a native body)."""
    if body not in BODIES:
        raise ValueError(f"pulse_chase: unknown body {body!r}; known: {BODIES}")
    if W > MAX_NODE_WORDS:
        raise ValueError(f"pulse_chase: node_words {W} > {MAX_NODE_WORDS}")
    if S > MAX_SCRATCH_WORDS:
        raise ValueError(f"pulse_chase: scratch_words {S} > {MAX_SCRATCH_WORDS}")
    if cap == 0:
        raise ValueError("pulse_chase: empty arena")
    if body != "isa":
        nb = NATIVE_BODIES[body]
        if S != nb.scratch_words or W < nb.row_words:
            raise ValueError(
                f"pulse_chase: body {body} takes {nb.scratch_words} scratch words and rows "
                f"of at least {nb.row_words} words, got {S} and {W}")
        return 0
    T = code.shape[0]
    if not 0 < T <= MAX_PROGRAM_ROWS or code.shape[1] != 4:
        raise ValueError(
            f"pulse_chase: program must be (T, 4) with 0 < T <= {MAX_PROGRAM_ROWS}, "
            f"got {tuple(code.shape)}"
        )
    return T


def _go(a: ChaseArgs, body: str, dev) -> None:
    """Launch with ``a`` on the current stream (a work counter of its own);
    raises on a refused launch."""
    counter = torch.empty(1, dtype=torch.int32, device=dev)  # zeroed by the launcher
    a.next_lane = counter.data_ptr()
    lib = _library()
    grid = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = lib.pulse_chase_launch(BODIES.index(body), ctypes.byref(a),
                                     torch.cuda.current_stream(dev).cuda_stream,
                                     ctypes.byref(grid))
    if err != 0:
        _raise(lib, "launch", err)
    launch.last_grid = grid.value


def blocks_per_sm(body: str, *, T: int = 0, S: int = 0, W: int = 0, n_fault_words: int = 0,
                  device=None) -> int:
    """Resident blocks (of 128 threads) per SM the card allows for ``body``
    at the shared memory a launch with these sizes takes."""
    lib = _library()
    a = ChaseArgs(T=T, S=S, W=W, n_bounds=n_fault_words)
    n = ctypes.c_int(0)
    with torch.cuda.device(device or torch.cuda.current_device()):
        err = lib.pulse_chase_blocks_per_sm(BODIES.index(body), ctypes.byref(a), ctypes.byref(n))
    if err != 0:
        _raise(lib, "occupancy query", err)
    return n.value
