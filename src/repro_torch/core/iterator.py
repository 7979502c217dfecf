"""PULSE iterator programming model (paper S3) on torch tensors.

A traversal is ``init() / next() / end()`` plus a fixed-size int32
``scratch_pad``; all mutable state lives in ``(cur_ptr, scratch_pad)`` so a
traversal can be suspended and resumed anywhere.

Per-iteration semantics (Listing 1 + S4.1):

    node = LOAD(cur_ptr)                 # ONE aggregated <=256 B load
    done, scratch = end(node, cur_ptr, scratch)
    if not done:
        cur_ptr, scratch = next(node, cur_ptr, scratch)

Iterator bodies are written batched: ``node`` is ``(B, W)``, ``ptr`` is
``(B,)`` and ``scratch`` is ``(B, S)``, all int32 on one device.  A body
returns new tensors and never writes into its inputs.  ``execute_batched``
runs a batch to completion; ``max_iters`` caps the iteration count and
overrunning requests return STATUS_MAXED with their scratch pad
(continuation semantics).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import translation
from repro_torch.core.arena import M_NONE, NULL, PERM_READ, Arena, load_node

# Request status codes (wire format field; identical for request & response).
STATUS_ACTIVE = 0  # still traversing
STATUS_DONE = 1  # end() returned true; scratch_pad is the result
STATUS_MAXED = 2  # hit max_iters; resumable continuation
STATUS_FAULT = 3  # translation/protection failure
STATUS_EMPTY = 4  # free slot (routing pools only)

# Serving-layer terminal codes (negative: never appear on the wire).
STATUS_SHED = -2
STATUS_RETRY = -3


@dataclasses.dataclass(frozen=True)
class PulseIterator:
    """A traversal program: the developer supplies next()/end() (+ optional
    host-side init()); the framework supplies execute().

    Attributes:
      scratch_words: fixed scratch_pad width (int32 words).
      next_fn:  (node (B,W), ptr (B,), scratch (B,S)) -> (new_ptr, scratch)
      end_fn:   (node (B,W), ptr (B,), scratch (B,S)) -> (done (B,), scratch)
      init_fn:  optional host-side (query...) -> (ptr (B,), scratch (B,S))
      step_fn:  optional fused (node, ptr, scratch) -> (done, new_ptr, scratch)
                (the ISA VM, whose single pass yields both answers).  An
                ISA-backed step_fn carries its program as
                ``step_fn.__wrapped_program__``.
      mut_fn:   optional mutating fused step (the write path):
                (node, ptr, scratch) -> (done, new_ptr, scratch,
                                         (m_op, m_tgt, m_mask, m_expect,
                                          m_data (B, W)))
                -- a step that stages a mutation (m_op != M_NONE) stalls its
                record until the commit phase applies it (core.commit).
      name:     for dispatch-engine reports.
      facts:    optional ``verify.ProgramFacts`` certificate.
      n_instructions: the dispatch model's instruction count N for an
                iterator written in torch (ISA iterators count their program
                instead).  Excluded from eq/hash like ``facts``.
    """

    scratch_words: int
    next_fn: Callable
    end_fn: Callable
    init_fn: Callable | None = None
    step_fn: Callable | None = None
    mut_fn: Callable | None = None
    name: str = "iterator"
    facts: object | None = dataclasses.field(default=None, compare=False)
    n_instructions: int | None = dataclasses.field(default=None, compare=False)

    @property
    def mutates(self) -> bool:
        return self.mut_fn is not None

    def init(self, *args, **kwargs):
        if self.init_fn is None:
            raise ValueError(f"iterator {self.name} has no init()")
        return self.init_fn(*args, **kwargs)


def _step_one(it: PulseIterator, node, ptr, scratch):
    """One iteration for every request of the batch (after the nodes have
    been fetched): ``(done, new_ptr, new_scratch)`` with the pointer gated on
    ``done``."""
    if it.step_fn is not None:
        done, new_ptr, new_scratch = it.step_fn(node, ptr, scratch)
        new_ptr = torch.where(done, ptr, new_ptr).to(torch.int32)
        return done, new_ptr, new_scratch.to(torch.int32)
    done, scratch = it.end_fn(node, ptr, scratch)
    nptr, nscratch = it.next_fn(node, ptr, scratch)
    new_ptr = torch.where(done, ptr, nptr).to(torch.int32)
    new_scratch = torch.where(done[:, None], scratch, nscratch).to(torch.int32)
    return done, new_ptr, new_scratch


def step_batch(
    it: PulseIterator,
    arena_data: torch.Tensor,
    ptr: torch.Tensor,  # (B,) int32 global addresses
    scratch: torch.Tensor,  # (B, S) int32
    status: torch.Tensor,  # (B,) int32
    iters: torch.Tensor,  # (B,) int32
    *,
    max_iters: int,
    local_lo: int | torch.Tensor = 0,
    local_hi: int | torch.Tensor | None = None,
    perm_ok: torch.Tensor | bool = True,
    logic_fn=None,
    rep_data: torch.Tensor | None = None,
    rep_lo: int | torch.Tensor = 0,
    rep_hi: int | torch.Tensor = 0,
    rep_base: int | torch.Tensor = 0,
    rep_on: torch.Tensor | bool = False,
    rep_perm_ok: torch.Tensor | bool = True,
):
    """Advance every ACTIVE request by one iteration.

    ``local_lo/local_hi`` bound the addresses this executor can serve; an
    ACTIVE request pointing elsewhere is left untouched.  ``perm_ok`` is the
    node-level protection check result (a bool or a ``(B,)`` bool tensor).

    ``logic_fn`` optionally substitutes a batched fused next+end body
    (``kernels.pulse_chase.ops.iterator_logic``) with identical done-gating.

    ``rep_data``/``rep_lo``/``rep_hi`` declare a second servable range: the
    replica rows this executor holds for another shard (read fan-out).
    When ``rep_on`` is true a record whose pointer lies in ``[rep_lo,
    rep_hi)`` is chased from ``rep_data`` at row ``ptr - rep_lo +
    rep_base`` under the primary's grant ``rep_perm_ok``; replicas are
    bit-identical to their primary, so the copy that served a read never
    changes its result.
    """
    if local_hi is None:
        local_hi = arena_data.shape[0]
    own = (ptr >= local_lo) & (ptr < local_hi)
    if rep_data is not None:
        rep = torch.as_tensor(rep_on, device=ptr.device) & (ptr >= rep_lo) & (ptr < rep_hi)
    else:
        rep = torch.zeros_like(own)
    local = own | rep
    null = ptr == NULL
    active = status == STATUS_ACTIVE

    # a replica-served record checks the primary's grant
    grant = torch.where(rep, torch.as_tensor(rep_perm_ok, device=ptr.device),
                        torch.as_tensor(perm_ok, dtype=torch.bool, device=ptr.device))
    fault = active & local & ~grant & ~null
    runnable = active & local & ~fault & ~null

    offset = ptr - local_lo
    node = load_node(arena_data, torch.where(runnable & own, offset, 0))
    if rep_data is not None:
        rep_node = load_node(rep_data, torch.where(runnable & rep, ptr - rep_lo + rep_base, 0))
        node = torch.where(rep[:, None], rep_node, node)
    if logic_fn is not None:
        done, nptr, nscr = logic_fn(node, ptr, scratch)
        new_ptr = torch.where(done, ptr, nptr).to(torch.int32)
        new_scratch = nscr.to(torch.int32)
    else:
        done, new_ptr, new_scratch = _step_one(it, node, ptr, scratch)

    ptr = torch.where(runnable, new_ptr, ptr)
    scratch = torch.where(runnable[:, None], new_scratch, scratch)
    iters = torch.where(runnable, iters + 1, iters)
    status = torch.where(runnable & done, STATUS_DONE, status)
    status = torch.where(fault, STATUS_FAULT, status)
    status = torch.where(
        (status == STATUS_ACTIVE) & (iters >= max_iters), STATUS_MAXED, status
    )
    # a finished-by-NULL-dereference is a fault too (walked off the structure)
    status = torch.where(active & null, STATUS_FAULT, status)
    return ptr, scratch, status, iters


def mut_step_batch(
    it: PulseIterator,
    arena_data: torch.Tensor,
    ptr: torch.Tensor,  # (B,) int32 global addresses
    scratch: torch.Tensor,  # (B, S) int32
    status: torch.Tensor,  # (B,) int32
    iters: torch.Tensor,  # (B,) int32
    mut: torch.Tensor,  # (B, MUT_EXTRA + W) staged-mutation payload block
    *,
    max_iters: int,
    local_lo: int = 0,
    local_hi: int | None = None,
    perm_ok: torch.Tensor | bool = True,
    row0: int = 0,
):
    """Advance every runnable request of a *mutating* iterator by one step.

    ``arena_data`` is the whole arena, addressed by global row (or, with
    ``row0``, the rows from global row ``row0`` on: a memory node's own);
    ``local_lo``/``local_hi`` bound the addresses this executor serves (ints,
    or ``(B,)`` tensors of per-request bounds, as the routing superstep
    gives when it chases every shard's pool in one call).  The JAX
    package's ``mut_step_batch`` takes a shard's rows and offsets by
    ``local_lo``; here the offset is ``row0``, apart from the bounds.

    The write-path twin of ``step_batch``, with its rules (core.commit):

      * a record with a staged mutation (``mut[:, 0] != M_NONE``) is
        stalled: it runs nothing until its commit phase applies the
        mutation and clears the payload;
      * a step that stages a mutation cannot also finish: ``done`` is
        forced off, so a program ends on a clean iteration after it has
        observed its commit;
      * a record never goes MAXED while a mutation is staged, so a MAXED
        continuation resumes from ``(cur_ptr, scratch)`` alone;
      * a record whose budget is spent (``iters >= max_iters``) takes no
        further step; it MAXes once its commit has cleared.

    Returns new ``(ptr, scratch, status, iters, mut)``.
    """
    if local_hi is None:
        local_hi = arena_data.shape[0]
    stalled = mut[:, 0] != M_NONE
    exhausted = iters >= max_iters
    local = (ptr >= local_lo) & (ptr < local_hi)
    null = ptr == NULL
    active = status == STATUS_ACTIVE
    grant = torch.as_tensor(perm_ok, dtype=torch.bool, device=ptr.device)
    fault = active & local & ~grant & ~null & ~stalled
    runnable = active & local & ~fault & ~null & ~stalled & ~exhausted

    node = load_node(arena_data, torch.where(runnable, ptr - row0, 0))
    done, nptr, nscr, staged = it.mut_fn(node, ptr, scratch)
    m_op, m_tgt, m_mask, m_expect, m_data = (
        torch.as_tensor(x, dtype=torch.int32, device=ptr.device) for x in staged
    )
    stages = m_op != M_NONE
    done = done & ~stages  # the commit is part of the traversal
    new_ptr = torch.where(done, ptr, nptr).to(torch.int32)

    ptr = torch.where(runnable, new_ptr, ptr)
    scratch = torch.where(runnable[:, None], nscr.to(torch.int32), scratch)
    iters = torch.where(runnable, iters + 1, iters)
    payload = torch.cat([torch.stack([m_op, m_tgt, m_mask, m_expect], 1), m_data], 1)
    mut = torch.where((runnable & stages)[:, None], payload, mut)
    pending = mut[:, 0] != M_NONE

    status = torch.where(runnable & done, STATUS_DONE, status)
    status = torch.where(fault, STATUS_FAULT, status)
    status = torch.where(
        (status == STATUS_ACTIVE) & (iters >= max_iters) & ~pending,
        STATUS_MAXED,
        status,
    )
    status = torch.where(active & null & ~stalled, STATUS_FAULT, status)
    return ptr, scratch, status, iters, mut


def execute_batched(
    it: PulseIterator,
    arena: Arena,
    ptr0,
    scratch0,
    *,
    max_iters: int,
    unroll: int = 1,
    elide_access_check: bool = False,
):
    """Run a batch of traversals to completion on one memory node.

    The plain executor the kernel path is held against.  The loop checks
    for a remaining ACTIVE request once every ``unroll`` steps.
    ``elide_access_check=True`` drops the per-step owner lookup and access
    probe; callers set it only when the check is constant-true
    (``routing.can_elide_access_check``).

    Returns ``(ptr, scratch, status, iters)`` on the arena's device.
    """
    if it.mutates:
        raise ValueError(
            f"iterator {it.name} mutates: execute_batched is the read-only "
            f"executor and would silently drop its staged writes"
        )
    dev = arena.data.device
    ptr = torch.as_tensor(ptr0, dtype=torch.int32).to(dev)
    B = ptr.shape[0]
    scratch = torch.as_tensor(scratch0, dtype=torch.int32).to(dev)
    scratch = scratch.reshape(B, it.scratch_words)
    status = torch.full((B,), STATUS_ACTIVE, dtype=torch.int32, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)

    readable = None if elide_access_check else translation.access_table(
        arena.perms, PERM_READ
    )
    while bool((status == STATUS_ACTIVE).any()):
        for _ in range(unroll):
            if readable is None:
                perm = True
            else:
                perm = translation.check_access_table(
                    readable, translation.owner_of(arena.bounds, ptr)
                )
            ptr, scratch, status, iters = step_batch(
                it, arena.data, ptr, scratch, status, iters,
                max_iters=max_iters, perm_ok=perm,
            )
    return ptr, scratch, status, iters


def resume(status: torch.Tensor) -> torch.Tensor:
    """Continuation restart: MAXED requests become ACTIVE again."""
    return torch.where(status == STATUS_MAXED, STATUS_ACTIVE, status)
