"""Wrappers for the pulse_chase kernel, the PulseIterator adapter, the
whole-traversal run that ``PulseEngine.execute`` uses, the local chase of
a routing superstep and the variable-depth wave scheduler.

``pulse_chase`` (fixed depth), ``pulse_chase_run`` (one traversal to its
end, one launch) and ``pulse_chase_superstep`` (one superstep of every
shard's pool, one launch) launch the CUDA kernel for CUDA tensors and run
their plain versions (``ref.chase_reference``, ``ref.chase_run_reference``,
``ref.chase_superstep_reference``) for CPU tensors; they never fall back
from one to the other.  ``pulse_chase.launches`` counts the kernel's
launches from all three.
``pulse_chase_waves`` is the counterpart of the JAX package's wave
scheduler, held against it; it launches ``pulse_chase`` once per chunk.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.arena import PERM_READ
from repro_torch.core.iterator import PulseIterator
from repro_torch.kernels.pulse_chase import kernel as _kernel
from repro_torch.kernels.pulse_chase.ref import (
    chase_reference,
    chase_run_reference,
    chase_superstep_reference,
)


class ChaseLogic:
    """The batched fused next+end body of a PulseIterator, and the body the
    kernel runs for it.

    Calling it runs the body in torch: ``(nodes (B,W), ptr (B,), scratch
    (B,S)) -> (done, new_ptr, new_scratch)``.  ``program`` is the iterator's
    ``Program`` for an ISA iterator (``code_on(device)`` gives its code
    tensor, ``core.isa.IsaStep.code_on``), else None.  ``native`` is the
    kernel's native body (``kernel.NATIVE_BODIES``) for a structure's
    iterator written in torch, else None.  The kernel runs a logic that has
    either; any other raises on a CUDA tensor."""

    def __init__(self, it: PulseIterator):
        self.it = it
        self.program = getattr(it.step_fn, "__wrapped_program__", None)
        self.native = None
        if self.program is not None:
            self.code_on = it.step_fn.code_on
        else:
            self.native = _kernel.native_body(it)

    def __call__(self, nodes, ptr, scratch):
        it = self.it
        if it.step_fn is not None:
            done, nptr, nscr = it.step_fn(nodes, ptr, scratch)
        else:
            done, scr = it.end_fn(nodes, ptr, scratch)
            nptr, nscr = it.next_fn(nodes, ptr, scr)
            nptr = torch.where(done, ptr, nptr)
            nscr = torch.where(done[:, None], scr, nscr)
        return done, nptr.to(torch.int32), nscr.to(torch.int32)


def iterator_logic(it: PulseIterator) -> ChaseLogic:
    """Batched fused next+end body for a PulseIterator (the compiled
    iterator the dispatch engine ships to the accelerator)."""
    return ChaseLogic(it)


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def _kernel_body(logic_fn, device):
    """(body name, code tensor or None) the kernel runs for ``logic_fn``."""
    if getattr(logic_fn, "program", None) is not None:
        return "isa", logic_fn.code_on(device)
    native = getattr(logic_fn, "native", None)
    if native is not None:
        return native.name, None
    raise ValueError(
        "the pulse_chase CUDA kernel runs PULSE ISA programs and the native bodies "
        f"of the structures' own iterators ({', '.join(_kernel.NATIVE_BODIES)}); this "
        "logic has neither.  Use the ISA route (core.isa.as_pulse_iterator of a "
        "program from core.structures.isa_programs), a structure's iterator, or "
        "PulseEngine.execute(..., backend='reference')"
    )


def pulse_chase(
    arena_data: torch.Tensor,
    ptr: torch.Tensor,
    scratch: torch.Tensor,
    status: torch.Tensor,
    iters: torch.Tensor | None = None,
    *,
    logic_fn,
    num_steps: int,
):
    """Run ``num_steps`` traversal iterations for a batch of lanes.

    Returns new ``(ptr, scratch, status, iters)``; ``iters`` is the exact
    per-lane iteration count accumulated on top of the passed-in counts
    (zeros when omitted).  The inputs are not modified.

    On CUDA tensors this launches the kernel, with the interpreter for an
    ISA iterator's logic or the native body of a structure's iterator;
    ``logic_fn`` must come from ``iterator_logic`` of one of those, otherwise
    ``ValueError``.  On CPU tensors it runs the plain version with
    ``logic_fn`` as the body.
    """
    if iters is None:
        iters = torch.zeros_like(ptr)
    if not _on_cuda(arena_data):
        return chase_reference(arena_data, ptr, scratch, status, iters, logic_fn, num_steps)
    body, code = _kernel_body(logic_fn, arena_data.device)
    if ptr.shape[0] == 0:
        return ptr.clone(), scratch.clone(), status.clone(), iters.clone()
    out = _kernel.launch(arena_data, ptr, scratch, status, iters, code, num_steps, body=body)
    pulse_chase.launches += 1
    return out


pulse_chase.launches = 0


@dataclasses.dataclass(eq=False)
class FaultCheck:
    """The engine's translation/protection check as data: a pointer faults
    when it lies outside ``[0, cap)`` or its shard (``bounds``, sorted
    shard bases) lacks the permission bits ``need`` (``perms``).

    Calling it gives the mask for a batch of pointers, so it serves as a
    ``fault_fn``; the kernel reads its tensors and searches the shards
    itself."""

    bounds: torch.Tensor
    perms: torch.Tensor
    cap: int
    need: int = PERM_READ

    def __call__(self, p: torch.Tensor) -> torch.Tensor:
        shard = torch.searchsorted(self.bounds, p, right=True) - 1
        ok = self.perms[shard.clamp(0, self.perms.shape[0] - 1)] & self.need
        return (p < 0) | (p >= self.cap) | (ok != self.need)


def pulse_chase_run(
    arena_data: torch.Tensor,
    ptr,
    scratch,
    status,
    *,
    logic_fn,
    max_steps: int,
    depth_quantum: int = 8,
    fault_fn: FaultCheck | None = None,
):
    """Run every lane to its end within ``max_steps`` iterations: one
    kernel launch on CUDA tensors, with faults checked on the device.

    The results equal ``pulse_chase_waves`` (and the JAX package's wave
    scheduler) with the same ``depth_quantum`` and ``fault_fn``: a lane
    entering active with a negative pointer faults; a live lane is checked
    by ``fault_fn`` whenever its iteration count is a multiple of
    ``depth_quantum`` and once more if it is live at ``max_steps``; a lane
    retired on a negative pointer is a fault too; a lane live at
    ``max_steps`` keeps status 0.

    On CUDA tensors ``fault_fn`` must be a ``FaultCheck`` or None (any other
    callable raises ``ValueError``) and ``logic_fn`` must have a kernel body
    (see ``pulse_chase``); the host reads nothing.  On CPU tensors the plain
    version runs (``ref.chase_run_reference``).

    Returns ``(ptr, scratch, status, stats)`` in the original lane order;
    ``stats`` is a ``WaveStats`` of one chunk whose ``lane_steps`` (a
    tensor) counts the executed lane-steps.
    """
    dev = arena_data.device
    ptr = torch.as_tensor(ptr, dtype=torch.int32).to(dev).contiguous()
    scratch = torch.as_tensor(scratch, dtype=torch.int32).to(dev).contiguous()
    status = torch.as_tensor(status, dtype=torch.int32).to(dev).contiguous()
    if depth_quantum < 1:
        raise ValueError(f"depth_quantum must be >= 1, got {depth_quantum}")
    B = ptr.shape[0]
    if not _on_cuda(arena_data):
        p, s, st, it, faulted = chase_run_reference(
            arena_data, ptr, scratch, status, logic_fn, max_steps, depth_quantum, fault_fn)
    else:
        if fault_fn is not None and not isinstance(fault_fn, FaultCheck):
            raise ValueError(
                "pulse_chase_run on the card checks faults in the kernel: fault_fn must be "
                f"a FaultCheck or None, got {type(fault_fn).__name__}")
        body, code = _kernel_body(logic_fn, dev)
        if B == 0:
            p, s, st = ptr.clone(), scratch.clone(), status.clone()
            it, faulted = torch.zeros_like(ptr), torch.zeros(0, dtype=torch.bool, device=dev)
        else:
            p, s, st, it, faulted = _kernel.launch(
                arena_data, ptr, scratch, status, None, code, max_steps, body=body,
                quantum=depth_quantum, fault=fault_fn)
            pulse_chase.launches += 1
    stats = WaveStats(chunks=1 if B else 0, lane_steps=it.sum(), dense_lane_steps=B * max_steps,
                      steps_per_chunk=[max_steps] if B else [],
                      lanes_per_chunk=[B] if B else [], retire_step=it, faulted=faulted)
    return p, s, st, stats


def pulse_chase_superstep(
    arena_data: torch.Tensor,
    pool: torch.Tensor,
    bounds: torch.Tensor,
    perms: torch.Tensor,
    *,
    logic_fn,
    k_local: int,
    max_iters: int | torch.Tensor,
    elide_access_check: bool = False,
    rep=None,
    shard0: int = 0,
    row0: int = 0,
):
    """The local chase of one routing superstep, every shard at once.

    ``pool`` is ``(P, L, R)`` int32 request records (``core.routing``'s
    format), shard ``s``'s pool at ``pool[s]``; ``bounds`` ``(P + 1,)`` and
    ``perms`` ``(P,)`` are the arena's.  Each record takes up to
    ``k_local`` steps of ``iterator.step_batch`` over its shard's range
    (``ref.chase_superstep_reference`` says how).  ``rep = (rep_rows,
    primary_map, dead_mask, policy)`` (replicated reads) adds each shard's
    replica window.  ``max_iters`` is an int, or a 0-d int32 tensor on the
    pool's device that the kernel (and the plain version) read, so that a
    captured launch serves any budget.  ``shard0`` and ``row0`` take one
    shard of the mesh (a memory node that holds only its own rows):
    ``pool`` is then shards ``shard0 ..`` of the ``perms.shape[0]`` that
    ``bounds`` and ``perms`` describe, and ``arena_data``'s first row is
    global row ``row0``.  Returns the new pool; the input is not
    modified.

    On CUDA tensors this is one launch of the kernel (the interpreter for
    an ISA iterator's logic, or the native body of a structure's iterator;
    any other logic raises ``ValueError``), and the host reads nothing.  On
    CPU tensors the plain version runs.  An empty pool launches nothing."""
    S = logic_fn.it.scratch_words
    if not _on_cuda(arena_data):
        return chase_superstep_reference(
            arena_data, pool, bounds, perms, logic_fn, k_local, scratch_words=S,
            max_iters=max_iters, elide=elide_access_check, rep=rep, shard0=shard0, row0=row0)
    body, code = _kernel_body(logic_fn, arena_data.device)
    if pool.shape[0] * pool.shape[1] == 0:
        return pool.clone()
    out = _kernel.launch_superstep(
        arena_data, pool.contiguous(), bounds, perms, code, k_local, body=body,
        scratch_words=S, max_iters=max_iters, elide=elide_access_check, rep=rep, shard0=shard0,
        row0=row0)
    pulse_chase.launches += 1
    return out


# ------------------------- variable-depth scheduling -------------------------


@dataclasses.dataclass
class WaveStats:
    """Accounting for the variable-depth wave scheduler.

    ``lane_steps`` is the work actually executed (surviving+padding lanes x
    steps, summed over chunks; for ``pulse_chase_run``, one chunk, the
    executed lane-steps as a tensor on the arena's device, so that the host
    reads nothing); ``dense_lane_steps`` is what the fixed-depth
    scheduler would have executed (every lane runs every step).
    ``retire_step`` is the exact per-lane iteration count and ``faulted``
    marks lanes retired by ``fault_fn`` or a NULL/negative pointer; both are
    tensors on the arena's device.
    """

    chunks: int = 0
    lane_steps: int = 0
    dense_lane_steps: int = 0
    steps_per_chunk: list = dataclasses.field(default_factory=list)
    lanes_per_chunk: list = dataclasses.field(default_factory=list)
    retire_step: torch.Tensor | None = None
    faulted: torch.Tensor | None = None

    @property
    def savings(self) -> float:
        if not self.dense_lane_steps:
            return 0.0
        return 1.0 - self.lane_steps / self.dense_lane_steps


def _pad_ladder(n: int, wave: int) -> int:
    """Smallest wave multiple >= n from the power-of-two ladder {wave, 2*wave,
    4*wave, ...}: few distinct batch shapes, padding overhead under 2x."""
    m = wave
    while m < n:
        m *= 2
    return m


def pulse_chase_waves(
    arena_data: torch.Tensor,
    ptr,
    scratch,
    status,
    *,
    logic_fn,
    max_steps: int,
    depth_quantum: int = 8,
    wave: int = 8,
    fault_fn=None,
):
    """Variable-depth traversal: retire finished lanes between depth quanta.

    Runs ``pulse_chase`` in chunks of ``depth_quantum`` steps, compacts
    retired lanes out of the batch between chunks (padded up the pow2 lane
    ladder with lanes that are born retired), and keeps only survivors in
    flight.  All lane state stays on the arena's device; the host reads one
    count per chunk.

    Lanes entering with a negative pointer retire at once as faults.
    ``fault_fn`` is the translation/protection hook: ``(ptrs int32 tensor)
    -> bool tensor`` applied to live lanes on entry and between chunks;
    ``True`` lanes retire as faults, so detection is quantum-granular.

    The counterpart of the JAX package's ``pulse_chase_waves``, held
    against it; ``PulseEngine.execute`` runs ``pulse_chase_run``, which gives
    the same results in one launch.

    Returns ``(ptr, scratch, status, stats)`` in the original lane order.
    """
    dev = arena_data.device
    out_ptr = torch.as_tensor(ptr, dtype=torch.int32).to(dev).clone()
    out_scr = torch.as_tensor(scratch, dtype=torch.int32).to(dev).clone()
    out_st = torch.as_tensor(status, dtype=torch.int32).to(dev).clone()
    B = out_ptr.shape[0]
    out_it = torch.zeros(B, dtype=torch.int32, device=dev)
    faulted = (out_st == 0) & (out_ptr < 0)  # NULL entry: fault on arrival

    stats = WaveStats(dense_lane_steps=B * max_steps, retire_step=out_it, faulted=faulted)

    def _apply_faults(idx):
        """Retire live lanes whose pointer fails the caller's check."""
        if fault_fn is None or not idx.numel():
            return idx
        bad = fault_fn(out_ptr[idx]).to(torch.bool)
        faulted[idx[bad]] = True
        out_st[idx[bad]] = 1
        return idx[~bad]

    out_st[faulted] = 1
    steps_done = 0
    live = _apply_faults(torch.nonzero(out_st == 0).flatten())
    S = out_scr.shape[1]
    while live.numel() and steps_done < max_steps:
        q = min(depth_quantum, max_steps - steps_done)
        n = int(live.numel())
        padded = _pad_ladder(n, wave)
        p_in = torch.full((padded,), -1, dtype=torch.int32, device=dev)
        s_in = torch.zeros((padded, S), dtype=torch.int32, device=dev)
        st_in = torch.ones((padded,), dtype=torch.int32, device=dev)  # born retired
        it_in = torch.zeros((padded,), dtype=torch.int32, device=dev)
        p_in[:n] = out_ptr[live]
        s_in[:n] = out_scr[live]
        st_in[:n] = 0
        it_in[:n] = out_it[live]  # the kernel accumulates on top: counts stay exact
        p1, s1, st1, it1 = pulse_chase(
            arena_data, p_in, s_in, st_in, it_in, logic_fn=logic_fn, num_steps=q
        )
        p1, s1, st1, it1 = p1[:n], s1[:n], st1[:n], it1[:n]
        out_ptr[live] = p1
        out_scr[live] = s1
        out_st[live] = st1
        out_it[live] = it1
        steps_done += q
        stats.chunks += 1
        stats.lane_steps += padded * q
        stats.steps_per_chunk.append(q)
        stats.lanes_per_chunk.append(n)
        # lanes the kernel retired on a negative pointer are faults too
        faulted[live[(st1 == 1) & (p1 < 0)]] = True
        live = _apply_faults(live[st1 == 0])
    return out_ptr, out_scr, out_st, stats
