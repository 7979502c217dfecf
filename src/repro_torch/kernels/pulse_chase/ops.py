"""Wrappers for the pulse_chase kernel + the PulseIterator adapter and the
variable-depth wave scheduler.

``pulse_chase`` launches the CUDA kernel for CUDA tensors and runs the
plain version (``ref.chase_reference``) for CPU tensors; it never falls
back from one to the other.  ``pulse_chase.launches`` counts kernel
launches.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.iterator import PulseIterator
from repro_torch.kernels.pulse_chase import kernel as _kernel
from repro_torch.kernels.pulse_chase.ref import chase_reference


class ChaseLogic:
    """The batched fused next+end body of a PulseIterator, plus -- for an
    ISA-backed iterator -- the program the kernel interprets.

    Calling it runs the body in torch: ``(nodes (B,W), ptr (B,), scratch
    (B,S)) -> (done, new_ptr, new_scratch)``.  ``program`` is the iterator's
    ``Program`` or None for an iterator written in torch; for an ISA
    iterator ``code_on(device)`` gives the program's code tensor
    (``core.isa.IsaStep.code_on``)."""

    def __init__(self, it: PulseIterator):
        self.it = it
        self.program = getattr(it.step_fn, "__wrapped_program__", None)
        if self.program is not None:
            self.code_on = it.step_fn.code_on

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

    On CUDA tensors this launches the kernel, which runs ISA programs only:
    ``logic_fn`` must come from ``iterator_logic`` of an ISA-backed
    iterator, otherwise ``ValueError``.  On CPU tensors it runs the plain
    version with ``logic_fn`` as the body.
    """
    if iters is None:
        iters = torch.zeros_like(ptr)
    if not _on_cuda(arena_data):
        return chase_reference(arena_data, ptr, scratch, status, iters, logic_fn, num_steps)
    if getattr(logic_fn, "program", None) is None:
        raise ValueError(
            "the pulse_chase CUDA kernel runs PULSE ISA programs only; this "
            "logic has none.  Use the ISA route (core.isa.as_pulse_iterator of "
            "a program from core.structures.isa_programs) or "
            "PulseEngine.execute(..., backend='reference')"
        )
    if ptr.shape[0] == 0:
        return ptr.clone(), scratch.clone(), status.clone(), iters.clone()
    out = _kernel.launch(
        arena_data, ptr, scratch, status, iters,
        logic_fn.code_on(arena_data.device), num_steps,
    )
    pulse_chase.launches += 1
    return out


pulse_chase.launches = 0


# ------------------------- variable-depth scheduling -------------------------


@dataclasses.dataclass
class WaveStats:
    """Accounting for the variable-depth wave scheduler.

    ``lane_steps`` is the work actually executed (surviving+padding lanes x
    steps, summed over chunks); ``dense_lane_steps`` is what the fixed-depth
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
