"""Plain torch version of the pulse_chase kernel: K traversal steps for a
batch of lanes over an arena, with the kernel's masked-update semantics."""

from __future__ import annotations

import torch


def chase_reference(arena, ptr, scratch, status, iters, logic_fn, num_steps: int):
    """``logic_fn(nodes (B,W), ptr (B,), scratch (B,S)) -> (done, new_ptr,
    new_scratch)`` batched over lanes.  status: 0 active, 1 done.
    ``iters`` accumulates exact per-lane iteration counts: every step an
    active lane executes counts, including the one that discovers done.
    Returns new ``(ptr, scratch, status, iters)`` tensors."""
    cap = arena.shape[0]
    for _ in range(num_steps):
        active = status == 0
        safe = ptr.clamp(0, cap - 1)
        nodes = arena[torch.where(active, safe, 0).long()]
        done, nptr, nscr = logic_fn(nodes, ptr, scratch)
        ptr = torch.where(active & ~done, nptr, ptr).to(torch.int32)
        scratch = torch.where(active[:, None], nscr, scratch).to(torch.int32)
        status = torch.where(active & done, 1, status).to(torch.int32)
        # walking off the structure (NULL) terminates too
        status = torch.where((status == 0) & (ptr < 0), 1, status).to(torch.int32)
        iters = torch.where(active, iters + 1, iters).to(torch.int32)
    return ptr, scratch, status, iters
