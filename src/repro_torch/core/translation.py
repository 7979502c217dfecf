"""Hierarchical address translation (PULSE S5), on tensors.

  1. **Switch level** -- the sorted ``bounds`` base table maps a global
     address to its memory node; ``owner_of`` is the TCAM lookup, realised
     as ``torch.searchsorted``.
  2. **Node level** -- each memory node translates a global address to a
     local offset (``local_offset``) and enforces protection
     (``check_access``).  A failure terminates the traversal with FAULT.

Every function takes and returns int32 (or bool) tensors on the device of
its inputs.
"""

from __future__ import annotations

import torch

from repro_torch.core.arena import NULL, PERM_READ


def owner_of(bounds: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """Switch-level lookup: which memory node owns global address ``ptr``.

    Returns -1 for NULL / out-of-range addresses."""
    ptr = torch.as_tensor(ptr, dtype=torch.int32, device=bounds.device)
    shard = (torch.searchsorted(bounds, ptr, right=True) - 1).to(torch.int32)
    num_shards = bounds.shape[0] - 1
    valid = (ptr >= 0) & (ptr < bounds[-1]) & (shard >= 0) & (shard < num_shards)
    return torch.where(valid, shard, torch.full_like(shard, NULL))


def local_offset(
    bounds: torch.Tensor, shard: torch.Tensor, ptr: torch.Tensor
) -> torch.Tensor:
    """Node-level translation: global address -> row offset in the shard."""
    base = bounds[shard.clamp(0, bounds.shape[0] - 2).long()]
    return (torch.as_tensor(ptr, dtype=torch.int32, device=bounds.device) - base).to(
        torch.int32
    )


def is_local(bounds: torch.Tensor, shard_id, ptr) -> torch.Tensor:
    """True iff ``ptr`` translates locally on ``shard_id`` (no re-route)."""
    lo = bounds[int(shard_id)]
    hi = bounds[int(shard_id) + 1]
    ptr = torch.as_tensor(ptr, dtype=torch.int32, device=bounds.device)
    return (ptr >= lo) & (ptr < hi)


def access_table(perms: torch.Tensor, want: int = PERM_READ) -> torch.Tensor:
    """Per-shard grant table for ``want`` access: ``(num_shards,)`` bool.
    Loop-invariant, so traversal loops hoist it once."""
    return (perms & want) == want


def check_access_table(table: torch.Tensor, shard: torch.Tensor) -> torch.Tensor:
    """Protection check against a hoisted ``access_table`` result."""
    num_shards = table.shape[0]
    safe = shard.clamp(0, num_shards - 1).long()
    return table[safe] & (shard >= 0) & (shard < num_shards)


def check_access(
    perms: torch.Tensor, shard: torch.Tensor, want: int = PERM_READ
) -> torch.Tensor:
    """Node-level protection check: does the range grant ``want`` access."""
    return check_access_table(access_table(perms, want), shard)
