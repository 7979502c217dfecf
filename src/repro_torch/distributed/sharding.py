"""The versioned shard-of-slot owner function of an elastic arena.

An arena is range partitioned: shard ``s`` owns the global rows
``[bounds[s], bounds[s + 1])``.  A live reshard (``arena.remap_shards``)
installs new bounds; per-shard serving state minted under the old ones
forwards to the new shards covering the same rows.  Pure index
translation on the host: pointers are global, so no record is rewritten.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class OwnerEpoch:
    """One version of the owner function: the switch's translation base
    table (the range-partition bounds) at a reshard epoch."""

    epoch: int
    bounds: tuple[int, ...]  # (num_shards + 1,) sorted row-range partition

    @property
    def num_shards(self) -> int:
        return len(self.bounds) - 1

    def owner_of(self, ptr):
        """Owning shard of global address(es); -1 when out of range."""
        b = np.asarray(self.bounds, np.int64)
        p = np.asarray(ptr, np.int64)
        shard = np.searchsorted(b, p, side="right") - 1
        valid = (p >= 0) & (p < b[-1]) & (shard >= 0) & (shard < self.num_shards)
        return np.where(valid, shard, -1).astype(np.int32)


class VersionedOwnerMap:
    """Owner-function epochs with forwarding between them.

    ``advance`` installs a new epoch; ``forward_shard`` and
    ``forward_mask`` translate state minted under an older epoch: an old
    shard goes to the new shards covering its address range."""

    def __init__(self, bounds):
        self._epochs = [OwnerEpoch(0, tuple(int(b) for b in bounds))]

    @property
    def current(self) -> OwnerEpoch:
        return self._epochs[-1]

    @property
    def epoch(self) -> int:
        return self._epochs[-1].epoch

    def at(self, epoch: int) -> OwnerEpoch:
        for e in self._epochs:
            if e.epoch == epoch:
                return e
        raise KeyError(f"unknown owner epoch {epoch}")

    def advance(self, bounds) -> OwnerEpoch:
        """Install a new owner function (the forwarding epoch boundary)."""
        new = tuple(int(b) for b in bounds)
        cur = self.current
        if new[0] != cur.bounds[0] or new[-1] != cur.bounds[-1]:
            raise ValueError(
                "an owner epoch must cover the same address space: "
                f"{cur.bounds[0]}..{cur.bounds[-1]} vs {new[0]}..{new[-1]}")
        nxt = OwnerEpoch(cur.epoch + 1, new)
        self._epochs.append(nxt)
        return nxt

    def forward_shard(self, shard: int, *, from_epoch: int,
                      to_epoch: int | None = None) -> tuple[int, ...]:
        """The shards of ``to_epoch`` (default: the current one) whose
        ranges overlap ``shard``'s range at ``from_epoch``."""
        src = self.at(from_epoch)
        dst = self.current if to_epoch is None else self.at(to_epoch)
        if not 0 <= shard < src.num_shards:
            raise ValueError(f"shard {shard} out of range for epoch {from_epoch}")
        lo, hi = src.bounds[shard], src.bounds[shard + 1]
        db = np.asarray(dst.bounds, np.int64)
        first = int(np.searchsorted(db, lo, side="right")) - 1
        last = int(np.searchsorted(db, hi, side="left"))
        return tuple(range(max(first, 0), min(last, dst.num_shards)))

    def forward_mask(self, mask, *, from_epoch: int, to_epoch: int | None = None) -> np.ndarray:
        """Forward a per-shard bool mask: a new shard is set iff an old
        shard overlapping it was."""
        src = self.at(from_epoch)
        dst = self.current if to_epoch is None else self.at(to_epoch)
        mask = np.asarray(mask, bool)
        if mask.shape != (src.num_shards,):
            raise ValueError(
                f"mask shape {mask.shape} != ({src.num_shards},) of epoch {from_epoch}")
        out = np.zeros(dst.num_shards, bool)
        for s in np.flatnonzero(mask):
            for d in self.forward_shard(int(s), from_epoch=from_epoch, to_epoch=dst.epoch):
                out[d] = True
        return out
