"""Fault injection for the distributed traversal engine (test-only).

Rack-scale disaggregated memory treats memory-node failure as a normal
operating condition.  This module is the hook that lets every schedule and
fabric be exercised under injected failures:

  * **kill** -- shard ``kill_shard`` dies before superstep ``kill_superstep``
    of engine call ``kill_call``: the executor raises ``ShardFailure``
    without publishing any partial state (the engine swaps its arena only
    on success, so the heap after a kill is the pre-call heap -- the
    recovery anchor).
  * **drop** -- each record crossing the fabric is independently lost with
    probability ``drop_prob``.  Loss is link-level park-and-retransmit: a
    dropped record stays on its source shard and is sent again next
    superstep, so no traversal state is lost, only superstep counts grow.
    The seeded mask is a pure function of (drop_seed, shard, superstep)
    (``routing._drop_mask``), so a lossy run replays bit for bit.
  * **delay** -- shard ``delay_shard`` sleeps ``delay_s`` before each
    superstep of the dispatched schedule in which it serves work (an ACTIVE
    record points into its range), a straggler memory node.  Reads fanned
    out to its replica cost it nothing.

The injector is threaded through ``routing.distributed_execute``,
``commit.sequential_commit_execute`` and ``PulseEngine`` as an optional
argument; callers that pass none pay nothing.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative failure schedule for one engine lifetime.

    ``kill_call`` counts engine executions (0-based); ``kill_superstep`` is
    1-based: the failure fires before that superstep runs, so exactly
    ``kill_superstep - 1`` supersteps of the targeted call complete.
    """

    kill_shard: int | None = None  # shard that dies (None: no kill)
    kill_call: int = 0  # which engine call the kill targets
    kill_superstep: int = 1  # die before this (1-based) superstep
    drop_prob: float = 0.0  # per-record fabric loss probability
    drop_seed: int = 0  # seed of the loss mask
    delay_shard: int | None = None  # straggler shard (dispatched schedule only)
    delay_s: float = 0.0  # straggler delay per superstep it serves work in


class ShardFailure(RuntimeError):
    """An injected (or detected) memory-shard death.  ``label`` is set by
    whoever owns the failing unit of work."""

    def __init__(self, shard: int, superstep: int):
        super().__init__(f"shard {shard} died before superstep {superstep}")
        self.shard = shard
        self.superstep = superstep
        self.label: str | None = None


class FaultInjector:
    """Mutable per-run state of a ``FaultPlan``: counts engine calls and
    fires the kill exactly once."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.calls = 0  # engine calls begun
        self.fired = False  # the kill already happened

    def begin_call(self) -> int:
        """Register one engine execution; returns its 0-based index."""
        idx = self.calls
        self.calls += 1
        return idx

    def kill_step(self, call_idx: int) -> int | None:
        """The 1-based superstep before which this call must die, or None
        if this call is not targeted (wrong call, no kill, already fired)."""
        p = self.plan
        if self.fired or p.kill_shard is None or call_idx != p.kill_call:
            return None
        return p.kill_superstep

    def fire(self, superstep: int):
        """Raise the shard death (once)."""
        self.fired = True
        raise ShardFailure(self.plan.kill_shard, superstep)
