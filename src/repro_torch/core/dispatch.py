"""PULSE dispatch engine: the offload cost model (paper S4.1).

The CPU node offloads an iterator iff its per-iteration compute time fits
under the accelerator's memory time: ``t_c <= eta * t_d`` with
``t_c = t_i * N`` (N instructions, t_i per-instruction time at the logic
pipeline clock) and ``t_d`` the single aggregated LOAD's latency + transfer.
``eta = m/n`` mirrors the provisioned logic:memory pipeline ratio (S4.2).

Two N sources:
  * ISA programs: exact upper bound, the longest path through the
    forward-jump-only CFG.
  * iterators written in torch: the count the iterator declares
    (``PulseIterator.n_instructions``), the weighted critical path of its
    next/end bodies.

``schedule_decision`` is the overlap model of a distributed traversal:
the superstep schedule (pipelined, fused) that hides the larger share of a
superstep's modeled local-chase and fabric time; ``PulseEngine`` asks it
for ``schedule="auto"`` on a mesh.

Defaults mirror the paper's prototype: 250 MHz pipelines (t_i = 4 ns),
132 ns memory pipeline latency (TCAM 22 + controller 110, Fig. 10), 25 GB/s
per-node bandwidth, eta = 0.75 (m=3, n=4).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.iterator import PulseIterator


@dataclasses.dataclass(frozen=True)
class AcceleratorSpec:
    t_i_ns: float = 4.0  # per-instruction time (250 MHz logic pipeline)
    mem_latency_ns: float = 132.0  # TCAM + memory controller (Fig. 10)
    mem_bw_gbps: float = 25.0  # per-node bandwidth cap (S6 setup)
    eta: float = 0.75  # m/n = 3/4 in the prototype (S4.2)
    network_ns: float = 426.3  # network stack traversal (Fig. 10)
    scheduler_ns: float = 5.1
    interconnect_ns: float = 47.0
    logic_ns: float = 10.0  # per-iteration logic latency (Fig. 10)

    def t_d_ns(self, node_bytes: int) -> float:
        return self.mem_latency_ns + node_bytes / self.mem_bw_gbps


@dataclasses.dataclass(frozen=True)
class OffloadDecision:
    offload: bool
    t_c_ns: float
    t_d_ns: float
    ratio: float  # t_c / t_d  (Table 3's column)
    n_instructions: int
    reason: str


def count_instructions(it: PulseIterator, node_words: int) -> int:
    """Instruction count N for the t_c model.

    ISA programs: longest path through the forward-jump-only CFG (exact
    worst-case instruction count).  Other iterators: their declared count.
    ``node_words`` is accepted for the model's signature; neither count
    depends on it."""
    for fn in (it.step_fn, it.mut_fn):
        if fn is not None and hasattr(fn, "__wrapped_program__"):
            return isa_longest_path(fn.__wrapped_program__)
    if it.n_instructions is None:
        raise ValueError(
            f"iterator {it.name!r} declares no instruction count "
            f"(PulseIterator.n_instructions) and carries no ISA program"
        )
    return int(it.n_instructions)


def isa_longest_path(prog) -> int:
    """Worst-case instructions per iteration: longest path in the forward CFG."""
    from repro_torch.core import isa as isa_mod

    code = prog.code
    T = code.shape[0]
    cost = [0] * (T + 1)
    for i in range(T - 1, -1, -1):
        op, a, b, imm = (int(x) for x in code[i])
        if op in (isa_mod.RETURN, isa_mod.NEXT_ITER, isa_mod.HALT):
            cost[i] = 1
        elif op == isa_mod.JMP:
            cost[i] = 1 + cost[imm]
        elif op in (isa_mod.JEQ, isa_mod.JNE, isa_mod.JLT, isa_mod.JLE,
                    isa_mod.JGT, isa_mod.JGE):
            cost[i] = 1 + max(cost[i + 1], cost[imm])
        else:
            cost[i] = 1 + cost[i + 1]
    return cost[0]


def offload_decision(
    it: PulseIterator,
    node_words: int,
    accel: AcceleratorSpec | None = None,
    *,
    eta: float | None = None,
) -> OffloadDecision:
    accel = accel or AcceleratorSpec()
    eta = accel.eta if eta is None else eta
    n = count_instructions(it, node_words)
    t_c = accel.t_i_ns * n
    t_d = accel.t_d_ns(node_words * 4)
    ratio = t_c / t_d
    ok = t_c <= eta * t_d
    reason = (
        f"t_c={t_c:.1f}ns (N={n}) {'<=' if ok else '>'} eta*t_d="
        f"{eta * t_d:.1f}ns -> {'offload' if ok else 'run at CPU node'}"
    )
    return OffloadDecision(ok, t_c, t_d, ratio, n, reason)


@dataclasses.dataclass(frozen=True)
class ScheduleDecision:
    """Which distributed superstep schedule the dispatch engine picks: a
    closed-form model of where a superstep's time goes, and the schedule
    that hides the larger share.  ``overlap_frac`` is the fraction of a
    serialized superstep the wavefront-pipelined schedule can hide (the
    smaller phase over their sum): above 0 whenever both phases are, so a
    multi-shard traversal defaults to ``pipelined`` unless one phase
    dominates."""

    schedule: str  # "pipelined" | "fused" | "local"
    t_local_ns: float  # modeled local-chase time per superstep
    t_fabric_ns: float  # modeled fabric time per superstep
    overlap_frac: float  # serialized time hidden by overlapping the two
    reason: str


def schedule_decision(
    it: PulseIterator,
    node_words: int,
    num_shards: int,
    accel: AcceleratorSpec | None = None,
    *,
    k_local: int = 4,
    min_overlap: float = 0.05,
) -> ScheduleDecision:
    """Pick the superstep schedule of a distributed traversal (S5 and the
    overlap of the local chase with the fabric).

    The local phase runs ``k_local`` iterations, each bounded by the larger
    of compute (t_i * N) and the aggregated LOAD (t_d); the fabric phase is
    the network stack plus per-link interconnect time.  When neither phase
    dominates, pipelining the two wavefronts hides ``min(t_local,
    t_fabric)`` of every superstep, so the engine picks ``pipelined``;
    below ``min_overlap`` the serialized fused loop wins."""
    accel = accel or AcceleratorSpec()
    if num_shards <= 1:
        return ScheduleDecision(
            "local", 0.0, 0.0, 0.0, "single memory node: nothing to overlap"
        )
    n = count_instructions(it, node_words)
    t_local = k_local * max(accel.t_i_ns * n, accel.t_d_ns(node_words * 4))
    t_fabric = (
        accel.network_ns
        + accel.scheduler_ns
        + accel.interconnect_ns * (num_shards - 1)
    )
    overlap = min(t_local, t_fabric) / (t_local + t_fabric)
    schedule = "pipelined" if overlap >= min_overlap else "fused"
    reason = (
        f"t_local={t_local:.0f}ns t_fabric={t_fabric:.0f}ns -> overlap hides "
        f"{overlap:.0%} of a serialized superstep -> {schedule}"
    )
    return ScheduleDecision(schedule, t_local, t_fabric, overlap, reason)


def workload_table(entries):
    """The shape of paper Table 3: name, t_c/t_d, iterations.  ``entries``
    is a list of ``(name, iterator, node_words, iters)``."""
    rows = []
    accel = AcceleratorSpec()
    for name, it, node_words, iters in entries:
        d = offload_decision(it, node_words, accel)
        rows.append(
            dict(name=name, tc_td=round(d.ratio, 3), iterations=iters,
                 offload=d.offload, n_instructions=d.n_instructions)
        )
    return rows
