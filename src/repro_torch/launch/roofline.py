"""Roofline terms of a step on the H100 (the dry run's report).

Per (arch x shape x mesh), per GPU:
    compute term    = FLOPs / peak FLOP/s
    memory term     = bytes / HBM rate
    collective term = ring wire bytes / link rate
The FLOPs and bytes come from the meta counter (``launch.dryrun``), the
reference's from XLA's ``cost_analysis`` of the compiled program.  The
collective term is the ring model of the reference's HLO parser, as a
function of ``(kind, bytes, group size[, axis])`` records: the port compiles
no program to parse, so the dry run records the collectives DTensor issues
when the step runs sharded on a fake world of the mesh's ranks
(``dryrun.CollectiveRecorder``), each with the mesh axes its group spans.

Every constant below is an NVIDIA H100 SXM datasheet figure, not a
measurement.
"""

from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12  # bf16 dense tensor-core peak (datasheet)
HBM_BW = 3.35e12  # HBM3 (datasheet)
NVLINK_BW = 450e9  # NVLink 4, each way, within a node of eight (datasheet)
IB_BW = 50e9  # one 400 Gb/s NIC per GPU across nodes (datasheet)
LINK_BW = {"model": NVLINK_BW, "data": IB_BW, "pod": IB_BW}  # the mesh axes' links

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def ring_wire_bytes(kind: str, nbytes: float, n: int) -> float:
    """Per-GPU ring-model wire bytes of one collective whose result is
    ``nbytes`` over a group of ``n`` (at least 2)."""
    n = max(n, 2)
    ring = (n - 1) / n
    if kind == "all-gather":
        return nbytes * ring  # result bytes cross the ring once
    if kind == "all-reduce":
        return 2 * nbytes * ring  # reduce-scatter + all-gather phases
    if kind == "reduce-scatter":
        return nbytes * (n - 1)  # result is 1/n of the input
    if kind == "all-to-all":
        return nbytes * ring
    if kind == "collective-permute":
        return nbytes
    raise ValueError(f"unknown collective {kind!r}; known: {KINDS}")


def collective_wire_bytes(records) -> dict:
    """Per-GPU ring-model wire bytes by collective kind, ``counts`` and
    ``total``, over ``(kind, bytes, group size[, axis])`` records (a group
    size of 0, unknown, counts as 2, as the reference's parser does)."""
    out = dict.fromkeys(KINDS, 0.0)
    counts = dict.fromkeys(KINDS, 0)
    for kind, nbytes, n, *_axis in records:
        out[kind] += ring_wire_bytes(kind, nbytes, n)
        counts[kind] += 1
    out["counts"] = counts
    out["total"] = sum(out[k] for k in KINDS)
    return out


def link_bw(axis: str | None) -> float:
    """The link a group over ``axis`` crosses: the slowest of its axes
    (names joined by ``+``); a group without an axis across nodes."""
    return min(LINK_BW[a] for a in axis.split("+")) if axis else LINK_BW["data"]


def collective_seconds(records) -> float:
    """The ring wire bytes of each record over its axis's link
    (``link_bw``)."""
    return sum(ring_wire_bytes(kind, nbytes, n) / link_bw(axis[0] if axis else None)
               for kind, nbytes, n, *axis in records)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float  # per GPU: the meta counter's FLOPs (the reference's HLO count)
    hlo_bytes: float  # per GPU: the meta counter's bytes
    collective_bytes: float  # per GPU (ring wire)
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float  # 6*N*D (global, per step)
    useful_ratio: float  # model_flops / (hlo_flops * chips)
    bytes_per_device: int
    collective_detail: dict
    note: str = ""

    def to_json(self):
        return dataclasses.asdict(self)


def analyze(*, arch: str, shape_name: str, mesh_name: str, chips: int, cost: dict,
            collectives=(), bytes_per_device: int = 0, model_flops: float,
            note: str = "") -> RooflineReport:
    """``cost``: per-GPU ``flops`` and ``bytes accessed``; ``collectives``:
    the records of ``collective_wire_bytes``."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    coll = collective_wire_bytes(collectives)
    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    coll_s = collective_seconds(collectives)
    dom = max([("compute", compute_s), ("memory", memory_s), ("collective", coll_s)],
              key=lambda kv: kv[1])[0]
    useful = model_flops / (flops * chips) if flops else 0.0
    return RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=flops, hlo_bytes=byts, collective_bytes=coll["total"],
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        dominant=dom, model_flops=model_flops, useful_ratio=useful,
        bytes_per_device=int(bytes_per_device),
        collective_detail={k: v for k, v in coll.items() if k != "counts"}
        | {"counts": coll["counts"]},
        note=note,
    )


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); decode: D = batch
    tokens per step; train adds nothing extra (the 6 covers fwd+bwd)."""
    n = cfg.active_param_count() if cfg.family == "moe" else cfg.param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens  # forward only
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
