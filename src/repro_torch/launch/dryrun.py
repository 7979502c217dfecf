"""Dry run of every (architecture x input shape) cell on the H100 meshes:
the cell's step run once on the meta device at its full global shape,
counted, and its roofline terms per GPU.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun                      # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_0_6b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi_pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --out build/dryrun.json

Any machine runs it: meta tensors have shapes and dtypes and no storage,
so nothing is allocated and nothing is computed.  The reference lowers and
compiles each cell for 256/512 placeholder devices and scales XLA's cost
analysis by unrolled probes; eager torch runs every layer, so one run
counts all the work.  What the count is:
  * FLOPs: every aten op's, by ``torch.utils.flop_counter``'s formulas
    (the products; elementwise work counts 0, as in XLA's count), plus
    ``flash_attention``'s and ``ssd_scan``'s own work, which their meta
    route reports (``kernels.work``; the causal pairs, not a plain
    version's square).  A train step's backward is counted as the port
    runs it: the kernels' backward is the plain version recomputed.
  * bytes: each op's input and output bytes, views and allocations
    excluded, plus the kernels' own.
  * per GPU: the global counts / chips.  Argument bytes per GPU (params,
    optimizer state, batch, cache) come from the specs; ``temp`` (the
    activations' peak) is not measured on meta.
  * collectives: the same step run a second time on each mesh, as
    DTensors on a fake world of the mesh's ranks (``launch.mesh.
    fake_world``; this process its rank 0, nothing moved), the arguments
    placed by their shardings (``steps.distribute_step_args``), every
    collective it issues recorded (``CollectiveRecorder``) and priced by
    the ring model per axis (``roofline``).  The FLOPs and bytes stay the
    first run's.  A cell whose sharded run fails is reported failed, as the
    reference reports a failed compile.  DTensor picks each op's
    collectives by its own rules (the reference's are XLA's partitioner's);
    where it has none or a costly one, the port's model code gives the op
    its placements (``distributed.sharding``: the FSDP gather before a
    weight's use, the vocab-sharded lookup and logsumexp, the decode
    cache's writes, the scan's and the attention's inputs), and the
    kernels' wrappers run on each rank's local shards
    (``kernels/shards.py``).
"""

from __future__ import annotations

import argparse
import functools
import itertools
import json
import math
import sys
import time
import traceback
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._pytree import tree_flatten
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, SKIPPED_CELLS, all_cells, get_config
from repro_torch.distributed.sharding import NamedSharding
from repro_torch.kernels import work
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import MeshSpec, fake_world, make_production_mesh
from repro_torch.launch.steps import build_step, distribute_step_args

_ALLOCATIONS = {torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided,
                torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided}
NOTE = ("meta counter: FLOPs and bytes are the global step's / chips; temp not measured on "
        "meta; collectives recorded from the step run as DTensors on a fake world of chips "
        "ranks")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _BytesMode(TorchDispatchMode):
    def __init__(self, counter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if outs:
            # a real tensor of no elements (torch.utils.checkpoint's dummy) has no storage
            real = sum(not t.is_meta and t.numel() > 0 for t in outs)
            if real:
                self.counter.real_outputs += real
                self.counter.real_ops.add(str(func))
                self.counter.real_stack = self.counter.real_stack or "".join(
                    traceback.format_stack(limit=16))
            if not func.is_view and func._overloadpacket not in _ALLOCATIONS:
                ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
                self.counter.bytes += sum(_nbytes(t) for t in ins + outs)
        return out


class WorkCounter:
    """What the ops run inside it do: ``aten_flops`` (FlopCounterMode's
    total), ``bytes`` (each op's inputs and outputs, views and allocations
    excluded), ``kernels`` (name -> calls, flops, bytes, from the float
    kernels' meta route) and ``real_outputs`` (tensors with elements made
    off meta, by the ops ``real_ops``: none in a dry run)."""

    def __init__(self):
        self.flop_mode = FlopCounterMode(display=False)
        self.bytes = 0
        self.real_outputs = 0
        self.real_ops = set()
        self.real_stack = ""  # where the first real tensor was made
        self.kernels = {}

    def add_kernel(self, name, flops, nbytes):
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    @property
    def aten_flops(self) -> int:
        return self.flop_mode.get_total_flops()

    @property
    def kernel_flops(self) -> int:
        return sum(k["flops"] for k in self.kernels.values())

    @property
    def flops(self) -> int:
        return self.aten_flops + self.kernel_flops

    @property
    def total_bytes(self) -> int:
        return self.bytes + sum(k["bytes"] for k in self.kernels.values())

    def __enter__(self):
        self.flop_mode.__enter__()
        self._bytes_mode = _BytesMode(self).__enter__()
        work.COUNTERS.append(self)
        return self

    def __exit__(self, *exc):
        work.COUNTERS.remove(self)
        self._bytes_mode.__exit__(*exc)
        self.flop_mode.__exit__(*exc)
        return False


# each collective op, by its schema's name -> the ring model's kind
# (roofline.KINDS): the functional collectives DTensor issues, the c10d ones
# ``torch.distributed``'s calls issue (the MoE's expert-parallel body), and
# DTensor's all-to-all on a card's mesh
_ALL_GATHER = ("_c10d_functional::all_gather_into_tensor",
               "_c10d_functional::all_gather_into_tensor_out",
               "_c10d_functional::all_gather_into_tensor_coalesced", "c10d::allgather_",
               "c10d::_allgather_base_", "c10d::allgather_coalesced_",
               "c10d::allgather_into_tensor_coalesced_")
_ALL_REDUCE = ("_c10d_functional::all_reduce", "_c10d_functional::all_reduce_",
               "_c10d_functional::all_reduce_coalesced",
               "_c10d_functional::all_reduce_coalesced_", "c10d::allreduce_",
               "c10d::allreduce_coalesced_")
_REDUCE_SCATTER = ("_c10d_functional::reduce_scatter_tensor",
                   "_c10d_functional::reduce_scatter_tensor_out",
                   "_c10d_functional::reduce_scatter_tensor_coalesced", "c10d::reduce_scatter_",
                   "c10d::_reduce_scatter_base_", "c10d::reduce_scatter_tensor_coalesced_")
_ALL_TO_ALL = ("_c10d_functional::all_to_all_single", "c10d::alltoall_base_",
               "c10d::alltoall_", "_dtensor::shard_dim_alltoall")
COLLECTIVE_KINDS = (dict.fromkeys(_ALL_GATHER, "all-gather")
                    | dict.fromkeys(_ALL_REDUCE, "all-reduce")
                    | dict.fromkeys(_REDUCE_SCATTER, "reduce-scatter")
                    | dict.fromkeys(_ALL_TO_ALL, "all-to-all"))
_NOT_COLLECTIVES = ("_c10d_functional::wait_tensor", "_c10d_functional::_wrap_tensor_autograd")
_C10D_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d",
                    "c10d_functional", "_dtensor")


def _result_bytes(func, args, out) -> int:
    """The bytes of a collective's result: its output tensors (a c10d op's
    output is its first argument, written in place; an all-reduce's its
    tensors)."""
    if func.namespace == "c10d":
        out = args[0]
    return sum(_nbytes(t) for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor))


def _group_arg(func, args, kwargs):
    """A collective's process group (a c10d op's) or group's name (a
    functional one's), by its schema's argument name."""
    for i, arg in enumerate(func._schema.arguments):
        if arg.name in ("group_name", "process_group", "group"):
            return kwargs[arg.name] if arg.name in kwargs else args[i]
    raise ValueError(f"{func} names no process group")


class CollectiveRecorder(TorchDispatchMode):
    """Records every collective the ops inside it issue as ``(kind, bytes,
    group size, axis)``, in ``roofline.ring_wire_bytes``'s convention: the
    result's bytes (a reduce-scatter's 1/n result).  ``axis`` names the
    ``device_mesh`` dims the group spans (each by its ``labels`` entry,
    where it has one), joined by ``+`` where several.  DTensor's own ops
    pass through (``NotImplemented``) so that the collectives they issue
    on their shards are seen; an op of a collective namespace that is not
    one of the known kinds raises.  ``real_outputs`` counts tensors with
    elements made on the mesh's cards (``_real``), as ``WorkCounter``
    counts those made off meta."""

    def __init__(self, device_mesh, labels=None):
        super().__init__()
        self.device_mesh = device_mesh
        self.labels = labels or {}
        self.records = []
        self.real_outputs = 0
        self._axes = {}

    def _axis(self, group) -> tuple[int, str]:
        """(size, axis) of a process group or a group's name."""
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group

        if isinstance(group, torch.ScriptObject):  # a c10d op's, boxed
            group = dist.ProcessGroup.unbox(group)
        name = group if isinstance(group, str) else group.group_name
        if name not in self._axes:
            pg = _resolve_process_group(name)
            ranks = set(dist.get_process_group_ranks(pg))
            mesh = self.device_mesh.mesh.tolist()
            coords = [c for c in itertools.product(*map(range, self.device_mesh.shape))
                      if functools.reduce(lambda m, i: m[i], c, mesh) in ranks]
            dims = [i for i in range(len(self.device_mesh.shape))
                    if len({c[i] for c in coords}) > 1]
            names = self.device_mesh.mesh_dim_names
            self._axes[name] = (len(ranks), "+".join(self.labels.get(names[i], names[i])
                                                     for i in dims))
        return self._axes[name]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        name = func._schema.name
        kind = COLLECTIVE_KINDS.get(name)
        if kind is not None:
            n, axis = self._axis(_group_arg(func, args, kwargs))
            self.records.append((kind, _result_bytes(func, args, out), n, axis))
        elif func.namespace in _C10D_NAMESPACES and name not in _NOT_COLLECTIVES:
            raise NotImplementedError(f"the dry run has no ring model for {func}")
        self.real_outputs += sum(self._real(t) for t in tree_flatten(out)[0]
                                 if isinstance(t, torch.Tensor))
        return out

    def _real(self, t) -> bool:
        """Whether ``t`` holds elements on the mesh's cards: not meta, not a
        fake tensor (DTensor's sharding propagation), and not on the host,
        where DTensor's redistribute planner and the ``DeviceMesh`` keep
        their index arithmetic."""
        if t.is_meta or isinstance(t, FakeTensor) or t.numel() == 0:
            return False
        return t.device.type == self.device_mesh.device_type


def recording_mesh(mesh: MeshSpec):
    """(the mesh a step is sharded on to record ``mesh``'s collectives, the
    labels of its dims).  Every spec and hint on the production meshes
    names ``pod`` and ``data`` together (``sharding.fsdp_axes``, ``"dp"``),
    so the multi-pod mesh is recorded as one ``data`` dim of pod x data
    ranks, labelled ``pod+data``: each of its collectives is one over that
    whole group, as the reference's partitioner issues it (DTensor would
    issue two in turn on a 3-D mesh, and its redistribute planner searches
    many times as long over three dims)."""
    if "pod" not in mesh.axis_names:
        return mesh, {}
    if mesh.axis_names != ("pod", "data", "model"):
        raise ValueError(f"no recording mesh for the axes {mesh.axis_names}")
    shape = mesh.shape
    return (MeshSpec((shape["pod"] * shape["data"], shape["model"]), ("data", "model")),
            {"data": "pod+data"})


def record_collectives(cfg, shape, mesh, device_type: str = "cuda"):
    """The cell's step run a second time, as DTensors on a fake world of
    ``mesh`` (``recording_mesh``; the arguments placed by their shardings),
    its collectives recorded -> the ``CollectiveRecorder``.  Plain tensors
    the step makes (positions, masks) are replicated
    (``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    mesh, labels = recording_mesh(mesh)
    with fake_world(mesh, device_type) as dm:
        step, args, in_sh = build_step(cfg, shape, mesh, device_mesh=dm)
        args = distribute_step_args(args, in_sh, dm)
        with CollectiveRecorder(dm, labels) as rec, implicit_replication():
            step(*args)
    return rec


def _dryrun_cfg(arch: str):
    """Production numerics for the dry run: bf16 compute everywhere."""
    return get_config(arch).replace(compute_dtype=torch.bfloat16)


def arg_bytes_per_device(args, in_shardings) -> int:
    """Bytes of one GPU's shards of the step's arguments."""
    leaves, spec = tree_flatten(args)
    shards, sh_spec = tree_flatten(in_shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    if spec != sh_spec:
        raise ValueError("the shardings' tree is not the arguments'")
    return sum(math.prod(sh.shard_shape(t.shape)) * t.element_size()
               for t, sh in zip(leaves, shards))


def count_step(cfg, shape, mesh):
    """Run the cell's step once on meta inside a ``WorkCounter`` -> (counter,
    the step's output, its example args, their shardings)."""
    step, args, in_sh = build_step(cfg, shape, mesh)
    with WorkCounter() as counter:
        out = step(*args)
    return counter, out, args, in_sh


def run_cell(arch: str, shape_name: str, meshes, *, cfg=None, shape=None):
    """The cell counted once, its collectives recorded on each mesh ->
    ({mesh name: RooflineReport, or the exception its sharded run raised},
    counter, seconds).  ``cfg`` and ``shape`` stand in for the cell's own
    (a reduced config, a shorter shape)."""
    cfg = cfg or _dryrun_cfg(arch)
    shape = shape or SHAPES[shape_name]
    t0 = time.time()
    counter, _out, args, in_sh = count_step(cfg, shape, meshes[0])
    if counter.real_outputs:
        raise RuntimeError(f"{arch} x {shape_name}: {counter.real_outputs} ops made a real "
                           f"tensor in a meta run: {sorted(counter.real_ops)}; the first "
                           f"at\n{counter.real_stack}")
    out = {}
    for i, mesh in enumerate(meshes):
        if i:  # the same meta arguments, sharded on this mesh
            _, args, in_sh = build_step(cfg, shape, mesh)
        arg_bytes = arg_bytes_per_device(args, in_sh)
        try:
            rec = record_collectives(cfg, shape, mesh)
            if rec.real_outputs:
                raise RuntimeError(f"{rec.real_outputs} tensors made on the cards in the "
                                   f"sharded meta run")
        except Exception as e:  # noqa: BLE001 -- reported as the cell's failure on this mesh
            traceback.print_exc()
            out[mesh.name] = e
            continue
        out[mesh.name] = rl.analyze(
            arch=arch, shape_name=shape_name, mesh_name=mesh.name, chips=mesh.size,
            cost={"flops": counter.flops / mesh.size,
                  "bytes accessed": counter.total_bytes / mesh.size},
            collectives=rec.records, bytes_per_device=arg_bytes,
            model_flops=rl.model_flops_for(cfg, shape), note=NOTE)
    dt = time.time() - t0
    for name, r in out.items():
        print(f"\n=== {arch} x {shape_name} @ {name} ({dt:.1f}s) ===")
        if isinstance(r, Exception):
            print(f"sharded run failed: {type(r).__name__}: {r}")
            continue
        print(f"count: flops/dev={r.hlo_flops:.3e} bytes/dev={r.hlo_bytes:.3e} "
              f"args/dev={r.bytes_per_device:.3e} kernels={counter.kernels}")
        print(f"collectives: {r.collective_detail['counts']} wire/dev={r.collective_bytes:.3e}")
        print(f"roofline: compute={r.compute_s*1e3:.3f}ms memory={r.memory_s*1e3:.3f}ms "
              f"collective={r.collective_s*1e3:.3f}ms dominant={r.dominant} "
              f"useful={r.useful_ratio:.3f}")
    return out, counter, dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi_pod", "both"])
    ap.add_argument("--out", default="build/dryrun.json")
    args = ap.parse_args(argv)

    cells = all_cells()
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch.replace("-", "_")]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]
    meshes = [make_production_mesh(multi_pod=mp) for mp in
              {"single": [False], "multi_pod": [True], "both": [False, True]}[args.mesh]]

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results, failures = {}, []
    for arch, shape_name in cells:
        try:
            reports, counter, dt = run_cell(arch, shape_name, meshes)
        except Exception as e:  # noqa: BLE001
            traceback.print_exc()
            for mesh in meshes:
                key = f"{arch}|{shape_name}|{mesh.name}"
                failures.append(key)
                results[key] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            continue
        for name, report in reports.items():
            key = f"{arch}|{shape_name}|{name}"
            if isinstance(report, Exception):
                failures.append(key)
                results[key] = {"ok": False, "error": f"{type(report).__name__}: {report}"}
                continue
            results[key] = {
                "ok": True, "compile_s": dt, **report.to_json(), "temp_bytes": None,
                "kernels": counter.kernels, "aten_flops": counter.aten_flops,
                "counted_on": "meta"}
    for a_s, why in SKIPPED_CELLS.items():
        results[f"{a_s[0]}|{a_s[1]}|skipped"] = {"ok": True, "skipped": why}
    out_path.write_text(json.dumps(results, indent=1))

    n_ok = sum(1 for v in results.values() if v.get("ok"))
    print(f"\n==== dry-run complete: {n_ok}/{len(results)} ok; failures: {failures} ====")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
