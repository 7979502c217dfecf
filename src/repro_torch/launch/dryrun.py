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
    activations' peak) is not measured on meta; collectives are not
    counted (0, with a note).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from pathlib import Path

import torch
from torch.utils._pytree import tree_flatten
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, SKIPPED_CELLS, all_cells, get_config
from repro_torch.distributed.sharding import NamedSharding
from repro_torch.kernels import work
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_step

_ALLOCATIONS = {torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided,
                torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided}
NOTE = ("meta counter: FLOPs and bytes are the global step's / chips; temp not measured on "
        "meta; collectives not counted (one process, no program to parse: 0)")


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


def run_cell(arch: str, shape_name: str, meshes):
    """The cell counted once, reported on each mesh -> ({mesh name:
    RooflineReport}, counter, seconds)."""
    cfg = _dryrun_cfg(arch)
    shape = SHAPES[shape_name]
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
        report = rl.analyze(
            arch=arch, shape_name=shape_name, mesh_name=mesh.name, chips=mesh.size,
            cost={"flops": counter.flops / mesh.size,
                  "bytes accessed": counter.total_bytes / mesh.size},
            bytes_per_device=arg_bytes, model_flops=rl.model_flops_for(cfg, shape), note=NOTE)
        out[mesh.name] = report
    dt = time.time() - t0
    for name, r in out.items():
        print(f"\n=== {arch} x {shape_name} @ {name} ({dt:.1f}s) ===")
        print(f"count: flops/dev={r.hlo_flops:.3e} bytes/dev={r.hlo_bytes:.3e} "
              f"args/dev={r.bytes_per_device:.3e} kernels={counter.kernels}")
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
            results[f"{arch}|{shape_name}|{name}"] = {
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
