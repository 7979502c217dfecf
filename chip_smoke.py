#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PULSE on one NVIDIA card and check it.

Run from the root of the repository, on a machine with a CUDA card and
``nvcc``:

    python3 chip_smoke.py [--seed 0] [--json PATH]

Phases (any failure exits non-zero before the last line):
  1. device and build: the card's name and power limit, then the
     ``pulse_chase`` kernel built from ``src/repro_torch/csrc`` with its
     ``-Xptxas -v`` report;
  2. kernel against its plain version: the four ISA read programs, each on
     its structure at a small size and at the paper's size, through
     ``ops.pulse_chase`` (kernel) and ``ref.chase_reference`` (plain) on the
     same CUDA tensors; every output must be bit-equal (tolerance 0: the
     state is int32);
  3. the main path: ``PulseEngine(arena).execute(it, ptr0, scr0,
     max_iters=4096)`` with the default backend ("kernel") on three
     workloads of 65,536 YCSB-Zipfian queries (90% stored keys by rank with
     p ~ rank^-0.99, 10% absent keys); results must equal
     ``backend="reference"`` and the structure's ``ref_find`` oracle, and
     the kernel's launch count must rise.

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
B_MAIN = 65_536  # queries per main-path workload
ZIPF_S = 0.99  # YCSB's Zipfian constant
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
TPU_KERNEL = "src/repro/kernels/pulse_chase/kernel.py:38"
KERNEL_SOURCE = "src/repro_torch/csrc/pulse_chase.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------- workloads ----------------------------------


def make_keys(rng, n: int):
    """``n`` distinct non-negative int32 keys in rank order (rank 1 first)."""
    import numpy as np

    k = np.unique(rng.integers(0, 2**31 - 1, size=n + n // 8 + 1024, dtype=np.int64))
    if len(k) < n:
        raise RuntimeError("key draw came up short")
    return rng.permutation(k)[:n].astype(np.int32)


def make_queries(rng, keys, B: int):
    """90% stored keys drawn by rank with p ~ rank^-ZIPF_S, 10% absent."""
    import numpy as np

    n = len(keys)
    n_hit = int(round(0.9 * B))
    w = np.arange(1, n + 1, dtype=np.float64) ** -ZIPF_S
    hits = keys[rng.choice(n, size=n_hit, p=w / w.sum())]
    stored = np.sort(keys.astype(np.int64))
    cand = rng.integers(0, 2**31 - 1, size=4 * (B - n_hit) + 64, dtype=np.int64)
    pos = np.clip(np.searchsorted(stored, cand), 0, n - 1)
    absent = cand[stored[pos] != cand][: B - n_hit]
    if len(absent) < B - n_hit:
        raise RuntimeError("absent-key draw came up short")
    q = np.concatenate([hits.astype(np.int64), absent])
    return rng.permutation(q).astype(np.int32)


def build_structure(kind: str, n_keys: int, rng, *, n_buckets: int = 0, B: int = B_MAIN):
    """(arena on the card, ISA iterator, ptr0, scr0, oracle).

    ``oracle(res, idx)`` checks lanes ``idx`` of an ExecResult against the
    structure's ``ref_find`` (hash table and B+tree; None otherwise)."""
    import numpy as np
    import torch

    from repro_torch.core import isa
    from repro_torch.core.structures import bst, btree, hash_table, isa_programs
    from repro_torch.core.structures import linked_list

    keys = make_keys(rng, n_keys)
    values = rng.integers(0, 2**31 - 1, n_keys).astype(np.int32)
    q = make_queries(rng, keys, B)
    qt = torch.from_numpy(q).cuda()
    oracle = None
    if kind == "list":
        arena, head = linked_list.build(keys, values)
        ptr0, scr0 = linked_list.find_iterator().init(qt, head)
        prog = isa_programs.list_find_program()
    elif kind == "hash":
        arena, heads = hash_table.build(keys, values, n_buckets)
        ptr0, scr0 = hash_table.find_iterator(n_buckets).init(qt, heads)
        prog = isa_programs.hash_find_program()

        def oracle(res, idx):
            want = hash_table.ref_find(keys, values, n_buckets, q[idx])
            return _check_find(res, idx, want, hops=True)
    elif kind == "bst":
        arena, root, _ = bst.build(keys, values)
        ptr0, scr0 = bst.find_iterator().init(qt, root)
        prog = isa_programs.bst_find_program()
    else:
        arena, root, _ = btree.build(keys, values)
        ptr0, scr0 = btree.find_iterator().init(qt, root)
        prog = isa_programs.btree_find_program()

        def oracle(res, idx):
            want = btree.ref_find(keys, values, q[idx])
            return _check_find(res, idx, want, hops=False)
    return arena, isa.as_pulse_iterator(prog), ptr0, scr0, oracle


def _check_find(res, idx, want, *, hops: bool) -> bool:
    import numpy as np

    scr = res.scratch.cpu().numpy()[idx]
    got = [(int(s[1]), int(s[2])) for s in scr]
    if got != [(w[0], w[1]) for w in want]:
        return False
    if hops:  # chain walks: iterations == nodes visited
        return list(res.iters.cpu().numpy()[idx]) == [w[2] for w in want]
    return bool(np.all(res.status.cpu().numpy()[idx] == 1))


# ------------------------------ measurement ---------------------------------


def work_bytes(lane_steps: int, B: int, W: int, S: int, T: int) -> int:
    """Bytes the work must move: W*4 per executed lane-step, the lane state
    (ptr, status, iters, scratch) in and out once and the program once.
    The work is all gathers and integer compares, so bytes bound it."""
    return lane_steps * W * 4 + 2 * B * (3 + S) * 4 + T * 16


def time_cuda(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def kernel_vs_plain(arena, it, ptr0, scr0, num_steps: int):
    """One launch of the kernel and one of the plain version on the same
    CUDA tensors; returns (outputs equal?, max |diff|)."""
    import torch

    from repro_torch.kernels.pulse_chase import ops, ref

    logic = ops.iterator_logic(it)
    st0 = torch.zeros_like(ptr0)
    got = ops.pulse_chase(arena.data, ptr0, scr0, st0, logic_fn=logic, num_steps=num_steps)
    want = ref.chase_reference(arena.data, ptr0, scr0, st0, torch.zeros_like(ptr0), logic,
                               num_steps)
    torch.cuda.synchronize()
    err = max(max_abs_err(a, b) for a, b in zip(want, got))
    same = all(torch.equal(a, b) for a, b in zip(want, got))
    return same, err


# --------------------------------- phases -----------------------------------


def phase_device():
    import torch

    from repro_torch.kernels.pulse_chase import kernel

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible)")
    log(f"nvidia-smi: {smi}")
    t0 = time.perf_counter()
    so = kernel.build()
    log(f"built {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in kernel.build_log().splitlines():
        if "ptxas" in line:
            log(f"  {line.strip()}")
    return name, smi


def phase_kernel_vs_plain(rng):
    """The four read programs, small and at the paper's size."""
    from repro_torch.kernels.pulse_chase import ops

    cases = [
        # (program, structure, keys, buckets, lanes, steps)
        ("list_find", "list", 64, 0, 256, 80),
        ("list_find", "list", 4096, 0, B_MAIN, 64),
        ("hash_find", "hash", 256, 32, 256, 64),
        ("hash_find", "hash", 200_000, 4096, B_MAIN, 64),
        ("bst_find", "bst", 512, 0, 256, 16),
        ("bst_find", "bst", 500_000, 0, B_MAIN, 24),
        ("btree_find", "btree", 512, 0, 256, 8),
        ("btree_find", "btree", 500_000, 0, B_MAIN, 8),
    ]
    before = ops.pulse_chase.launches
    checks = []
    for prog, kind, n, nb, B, steps in cases:
        arena, it, ptr0, scr0, _ = build_structure(kind, n, rng, n_buckets=nb, B=B)
        same, err = kernel_vs_plain(arena, it, ptr0, scr0, steps)
        checks.append(dict(program=prog, keys=n, lanes=B, num_steps=steps,
                           bit_equal=same, max_abs_err=err))
        log(f"  {prog:10s} keys={n:>7d} lanes={B:>6d} steps={steps:>3d} "
            f"bit_equal={same} max_abs_err={err}")
        if not same:
            raise AssertionError(f"pulse_chase kernel disagrees with its plain version on {prog}")
    n_launch = ops.pulse_chase.launches - before
    log(json.dumps({"phase": "kernel_vs_plain", "name": "pulse_chase",
                    "launches": n_launch, "mismatches": 0, "checks": checks}))
    return checks


def _timed_launches(fn):
    """Run ``fn`` with CUDA events around every kernel launch; returns
    (result, per-launch milliseconds)."""
    import torch

    from repro_torch.kernels.pulse_chase import kernel

    real, events = kernel.launch, []

    def timed(*args, **kwargs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = real(*args, **kwargs)
        b.record()
        events.append((a, b))
        return out

    kernel.launch = timed
    try:
        out = fn()
    finally:
        kernel.launch = real
    torch.cuda.synchronize()
    return out, [a.elapsed_time(b) for a, b in events]


def phase_main(rng, workloads):
    import numpy as np
    import torch

    from repro_torch.core.engine import PulseEngine
    from repro_torch.core.iterator import STATUS_DONE, STATUS_FAULT
    from repro_torch.kernels.pulse_chase import ops, ref

    l2_size = torch.cuda.get_device_properties(0).L2_cache_size
    rows = []
    for wl in workloads:
        t0 = time.perf_counter()
        arena, it, ptr0, scr0, oracle = build_structure(
            wl["structure"], wl["n_keys"], rng, n_buckets=wl["n_buckets"])
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        eng = PulseEngine(arena)
        decision = eng.dispatch(it)
        log(f"[{wl['name']}] {wl['n_keys']} keys, arena {arena.capacity} x {arena.node_words} "
            f"words ({arena.capacity * arena.node_words * 4 / 1e6:.1f} MB), set-up "
            f"{setup_s:.1f} s; dispatch model: {decision.reason} (an arena on the card "
            f"is traversed on the card)")
        run = dict(max_iters=4096)

        # the main path, with the launch count read around it
        torch.cuda.reset_peak_memory_stats()
        ops.pulse_chase.launches = 0
        res = eng.execute(it, ptr0, scr0, **run)
        torch.cuda.synchronize()
        launches = ops.pulse_chase.launches
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        if launches == 0 or not res.offloaded:
            raise AssertionError(f"{wl['name']}: the main path launched no kernel")
        for f in ("ptr", "scratch", "status", "iters"):
            t = getattr(res, f)
            if not (t.is_cuda and t.dtype == torch.int32 and t.shape[0] == B_MAIN):
                raise AssertionError(f"{wl['name']}: bad {f} {t.dtype} {tuple(t.shape)}")

        ref_res = eng.execute(it, ptr0, scr0, backend="reference", **run)
        torch.cuda.synchronize()
        for f in ("ptr", "scratch", "status", "iters"):
            if not torch.equal(getattr(res, f), getattr(ref_res, f)):
                raise AssertionError(f"{wl['name']}: kernel and reference backends differ on {f}")
        sample = np.sort(np.random.default_rng(1).choice(B_MAIN, 1024, replace=False))
        if not oracle(res, sample):
            raise AssertionError(f"{wl['name']}: results disagree with ref_find")
        status = res.status.cpu().numpy()
        if not np.all((status == STATUS_DONE) | (status == STATUS_FAULT)):
            raise AssertionError(f"{wl['name']}: lanes left unfinished")

        # end-to-end rate: host clock around work that ends in a synchronise
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            eng.execute(it, ptr0, scr0, **run)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        _, per_launch = _timed_launches(lambda: eng.execute(it, ptr0, scr0, **run))

        # one launch over the whole batch to full depth: kernel, plain, bound
        iters = res.iters.long()
        depth = int(iters.max().item())
        logic = ops.iterator_logic(it)
        st0 = torch.zeros_like(ptr0)
        scr0c = scr0.reshape(B_MAIN, it.scratch_words).contiguous()
        one = ops.pulse_chase(arena.data, ptr0, scr0c, st0, logic_fn=logic, num_steps=depth)
        torch.cuda.synchronize()
        lane_steps = int(one[3].long().sum().item())
        k_ms = time_cuda(lambda: ops.pulse_chase(arena.data, ptr0, scr0c, st0,
                                                 logic_fn=logic, num_steps=depth), 10)
        p_ms = time_cuda(lambda: ref.chase_reference(arena.data, ptr0, scr0c, st0,
                                                     torch.zeros_like(ptr0), logic, depth), 1)
        nbytes = work_bytes(lane_steps, B_MAIN, arena.node_words, it.scratch_words,
                            len(logic.program))
        arena_bytes = arena.capacity * arena.node_words * 4
        in_l2 = arena_bytes < l2_size
        done = res.status == STATUS_DONE
        row = dict(
            workload=wl["name"], keys=wl["n_keys"], lanes=B_MAIN,
            arena_mb=arena.capacity * arena.node_words * 4 / 1e6,
            launches=launches, chunks=res.stats.chunks,
            lanes_per_chunk=res.stats.lanes_per_chunk,
            kernel_ms_per_launch_mean=float(np.mean(per_launch)),
            kernel_ms_per_launch_max=float(np.max(per_launch)),
            kernel_ms_in_execute=float(np.sum(per_launch)),
            execute_s=secs, lookups_per_s=B_MAIN / min(secs),
            iters_mean=float(iters[done].float().mean().item()),
            iters_max=int(iters.max().item()),
            faulted_lanes=int((res.status == STATUS_FAULT).sum().item()),
            peak_mb=peak_mb,
            full_depth_steps=depth, full_depth_lane_steps=lane_steps,
            ms=k_ms, plain_ms=p_ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", bound_rate="HBM", arena_in_l2=in_l2,
            # an arena that fits in L2 is never read from HBM: its least time
            # at the L2 rate lies below this HBM bound, so kernel/bound
            # understates how far the kernel is from the card's limit
            bound_note=("HBM bound; the arena is L2-resident, so the least time is "
                        "below it" if in_l2 else "HBM bound; the gathers come from HBM"),
            dispatch_offload=decision.offload, offloaded=res.offloaded,
        )
        log(f"[{wl['name']}] launches={launches} chunks={row['chunks']} "
            f"lookups/s={row['lookups_per_s']:.4g} (execute s {secs}) "
            f"kernel ms/launch mean={row['kernel_ms_per_launch_mean']:.4f} "
            f"max={row['kernel_ms_per_launch_max']:.4f} "
            f"iters mean={row['iters_mean']:.2f} max={row['iters_max']} "
            f"peak={peak_mb:.1f} MiB")
        log(f"[{wl['name']}] one launch, {depth} steps, {lane_steps} lane-steps: "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bytes bound {row['bound_ms']:.5f} ms "
            f"({row['bound_note']})")
        rows.append(row)
        del arena, eng, res, ref_res
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", type=Path, default=None,
                    help="also write every measured number to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.configs import pulse_paper
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 1

    import numpy as np

    rng = np.random.default_rng(args.seed)
    t_start = time.perf_counter()
    log("== phase 1: device and build")
    name, smi = phase_device()
    log("== phase 2: pulse_chase kernel against its plain version")
    checks = phase_kernel_vs_plain(rng)
    log("== phase 3: PulseEngine.execute, backend='kernel'")
    ws, wt = pulse_paper.WEBSERVICE, pulse_paper.WIREDTIGER
    workloads = [
        dict(name=ws.name, structure="hash", n_keys=ws.n_keys, n_buckets=ws.n_buckets),
        dict(name=wt.name, structure="btree", n_keys=wt.n_keys, n_buckets=0),
        dict(name="wiredtiger_2p24", structure="btree", n_keys=2**24, n_buckets=0),
    ]
    rows = phase_main(rng, workloads)

    # the headline is the workload whose gathers come from HBM, where the
    # bytes bound at the HBM rate is the card's own
    head = next(r for r in rows if not r["arena_in_l2"])
    entry = dict(
        name="pulse_chase", route="cuda", source=KERNEL_SOURCE, replaces=TPU_KERNEL,
        launches=sum(r["launches"] for r in rows),
        max_abs_err=max(c["max_abs_err"] for c in checks), mismatches=0,
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by="bytes", library_ms=None, timed_on=head["workload"],
        workloads=rows,
    )
    summary = {"kernels": [entry]}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(dict(
            device=name, nvidia_smi=smi, seed=args.seed, checks=checks, **summary,
            seconds=time.perf_counter() - t_start), indent=1))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
