#!/usr/bin/env python3
"""Time ``pulse_chase``'s superstep mode and ``pulse_commit`` on one NVIDIA
card for one checkout's ``src`` directory, so that two versions of the
kernels (before and after their shard offset) can be compared in turns
inside one run on one card:

    python3 benchmarks/torch/offset_kernels_bench.py [--src DIR] [--label NAME] [--seed 0]

The inputs are ``chip_smoke.py``'s phase-11 and phase-12 batches over four
emulated memory nodes (65,536 YCSB-Zipfian records): one superstep's local
chase of ``webservice`` (interleaved) and of ``wiredtiger`` (sequential)
after two routed supersteps (``chip_smoke.superstep_vs_plain``), and the
``wiredtiger_update`` commit phase with the most staged records
(``chip_smoke._capture_commits`` and ``commit_vs_plain``).  Each is checked
against its plain version, then timed by the profiler's kernel timestamps
(the commit: every kernel of the phase, the sort's included).  Where the
checkout's kernels take a shard offset (``shard0``, ``row0``), the four
one-shard launches of the same superstep (each over its shard's pool and
rows) are timed too and held against the all-shards launch's slices.
``--src`` (default: this checkout's ``src``) picks the ``repro_torch``
that is imported; the measurement code is this checkout's.  Prints the
card's name and power limit and, last, one JSON line.  Exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("offset_kernels_bench: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    import numpy as np

    import chip_smoke
    from repro_torch.core import routing
    from repro_torch.core.arena import arena_from_numpy
    from repro_torch.core.engine import PulseEngine
    from repro_torch.kernels.pulse_chase import ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    offset = "shard0" in inspect.signature(ops.pulse_chase_superstep).parameters
    rng = np.random.default_rng(args.seed)
    P, batches = chip_smoke.routing_batches(rng)
    out = dict(label=args.label, src=str(args.src), card=smi, shard_offset=offset)
    for b in batches[:2]:
        card = arena_from_numpy(*(t.numpy() for t in (b["arena"].data, b["arena"].bounds,
                                                      b["arena"].perms, b["arena"].heap)),
                                device="cuda")
        p0, s0 = b["p0"].cuda(), b["s0"].cuda()
        one = chip_smoke.superstep_vs_plain(card, b["it"], p0, s0, P)
        if not one["bit_equal"]:
            raise AssertionError(f"{b['name']}: the superstep kernel disagrees with plain")
        row = dict(ms=one["ms"], ms_source=one["ms_source"], active=one["active_records"])
        if offset:
            pools, _ = routing.place_requests(p0, s0, P)
            step = routing.make_superstep(b["it"], P, k_local=4, max_iters=4096,
                                          drain_done=True)
            for _ in range(2):
                pools = step(pools, card.data, card.bounds, card.perms)[0]
            logic = ops.iterator_logic(b["it"])
            run = dict(logic_fn=logic, k_local=4, max_iters=4096)
            whole = ops.pulse_chase_superstep(card.data, pools, card.bounds, card.perms, **run)
            edges = card.bounds.tolist()
            rows = [card.data[edges[s]:edges[s + 1]].clone() for s in range(P)]
            shards = [pools[s:s + 1].contiguous() for s in range(P)]

            def per_shard():
                return [ops.pulse_chase_superstep(rows[s], shards[s], card.bounds, card.perms,
                                                  shard0=s, row0=edges[s], **run)
                        for s in range(P)]

            got = per_shard()
            if not all(torch.equal(g[0], whole[s]) for s, g in enumerate(got)):
                raise AssertionError(f"{b['name']}: a one-shard launch differs from the "
                                     f"all-shards launch's slice")
            row.update(one_shard_launches_ms=chip_smoke.profiled_ms([per_shard], 10,
                                                                    "chase_kernel"))
        out[f"superstep/{b['name']}"] = row
        print(json.dumps({b["name"]: row}), flush=True)

    wb = chip_smoke._wiredtiger_update(rng, P)
    (_, it, p0, s0), = wb["steps"]
    card = arena_from_numpy(*wb["fields"], device="cuda")
    _, best, _ = chip_smoke._capture_commits(lambda: PulseEngine(
        card, mesh=routing.EmulatedMesh(P, "cuda")).execute(
            it, p0.cuda(), s0.cuda(), **chip_smoke.WRITE_MESH_RUN))
    commit = chip_smoke.commit_vs_plain(best)
    if not commit["bit_equal"]:
        raise AssertionError("wiredtiger_update: pulse_commit disagrees with plain")
    out["commit/wiredtiger_update"] = {k: commit[k] for k in (
        "ms", "ms_source", "stages_ms", "eligible", "bound_ms")}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
