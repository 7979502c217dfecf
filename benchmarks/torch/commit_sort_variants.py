#!/usr/bin/env python3
"""Time the ordering step of ``pulse_commit`` (the sort between its
``commit_key`` and ``commit_apply`` kernels) on one NVIDIA card, beside two
alternatives, at the pool shapes of ``chip_smoke.py`` phase 12:

    python3 benchmarks/torch/commit_sort_variants.py [--seed 0]

Each case is P = 4 shards of L int64 order keys, ``(class * cap + slot) *
L + id`` for a share of eligible records and ``3 * cap * L`` for the rest
(cap = 2^18 rows), as ``commit_key`` writes them.  The variants:

  * ``dim1``: ``torch.sort(key, dim=1, stable=True)``, the port's call;
  * ``flat``: one 1-D ``torch.sort`` of the keys offset by ``shard * (top +
    1)``, which gives each shard's order in its own L positions;
  * ``flat_i32``: the same call on int32 keys, as a key of 32 bits would
    allow (the order of int32 keys is not the commit's; timed only).

``flat``'s order is checked equal to ``dim1``'s.  Each is timed by the
profiler's kernel timestamps, summed over every kernel of one call
(``chip_smoke.kernel_breakdown_ms``), and by CUDA events around calls made
back to back (``chip_smoke.time_cuda``: the stream's time per call, which
holds the host's time to issue it when that is longer).  Prints the card's
name and power limit, one JSON line per case and, last, one JSON line with
them all.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CAP = 1 << 18
CASES = {  # name: (P, L, share of eligible records)
    "wiredtiger_update": (4, 65536, 0.1875),  # 49,152 of 262,144
    "webservice_rw": (4, 65536, 0.002),
    "skiplist_rw": (4, 4096, 0.005),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("commit_sort_variants: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = []
    for name, (P, L, share) in CASES.items():
        top = 3 * CAP * L
        dev = "cuda"
        klass = torch.randint(0, 3, (P, L), generator=gen, device=dev)
        slot = torch.where(klass == 2, 0, torch.randint(0, CAP, (P, L), generator=gen,
                                                        device=dev))
        ids = torch.argsort(torch.rand((P, L), generator=gen, device=dev), dim=1)
        eligible = torch.rand((P, L), generator=gen, device=dev) < share
        key = torch.where(eligible, (klass * CAP + slot) * L + ids, top)
        offset = torch.arange(P, device=dev)[:, None] * (top + 1)
        flat = (key + offset).reshape(-1)
        flat32 = (flat % (1 << 31)).to(torch.int32)
        base = torch.arange(P, device=dev)[:, None] * L

        def dim1(key=key):
            return torch.sort(key, dim=1, stable=True)

        def flat_sort(flat=flat):
            return torch.sort(flat, stable=True)

        def flat_i32(flat32=flat32):
            return torch.sort(flat32, stable=True)

        sk, order = dim1()
        fk, forder = flat_sort()
        same = bool(torch.equal(forder.view(P, L) - base, order)
                    and torch.equal(fk.view(P, L) - offset, sk))
        row = dict(case=name, P=P, L=L, eligible=int(eligible.sum()), flat_equal_dim1=same)
        for vname, fn in (("dim1", dim1), ("flat", flat_sort), ("flat_i32", flat_i32)):
            by_name = chip_smoke.kernel_breakdown_ms([fn], 20) or {}
            row[vname] = dict(device_ms=sum(by_name.values()), kernels=by_name,
                              stream_ms=chip_smoke.time_cuda(fn, 50))
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"device": smi, "cases": rows}))
    return 0 if all(r["flat_equal_dim1"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
