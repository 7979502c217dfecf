#!/usr/bin/env python3
"""Time the port's ``paged_attention`` on one NVIDIA card at three decode
shapes, for one checkout's ``src`` directory, so that two versions of the
kernel can be compared in turns inside one run on one card:

    python3 benchmarks/torch/paged_decode_bench.py [--src DIR] [--label NAME] [--seed 0]

The shapes (f32, page 16, pools rotated beyond the 50 MB L2 so that every
call reads its pages from HBM): Qwen3-0.6B's widths (B 4, H 16, Hk 8, D
128, lengths 512-528), kimi_k2_1t_a32b's heads (B 4, H 64, Hk 8, D 112, the
same lengths) and one sequence of 8,192 tokens at Qwen's widths.  Each is
checked against the plain version first, then timed by the profiler's
kernel timestamps summed over every kernel whose name contains
``paged_decode`` (``chip_smoke.time_paged``), beside its bytes bound at
3.35 TB/s.  ``--src`` (default: this checkout's ``src``) picks the
``repro_torch`` that is imported; the measurement code is this checkout's.
Prints the card's name and power limit, one JSON line per shape and, last,
one JSON line with them all.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SHAPES = {  # name: (B, H, Hk, D, lengths)
    "qwen": (4, 16, 8, 128, (528, 523, 517, 512)),
    "d112": (4, 64, 8, 112, (528, 523, 517, 512)),
    "long": (1, 16, 8, 128, (8192,)),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("paged_decode_bench: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.kernels.paged_attention import kernel

    kernel.SOURCE.build()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = {}
    for name, (B, H, Hk, D, lengths) in SHAPES.items():
        row = chip_smoke.time_paged(gen, B, H, Hk, D, lengths=lengths)
        rows[name] = {k: row[k] for k in ("ms", "ms_events", "ms_l2_warm", "plain_ms",
                                          "bound_ms", "max_abs_err", "splits", "blocks",
                                          "merge_ms", "merge_share")}
        rows[name]["share_of_bound"] = row["bound_ms"] / row["ms"]
        print(json.dumps({"label": args.label, "shape": name, **rows[name]}), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "src": str(args.src), "device": smi, **rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
