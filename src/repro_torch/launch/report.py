"""Renders the roofline table of a dry run's JSON (``launch.dryrun``'s
``--out``), the same table, byte for byte, as the JAX package's report of
the same JSON.

    PYTHONPATH=src python -m repro_torch.launch.report [--json build/dryrun.json] [--mesh 32x8]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def fmt_s(x):
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def fmt_b(x):
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x/div:.1f}{unit}"
    return f"{x:.0f}B"


def render(path: str, mesh_filter: str | None = None) -> str:
    data = json.loads(Path(path).read_text())
    rows = []
    for key, v in sorted(data.items()):
        if not v.get("ok") or "skipped" in v:
            continue
        arch, shape, mesh = key.split("|")
        if mesh_filter and mesh != mesh_filter:
            continue
        flag = " (probeless)" if v.get("probeless") else ""
        rows.append(
            f"| {arch} | {shape} | {mesh}{flag} | {fmt_s(v['compute_s'])} "
            f"| {fmt_s(v['memory_s'])} | {fmt_s(v['collective_s'])} "
            f"| {v['dominant']} | {v['useful_ratio']:.3f} "
            f"| {fmt_b(v['bytes_per_device'])} |"
        )
    hdr = (
        "| arch | shape | mesh | compute | memory | collective | dominant "
        "| 6ND/HLO | bytes/dev |\n|---|---|---|---|---|---|---|---|---|"
    )
    skips = [
        f"| {k.split('|')[0]} | {k.split('|')[1]} | SKIPPED: {v['skipped']} |"
        for k, v in data.items()
        if v.get("skipped")
    ]
    failures = [k for k, v in data.items() if not v.get("ok")]
    out = [hdr] + rows
    if skips:
        out += ["", "Skipped cells:"] + skips
    if failures:
        out += ["", f"FAILED cells: {failures}"]
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="build/dryrun.json")
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args()
    print(render(args.json, args.mesh))


if __name__ == "__main__":
    main()
