#!/usr/bin/env python3
"""Build variants of the split-K ``paged_attention`` kernel on one NVIDIA
card and time each at the decode shapes of ``paged_decode_bench.py``:

    python3 benchmarks/torch/paged_decode_variants.py [--seed 0] [--rounds 2]

A variant is this checkout's ``src/repro_torch/csrc/paged_attention.cu``
with a few lines replaced (``VARIANTS``), built into its own library and
swapped in for the wrapper's; the timing is ``chip_smoke.time_paged``
(profiler kernel time summed over the call's kernels, pools from HBM, the
result held against the plain version first).  Per variant it prints the
``paged_decode*`` instantiations whose ``-Xptxas -v`` report shows a stack
frame or spills, then one JSON line per round.  Exits non-zero without a
card or when a variant does not build.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "paged_attention.cu"
SHAPES = {  # name: (B, H, Hk, D, lengths)
    "qwen": (4, 16, 8, 128, (528, 523, 517, 512)),
    "d112": (4, 64, 8, 112, (528, 523, 517, 512)),
    "long": (1, 16, 8, 128, (8192,)),
}
_CP_ASYNC_HELPERS = '''// 16 bytes from global to shared memory, past L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// the consumer warps only'''
VARIANTS = {  # name: [(text in the source, its replacement)]
    "kernel": [],
    # the producer's lanes copy 16 bytes each (cp.async, lanes along a row)
    # instead of one bulk copy of a row each
    "cp_async": [
        ("// the consumer warps only", _CP_ASYNC_HELPERS),
        ("      mbar_init(&full_bar[i], 1);", "      mbar_init(&full_bar[i], 32);"),
        ('''      if (lane == 0) mbar_arrive_expect_tx(&full_bar[slot], 2u * n * kRowBytes);
      __syncwarp();
      if (lane < n) {
        unsigned char* st = smem + slot * Sh::STAGE;
        bulk_copy(st + lane * RS, kp + off, kRowBytes, &full_bar[slot]);
        bulk_copy(st + (kTok + lane) * RS, vp + off, kRowBytes, &full_bar[slot]);
      }
''', '''      unsigned char* st = smem + slot * Sh::STAGE;
#pragma unroll 4
      for (int i0 = 0; i0 < 2 * kTok * Sh::CH; i0 += 32) {
        const int idx = i0 + lane;
        const int row = idx / Sh::CH, cc = idx - (idx / Sh::CH) * Sh::CH;
        const bool is_v = row >= kTok;
        const int t = is_v ? row - kTok : row;
        const long long src = __shfl_sync(0xffffffffu, off, t);
        if (t < n) cp_async16(st + row * RS + cc * 16, (is_v ? vp : kp) + src + cc * VEC);
      }
      cp_async_arrive(&full_bar[slot]);
''')],
    # 4 consumer warps and a 4-stage ring (135 KB at D 128 f32: 1 block an SM)
    "warps4": [("constexpr int kWarps = 3;", "constexpr int kWarps = 4;")],
    # 2 consumer warps and a 2-stage ring
    "warps2": [("constexpr int kWarps = 3;", "constexpr int kWarps = 2;")],
    # __launch_bounds__ without its minimum of 1 block (ptxas then spills)
    "no_min_blocks": [("__launch_bounds__(kThreads, 1)", "__launch_bounds__(kThreads)")],
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "paged_variants",
                    help="where the variants' sources go (a directory git ignores)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("paged_decode_variants: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import kernel

    base = SOURCE.read_text()
    args.out.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name, subs in VARIANTS.items():
        text = base
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: {old[:60]!r} is not in the source")
            text = text.replace(old, new)
        path = args.out / f"paged_{name}.cu"
        path.write_text(text)
        sources[name] = _build.KernelSource(f"paged_{name}", path)
    _build.build_all(sources.values())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0], flush=True)
    for name, src in sources.items():
        entry, spills = "", []
        for line in src.build_log().splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "spill" in line and "0 bytes stack frame, 0 bytes spill" not in line:
                spills.append(f"{entry}: {line.strip()}")
        print(json.dumps({"variant": name, "instantiations_with_spills": len(spills),
                          "spills": spills}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for rnd in range(args.rounds):
        for name, src in sources.items():
            kernel.SOURCE = src
            kernel._library.cache_clear()
            kernel._blocks_per_sm.cache_clear()
            row = {"variant": name, "round": rnd}
            for shape, (B, H, Hk, D, lengths) in SHAPES.items():
                r = chip_smoke.time_paged(gen, B, H, Hk, D, lengths=lengths)
                row[shape] = {k: r[k] for k in ("ms", "merge_ms", "splits", "max_abs_err")}
                row[shape]["blocks_per_sm"] = kernel._blocks_per_sm(
                    torch.cuda.current_device(), D, H // Hk, 0)
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
