#!/usr/bin/env python3
"""Time the serve path's decode step and prefill call on one NVIDIA card
for one checkout's ``src`` directory, so that two versions of the model
code can be compared in turns inside one run on one card:

    python3 benchmarks/torch/serve_decode_bench.py [--src DIR] [--label NAME] [--rounds 3]

The workloads are ``chip_smoke.py``'s phases 6 and 17: ``qwen3_0_6b`` and
``granite_moe_1b_a400m`` at full width (f32, seeded weights), 8 requests
of 512-token prompts, 16 new tokens each, batches of 4
(``chip_smoke.SERVE_SHAPE``).  For each, the weights are made once and the
requests served ``--rounds`` + 1 times through ``ContinuousBatcher`` (the
loop ``launch.serve`` runs); the first serving warms up and is left out.
Reported for each round: decode ms a step and prefill ms a call (the
batcher's own clocks, as phases 6 and 17 report them), and their medians.
``--src`` (default: this checkout's ``src``) picks the ``repro_torch``
that is imported.  Prints the card's name and power limit, one JSON line
per model and, last, one JSON line with all of it.  Exits non-zero without
a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ARCHS = ("qwen3_0_6b", "granite_moe_1b_a400m")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("serve_decode_bench: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serving.batching import ContinuousBatcher

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    shape = dict(zip(chip_smoke.SERVE_SHAPE[::2], chip_smoke.SERVE_SHAPE[1::2]))
    n_req, max_batch, prompt_len, max_len, max_new = (int(shape[k]) for k in (
        "--requests", "--max-batch", "--prompt-len", "--max-len", "--max-new"))
    out = dict(label=args.label, src=str(args.src), card=smi, shape=shape)
    for arch in ARCHS:
        cfg = get_config(arch)
        model = build_model(cfg)
        params = serve.init_params(model, "cuda")
        rounds = []
        for r in range(args.rounds + 1):
            reqs = serve.make_requests(cfg, n_req, prompt_len, max_new)
            batcher = ContinuousBatcher(model, max_batch=max_batch, max_len=max_len)
            batcher.model_params = params
            torch.cuda.synchronize()
            m = batcher.serve(reqs)
            torch.cuda.synchronize()
            if not all(q.finished_step >= 0 for q in reqs):
                raise AssertionError(f"{arch}: requests left unfinished")
            if r:
                rounds.append(dict(decode_ms_per_step=m.decode_s / m.steps * 1e3,
                                   prefill_ms_per_call=m.prefill_s / m.prefill_calls * 1e3,
                                   tokens_per_s=m.tokens_per_s, steps=m.steps))
        out[arch] = dict(
            rounds=rounds,
            decode_ms_median=statistics.median(x["decode_ms_per_step"] for x in rounds),
            prefill_ms_median=statistics.median(x["prefill_ms_per_call"] for x in rounds))
        print(json.dumps({arch: out[arch]}), flush=True)
        del model, params
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
