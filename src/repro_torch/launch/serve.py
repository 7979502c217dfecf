"""Serving launcher: continuous batching over the model zoo.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch <id> \
        [--reduced] [--device cuda|cpu] [--requests 8] [--max-new 16]

``<id>`` is one of ``repro_torch.configs.ARCH_IDS``: qwen3_0_6b, olmo_1b,
qwen1_5_4b, qwen3_4b (dense), internvl2_2b (vlm), mamba2_780m (ssm),
zamba2_7b (hybrid), granite_moe_1b_a400m, kimi_k2_1t_a32b (moe; kimi only
``--reduced``: it does not fit one card), whisper_large_v3 (encdec).  As in
the JAX package, the batcher's prompts are tokens only: a vlm is served
without a patch prefix, and Whisper in token mode, its cross-attention over
zero K/V (``serving/batching.py``); ``build_model(cfg).prefill`` with
``batch["patches"]`` or ``batch["frames"]`` runs the whole model.

Weights are random, drawn from a seeded ``torch.Generator`` on the device;
prompts come from a seeded numpy generator.  Runs on the card unless
``--device cpu`` is given; with no card it fails rather than run on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models.model_zoo import build_model
from repro_torch.serving.batching import ContinuousBatcher, Request


def make_requests(cfg, n: int, prompt_len: int, max_new: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [
        Request(req_id=i, prompt=rng.integers(2, cfg.vocab, prompt_len).astype(np.int32),
                max_new_tokens=max_new)
        for i in range(n)
    ]


def init_params(model, device, seed: int = 0):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return model.init(gen)


def main(argv=None):
    """Serve ``--requests`` seeded prompts; returns (metrics, requests)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve: no CUDA device is available (pass --device cpu to run on the CPU)")
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg)
    params = init_params(model, device)
    reqs = make_requests(cfg, args.requests, args.prompt_len, args.max_new)
    b = ContinuousBatcher(model, max_batch=args.max_batch, max_len=args.max_len)
    b.model_params = params
    m = b.serve(reqs)
    done = sum(1 for r in reqs if r.finished_step >= 0)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(
        f"served {done}/{len(reqs)} requests in {m.steps} steps, "
        f"{m.tokens_out} tokens, {m.tokens_per_s:.1f} tok/s ({where})"
    )
    for r in reqs[:3]:
        print(f"  req {r.req_id}: out[{len(r.output)}] = {r.output[:8]}...")
    return m, reqs


if __name__ == "__main__":
    main()
