"""Training launcher, the JAX package's ``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b \
        [--steps 100] [--batch 8] [--seq 128] [--reduced] [--device cuda|cpu] \
        [--ckpt-dir DIR [--resume]] [--microbatches 1] [--compression none|topk|int8]

Drives ``TrainLoop`` on synthetic data (``data/pipeline.py``): the
optimizer the config names (``cfg.optimizer``), warmup ``max(steps // 20,
5)``, cosine decay to ``steps``; zero ``patches`` (vlm) or ``frames``
(encdec) beside the tokens; checkpoints every ``--ckpt-every`` steps and at
the end, and ``--resume`` from the latest.  One host (``num_hosts`` 1).
Weights are random, drawn from a ``torch.Generator`` seeded by ``--seed``
on the device.  Runs on the card unless ``--device cpu`` is given; with no
card it fails rather than run on the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.models.model_zoo import build_model
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.compression import CompressionConfig
from repro_torch.training.train_loop import StragglerPolicy, TrainConfig, TrainLoop, init_state


def train_config(cfg, args) -> TrainConfig:
    return TrainConfig(
        opt=opt_mod.OptimizerConfig(
            name=cfg.optimizer, lr=args.lr, warmup_steps=max(args.steps // 20, 5),
            total_steps=args.steps,
        ),
        compression=CompressionConfig(scheme=args.compression),
        microbatches=args.microbatches,
    )


def data_iterator(cfg, args, device) -> DataIterator:
    data = DataIterator(DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch),
                        device=device)
    if cfg.family == "vlm":
        data.extras["patches"] = lambda step, b: np.zeros(
            (b, cfg.n_patches, cfg.d_model), np.float32)
    if cfg.family == "encdec":
        data.extras["frames"] = lambda step, b: np.zeros(
            (b, cfg.n_audio_frames, cfg.d_model), np.float32)
    return data


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default="none", choices=["none", "topk", "int8"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="seeds the weights' torch.Generator")
    return ap


def main(argv=None):
    """Train; returns the log (one metrics row a step)."""
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train: no CUDA device is available (pass --device cpu to run on the CPU)")
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg)
    tcfg = train_config(cfg, args)
    data = data_iterator(cfg, args, device)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    state = init_state(model, tcfg, gen)
    start_step = 0
    if args.resume and ckpt is not None and ckpt.latest_step() is not None:
        state, extra, start_step = ckpt.restore(state)
        data.load_state_dict(extra)
        print(f"resumed from step {start_step}")

    loop = TrainLoop(model, tcfg, data, ckpt_manager=ckpt, ckpt_every=args.ckpt_every,
                     straggler=StragglerPolicy())
    t0 = time.time()
    state, log = loop.run(state, start_step, args.steps - start_step)
    for row in log:
        if row["step"] % args.log_every == 0 or row["step"] == args.steps - 1:
            print(f"step {row['step']:5d} loss {row['loss']:.4f} "
                  f"gnorm {row['grad_norm']:.3f} dt {row['dt'] * 1e3:.0f}ms")
    if ckpt is not None:
        ckpt.save(state, args.steps, extra=data.state_dict(), block=True)
    dt = time.time() - t0
    toks = args.steps * args.batch * args.seq
    print(f"done: {args.steps} steps, {toks / dt:.0f} tok/s, "
          f"final loss {log[-1]['loss']:.4f}, stragglers {loop.straggler.flagged_steps}")
    return log


if __name__ == "__main__":
    main()
