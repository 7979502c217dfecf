"""Training launcher, the JAX package's ``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b \
        [--steps 100] [--batch 8] [--seq 128] [--reduced] [--device cuda|cpu] \
        [--ckpt-dir DIR [--resume]] [--microbatches 1] [--compression none|topk|int8]

Drives ``TrainLoop`` on synthetic data (``data/pipeline.py``): the
optimizer the config names (``cfg.optimizer``), warmup ``max(steps // 20,
5)``, cosine decay to ``steps``; zero ``patches`` (vlm) or ``frames``
(encdec) beside the tokens; checkpoints every ``--ckpt-every`` steps and at
the end, and ``--resume`` from the latest.  Weights are random, drawn from
a ``torch.Generator`` seeded by ``--seed`` on the device.  Runs on the card
unless ``--device cpu`` is given; with no card it fails rather than run on
the CPU.

Several hosts: started by a launcher that sets ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` (``torchrun --nproc_per_node N -m
repro_torch.launch.train ...``), each process joins the world's group
(``backend_for``: NCCL where each of a host's ranks has a card of its own,
Gloo on the CPU or where ranks share a card, which NCCL refuses), or keeps
the group it has
(``distributed.world.spawn``).  As in the reference, each rank trains its
own copy of the same seeded state on its rows ``[r * local, (r + 1) *
local)`` of every global batch (``DataConfig(num_hosts=world, host_id=
rank)``); no mesh is built, and no gradient or other collective crosses
ranks in the loop.  A rank's card is ``cuda:<LOCAL_RANK>`` modulo the
cards there are (``cuda:0`` for every rank on one card).  Checkpoints:
rank 0 alone writes (``shard_0.npz`` and ``LATEST``), and every rank waits
for its last save at a barrier; a resume restores that file on every rank,
state and data step alike (the reference's hosts all write ``shard_0``,
racing).  Rank 0 prints the log; the ``done:`` line's tokens/s counts the
world's global batches over the slowest rank's time.  With none of the
variables set and no group, one host, as before.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.distributed import world
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


def data_iterator(cfg, args, device, *, num_hosts: int = 1, host_id: int = 0) -> DataIterator:
    data = DataIterator(DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
                                   num_hosts=num_hosts, host_id=host_id), device=device)
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


def backend_for(device: torch.device) -> str:
    """The process group's backend for ranks on ``device``: NCCL where each
    of this host's ranks (``LOCAL_WORLD_SIZE``, else ``WORLD_SIZE``) has a
    card of its own, Gloo otherwise."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    own_card = local == 1 or (device.index is None and local <= torch.cuda.device_count())
    return "nccl" if device.type == "cuda" and own_card else "gloo"


def rank_device(device: torch.device, rank: int) -> torch.device:
    """A rank's card: ``cuda:<LOCAL_RANK>`` modulo the cards there are."""
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def main(argv=None):
    """Train; returns this rank's log (one metrics row a step)."""
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train: no CUDA device is available (pass --device cpu to run on the CPU)")
    grouped = world.join_from_env(backend_for(device))
    rank, size = (dist.get_rank(), dist.get_world_size()) if grouped else (0, 1)
    device = rank_device(device, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    lead = rank == 0
    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg)
    tcfg = train_config(cfg, args)
    data = data_iterator(cfg, args, device, num_hosts=size, host_id=rank)

    # every rank restores rank 0's checkpoint; rank 0 alone writes
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    state = init_state(model, tcfg, gen)
    start_step = 0
    if args.resume and ckpt is not None and ckpt.latest_step() is not None:
        state, extra, start_step = ckpt.restore(state)
        data.load_state_dict(extra)
        if lead:
            print(f"resumed from step {start_step}")

    loop = TrainLoop(model, tcfg, data, ckpt_manager=ckpt if lead else None,
                     ckpt_every=args.ckpt_every, straggler=StragglerPolicy())
    t0 = time.time()
    state, log = loop.run(state, start_step, args.steps - start_step)
    if lead:
        for row in log:
            if row["step"] % args.log_every == 0 or row["step"] == args.steps - 1:
                print(f"step {row['step']:5d} loss {row['loss']:.4f} "
                      f"gnorm {row['grad_norm']:.3f} dt {row['dt'] * 1e3:.0f}ms")
    if ckpt is not None and lead:
        ckpt.save(state, args.steps, extra=data.state_dict(), block=True)
    dt = time.time() - t0
    if grouped:
        dts = [None] * size
        dist.all_gather_object(dts, dt)  # the slowest rank's time; the save's barrier too
        dt = max(dts)
    toks = args.steps * args.batch * args.seq
    if lead:
        print(f"done: {args.steps} steps, {toks / dt:.0f} tok/s, "
              f"final loss {log[-1]['loss']:.4f}, stragglers {loop.straggler.flagged_steps}")
    return log


if __name__ == "__main__":
    main()
