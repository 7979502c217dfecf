"""The arguments of every cell's step, and their shardings.

The reference's ``ShapeDtypeStruct`` stand-ins are meta tensors here:
shapes and dtypes, no storage, so a full-width state of any config costs
nothing (``device="meta"``, the default).  Given a real device, the same
functions return real tensors drawn from a seeded generator (the cache
zeros), for running the step.  A sharding is ``distributed.sharding.
NamedSharding``: a mesh and a spec.
"""

from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig, ShapeSpec
from repro_torch.distributed.sharding import NamedSharding, fsdp_axes, map_with_path, valid_spec
from repro_torch.models.model_zoo import build_model
from repro_torch.training import optimizer as opt_mod


_valid = valid_spec  # drop spec axes that do not divide the dim (tiny dims replicate)


def generator(device, seed: int = 0) -> torch.Generator:
    """A seeded generator for ``device``'s draws: the CPU's for meta (whose
    draws are shapes only)."""
    device = torch.device(device)
    return torch.Generator(device="cpu" if device.type == "meta" else device).manual_seed(seed)


def batch_struct(cfg: ArchConfig, shape: ShapeSpec, *, device="meta", seed: int = 0):
    """A train/prefill batch: tokens and labels (B, L) int32, a vlm's
    patches, an encdec's frames (f32).  On a real device the tokens are
    uniform draws, the labels the tokens shifted by one, the patches and
    frames standard normal."""
    B, L = shape.global_batch, shape.seq_len
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = (B, cfg.n_patches, cfg.d_model)
    if cfg.family == "encdec":
        extra["frames"] = (B, cfg.n_audio_frames, cfg.d_model)
    if torch.device(device).type == "meta":
        batch = {"tokens": torch.empty((B, L), dtype=torch.int32, device="meta")}
        batch["labels"] = torch.empty_like(batch["tokens"])
        return batch | {k: torch.empty(s, device="meta") for k, s in extra.items()}
    gen = generator(device, seed)
    toks = torch.randint(0, cfg.vocab, (B, L), generator=gen, device=device, dtype=torch.int32)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    return batch | {k: torch.randn(s, generator=gen, device=device) for k, s in extra.items()}


def batch_sharding(cfg, batch, mesh):
    dp = fsdp_axes(mesh)
    dp = dp if dp else (None,)

    def one(_path, leaf):
        spec = (dp,) if leaf.dim() == 1 else (dp,) + (None,) * (leaf.dim() - 1)
        return NamedSharding(mesh, _valid(spec, leaf.shape, mesh))

    return map_with_path(one, batch)


def cache_struct(cfg: ArchConfig, shape: ShapeSpec, *, device="meta"):
    """The decode cache at ``shape.seq_len`` (zeros on a real device)."""
    return build_model(cfg).cache_init(shape.global_batch, shape.seq_len, device=device)


def cache_sharding(cfg, cache, mesh):
    """KV (L, B, S, Hk, hd): batch over dp, S over model (flash-decode
    style sequence sharding); at batch 1 (long_500k) S over dp + model.
    SSM state: batch over dp, heads over model; conv: batch over dp,
    channels over model; each where it divides."""
    dp = fsdp_axes(mesh)
    dp = dp if dp else (None,)

    def one(path, leaf):
        name = str(path[-1])
        if name in ("k", "v", "xk", "xv"):  # (L, B, S, Hk, hd)
            spec = (None, dp, "model", None, None)
            if leaf.shape[1] == 1:  # batch 1 (long_500k): shard S harder
                spec = (None, None, dp + ("model",), None, None)
        elif name == "S":  # (L, B, H, N, dh)
            spec = (None, dp, "model", None, None)
        elif name == "conv":  # (L, B, K-1, C)
            spec = (None, dp, None, "model")
        else:
            spec = ()
        return NamedSharding(mesh, _valid(spec, leaf.shape, mesh))

    return map_with_path(one, cache)


def decode_inputs(cfg, shape: ShapeSpec, mesh, *, device="meta", seed: int = 0):
    """((tokens, pos), (their shardings)) for the decode step: (B,) int32
    each; on a real device uniform tokens and positions in [0, seq_len)."""
    B = shape.global_batch
    dp = fsdp_axes(mesh)
    dp = dp if dp else (None,)
    sh = NamedSharding(mesh, _valid((dp,), (B,), mesh))
    if torch.device(device).type == "meta":
        tok = torch.empty((B,), dtype=torch.int32, device="meta")
        return (tok, torch.empty_like(tok)), (sh, sh)
    gen = generator(device, seed + 1)
    tok = torch.randint(0, cfg.vocab, (B,), generator=gen, device=device, dtype=torch.int32)
    pos = torch.randint(0, shape.seq_len, (B,), generator=gen, device=device, dtype=torch.int32)
    return (tok, pos), (sh, sh)


def train_state_struct(cfg: ArchConfig, model=None, *, device="meta", seed: int = 0):
    """({params, opt}, optimizer config): the params from ``model.init``
    on ``device`` and the optimizer state of ``cfg.optimizer``."""
    model = model or build_model(cfg)
    params = model.init(generator(device, seed), device=device)
    ocfg = opt_mod.OptimizerConfig(name=cfg.optimizer)
    return {"params": params, "opt": opt_mod.opt_init(ocfg, params)}, ocfg
