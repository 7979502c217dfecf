"""Decoder LM, the dense, vlm, moe, ssm and hybrid families: init, the
layer stack, prefill and decode.

The layer stack is a list of per-layer param dicts applied by a plain loop
(the JAX package scans over a stacked leading L axis).  Hybrid (Zamba2):
ONE weight-shared attention+MLP block, ``params["shared_attn"]``, applied
after every ``hybrid_attn_every`` mamba layers; the mamba layers past the
last whole group are the tail (81 = 13 x 6 + 3).  The vlm is the dense
stack with ``patch_proj``, whose projection of the precomputed patch
embeddings a prefill puts in front of the prompt.  The encdec family
(Whisper) is ``models/whisper.py``.

``lm_loss`` is the training objective: the layer stack, then the fused
chunked unembed + cross entropy.  ``cfg.remat`` picks what each layer keeps
for its backward, where the JAX package's ``_remat`` wraps its scanned
bodies: each dense, vlm and moe block and each mamba block (ssm, hybrid),
not the hybrid's shared attention block.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.distributed.sharding import is_dtensor, shard_hint, take_rows, zeros_placed_as
from repro_torch.models import attention, moe, ssm
from repro_torch.models.common import (
    chunked_softmax_xent,
    dense_apply,
    dense_init,
    rmsnorm_apply,
    rmsnorm_init,
    swiglu_apply,
    swiglu_init,
    uniform_scale_init,
)

FAMILIES = ("dense", "vlm", "ssm", "hybrid", "moe")


def require_decoder(cfg):
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not a decoder-only LM ({FAMILIES}); "
                         f"model_zoo.build_model builds every family")


def hybrid_split(cfg):
    """(n_groups, tail): 81 layers, every=6 -> 13 groups + 3 tail layers."""
    every = cfg.hybrid_attn_every
    return cfg.n_layers // every, cfg.n_layers % every


def _shared_after(cfg, i: int):
    """The group whose shared attention block follows mamba layer ``i``
    (hybrid), or None: layers [g*every, (g+1)*every) are group g's."""
    if cfg.family != "hybrid" or (i + 1) % cfg.hybrid_attn_every:
        return None
    return (i + 1) // cfg.hybrid_attn_every - 1


def _attn_block_init(gen, cfg, dev, *, parametric=True, is_moe=False):
    D = cfg.d_model
    p = {
        "attn_norm": rmsnorm_init(D, cfg.param_dtype, dev, parametric=parametric),
        "attn": attention.attention_init(gen, cfg, dev),
        "mlp_norm": rmsnorm_init(D, cfg.param_dtype, dev, parametric=parametric),
    }
    if is_moe:
        p["moe"] = moe.moe_init(gen, cfg, dev)
    else:
        p["mlp"] = swiglu_init(gen, D, cfg.d_ff, cfg.param_dtype, dev)
    return p


def lm_init(gen: torch.Generator, cfg, device=None):
    """Random params from ``gen``, on ``device`` (by default ``gen``'s)."""
    require_decoder(cfg)
    D, V, dev = cfg.d_model, cfg.vocab, device or gen.device
    parametric = not cfg.nonparametric_norm
    p = {
        "embed": uniform_scale_init(gen, (V, D), 1.0, cfg.param_dtype, dev),
        "final_norm": rmsnorm_init(D, cfg.param_dtype, dev, parametric=parametric),
        "unembed": dense_init(gen, D, V, cfg.param_dtype, device=dev),
    }
    if cfg.family in ("ssm", "hybrid"):
        p["layers"] = [
            {"norm": rmsnorm_init(D, cfg.param_dtype, dev), "ssm": ssm.ssm_init(gen, cfg, dev)}
            for _ in range(cfg.n_layers)
        ]
        if cfg.family == "hybrid":  # unstacked: one block, shared by every group
            p["shared_attn"] = _attn_block_init(gen, cfg, dev)
        return p
    p["layers"] = [_attn_block_init(gen, cfg, dev, parametric=parametric,
                                    is_moe=cfg.family == "moe")
                   for _ in range(cfg.n_layers)]
    if cfg.family == "vlm":  # the stub frontend's adapter: patch embeddings -> d_model
        p["patch_proj"] = dense_init(gen, D, D, cfg.param_dtype, device=dev)
    return p


def _dense_block(lp, cfg, x, positions, mesh=None):
    """Attention then the MLP (MoE where ``lp`` has one), each pre-norm with a
    residual; also the hybrid's shared block (the JAX package's
    ``_shared_attn_block``) on ``params["shared_attn"]``."""
    x = shard_hint(x, mesh, "dp", None, None)
    h = rmsnorm_apply(lp["attn_norm"], x)
    a, kv = attention.attention_apply(lp["attn"], cfg, h, positions=positions, causal=True,
                                      mesh=mesh)
    x = x + a
    return x + _mlp(lp, cfg, rmsnorm_apply(lp["mlp_norm"], x), mesh), kv


def _mlp(lp, cfg, h, mesh=None):
    """The MLP, or the MoE, whose expert-parallel path ``mesh`` feeds
    (``moe.moe_apply``)."""
    if "moe" in lp:
        return moe.moe_apply(lp["moe"], cfg, h, mesh=mesh)
    return swiglu_apply(lp["mlp"], h, cfg.compute_dtype)


def _ssm_block(lp, cfg, x, mesh=None):
    x = shard_hint(x, mesh, "dp", None, None)
    h = rmsnorm_apply(lp["norm"], x)
    out, st = ssm.ssm_apply(lp["ssm"], cfg, h, return_state=True)
    return x + out, st


# "dots": the outputs of matrix products with no batch dimension are kept
# (a linear layer on a (B, T, D) input reaches aten.mm, with a bias
# aten.addmm), everything else is recomputed -- batched products (bmm)
# too, as jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
REMAT = ("none", "dots", "full")


def _remat(f, policy: str):
    """``f`` with ``policy``'s rematerialisation where autograd records:
    "none" keeps every activation, "full" keeps only ``f``'s inputs and
    recomputes the rest in the backward, "dots" keeps the unbatched
    products' outputs as well.  No block draws random numbers, so no RNG
    state is kept for the recompute."""
    if policy not in REMAT:
        raise ValueError(f"unknown remat {policy!r}; known: {REMAT}")
    if policy == "none" or not torch.is_grad_enabled():
        return f
    kw = {"context_fn": _DOTS_CONTEXT} if policy == "dots" else {}
    return functools.partial(checkpoint, f, use_reentrant=False, preserve_rng_state=False, **kw)


def backbone_apply(params, cfg, x, *, positions=None, collect=False, mesh=None):
    """Layer stack on embeddings x (B, T, D) -> (h, cache parts | None).

    ``collect=True`` also returns the cache ingredients prefill needs, stacked
    on a leading axis: K/V as (L, B, T, Hk, hd) (dense, vlm, moe); the SSM state
    S (L, B, H, N, dh) and conv state (L, B, 3, d_inner+2N) (ssm); both,
    with K/V one per group, (n_groups, B, T, Hk, hd) (hybrid).
    """
    require_decoder(cfg)
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, device=x.device).expand(B, T)
    states, ks, vs = [], [], []
    ssm_block, dense_block = _remat(_ssm_block, cfg.remat), _remat(_dense_block, cfg.remat)
    for i, lp in enumerate(params["layers"]):
        if cfg.family in ("ssm", "hybrid"):
            x, st = ssm_block(lp, cfg, x, mesh)
            if collect:
                states.append(st)
            if _shared_after(cfg, i) is None:
                continue
            x, (k, v) = _dense_block(params["shared_attn"], cfg, x, positions, mesh)
        else:
            x, (k, v) = dense_block(lp, cfg, x, positions, mesh)
        if collect:
            ks.append(k)
            vs.append(v)
    aux = None
    if collect:
        aux = {k: torch.stack([st[k] for st in states]) for k in ("S", "conv")} if states else {}
        if ks:
            aux.update(k=torch.stack(ks), v=torch.stack(vs))
    return rmsnorm_apply(params["final_norm"], x), aux


def embed_tokens(params, cfg, tokens):
    return take_rows(params["embed"], tokens.long()).to(cfg.compute_dtype)


def lm_logits(params, cfg, h):
    return dense_apply(params["unembed"], h, cfg.compute_dtype)


def lm_loss(params, cfg, batch, *, mesh=None):
    """batch: {tokens (B, L), labels (B, L), [mask (B, L)], [patches (B, P,
    D): a vlm's patch embeddings, projected and put in front of the
    tokens]} -> the mean next-token nll (z-loss 1e-4) over the tokens' rows,
    through the fused chunked unembed + cross entropy."""
    x = embed_tokens(params, cfg, batch["tokens"])
    n_prefix = 0
    if cfg.family == "vlm" and "patches" in batch:
        pe = dense_apply(params["patch_proj"], batch["patches"].to(cfg.compute_dtype),
                         cfg.compute_dtype)
        x = torch.cat([pe, x], dim=1)
        n_prefix = pe.shape[1]
    x = shard_hint(x, mesh, "dp", None, None)
    h, _ = backbone_apply(params, cfg, x, mesh=mesh)
    return chunked_softmax_xent(h[:, n_prefix:], params["unembed"]["w"], batch["labels"],
                                chunk=cfg.ce_chunk, z_loss=1e-4, mask=batch.get("mask"),
                                mesh=mesh)


def decode_cache_init(cfg, batch: int, max_len: int, dtype=None, *, device="cuda"):
    """Zeros: the KV cache {"k", "v"}, each (L, batch, max_len, Hk, hd)
    (dense, vlm, moe); the recurrent state {"S": (L, batch, H, N, dh) f32, "conv":
    (L, batch, 3, d_inner+2N)} (ssm, which needs no max_len); or both, with
    K/V (n_groups, batch, max_len, Hk, hd) (hybrid)."""
    require_decoder(cfg)
    dtype = dtype or cfg.compute_dtype
    cache = {}
    if cfg.family in ("ssm", "hybrid"):
        cache = ssm.ssm_decode_init(cfg, (cfg.n_layers, batch), dtype, device=device)
    if cfg.family == "ssm":
        return cache
    n_kv = hybrid_split(cfg)[0] if cfg.family == "hybrid" else cfg.n_layers
    shape = (n_kv, batch, max_len, cfg.n_kv_heads, cfg.hd)
    cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
    cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def _dense_decode(lp, cfg, x, cache_k, cache_v, pos, mesh=None):
    hn = rmsnorm_apply(lp["attn_norm"], x)
    x = x + attention.decode_attention_apply(lp["attn"], cfg, hn, cache_k, cache_v, pos)
    return x + _mlp(lp, cfg, rmsnorm_apply(lp["mlp_norm"], x), mesh)


def decode_step(params, cfg, cache, tokens, pos, *, mesh=None):
    """One decode step.  tokens (B,), pos (B,) -> (logits (B, V), cache).

    The new token's K/V (dense, vlm, moe, hybrid) and the new recurrent state
    (ssm, hybrid) are written into ``cache`` in place; the cache returned
    is the one passed in.  The hybrid runs each group's mamba layers, then
    the shared block on that group's K/V, then the tail."""
    require_decoder(cfg)
    x = shard_hint(embed_tokens(params, cfg, tokens[:, None]), mesh, "dp", None, None)
    for i, lp in enumerate(params["layers"]):
        if cfg.family in ("ssm", "hybrid"):
            hn = rmsnorm_apply(lp["norm"], x)
            out, st = ssm.ssm_decode_apply(
                lp["ssm"], cfg, hn, {"S": cache["S"][i], "conv": cache["conv"][i]})
            cache["S"][i].copy_(st["S"])
            cache["conv"][i].copy_(st["conv"])
            x = x + out
            g = _shared_after(cfg, i)
            if g is not None:
                x = _dense_decode(params["shared_attn"], cfg, x, cache["k"][g],
                                  cache["v"][g], pos, mesh)
        else:
            x = _dense_decode(lp, cfg, x, cache["k"][i], cache["v"][i], pos, mesh)
    h = rmsnorm_apply(params["final_norm"], x)
    return lm_logits(params, cfg, h)[:, 0], cache


def prefill(params, cfg, tokens, max_len: int, *, patches=None, mesh=None):
    """Full-sequence prefill: tokens (B, L) -> (logits (B, T, V), cache):
    the sequence's K/V at positions [0, T) and zeros up to max(max_len, T)
    (dense, vlm, moe, hybrid), and the recurrent state after it (ssm,
    hybrid).  A vlm given ``patches`` (B, P, D) puts their projection in
    front of the prompt's embeddings, so T = P + L; otherwise T = L."""
    B, L = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    if cfg.family == "vlm" and patches is not None:
        pe = dense_apply(params["patch_proj"], patches.to(cfg.compute_dtype), cfg.compute_dtype)
        x = torch.cat([pe, x], dim=1)
    T = x.shape[1]
    positions = torch.arange(T, device=x.device).expand(B, T)
    h, aux = backbone_apply(params, cfg, x, positions=positions, collect=True, mesh=mesh)
    logits = lm_logits(params, cfg, h)
    if cfg.family == "ssm":
        return logits, aux
    cache = decode_cache_init(cfg, B, max(max_len, T), device=x.device)
    if is_dtensor(aux["k"]):  # each buffer where its K/V (or state) shards lie
        cache = {k: zeros_placed_as(aux[k], v.shape, v.dtype) for k, v in cache.items()}
    cache["k"][:, :, :T] = aux["k"]
    cache["v"][:, :, :T] = aux["v"]
    if cfg.family == "hybrid":
        cache["S"].copy_(aux["S"])
        cache["conv"].copy_(aux["conv"])
    return logits, cache
