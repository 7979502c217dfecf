"""Decoder LM, dense family: init, the layer stack, prefill and decode.

The layer stack is a list of per-layer param dicts applied by a plain loop
(the JAX package scans over a stacked leading L axis).  The JAX package's
other families (moe, ssm, hybrid, vlm) come with later slices and raise
``NotImplementedError`` here.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention
from repro_torch.models.common import (
    dense_apply,
    dense_init,
    rmsnorm_apply,
    rmsnorm_init,
    swiglu_apply,
    swiglu_init,
    uniform_scale_init,
)

_LATER = {
    "moe": "ROADMAP queue 1, item 10 (models/moe.py)",
    "ssm": "ROADMAP queue 1, the ssd_scan slice (models/ssm.py)",
    "hybrid": "ROADMAP queue 1, item 10 (after the ssd_scan slice)",
    "vlm": "ROADMAP queue 1, item 10 (the patch frontend)",
    "encdec": "ROADMAP queue 1, item 10 (models/whisper.py)",
}


def _require_dense(cfg):
    if cfg.family != "dense":
        where = _LATER.get(cfg.family, "no ROADMAP item")
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: {where}; the port runs 'dense'"
        )


def lm_init(gen: torch.Generator, cfg):
    """Random params from ``gen``, on ``gen``'s device."""
    _require_dense(cfg)
    D, V, dev = cfg.d_model, cfg.vocab, gen.device
    parametric = not cfg.nonparametric_norm
    p = {
        "embed": uniform_scale_init(gen, (V, D), 1.0, cfg.param_dtype),
        "final_norm": rmsnorm_init(D, cfg.param_dtype, dev, parametric=parametric),
        "unembed": dense_init(gen, D, V, cfg.param_dtype),
    }
    p["layers"] = [
        {
            "attn_norm": rmsnorm_init(D, cfg.param_dtype, dev, parametric=parametric),
            "attn": attention.attention_init(gen, cfg),
            "mlp_norm": rmsnorm_init(D, cfg.param_dtype, dev, parametric=parametric),
            "mlp": swiglu_init(gen, D, cfg.d_ff, cfg.param_dtype),
        }
        for _ in range(cfg.n_layers)
    ]
    return p


def _dense_block(lp, cfg, x, positions):
    h = rmsnorm_apply(lp["attn_norm"], x)
    a, kv = attention.attention_apply(lp["attn"], cfg, h, positions=positions, causal=True)
    x = x + a
    h = rmsnorm_apply(lp["mlp_norm"], x)
    return x + swiglu_apply(lp["mlp"], h, cfg.compute_dtype), kv


def backbone_apply(params, cfg, x, *, positions=None, collect=False):
    """Layer stack on embeddings x (B, T, D) -> (h, {"k", "v"} | None).

    ``collect=True`` also returns every layer's K/V stacked as (L, B, T, Hk,
    hd), the cache ingredients prefill needs.
    """
    _require_dense(cfg)
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, device=x.device).expand(B, T)
    ks, vs = [], []
    for lp in params["layers"]:
        x, (k, v) = _dense_block(lp, cfg, x, positions)
        if collect:
            ks.append(k)
            vs.append(v)
    aux = {"k": torch.stack(ks), "v": torch.stack(vs)} if collect else None
    return rmsnorm_apply(params["final_norm"], x), aux


def embed_tokens(params, cfg, tokens):
    return params["embed"][tokens.long()].to(cfg.compute_dtype)


def lm_logits(params, cfg, h):
    return dense_apply(params["unembed"], h, cfg.compute_dtype)


def decode_cache_init(cfg, batch: int, max_len: int, dtype=None, *, device="cuda"):
    """KV cache {"k", "v"}, each (L, batch, max_len, Hk, hd), zeros."""
    _require_dense(cfg)
    dtype = dtype or cfg.compute_dtype
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def decode_step(params, cfg, cache, tokens, pos):
    """One decode step.  tokens (B,), pos (B,) -> (logits (B, V), cache).

    The new token's K/V are written into ``cache`` in place; the cache
    returned is the one passed in."""
    _require_dense(cfg)
    x = embed_tokens(params, cfg, tokens[:, None])  # (B, 1, D)
    for i, lp in enumerate(params["layers"]):
        hn = rmsnorm_apply(lp["attn_norm"], x)
        x = x + attention.decode_attention_apply(
            lp["attn"], cfg, hn, cache["k"][i], cache["v"][i], pos)
        hn = rmsnorm_apply(lp["mlp_norm"], x)
        x = x + swiglu_apply(lp["mlp"], hn, cfg.compute_dtype)
    h = rmsnorm_apply(params["final_norm"], x)
    return lm_logits(params, cfg, h)[:, 0], cache


def prefill(params, cfg, tokens, max_len: int):
    """Full-sequence prefill: tokens (B, T) -> (logits (B, T, V), cache with
    the prompt's K/V at positions [0, T) and zeros up to max(max_len, T))."""
    B, T = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(T, device=x.device).expand(B, T)
    h, aux = backbone_apply(params, cfg, x, positions=positions, collect=True)
    logits = lm_logits(params, cfg, h)
    cache = decode_cache_init(cfg, B, max(max_len, T), device=x.device)
    cache["k"][:, :, :T] = aux["k"]
    cache["v"][:, :, :T] = aux["v"]
    return logits, cache
