"""Decoder LM, dense and ssm families: init, the layer stack, prefill and
decode.

The layer stack is a list of per-layer param dicts applied by a plain loop
(the JAX package scans over a stacked leading L axis).  The JAX package's
other families (moe, hybrid, vlm, encdec) come with later slices and raise
``NotImplementedError`` here.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention, ssm
from repro_torch.models.common import (
    dense_apply,
    dense_init,
    rmsnorm_apply,
    rmsnorm_init,
    swiglu_apply,
    swiglu_init,
    uniform_scale_init,
)

PORTED = ("dense", "ssm")
_LATER = {
    "moe": "ROADMAP queue 1, item 10 (models/moe.py)",
    "hybrid": "ROADMAP queue 1, item 10 (zamba2_7b: ssd_scan and flash_attention)",
    "vlm": "ROADMAP queue 1, item 10 (the patch frontend)",
    "encdec": "ROADMAP queue 1, item 10 (models/whisper.py)",
}


def require_ported(cfg):
    if cfg.family not in PORTED:
        where = _LATER.get(cfg.family, "no ROADMAP item")
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: {where}; the port runs {PORTED}"
        )


def lm_init(gen: torch.Generator, cfg):
    """Random params from ``gen``, on ``gen``'s device."""
    require_ported(cfg)
    D, V, dev = cfg.d_model, cfg.vocab, gen.device
    parametric = not cfg.nonparametric_norm
    p = {
        "embed": uniform_scale_init(gen, (V, D), 1.0, cfg.param_dtype),
        "final_norm": rmsnorm_init(D, cfg.param_dtype, dev, parametric=parametric),
        "unembed": dense_init(gen, D, V, cfg.param_dtype),
    }
    if cfg.family == "ssm":
        p["layers"] = [
            {"norm": rmsnorm_init(D, cfg.param_dtype, dev), "ssm": ssm.ssm_init(gen, cfg)}
            for _ in range(cfg.n_layers)
        ]
        return p
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


def _ssm_block(lp, cfg, x):
    h = rmsnorm_apply(lp["norm"], x)
    out, st = ssm.ssm_apply(lp["ssm"], cfg, h, return_state=True)
    return x + out, st


def backbone_apply(params, cfg, x, *, positions=None, collect=False):
    """Layer stack on embeddings x (B, T, D) -> (h, cache parts | None).

    ``collect=True`` also returns the cache ingredients prefill needs, every
    layer's stacked on a leading L axis: K/V as (L, B, T, Hk, hd) (dense),
    or the SSM state S (L, B, H, N, dh) and conv state (L, B, 3, d_inner+2N)
    (ssm).
    """
    require_ported(cfg)
    if cfg.family == "ssm":
        states = []
        for lp in params["layers"]:
            x, st = _ssm_block(lp, cfg, x)
            if collect:
                states.append(st)
        aux = ({k: torch.stack([st[k] for st in states]) for k in ("S", "conv")}
               if collect else None)
        return rmsnorm_apply(params["final_norm"], x), aux
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
    """Zeros: the KV cache {"k", "v"}, each (L, batch, max_len, Hk, hd)
    (dense), or the recurrent state {"S": (L, batch, H, N, dh) f32, "conv":
    (L, batch, 3, d_inner+2N)} (ssm, which needs no max_len)."""
    require_ported(cfg)
    dtype = dtype or cfg.compute_dtype
    if cfg.family == "ssm":
        return ssm.ssm_decode_init(cfg, (cfg.n_layers, batch), dtype, device=device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def decode_step(params, cfg, cache, tokens, pos):
    """One decode step.  tokens (B,), pos (B,) -> (logits (B, V), cache).

    The new token's K/V (dense), or the new recurrent state (ssm, which
    reads no ``pos``), are written into ``cache`` in place; the cache
    returned is the one passed in."""
    require_ported(cfg)
    x = embed_tokens(params, cfg, tokens[:, None])  # (B, 1, D)
    if cfg.family == "ssm":
        for i, lp in enumerate(params["layers"]):
            hn = rmsnorm_apply(lp["norm"], x)
            out, st = ssm.ssm_decode_apply(
                lp["ssm"], cfg, hn, {"S": cache["S"][i], "conv": cache["conv"][i]})
            cache["S"][i].copy_(st["S"])
            cache["conv"][i].copy_(st["conv"])
            x = x + out
        h = rmsnorm_apply(params["final_norm"], x)
        return lm_logits(params, cfg, h)[:, 0], cache
    for i, lp in enumerate(params["layers"]):
        hn = rmsnorm_apply(lp["attn_norm"], x)
        x = x + attention.decode_attention_apply(
            lp["attn"], cfg, hn, cache["k"][i], cache["v"][i], pos)
        hn = rmsnorm_apply(lp["mlp_norm"], x)
        x = x + swiglu_apply(lp["mlp"], hn, cfg.compute_dtype)
    h = rmsnorm_apply(params["final_norm"], x)
    return lm_logits(params, cfg, h)[:, 0], cache


def prefill(params, cfg, tokens, max_len: int):
    """Full-sequence prefill: tokens (B, T) -> (logits (B, T, V), cache):
    the prompt's K/V at positions [0, T) and zeros up to max(max_len, T)
    (dense), or the recurrent state after the prompt (ssm)."""
    B, T = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(T, device=x.device).expand(B, T)
    h, aux = backbone_apply(params, cfg, x, positions=positions, collect=True)
    logits = lm_logits(params, cfg, h)
    if cfg.family == "ssm":
        return logits, aux
    cache = decode_cache_init(cfg, B, max(max_len, T), device=x.device)
    cache["k"][:, :, :T] = aux["k"]
    cache["v"][:, :, :T] = aux["v"]
    return logits, cache
