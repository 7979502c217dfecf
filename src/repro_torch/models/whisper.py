"""Whisper-large-v3 backbone: the encoder-decoder transformer (the encdec
family).

Backbone only, as in the JAX package: the mel-spectrogram conv frontend is
a stub, and a prefill takes precomputed frame embeddings (B, T_frames,
d_model).  LayerNorm, a GELU MLP, sinusoidal positions and QKV bias; the
encoder is bidirectional self-attention, the decoder causal
self-attention then cross-attention to the encoder's output.  The layer
stacks are lists of per-layer dicts (``enc``, ``dec``), applied by a plain
loop.

Prefill's attention goes through ``attention.attention_apply``, so on the
kernel route every one of its three attentions a layer is a
``flash_attention`` launch at any length (1,500 frames included).  Decode
is plain torch, as the JAX package's is plain einsum: the self-attention
writes its K/V in place, and the cross-attention reads the fixed
``xk``/``xv`` the prefill took from the encoder.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import is_dtensor, take_rows, zeros_placed_as
from repro_torch.models import attention
from repro_torch.models.common import (
    chunked_softmax_xent,
    dense_apply,
    dense_init,
    gelu_mlp_apply,
    gelu_mlp_init,
    layernorm_apply,
    layernorm_init,
    sinusoidal_positions,
    uniform_scale_init,
)


def whisper_init(gen: torch.Generator, cfg, device=None):
    """Random params from ``gen``, on ``device`` (by default ``gen``'s)."""
    D, V, dt, dev = cfg.d_model, cfg.vocab, cfg.param_dtype, device or gen.device

    def enc_layer():
        return {"attn_norm": layernorm_init(D, dt, dev),
                "attn": attention.attention_init(gen, cfg, dev),
                "mlp_norm": layernorm_init(D, dt, dev),
                "mlp": gelu_mlp_init(gen, D, cfg.d_ff, dt, dev)}

    def dec_layer():
        return {"self_norm": layernorm_init(D, dt, dev),
                "self_attn": attention.attention_init(gen, cfg, dev),
                "cross_norm": layernorm_init(D, dt, dev),
                "cross_attn": attention.attention_init(gen, cfg, dev),
                "mlp_norm": layernorm_init(D, dt, dev),
                "mlp": gelu_mlp_init(gen, D, cfg.d_ff, dt, dev)}

    return {
        "frame_proj": dense_init(gen, D, D, dt, bias=True, device=dev),
        "embed": uniform_scale_init(gen, (V, D), 1.0, dt, dev),
        "enc": [enc_layer() for _ in range(cfg.n_enc_layers)],
        "enc_norm": layernorm_init(D, dt, dev),
        "dec": [dec_layer() for _ in range(cfg.n_dec_layers)],
        "dec_norm": layernorm_init(D, dt, dev),
    }


def _with_positions(cfg, x):
    T, D = x.shape[1], x.shape[2]
    return x + sinusoidal_positions(T, D, x.device)[None].to(cfg.compute_dtype)


def encode(params, cfg, frames, *, mesh=None):
    """frames (B, T, D), precomputed (the stub frontend) -> the encoder's
    states (B, T, D)."""
    cdt = cfg.compute_dtype
    x = _with_positions(cfg, dense_apply(params["frame_proj"], frames.to(cdt), cdt))
    for lp in params["enc"]:
        a, _ = attention.attention_apply(lp["attn"], cfg, layernorm_apply(lp["attn_norm"], x),
                                         causal=False, rope=False, mesh=mesh)
        x = x + a
        x = x + gelu_mlp_apply(lp["mlp"], layernorm_apply(lp["mlp_norm"], x), cdt)
    return layernorm_apply(params["enc_norm"], x)


def decode_train(params, cfg, tokens, enc_out, *, collect_kv=False, mesh=None):
    """The teacher-forced decoder over tokens (B, L) -> (h (B, L, D), aux):
    with ``collect_kv``, aux is ((k, v), (xk, xv)), the self-attention's
    K/V (Ld, B, L, Hk, hd) and the cross-attention's (Ld, B, T, Hk, hd);
    else None."""
    cdt = cfg.compute_dtype
    x = _with_positions(cfg, take_rows(params["embed"], tokens.long()).to(cdt))
    kv = ([], [], [], [])
    for lp in params["dec"]:
        a, (k, v) = attention.attention_apply(
            lp["self_attn"], cfg, layernorm_apply(lp["self_norm"], x), causal=True, rope=False,
            mesh=mesh)
        x = x + a
        a, (xk, xv) = attention.attention_apply(
            lp["cross_attn"], cfg, layernorm_apply(lp["cross_norm"], x), kv_x=enc_out,
            causal=False, rope=False, mesh=mesh)
        x = x + a
        x = x + gelu_mlp_apply(lp["mlp"], layernorm_apply(lp["mlp_norm"], x), cdt)
        if collect_kv:
            for acc, t in zip(kv, (k, v, xk, xv)):
                acc.append(t)
    h = layernorm_apply(params["dec_norm"], x)
    if not collect_kv:
        return h, None
    k, v, xk, xv = (torch.stack(a) for a in kv)
    return h, ((k, v), (xk, xv))


def whisper_loss(params, cfg, batch, *, mesh=None):
    """batch: {frames (B, T, D), tokens (B, L), labels (B, L), [mask]} -> the
    mean next-token nll (z-loss 1e-4): the encoder, the teacher-forced
    decoder, and the fused chunked cross entropy against the tied
    ``embed.T``.  Never rematerialised, as in the JAX package."""
    enc_out = encode(params, cfg, batch["frames"], mesh=mesh)
    h, _ = decode_train(params, cfg, batch["tokens"], enc_out, mesh=mesh)
    return chunked_softmax_xent(h, params["embed"].T, batch["labels"], chunk=cfg.ce_chunk,
                                z_loss=1e-4, mask=batch.get("mask"))


def _tied_logits(params, cfg, h):
    return dense_apply({"w": params["embed"].T}, h, cfg.compute_dtype)


def whisper_cache_init(cfg, batch: int, max_len: int, dtype=None, *, device="cuda"):
    """Zeros: the self-attention's ``k``/``v`` (Ld, batch, max_len, Hk, hd)
    and the cross-attention's ``xk``/``xv`` (Ld, batch, n_audio_frames, Hk,
    hd); the batch on axis 1, as every cache of the batcher."""
    dtype = dtype or cfg.compute_dtype
    Ld, Hk, hd = cfg.n_dec_layers, cfg.n_kv_heads, cfg.hd
    shapes = {"k": max_len, "v": max_len, "xk": cfg.n_audio_frames, "xv": cfg.n_audio_frames}
    return {key: torch.zeros((Ld, batch, n, Hk, hd), dtype=dtype, device=device)
            for key, n in shapes.items()}


def whisper_prefill(params, cfg, tokens, frames, max_len: int, *, mesh=None):
    """tokens (B, L), frames (B, T, D) -> (logits (B, L, V), cache): the
    prompt's K/V at positions [0, L) and zeros up to ``max_len``, and the
    cross K/V of the encoder's output."""
    enc_out = encode(params, cfg, frames, mesh=mesh)
    h, ((k, v), (xk, xv)) = decode_train(params, cfg, tokens, enc_out, collect_kv=True,
                                         mesh=mesh)
    logits = _tied_logits(params, cfg, h)
    B, L = tokens.shape
    if max_len < L:
        raise ValueError(f"max_len {max_len} is shorter than the prompt ({L} tokens)")
    cache = {}
    for key, t in (("k", k), ("v", v)):
        shape = t.shape[:2] + (max_len,) + t.shape[3:]
        cache[key] = (zeros_placed_as(t, shape, t.dtype) if is_dtensor(t)
                      else torch.zeros(shape, dtype=t.dtype, device=t.device))
        cache[key][:, :, :L] = t
    cache["xk"], cache["xv"] = xk, xv
    return logits, cache


def whisper_decode_step(params, cfg, cache, tokens, pos):
    """One decode step.  tokens (B,), pos (B,) -> (logits (B, V), cache).

    The new token's self-attention K/V are written into ``cache`` in place
    (the cache returned is the one passed in); the cross-attention is a
    plain f32 softmax over every one of the fixed ``xk``/``xv``, unmasked,
    as in the JAX package."""
    B = tokens.shape[0]
    D, H, Hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // Hk
    cdt = cfg.compute_dtype
    pos = pos if pos.dim() == 1 else pos[:, 0]
    x = take_rows(params["embed"], tokens[:, None].long()).to(cdt)
    table = sinusoidal_positions(cache["k"].shape[2], D, x.device)
    x = x + table[pos.long()][:, None].to(cdt)
    for i, lp in enumerate(params["dec"]):
        x = x + attention.decode_attention_apply(
            lp["self_attn"], cfg, layernorm_apply(lp["self_norm"], x), cache["k"][i],
            cache["v"][i], pos, rope=False)
        hn = layernorm_apply(lp["cross_norm"], x)
        q = attention.whole_heads(attention.split_heads(
            dense_apply(lp["cross_attn"]["wq"], hn, cdt), H, hd, rows_on_model=True))
        qg = q.float().reshape(B, Hk, G, hd) * hd ** -0.5
        s = torch.einsum("bkgd,bskd->bkgs", qg, cache["xk"][i].float())
        o = torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, dim=-1), cache["xv"][i].float())
        x = x + dense_apply(lp["cross_attn"]["wo"], o.reshape(B, 1, H * hd).to(cdt), cdt)
        x = x + gelu_mlp_apply(lp["mlp"], layernorm_apply(lp["mlp_norm"], x), cdt)
    h = layernorm_apply(params["dec_norm"], x)
    return _tied_logits(params, cfg, h)[:, 0], cache
