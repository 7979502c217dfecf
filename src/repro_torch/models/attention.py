"""GQA attention: init + prefill apply + decode-with-cache apply.

Covers the configs' variants: GQA, qk-norm, QKV bias, bidirectional (the
Whisper encoder) and cross-attention (the Whisper decoder, ``kv_x``).

The prefill path is ``attn_backend="kernel"`` (the hand-written CUDA
flash-attention kernel on a card, its plain version on the CPU; the JAX
package's ``"pallas"``) or ``"chunked"`` (blockwise online-softmax
attention in plain torch; its ``"xla"``).  Decode is plain torch, as the
JAX package's decode is plain einsum.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import axis_size, is_dtensor, put_rows, shard_hint
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import apply_rope, dense_apply, dense_init, rmsnorm_apply
from repro_torch.models.common import rmsnorm_init

NEG_INF = -1e30
BACKENDS = ("kernel", "chunked")


def attention_init(gen, cfg, device=None):
    D, H, Hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    device, dt, bias = device or gen.device, cfg.param_dtype, cfg.qkv_bias
    p = {
        "wq": dense_init(gen, D, H * hd, dt, bias=bias, device=device),
        "wk": dense_init(gen, D, Hk * hd, dt, bias=bias, device=device),
        "wv": dense_init(gen, D, Hk * hd, dt, bias=bias, device=device),
        "wo": dense_init(gen, H * hd, D, dt, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dt, device)
        p["k_norm"] = rmsnorm_init(hd, dt, device)
    return p


def split_heads(y, n, hd, *, rows_on_model: bool):
    """(B, L, n * hd) -> (B, L, n, hd).  A DTensor whose ``model`` dim cuts
    the last dim into pieces that are not whole heads (``n`` does not
    divide over it) first takes the placement the reference's attention
    hint gives where the heads do not divide: the rows on ``model`` (the
    queries), or ``model`` replicated (the keys and values)."""
    if is_dtensor(y) and n % axis_size(y.device_mesh, "model"):
        y = shard_hint(y, y.device_mesh, "dp", "model" if rows_on_model else None, None)
    return y.reshape(*y.shape[:2], n, hd)


def whole_heads(q):
    """A decode step's query (B, 1, H, hd) with every head on every rank of
    ``model``, where it is a DTensor (any other tensor unchanged): the
    decode cache shards its sequence on ``model`` (flash-decode), so each
    rank scores its slice of the sequence for every head."""
    return shard_hint(q, q.device_mesh, "dp", None, None, None) if is_dtensor(q) else q


def _project_q(p, cfg, x, positions, *, rope=True):
    q = split_heads(dense_apply(p["wq"], x, cfg.compute_dtype), cfg.n_heads, cfg.hd,
                     rows_on_model=True)
    if "q_norm" in p:
        q = rmsnorm_apply(p["q_norm"], q)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    return q


def _project_kv(p, cfg, x, positions, *, rope=True):
    Hk, hd = cfg.n_kv_heads, cfg.hd
    k = split_heads(dense_apply(p["wk"], x, cfg.compute_dtype), Hk, hd, rows_on_model=False)
    v = split_heads(dense_apply(p["wv"], x, cfg.compute_dtype), Hk, hd, rows_on_model=False)
    if "k_norm" in p:
        k = rmsnorm_apply(p["k_norm"], k)
    if rope:
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def chunked_attention(q, k, v, *, causal: bool, chunk: int = 1024, q_offset: int = 0):
    """Blockwise online-softmax attention in plain torch.

    q: (B, L, H, hd); k, v: (B, Lk, Hk, hd).  O(L*chunk) live memory, a loop
    over kv chunks; exact softmax attention.  KV heads are expanded to the
    H query heads before the score product, as in the JAX package.
    """
    B, Lq, H, hd = q.shape
    Lk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    chunk = min(chunk, Lk)
    nchunk = -(-Lk // chunk)
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    qf = q.float() * hd ** -0.5
    rows = q_offset + torch.arange(Lq, device=q.device)
    m = torch.full((B, Lq, H), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Lq, H), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Lq, H, hd), dtype=torch.float32, device=q.device)
    for ci in range(nchunk):
        kb = k[:, ci * chunk:(ci + 1) * chunk].float()
        vb = v[:, ci * chunk:(ci + 1) * chunk].float()
        s = torch.einsum("blhd,bchd->blhc", qf, kb)
        if causal:
            cols = ci * chunk + torch.arange(kb.shape[1], device=q.device)
            valid = rows[:, None] >= cols[None, :]
            s = torch.where(valid[None, :, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        pexp = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + pexp.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("blhc,bchd->blhd", pexp, vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def attention_apply(p, cfg, x, *, positions=None, causal=True, rope=True, kv_x=None, mesh=None):
    """Prefill attention -> (out (B, L, D), (k, v) each (B, Lk, Hk, hd)).

    ``kv_x`` (B, Lk, D) switches to cross-attention: K/V are projected from
    it, at positions [0, Lk).  The kernel route takes any lengths (the
    CUDA kernel's own tiling), as the JAX package's default ``"xla"`` route
    does; its ``"pallas"`` route raises where 128 does not divide them.
    ``mesh`` takes the reference's sharding hints (``shard_hint``: the
    identity on plain tensors).
    """
    B, L, _ = x.shape
    if positions is None:
        positions = torch.arange(L, device=x.device).expand(B, L)
    q = _project_q(p, cfg, x, positions, rope=rope)
    src = x if kv_x is None else kv_x
    kv_pos = positions if kv_x is None else torch.arange(
        src.shape[1], device=x.device).expand(B, src.shape[1])
    k, v = _project_kv(p, cfg, src, kv_pos, rope=rope)
    # heads on the TP axis and the batch on DP through the quadratic part;
    # where the heads do not divide over TP (Whisper's 20 over 16), the
    # query rows instead, K/V replicated
    tp = axis_size(mesh, "model")
    if cfg.n_heads % max(tp, 1) == 0:
        q = shard_hint(q, mesh, "dp", None, "model", None)
        k = shard_hint(k, mesh, "dp", None, "model", None)
        v = shard_hint(v, mesh, "dp", None, "model", None)
    else:
        q = shard_hint(q, mesh, "dp", "model", None, None)
        k = shard_hint(k, mesh, "dp", None, None, None)
        v = shard_hint(v, mesh, "dp", None, None, None)
    if cfg.attn_backend == "kernel":
        o = flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal,
        ).transpose(1, 2)
    elif cfg.attn_backend == "chunked":
        o = chunked_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    else:
        raise ValueError(f"unknown attn_backend {cfg.attn_backend!r}; known: {BACKENDS}")
    o = o.reshape(B, L, -1)
    if cfg.n_heads % max(tp, 1):  # keep the rows on model, the hint above, in the backward too
        o = shard_hint(o, mesh, "dp", "model", None)
    return dense_apply(p["wo"], o, cfg.compute_dtype), (k, v)


def decode_attention_apply(p, cfg, x, cache_k, cache_v, pos, *, rope=True):
    """One-token decode against a (B, S, Hk, hd) cache.

    Writes the new token's K/V into ``cache_k``/``cache_v`` at position
    ``pos`` (per sequence) IN PLACE -- the JAX package returns new arrays;
    updating in place saves a copy of the whole cache per layer and step --
    attends over positions <= pos, and returns the output (B, 1, D).
    """
    B = x.shape[0]
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    S = cache_k.shape[1]
    pos = pos if pos.dim() == 1 else pos[:, 0]
    positions = pos[:, None]
    q = whole_heads(_project_q(p, cfg, x, positions, rope=rope))  # (B, 1, H, hd)
    k_new, v_new = _project_kv(p, cfg, x, positions, rope=rope)  # (B, 1, Hk, hd)
    put_rows((cache_k, cache_v), pos, (k_new[:, 0], v_new[:, 0]))

    G = H // Hk
    qg = q.reshape(B, Hk, G, hd)
    if cfg.decode_kv_f32:
        s = torch.einsum("bkgd,bskd->bkgs", qg.float() * hd ** -0.5, cache_k.float())
    else:  # read the cache in its storage dtype, accumulate in f32
        s = torch.einsum("bkgd,bskd->bkgs", qg.to(cache_k.dtype), cache_k).float() * hd ** -0.5
    valid = torch.arange(S, device=x.device)[None, :] <= pos[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    pexp = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if cfg.decode_kv_f32:
        o = torch.einsum("bkgs,bskd->bkgd", pexp, cache_v.float())
    else:
        o = torch.einsum("bkgs,bskd->bkgd", pexp.to(cache_v.dtype), cache_v).float()
    o = o / pexp.sum(dim=-1)[..., None]
    o = o.reshape(B, 1, H * hd).to(cfg.compute_dtype)
    return dense_apply(p["wo"], o, cfg.compute_dtype)
