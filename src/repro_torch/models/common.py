"""Shared model building blocks (functional, dict-param style).

Conventions, as in the JAX package:
  * params are nested dicts of tensors; a dense weight is ``(in, out)``
    and applied as ``x @ w``.  A layer stack is a list of per-layer dicts
    applied by a plain loop (the JAX package stacks them on a leading L
    axis and scans).
  * compute happens in ``cfg.compute_dtype``, master params in
    ``cfg.param_dtype``; norms, softmax and rope always in f32.
  * init draws from an explicit ``torch.Generator`` and places every tensor
    on ``device``, by default that generator's.  ``device="meta"`` with a
    CPU generator gives a state of shapes and dtypes only (the launch
    tooling's abstract state); the draws on the CPU and on a card do not
    change.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (
    batch_unsharded,
    fsdp_gather,
    is_dtensor,
    settle,
    shard_hint,
)


def uniform_scale_init(gen: torch.Generator, shape, scale, dtype, device=None):
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale / (fan_in ** 0.5)
    x = torch.randn(shape, generator=gen, device=device or gen.device, dtype=torch.float32)
    return (x * std).to(dtype)


def dense_init(gen, in_dim, out_dim, dtype, *, bias=False, scale=1.0, device=None):
    device = device or gen.device
    p = {"w": uniform_scale_init(gen, (in_dim, out_dim), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


def dense_apply(p, x, compute_dtype):
    w = p["w"]
    if is_dtensor(w):  # a step sharded as DTensors
        w = fsdp_gather(w).to(compute_dtype)
        if batch_unsharded(x):  # a batched product: no row of the output spans two batch rows
            w = w.expand(x.shape[:-2] + w.shape)
    y = x.to(compute_dtype) @ w.to(compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def rmsnorm_init(dim, dtype, device, *, parametric=True):
    if not parametric:  # OLMo-style non-parametric norm: no learned scale
        return {}
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x, eps=1e-6):
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    if "scale" in p:
        y = y * p["scale"].float()
    return y.to(x.dtype)


def layernorm_init(dim, dtype, device):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm_apply(p, x, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """Half-split rotary embedding.  x: (..., L, H, D); positions:
    broadcastable to (..., L)."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)  # (D/2,)
    ang = positions[..., None].float() * freqs  # (..., L, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, dim: int, device=None):
    """(length, dim) f32: sin on the even columns, cos on the odd ones
    (interleaved, as the JAX package's), the frequencies computed in f32."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    step = float(np.float32(-math.log(10000.0)) / np.float32(dim))  # in f32, on the host
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device) * step)
    pe = torch.zeros((length, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def swiglu_init(gen, d_model, d_ff, dtype, device=None):
    return {
        "wi": dense_init(gen, d_model, d_ff, dtype, device=device),
        "wg": dense_init(gen, d_model, d_ff, dtype, device=device),
        "wo": dense_init(gen, d_ff, d_model, dtype, device=device),
    }


def swiglu_apply(p, x, compute_dtype):
    h = F.silu(dense_apply(p["wg"], x, compute_dtype)) * dense_apply(p["wi"], x, compute_dtype)
    return dense_apply(p["wo"], h, compute_dtype)


def gelu_mlp_init(gen, d_model, d_ff, dtype, device=None):
    return {
        "wi": dense_init(gen, d_model, d_ff, dtype, bias=True, device=device),
        "wo": dense_init(gen, d_ff, d_model, dtype, bias=True, device=device),
    }


def gelu_mlp_apply(p, x, compute_dtype):
    """The tanh approximation, ``jax.nn.gelu``'s default."""
    h = F.gelu(dense_apply(p["wi"], x, compute_dtype), approximate="tanh")
    return dense_apply(p["wo"], h, compute_dtype)


def _logsumexp(x):
    """``logsumexp`` over the last dim.  A DTensor's is written as a max
    and a sum, whose sharding rules reduce a vocab-sharded dim on its
    shards and all-reduce the partial results (DTensor's ``logsumexp``
    gathers the whole dim first); the max is a constant to autograd, so
    the gradient is the softmax either way."""
    if not is_dtensor(x):
        return torch.logsumexp(x, dim=-1)
    m = settle(x.detach().amax(dim=-1, keepdim=True))
    return (m + torch.log(settle(torch.exp(x - m).sum(dim=-1, keepdim=True))))[..., 0]


def _nll(logits, labels, z_loss):
    """Per-token negative log-likelihood of f32 ``logits`` (..., V), with
    the z-loss ``z_loss * logsumexp^2`` added where ``z_loss`` is set."""
    lse = _logsumexp(logits)
    gold = settle(torch.gather(logits, -1, labels.long()[..., None]))[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse ** 2
    return nll


def cross_entropy_loss(logits, labels, *, z_loss: float = 0.0, mask=None):
    """logits (..., V), cast to f32 inside; labels int.  Returns the mean
    nll (over ``mask``'s ones where given)."""
    nll = _nll(logits.float(), labels, z_loss)
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1)
    return nll.mean()


def _xent_chunk(hq, w, lq, mq, z_loss, mesh):
    logits = shard_hint(dense_apply({"w": w}, hq, w.dtype).float(), mesh,
                        "dp", None, "model")  # (B, chunk, V)
    return (_nll(logits, lq, z_loss) * mq).sum()


def chunked_softmax_xent(h, unembed_w, labels, *, chunk: int = 512, z_loss: float = 0.0,
                         mask=None, mesh=None):
    """Fused unembed projection + cross entropy, chunked over the sequence.

    Never holds the whole (B, L, V) logits: each chunk computes its (B,
    chunk, V) logits, reduces them to per-token nll, and is recomputed in
    the backward (``checkpoint``, as the JAX package's ``jax.checkpoint`` on
    the chunk body), so one chunk's logits and their gradient are live at a
    time.  The chunk draws no random numbers, so no RNG state is kept for
    the recompute.  A length ``chunk`` does not divide is padded, the mask with it
    (padding masked out).  Returns the masked mean nll.
    """
    B, L, _ = h.shape
    chunk = min(chunk, L)
    if mask is None:
        mask = torch.ones((B, L), dtype=torch.float32, device=h.device)
    if L % chunk:
        pad = chunk - L % chunk
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, h.shape[1], chunk):
        hq, lq, mq = h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk], mask[:, c0:c0 + chunk]
        tot = tot + checkpoint(_xent_chunk, hq, unembed_w, lq, mq, z_loss, mesh,
                               use_reentrant=False, preserve_rng_state=False)
        cnt = cnt + mq.sum()
    return tot / cnt.clamp_min(1.0)
