"""Mamba2 block (SSD, state-space duality, arXiv:2405.21060), the JAX
package's ``models/ssm.py``.

Block structure: in_proj -> [z (gate), x, B, C, dt]; causal depthwise conv
on (x, B, C); SSD scan over chunks; gated RMSNorm; out_proj.

Prefill runs the chunked SSD: ``cfg.ssm_backend="kernel"`` through the
``ssd_scan`` CUDA kernel (its plain version on CPU tensors), ``"chunked"``
through the plain ``ssd_chunked_batched``.  On DTensors the kernel route
first places the scan's inputs (``_scan_placed``): the kernel runs on each
rank's local shards.  Decode carries the O(1)
recurrent state (B, H, N, dh) in plain torch, as the JAX package's decode
is plain jnp.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import is_dtensor, shard_hint
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models.common import dense_apply, dense_init, rmsnorm_apply, rmsnorm_init

CONV_K = 4  # causal depthwise conv width
BACKENDS = ("kernel", "chunked")
F32_PARAMS = ("A_log", "dt_bias")  # kept in f32 whatever cfg.param_dtype is


def ssm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads


def ssm_init(gen: torch.Generator, cfg, device=None):
    """Random params from ``gen``, on ``device`` (by default ``gen``'s)."""
    D, N = cfg.d_model, cfg.ssm_state
    d_inner, H = ssm_dims(cfg)
    conv_dim = d_inner + 2 * N  # x, B, C all pass the conv
    dev, dt = device or gen.device, cfg.param_dtype

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    in_proj = dense_init(gen, D, 2 * d_inner + 2 * N + H, dt, device=dev)  # [z, x, B, C, dt]
    conv_w = (torch.randn((CONV_K, conv_dim), generator=gen, device=dev) * 0.1).to(dt)
    A_log = torch.log(uniform((H,), 1.0, 16.0))
    # dt bias: the log of a uniform draw in [1e-3, 1e-1], as the JAX package
    # draws it, added to dt before the softplus
    dt_bias = uniform((H,), math.log(1e-3), math.log(1e-1))
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=dev),
        "A_log": A_log,
        "dt_bias": dt_bias,
        "D_skip": torch.ones((H,), dtype=dt, device=dev),
        "norm": rmsnorm_init(d_inner, dt, dev),
        "out_proj": dense_init(gen, d_inner, D, dt, device=dev),
    }


def _split_proj(cfg, proj):
    d_inner, H = ssm_dims(cfg)
    N = cfg.ssm_state
    return torch.split(proj, [d_inner, d_inner, N, N, H], dim=-1)  # z, x, B, C, dt


def _causal_conv(w, b, u, conv_state=None):
    """Depthwise causal conv, width CONV_K, as four shifted multiply-adds
    (not ``F.conv1d``: cuDNN would run an f32 convolution in TF32).
    u: (B, L, C).  Returns (y, new state (B, CONV_K-1, C)) for decode."""
    Bt, L, Cdim = u.shape
    if conv_state is None:
        pad = torch.zeros((Bt, CONV_K - 1, Cdim), dtype=u.dtype, device=u.device)
    else:
        pad = conv_state.to(u.dtype)
    ext = torch.cat([pad, u], dim=1)  # (B, L+K-1, C)
    y = sum(ext[:, i:i + L] * w[i][None, None, :].to(u.dtype) for i in range(CONV_K))
    y = y + b[None, None, :].to(u.dtype)
    return F.silu(y), ext[:, L:]  # last K-1 raw inputs = decode state


def _scan_placed(x, dt, A, B, C):
    """The scan's inputs as the kernel runs them on DTensors: the batch on
    the dp axes and the heads on ``model`` where they divide (B and C the
    batch only), the placement the reference's partitioner gives the
    scan; plain tensors unchanged."""
    if not is_dtensor(x):
        return x, dt, A, B, C
    mesh = x.device_mesh
    return (shard_hint(x, mesh, "dp", None, "model", None),
            shard_hint(dt, mesh, "dp", None, "model"), shard_hint(A, mesh, "model"),
            shard_hint(B, mesh, "dp", None, None), shard_hint(C, mesh, "dp", None, None))


def ssm_apply(p, cfg, xin, *, return_state=False):
    """Prefill: xin (B, L, D) -> (B, L, D) [, decode state {"S", "conv"}]."""
    Bt, L, _ = xin.shape
    d_inner, H = ssm_dims(cfg)
    N, dh = cfg.ssm_state, cfg.ssm_head_dim
    proj = dense_apply(p["in_proj"], xin, cfg.compute_dtype)
    z, x, Bm, Cm, dt = _split_proj(cfg, proj)
    xbc_raw = torch.cat([x, Bm, Cm], dim=-1)
    xbc, conv_state = _causal_conv(p["conv_w"], p["conv_b"], xbc_raw)
    x, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])  # (H,) negative
    xh = x.reshape(Bt, L, H, dh)

    chunk = min(cfg.ssm_chunk, L)
    if L % chunk:  # pad to a chunk multiple; dt is padded after the softplus,
        # so a padded row has dt = 0: identity dynamics
        padlen = chunk - L % chunk
        xh = F.pad(xh, (0, 0, 0, 0, 0, padlen))
        dt = F.pad(dt, (0, 0, 0, padlen))
        Bm = F.pad(Bm, (0, 0, 0, padlen))
        Cm = F.pad(Cm, (0, 0, 0, padlen))

    args = (xh.float(), dt, A, Bm.float(), Cm.float())
    if cfg.ssm_backend == "kernel":
        y, S = ssd_ops.ssd_scan(*_scan_placed(*args), chunk=chunk)
    elif cfg.ssm_backend == "chunked":
        y, S = ssd_ref.ssd_chunked_batched(*args, chunk=chunk)
    else:
        raise ValueError(f"unknown ssm_backend {cfg.ssm_backend!r}; known: {BACKENDS}")
    y, xh = y[:, :L], xh[:, :L]
    y = y + xh.float() * p["D_skip"].float()[None, None, :, None]
    y = y.reshape(Bt, L, d_inner).to(cfg.compute_dtype)
    y = rmsnorm_apply(p["norm"], y * F.silu(z))
    out = dense_apply(p["out_proj"], y, cfg.compute_dtype)
    if return_state:
        return out, {"S": S, "conv": conv_state}
    return out


def ssm_decode_init(cfg, batch, dtype=torch.float32, *, device="cuda"):
    """Zero decode state; ``batch`` is an int or a tuple of leading dims
    (the model stack passes (n_layers, batch))."""
    d_inner, H = ssm_dims(cfg)
    N, dh = cfg.ssm_state, cfg.ssm_head_dim
    lead = (batch,) if isinstance(batch, int) else tuple(batch)
    return {
        "S": torch.zeros(lead + (H, N, dh), dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (CONV_K - 1, d_inner + 2 * N), dtype=dtype, device=device),
    }


def ssm_decode_apply(p, cfg, xin, state):
    """One-token decode: xin (B, 1, D), O(1) state update.  Returns (out,
    new state); the state passed in is not modified."""
    Bt = xin.shape[0]
    d_inner, H = ssm_dims(cfg)
    N, dh = cfg.ssm_state, cfg.ssm_head_dim
    proj = dense_apply(p["in_proj"], xin, cfg.compute_dtype)
    z, x, Bm, Cm, dt = _split_proj(cfg, proj)
    xbc = torch.cat([x, Bm, Cm], dim=-1)  # (B, 1, conv_dim)
    conv_in = torch.cat([state["conv"].to(xbc.dtype), xbc], dim=1)
    y = sum(
        conv_in[:, i:i + 1] * p["conv_w"][i][None, None, :].to(xbc.dtype) for i in range(CONV_K)
    ) + p["conv_b"][None, None, :].to(xbc.dtype)
    xbc_out = F.silu(y)
    new_conv = conv_in[:, 1:]
    x, Bm, Cm = torch.split(xbc_out, [d_inner, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])[:, 0]
    A = -torch.exp(p["A_log"])  # (H,)
    a = torch.exp(dt * A[None, :])  # (B, H)
    xh = x.reshape(Bt, H, dh).float()
    Bf, Cf = Bm[:, 0].float(), Cm[:, 0].float()  # (B, N)
    # S <- a S + dt * B x^T ; y = C S
    S = state["S"] * a[:, :, None, None] + dt[:, :, None, None] * torch.einsum(
        "bn,bhd->bhnd", Bf, xh)
    yh = torch.einsum("bn,bhnd->bhd", Cf, S)
    yh = yh + xh * p["D_skip"].float()[None, :, None]
    y = yh.reshape(Bt, 1, d_inner).to(cfg.compute_dtype)
    y = rmsnorm_apply(p["norm"], y * F.silu(z))
    out = dense_apply(p["out_proj"], y, cfg.compute_dtype)
    return out, {"S": S, "conv": new_conv}
