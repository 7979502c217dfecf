"""Model factory: ``build_model(cfg)`` -> a ``Model`` bundle;
``params_from_numpy`` and ``state_from_numpy`` to carry the JAX package's
params and training state across, ``state_to_numpy`` back.

One interface, as in the JAX package:
  init(gen, device=None)                  -> params (on device, by default gen's)
  loss(params, batch)                     -> scalar (the train objective)
  prefill(params, batch, max_len)         -> (logits, cache)
  decode_step(params, cache, tokens, pos) -> (logits, cache)
  cache_init(batch, max_len, device)      -> cache
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models import ssm, transformer, whisper


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    init: Callable
    loss: Callable
    prefill: Callable
    decode_step: Callable
    cache_init: Callable


def build_model(cfg, mesh=None) -> Model:
    """The encdec family's prefill reads ``batch["frames"]``; a vlm's takes
    ``batch.get("patches")``.  ``mesh`` goes to the model code's sharding
    hints, as in the JAX package."""
    if cfg.family == "encdec":
        return Model(
            cfg=cfg,
            init=lambda gen, device=None: whisper.whisper_init(gen, cfg, device),
            loss=lambda p, batch: whisper.whisper_loss(p, cfg, batch, mesh=mesh),
            prefill=lambda p, batch, max_len: whisper.whisper_prefill(
                p, cfg, batch["tokens"], batch["frames"], max_len, mesh=mesh),
            decode_step=lambda p, cache, tokens, pos: whisper.whisper_decode_step(
                p, cfg, cache, tokens, pos),
            cache_init=lambda batch, max_len, device="cuda": whisper.whisper_cache_init(
                cfg, batch, max_len, device=device),
        )
    transformer.require_decoder(cfg)
    return Model(
        cfg=cfg,
        init=lambda gen, device=None: transformer.lm_init(gen, cfg, device),
        loss=lambda p, batch: transformer.lm_loss(p, cfg, batch, mesh=mesh),
        prefill=lambda p, batch, max_len: transformer.prefill(
            p, cfg, batch["tokens"], max_len, patches=batch.get("patches"), mesh=mesh),
        decode_step=lambda p, cache, tokens, pos: transformer.decode_step(
            p, cfg, cache, tokens, pos, mesh=mesh),
        cache_init=lambda batch, max_len, device="cuda": transformer.decode_cache_init(
            cfg, batch, max_len, device=device),
    )


def layer_stacks(cfg) -> dict[str, int]:
    """The keys whose layer stack the port keeps as a list of per-layer
    dicts (the JAX package stacks it on a leading axis), with its depth."""
    if cfg.family == "encdec":
        return {"enc": cfg.n_enc_layers, "dec": cfg.n_dec_layers}
    transformer.require_decoder(cfg)
    return {"layers": cfg.n_layers}


def _tensor(a, dtype, device):
    a = np.asarray(a)
    if a.dtype.kind not in "biuf":  # ml_dtypes' bfloat16: through f32, exactly
        a = a.astype(np.float32)
    return torch.tensor(np.ascontiguousarray(a).reshape(a.shape), dtype=dtype, device=device)


def _split(cfg, tree, dtype_of, device):
    """``tree`` (the JAX layout) with each layer stack split into a list of
    per-layer subtrees; a leaf named ``name`` becomes ``dtype_of(name)``."""
    stacks = layer_stacks(cfg)

    def conv(node, index=None, name=""):
        if isinstance(node, dict):
            return {k: conv(v, index, k) for k, v in node.items()}
        a = np.asarray(node) if index is None else np.asarray(node)[index]
        return _tensor(a, dtype_of(name), device)

    out = {k: conv(v) for k, v in tree.items() if k not in stacks}
    for key, n in stacks.items():
        out[key] = [conv(tree[key], i) for i in range(n)]
    return out


def params_from_numpy(cfg, tree, *, device="cuda"):
    """The port's params from the JAX package's, as numpy arrays.

    ``tree`` is what ``jax.tree.map(np.asarray, model.init(key))`` gives for
    the same ``cfg``: the same nested dicts, with each layer stack on a
    leading axis, which is split into a list of per-layer dicts: ``layers``
    by ``n_layers`` (the MoE's experts ``(L, E, a, b)`` become ``(E, a, b)``
    a layer, with the router and the shared expert), Whisper's ``enc`` and
    ``dec`` by ``n_enc_layers`` and ``n_dec_layers``.  The hybrid's
    ``shared_attn``, the vlm's ``patch_proj`` and Whisper's ``frame_proj``
    are not stacked and stay whole.  Weights stay ``(in, out)``.  Leaves
    become ``cfg.param_dtype`` (a bf16 leaf passes through f32, exactly),
    except those the JAX init fixes in f32 (the ssm's ``A_log`` and
    ``dt_bias``).
    """
    return _split(cfg, tree, lambda name: torch.float32 if name in ssm.F32_PARAMS
                  else cfg.param_dtype, device)


def state_from_numpy(cfg, tcfg, tree, *, device="cuda"):
    """The port's training state from the JAX package's ``{params, opt,
    ef?}`` (``jax.tree.map(np.asarray, state)``) for the same ``cfg`` and
    train config ``tcfg``: the params as ``params_from_numpy``; the moments
    (AdamW's ``mu`` and ``nu``, Adafactor's ``v`` or ``vr``/``vc`` a leaf)
    and the error feedback ``ef``, all f32, split by layer the same way;
    ``step`` an int32 scalar."""
    f32 = lambda name: torch.float32  # noqa: E731
    opt = tree["opt"]
    out = {"params": params_from_numpy(cfg, tree["params"], device=device),
           "opt": {k: _split(cfg, opt[k], f32, device) for k in opt if k != "step"}}
    out["opt"]["step"] = _tensor(opt["step"], torch.int32, device)
    if "ef" in tree:
        out["ef"] = _split(cfg, tree["ef"], f32, device)
    if (tcfg.compression.scheme != "none") != ("ef" in out):
        raise ValueError("the state's error feedback does not match tcfg.compression")
    return out


def state_to_numpy(cfg, state):
    """``state_from_numpy``'s inverse: the JAX package's layout, each layer
    stack restacked on a leading axis, numpy arrays (bf16 leaves as f32,
    exactly: numpy has no bfloat16)."""

    def host(t):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    return jax_layout(cfg, state, host, np.stack)


def jax_layout(cfg, tree, leaf, stack):
    """``tree`` (the port's layout) in the JAX package's: each leaf mapped
    by ``leaf``, each layer stack's per-layer leaves joined by ``stack``
    (a list of mapped leaves -> one).  ``shapes_to_jax`` reads shapes only,
    so a meta state maps too."""
    stacks = layer_stacks(cfg)

    def conv(node):
        if isinstance(node, dict):
            return {k: _restack([conv(x) for x in v], stack)
                    if k in stacks and isinstance(v, list) else conv(v)
                    for k, v in node.items()}
        return leaf(node)

    return conv(tree)


def shapes_to_jax(cfg, tree):
    """The JAX package's layout of ``tree``'s shapes: ``(n_layers,) +
    shape`` for a layer stack's leaves."""
    return jax_layout(cfg, tree, lambda t: tuple(t.shape),
                      lambda shapes: (len(shapes),) + shapes[0])


def _restack(layers, stack):
    if isinstance(layers[0], dict):
        return {k: _restack([lp[k] for lp in layers], stack) for k in layers[0]}
    return stack(layers)
